"""ctypes binding of the native runtime library (LZ4, XXH64, state packing).

The port's copy of the functions of `omm_tpu/native/__init__.py` that its
host tail calls.  The library is `csrc/omm_native.cpp` (a copy of the JAX
package's source), built by g++ at first use through `kernels.build`,
which names each build by a digest of its own sources, its flags and the
host's -march=native target, and puts it in place by an atomic rename:
concurrent processes never load a half-written library, and hosts
sharing a build directory never load another's.  The build is required:
where the original fell back to numpy when g++ was missing, the port
raises.
The descent replays (`reconstruct_states`, `reconstruct_packed`) and
the unpacked rows' `row_post` are not bound: the port packs states on
the device, and `row_post_packed` takes the post of its packed rows.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .kernels import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_FNS = {
    "omm_xxh64": ([ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64],
                  ctypes.c_uint64),
    "omm_lz4_decompress_safe": ([ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_int],
                                ctypes.c_int),
    "omm_lz4_compress_default": ([ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_char_p, ctypes.c_int],
                                 ctypes.c_int),
    "omm_lz4_compress_bound": ([ctypes.c_int], ctypes.c_int),
    "omm_pack_states": ([_U8P, ctypes.c_size_t, ctypes.c_int, _U8P], None),
    "omm_hamming_u8": ([_U8P, _U8P, ctypes.c_size_t], ctypes.c_size_t),
    "omm_states3_xxh64": ([_U8P, ctypes.c_size_t, ctypes.c_uint64],
                          ctypes.c_uint64),
    "omm_all_uniform_u8": ([_U8P, ctypes.c_size_t], ctypes.c_int),
    "omm_pack_states_batch": ([_U64P, _I64P, _I32P, _I64P,
                               ctypes.c_int64, _U8P], None),
    "omm_row_post_packed": ([_U8P, ctypes.c_int64, ctypes.c_int64, _U64P,
                             _I32P, _I64P], None),
    "omm_unpack_2bit_seq": ([_U8P, ctypes.c_size_t, _U8P], None),
}


_LIB = None


def get_lib():
    """The loaded native library (built on first use)."""
    global _LIB
    if _LIB is None:
        _LIB = build.native_library(_FNS)
    return _LIB


def _u8ptr(arr):
    return arr.ctypes.data_as(_U8P)


def pack_states(states, bits: int):
    """OC1 bit-pack (M,) uint8 -> bytes array (bake_cpu_impl.cpp:1802-1819
    packing)."""
    s = np.ascontiguousarray(states, dtype=np.uint8)
    m = len(s)
    nbytes = max((m * bits + 7) >> 3, 1)
    out = np.zeros(nbytes, dtype=np.uint8)
    get_lib().omm_pack_states(_u8ptr(s), m, bits, _u8ptr(out))
    return out


def pack_states_into(states, bits: int, out) -> bool:
    """OC1 bit-pack directly into a caller-provided zeroed uint8 view
    (the bake's array-data buffer).  Returns False when `out` is not
    C-contiguous (caller falls back to pack_states + copy)."""
    if not out.flags["C_CONTIGUOUS"]:
        return False
    s = np.ascontiguousarray(states, dtype=np.uint8)
    get_lib().omm_pack_states(_u8ptr(s), len(s), bits, _u8ptr(out))
    return True


def pack_states_batch(state_arrs, bits_list, offs, out) -> bool:
    """Pack every item's states into `out` at the given byte offsets in
    ONE native call.  Returns False when `out` is not C-contiguous."""
    if not out.flags["C_CONTIGUOUS"]:
        return False
    n = len(state_arrs)
    # The native call reads raw pointers: anything non-contiguous or not
    # uint8 would pack garbage, so normalize (no-op for conforming inputs).
    state_arrs = [a if a.dtype == np.uint8 and a.flags["C_CONTIGUOUS"]
                  else np.ascontiguousarray(a, np.uint8)
                  for a in state_arrs]
    ptrs = np.fromiter((a.ctypes.data for a in state_arrs), np.uint64, n)
    ms = np.fromiter((a.shape[0] for a in state_arrs), np.int64, n)
    bt = np.asarray(bits_list, np.int32)
    of = np.asarray(offs, np.int64)
    get_lib().omm_pack_states_batch(
        ptrs.ctypes.data_as(_U64P), ms.ctypes.data_as(_I64P),
        bt.ctypes.data_as(_I32P), of.ctypes.data_as(_I64P), n, _u8ptr(out))
    return True


def states3_digest(states, seed: int = 0):
    """XXH64 of the 3-state view (UT==UO) WITHOUT materializing the
    remapped copy — the exact-dedup key (bake_cpu_impl.cpp:1031-1066)."""
    s = np.ascontiguousarray(states, dtype=np.uint8)
    return int(get_lib().omm_states3_xxh64(_u8ptr(s), len(s), seed))


def all_uniform_u8(arr):
    """states[0] if every byte matches it, else -1.  Early-exits at the
    first differing word."""
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    return int(get_lib().omm_all_uniform_u8(_u8ptr(a), len(a)))


def hamming_u8(a, b) -> int:
    """Count of differing bytes (near-duplicate merge distance)."""
    aa = np.ascontiguousarray(a, dtype=np.uint8)
    bb = np.ascontiguousarray(b, dtype=np.uint8)
    return int(get_lib().omm_hamming_u8(_u8ptr(aa), _u8ptr(bb), len(aa)))


def row_post_packed(packed, M: int, row_base=None):
    """The fused post pass over PACKED rows: a (rows, M/4) block of
    sequential 2-bit rows -> per row (3-state digest, uniform value),
    equal to (states3_digest, all_uniform_u8) of the unpacked row.
    row_base: rows scattered in `packed`, row r at byte row_base[r].
    Raises ValueError unless M is a power of 4 of at least 4: the C pass
    compares whole bytes with the uniform pattern, which a 1-state row
    does not fill, and takes the digest's tail in 4-byte words."""
    M = int(M)
    if M < 4 or M & (M - 1) or M.bit_length() % 2 == 0:
        raise ValueError(f"row_post_packed needs M a power of 4, >= 4 "
                         f"(got {M})")
    Q = M >> 2
    b = np.ascontiguousarray(packed, dtype=np.uint8)
    if row_base is None:
        if b.ndim != 2 or b.shape[1] != Q:
            raise ValueError(f"packed rows of shape {b.shape}, want "
                             f"(rows, {Q})")
        rows, rbp = b.shape[0], None
    else:
        rb = np.ascontiguousarray(row_base, np.int64)
        if rb.size and (rb.min() < 0 or rb.max() + Q > b.size):
            raise ValueError("a row_base row lies outside `packed`")
        rows, rbp = rb.shape[0], rb.ctypes.data_as(_I64P)
    dig = np.empty(rows, np.uint64)
    uni = np.empty(rows, np.int32)
    get_lib().omm_row_post_packed(_u8ptr(b), rows, M,
                                  dig.ctypes.data_as(_U64P),
                                  uni.ctypes.data_as(_I32P), rbp)
    return dig, uni


def unpack_2bit_seq(packed, M: int):
    """Sequential 2-bit unpack (state j in byte j>>2 at shift (j&3)*2):
    lazy materialization of WorkItem.states."""
    p = np.ascontiguousarray(packed, np.uint8)
    out = np.empty(M, np.uint8)
    get_lib().omm_unpack_2bit_seq(_u8ptr(p), M, _u8ptr(out))
    return out


def xxh64(data: bytes, seed: int = 0) -> int:
    return int(get_lib().omm_xxh64(data, len(data), seed))


def lz4_compress(data: bytes) -> bytes:
    lib = get_lib()
    bound = lib.omm_lz4_compress_bound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.omm_lz4_compress_default(data, len(data), out, bound)
    if n < 0:
        raise RuntimeError("LZ4 compression failed")
    return out.raw[:n]


def lz4_decompress(data: bytes, decompressed_size: int) -> bytes:
    out = ctypes.create_string_buffer(decompressed_size)
    n = get_lib().omm_lz4_decompress_safe(data, len(data), out,
                                          decompressed_size)
    if n < 0:
        raise RuntimeError("LZ4 decompression failed (corrupt blob)")
    return out.raw[:n]
