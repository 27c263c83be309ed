"""Builds the port's native code into shared libraries, loaded with
ctypes.

The CUDA libraries are compiled by nvcc for Hopper (`sm_90a`): the exact
stage's, and the capacity chain's descent and tile-slot kernels; the
host libraries compile the same math (`csrc/exact_math.cuh`,
`csrc/chain_math.cuh`) with g++ for the CPU tests; the native runtime library (`csrc/omm_native.cpp`:
LZ4, XXH64, state packing) is built by g++ for the bake's host tail.
Each is built at first use into `build/omm_tpu_torch/` beside the
package (in a checkout), or into `~/.cache/omm_tpu_torch/` where that
directory cannot be written (an installed package), named by a digest
of its own sources and flags (editing the
CUDA kernel rebuilds neither g++ library; the native library's name also
covers what -march=native means on the building host), and put in place
by an atomic rename from a per-process temporary, so concurrent
processes share one build and never load a half-written file.  fp32 results must be
bit-exact, so no compiler of the exact stage may contract `a*b + c` into
an FMA or use approximate division or sqrt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "omm_tpu_torch"
#: where the libraries go when BUILD_DIR cannot be written
USER_BUILD_DIR = Path("~/.cache/omm_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-x", "c++", "-O2", "-ffp-contract=off", "-std=c++17",
             "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
             "-shared", "-fPIC"]
#: -march=native lets the pack/unpack/digest loops vectorize for the
#: building host (3.3x faster 2-bit unpacking than plain -O3 on an x86
#: host); the library's name then includes what -march=native means
#: there (`_host_target`), so hosts that share a build directory each
#: build and load their own
NATIVE_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-pthread",
                "-shared", "-fPIC"]

_LOCK = threading.Lock()
_BUILD_LOCKS: dict = {}
_LIBS: dict = {}
#: per library: compiler output of the build this process ran (nvcc's
#: -Xptxas=-v register and shared-memory report) and its seconds
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argument list shared by the CUDA launcher and the host driver
_EXACT_ARGS = [_P, _I, _I, _P, _P, _I, _P, _P,        # plane .. ccw
               _I, _I, _I, _I, _I, _I, _I, _I, _I,   # subdiv .. W
               _F, _F, _F, _P, _P]                   # rcp, cutoff, outs


def _digest(flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _host_target() -> str:
    """g++'s resolved target options for -march=native on this host."""
    r = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ -march=native failed:\n{r.stderr}")
    return r.stdout


def build_dir() -> Path:
    """BUILD_DIR where it can be created and written, else the user's
    cache directory (USER_BUILD_DIR)."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if os.access(BUILD_DIR, os.W_OK):
            return BUILD_DIR
    except OSError:
        pass
    d = USER_BUILD_DIR.expanduser()
    d.mkdir(parents=True, exist_ok=True)
    return d


def _compile(name: str, cmd: list, sources: list, flags: list,
             compiled: int = 1) -> Path:
    """Build the first `compiled` sources (which include the rest) into
    lib<name>_<digest>.so in `build_dir()` unless that file exists."""
    key = [cmd[0], *flags]
    if "-march=native" in flags:
        key.append(_host_target())
    out = build_dir() / f"lib{name}_{_digest(key, sources)}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([*cmd, *flags, *map(str, sources[:compiled]), "-o",
                        str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {sources[0].name} failed:\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": r.stdout + r.stderr}
    return out


def _nvcc() -> str:
    """nvcc on PATH, else the CUDA toolkit's default install location."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _load(name: str, cmd, sources: list, flags: list, fns: dict,
          compiled: int = 1):
    """The loaded library `name`, built on first use (one build at a time
    per library; different libraries build at once); fns maps each
    exported function to its (argtypes, restype)."""
    lib = _LIBS.get(name)  # the per-launch path: one dict lookup
    if lib is not None:
        return lib
    with _LOCK:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name, cmd(), sources, flags,
                                           compiled)))
            for fn, (argtypes, restype) in fns.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def cuda_library_name(csrc=None) -> str:
    """The name cuda_library(csrc) builds and reports under (BUILD_INFO)."""
    if csrc is None:
        return "omm_exact_cuda"
    d = str(Path(csrc).resolve())
    return f"omm_exact_cuda_{hashlib.sha256(d.encode()).hexdigest()[:8]}"


def cuda_library(csrc=None):
    """The CUDA exact-classification library (built with nvcc on first
    use).  Its `omm_exact_classify` launches on the given stream and
    returns cudaGetLastError(); `omm_exact_error_string` names it;
    `omm_exact_shape` reports the launch shape.  csrc: another directory
    with an exact_classify.cu of the same launch interface, built under
    its own name (to time an earlier kernel beside this one)."""
    fns = {"omm_exact_classify": (_EXACT_ARGS + [_P], _I),
           "omm_exact_error_string": ([_I], ctypes.c_char_p)}
    if csrc is not None:
        d = Path(csrc).resolve()
        return _load(cuda_library_name(d), lambda: [_nvcc()],
                     [d / "exact_classify.cu", d / "exact_math.cuh"],
                     NVCC_FLAGS, fns)
    fns["omm_exact_shape"] = ([_I, _I, _P, _P, _P], _I)
    return _load(cuda_library_name(), lambda: [_nvcc()],
                 [CSRC / "exact_classify.cu", CSRC / "exact_math.cuh"],
                 NVCC_FLAGS, fns)


_L = ctypes.c_int64
#: omm_descend_sides: par, count, n_par, n_out, E, level, test, active,
#: act_span, uv, nm, cls, mip_ints, side, node, valid, open
_DESCEND_ARGS = [_P, _P, _L, _L, _L, _I, _I, _P, _L, _P, _I, _P, _P,
                 _P, _P, _P, _P]
#: omm_tile_keys: ids, kvalid, n, subdiv, uv, nm, mip_ints, keys
_KEYS_ARGS = [_P, _P, _L, _I, _P, _I, _P, _P]
#: omm_tile_slots: st, order, ids, K, nm, nblk, slot, padM, ids_slot,
#: block_tile (then the CUDA entry's bsum scratch)
_SLOTS_ARGS = [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P]
#: omm_slot_stream: ids, slot, keys, n, nblk, ids_slot, block_tile
_STREAM_ARGS = [_P, _P, _P, _L, _L, _P, _P]
CHAIN_CUDA_SOURCES = ("chain_descend.cu", "chain_slots.cu")
CHAIN_HEADERS = ("chain_math.cuh", "exact_math.cuh")


def chain_cuda_library():
    """The capacity chain's CUDA library (nvcc, one build of
    chain_descend.cu and chain_slots.cu): `omm_descend_sides` (kernel A),
    `omm_tile_keys` (B), `omm_tile_slots` (C) and `omm_slot_stream` (C's
    discovery form) launch on the given stream and return
    cudaGetLastError(); `omm_chain_error_string` names it;
    `omm_tile_slots_chunks` sizes C's scratch."""
    fns = {"omm_descend_sides": (_DESCEND_ARGS + [_P], _I),
           "omm_tile_keys": (_KEYS_ARGS + [_P], _I),
           "omm_tile_slots": (_SLOTS_ARGS + [_P, _P], _I),
           "omm_slot_stream": (_STREAM_ARGS + [_P], _I),
           "omm_tile_slots_chunks": ([_L], _L),
           "omm_chain_error_string": ([_I], ctypes.c_char_p)}
    return _load("omm_chain_cuda", lambda: [_nvcc()],
                 [CSRC / f for f in CHAIN_CUDA_SOURCES + CHAIN_HEADERS],
                 NVCC_FLAGS, fns, compiled=len(CHAIN_CUDA_SOURCES))


def chain_host_library():
    """The host build of the chain kernels' code (g++, chain_host.cpp):
    the same entries with a `_host` suffix and no stream."""
    return _load("omm_chain_host", lambda: ["g++"],
                 [CSRC / "chain_host.cpp",
                  *(CSRC / f for f in CHAIN_HEADERS)], GXX_FLAGS,
                 {"omm_descend_sides_host": (_DESCEND_ARGS, _I),
                  "omm_tile_keys_host": (_KEYS_ARGS, _I),
                  "omm_tile_slots_host": (_SLOTS_ARGS, _I),
                  "omm_slot_stream_host": (_STREAM_ARGS, _I)})


def host_library():
    """The host build of the exact stage's math (g++), whose
    `omm_exact_host` walks each block in the kernel's order."""
    return _load("omm_exact_host", lambda: ["g++"],
                 [CSRC / "exact_host.cpp", CSRC / "exact_math.cuh"],
                 GXX_FLAGS, {"omm_exact_host": (_EXACT_ARGS, _I)})


def native_library(fns: dict):
    """The native runtime library (g++, NATIVE_FLAGS): LZ4, XXH64 and
    state packing for the bake's host tail; fns as for `_load`."""
    return _load("omm_native", lambda: ["g++"], [CSRC / "omm_native.cpp"],
                 NATIVE_FLAGS, fns)
