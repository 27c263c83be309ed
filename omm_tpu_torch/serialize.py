"""Versioned blob serialization of bake inputs and results.

The port's copy of `omm_tpu/serialize.py`, on the port's own types,
texture and native library: blobs of either package read in the other,
and both write the same bytes for the same descriptor or result.

Byte-compatible with the reference SDK's serializer
(`serialize_impl.{h,cpp}`): XXH64-digested header (seed 42), format versions
V1..V5 readable / V5 written, optional LZ4 compression of the body, texture
payloads stored in their declared tiling order with 64-byte mip alignment.
Reference-SDK blobs (e.g. the goldens embedded in test_omm_bake_cpu.cpp)
deserialize directly.
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

from . import native
from .bit_tricks import xy_to_morton, next_pow2
from .types import (BakeError, BakeInputDesc, BakeResult, Format, IndexFormat,
                    MicromapDesc, Result, SamplerDesc, SpecialIndex,
                    TexCoordFormat, TextureFlags, TextureFormat, UsageCount,
                    UnknownStatePromotion, AlphaMode, BakeFlags,
                    OpacityState, TextureAddressMode, TextureFilterMode)
from .texture import Texture

SERIALIZE_VERSION = 5
VERSION_TRIPLE = (1, 9, 0)
_ALIGN = 64  # TextureImpl kAlignment (texture_impl.h:149)


class SerializeFlags:
    NONE = 0
    COMPRESS = 1


@dataclass
class DeserializedDesc:
    """ommCpuDeserializedDesc (omm.h:546-566)."""

    flags: int = SerializeFlags.NONE
    input_descs: list = field(default_factory=list)
    result_descs: list = field(default_factory=list)


def _align(v: int, a: int = _ALIGN) -> int:
    return (v + a - 1) & ~(a - 1)


def _texcoord_format_size(fmt: TexCoordFormat) -> int:
    return 4 if fmt != TexCoordFormat.UV32_FLOAT else 8


def _index_format_size(fmt: IndexFormat) -> int:
    return {IndexFormat.UINT_8: 1, IndexFormat.UINT_16: 2,
            IndexFormat.UINT_32: 4}[IndexFormat(fmt)]


# ---------------------------------------------------------------------------
# Texture payload (texture_impl.h:232-336)
# ---------------------------------------------------------------------------

def _texture_payload(tex: Texture) -> bytes:
    out = io.BytesIO()
    w = out.write
    n_mips = tex.mip_count
    w(struct.pack("<i", n_mips))

    elem = 1 if tex.format == TextureFormat.UNORM8 else 4
    morton = not (tex.flags & TextureFlags.DisableZOrder)

    offsets = []
    sat_offsets = []
    data_size = 0
    sat_size = 0
    n_elems = []
    for m in range(n_mips):
        tw, th = tex.size(m)
        if morton:
            max_dim = int(next_pow2(max(tw, th)))
            ne = max_dim * max_dim
        else:
            ne = tw * th
        n_elems.append(ne)
        offsets.append(data_size)
        sat_offsets.append(sat_size)
        data_size = _align(data_size + elem * ne)
        if tex.has_sat():
            sat_size = _align(sat_size + 4 * ne)

    for m in range(n_mips):
        tw, th = tex.size(m)
        w(struct.pack("<iiff", tw, th, float(tex.info[m].rcp_size[0]),
                      float(tex.info[m].rcp_size[1])))
        w(struct.pack("<QQQ", offsets[m], n_elems[m], sat_offsets[m]))

    tiling = 1 if morton else 0  # TilingMode::{Linear=0, MortonZ=1}
    w(struct.pack("<iifi", tiling, int(tex.flags), float(tex.alpha_cutoff),
                  int(tex.format)))

    data = np.zeros(data_size, dtype=np.uint8)
    for m in range(n_mips):
        tw, th = tex.size(m)
        plane = tex.mips[m]
        if morton:
            ys, xs = np.meshgrid(np.arange(th, dtype=np.uint32),
                                 np.arange(tw, dtype=np.uint32),
                                 indexing="ij")
            idx = xy_to_morton(xs, ys).astype(np.int64)
            buf = np.zeros(n_elems[m] * elem, dtype=np.uint8)
            flat = plane.reshape(-1).view(np.uint8).reshape(th * tw, elem)
            tgt = buf.reshape(n_elems[m], elem)
            tgt[idx.reshape(-1)] = flat
            data[offsets[m]:offsets[m] + len(buf)] = buf
        else:
            raw = plane.reshape(-1).view(np.uint8)
            data[offsets[m]:offsets[m] + len(raw)] = raw
    w(struct.pack("<Q", data_size))
    w(data.tobytes())

    w(struct.pack("<Q", sat_size))
    if tex.has_sat():
        sat = np.zeros(sat_size, dtype=np.uint8)
        for m in range(n_mips):
            # SAT is linear-indexed regardless of tiling
            # (texture_impl.cpp:193-219); padded tail stays zero.
            raw = tex.sat[m].astype(np.uint32).reshape(-1).view(np.uint8)
            sat[sat_offsets[m]:sat_offsets[m] + len(raw)] = raw
        w(sat.tobytes())
    return out.getvalue()


def _read_texture(r: io.BytesIO, version: int) -> Texture:
    (n_mips,) = struct.unpack("<i", r.read(4))
    mips_meta = []
    for _ in range(n_mips):
        tw, th, _rx, _ry = struct.unpack("<iiff", r.read(16))
        off, ne, soff = struct.unpack("<QQQ", r.read(24))
        mips_meta.append((tw, th, off, ne, soff))
    (tiling,) = struct.unpack("<i", r.read(4))
    if version >= 3:
        (flags,) = struct.unpack("<i", r.read(4))
        (alpha_cutoff,) = struct.unpack("<f", r.read(4))
    else:
        flags = (int(TextureFlags.NONE) if tiling == 1
                 else int(TextureFlags.DisableZOrder))
        alpha_cutoff = -1.0
    (tex_fmt,) = struct.unpack("<i", r.read(4))
    (data_size,) = struct.unpack("<Q", r.read(8))
    data = np.frombuffer(r.read(data_size), dtype=np.uint8)
    (sat_size,) = struct.unpack("<Q", r.read(8))
    has_sat = sat_size != 0
    if sat_size:
        r.read(sat_size)  # SAT is rebuilt from the cutoff

    elem = 1 if TextureFormat(tex_fmt) == TextureFormat.UNORM8 else 4
    dt = np.uint8 if elem == 1 else np.float32
    planes = []
    for tw, th, off, ne, _soff in mips_meta:
        raw = data[off:off + ne * elem]
        if tiling == 1:  # MortonZ
            vals = raw.view(dt)
            ys, xs = np.meshgrid(np.arange(th, dtype=np.uint32),
                                 np.arange(tw, dtype=np.uint32),
                                 indexing="ij")
            idx = xy_to_morton(xs, ys).astype(np.int64)
            planes.append(vals[idx.reshape(-1)].reshape(th, tw))
        else:
            planes.append(raw.view(dt)[:tw * th].reshape(th, tw))
    tex = Texture(planes, TextureFormat(tex_fmt), TextureFlags(flags),
                  alpha_cutoff=alpha_cutoff)
    tex._blob_had_sat = has_sat
    return tex


# ---------------------------------------------------------------------------
# Input desc (serialize_impl.cpp:81-157 / :381-481)
# ---------------------------------------------------------------------------

def _texcoords_bytes(desc: BakeInputDesc) -> bytes:
    tc = desc.tex_coords
    if (desc.tex_coord_format == TexCoordFormat.UV32_FLOAT
            and isinstance(tc, np.ndarray) and tc.dtype == np.float32
            and tc.ndim == 2):
        return np.ascontiguousarray(tc).tobytes()
    return np.ascontiguousarray(tc).view(np.uint8).tobytes()


def _index_bytes(desc: BakeInputDesc) -> bytes:
    ib = np.asarray(desc.index_buffer)
    width = _index_format_size(desc.index_format)
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    return ib.astype(dt).tobytes()[:desc.index_count * width]


def _max_index(desc: BakeInputDesc) -> int:
    ib = np.asarray(desc.index_buffer).reshape(-1)[:desc.index_count]
    return int(ib.max()) if len(ib) else 0


def _write_input_desc(w, desc: BakeInputDesc):
    w(struct.pack("<i", int(desc.bake_flags)))
    w(_texture_payload(desc.texture))
    w(struct.pack("<iifi", int(desc.runtime_sampler.addressing_mode),
                  int(desc.runtime_sampler.filter),
                  float(desc.runtime_sampler.border_alpha),
                  int(desc.alpha_mode)))
    w(struct.pack("<i", int(desc.tex_coord_format)))
    tc_size = _texcoord_format_size(desc.tex_coord_format) * (_max_index(desc) + 1)
    # Quirk parity (serialize_impl.cpp:98-104): the reference writes the
    # FIRST texCoordsSize bytes of the user buffer regardless of stride —
    # element size * (maxIndex+1) bytes raw, so a strided buffer's payload
    # includes the inter-element padding and is truncated relative to the
    # stride * (maxIndex+1) bytes a strided reader would need.
    raw_tc = _texcoords_bytes(desc)
    payload = raw_tc[:tc_size]
    w(struct.pack("<Q", tc_size))
    if tc_size:
        w(payload.ljust(tc_size, b"\0"))
    w(struct.pack("<I", desc.tex_coord_stride_in_bytes))
    w(struct.pack("<iI", int(desc.index_format), desc.index_count))
    w(_index_bytes(desc))
    w(struct.pack("<fff", float(desc.dynamic_subdivision_scale),
                  float(desc.rejection_threshold), float(desc.alpha_cutoff)))
    w(struct.pack("<iii", int(desc.alpha_cutoff_less_equal),
                  int(desc.alpha_cutoff_greater), int(desc.format)))
    # numFormats is indexCount in the blob format even though the buffer
    # holds one entry per TRIANGLE (serialize_impl.cpp:134-140); pad the
    # logical array with the global format so the stream stays parseable
    # and byte-deterministic.
    n_formats = 0 if desc.formats is None else desc.index_count
    w(struct.pack("<Q", n_formats))
    if n_formats:
        fm = np.full(n_formats, int(desc.format), np.int32)
        given = np.asarray(desc.formats, np.int32)[:n_formats]
        fm[: given.size] = given
        w(fm.tobytes())
    w(struct.pack("<ii", int(desc.unknown_state_promotion),
                  int(desc.unresolved_tri_state)))
    w(struct.pack("<B", desc.max_subdivision_level))
    w(struct.pack("<I", desc.max_array_data_size & 0xFFFFFFFF))
    # numSubdivLvls is indexCount in the reference's blob format even
    # though the buffer holds one entry per TRIANGLE
    # (serialize_impl.cpp:147-151 writes indexCount bytes); pad the
    # logical per-triangle array with 13 ("use global level",
    # omm.h:445-448) so the stream stays parseable and byte-deterministic.
    n_sub = 0 if desc.subdivision_levels is None else desc.index_count
    w(struct.pack("<Q", n_sub))
    if n_sub:
        sl = np.full(n_sub, 13, np.uint8)
        given = np.asarray(desc.subdivision_levels, np.uint8)[:n_sub]
        sl[: given.size] = given
        w(sl.tobytes())
    w(struct.pack("<Q", desc.max_workload_size & 0xFFFFFFFFFFFFFFFF))


def _read_input_desc(r: io.BytesIO, version: int) -> BakeInputDesc:
    desc = BakeInputDesc()
    (bake_flags,) = struct.unpack("<i", r.read(4))
    desc.bake_flags = BakeFlags(bake_flags)
    tex = _read_texture(r, version)
    desc.texture = tex
    am, filt, border, alpha_mode = struct.unpack("<iifi", r.read(16))
    desc.runtime_sampler = SamplerDesc(TextureAddressMode(am),
                                       TextureFilterMode(filt), border)
    desc.alpha_mode = AlphaMode(alpha_mode)
    (tcf,) = struct.unpack("<i", r.read(4))
    desc.tex_coord_format = TexCoordFormat(tcf)
    (tc_size,) = struct.unpack("<Q", r.read(8))
    raw = r.read(tc_size)
    desc.tex_coords = np.frombuffer(raw, dtype=np.uint8).copy()
    (desc.tex_coord_stride_in_bytes,) = struct.unpack("<I", r.read(4))
    idx_fmt, idx_count = struct.unpack("<iI", r.read(8))
    desc.index_format = IndexFormat(idx_fmt)
    desc.index_count = idx_count
    width = _index_format_size(desc.index_format)
    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    desc.index_buffer = np.frombuffer(r.read(width * idx_count), dtype=dt).copy()
    (desc.dynamic_subdivision_scale, desc.rejection_threshold,
     desc.alpha_cutoff) = struct.unpack("<fff", r.read(12))
    le, gt, fmt = struct.unpack("<iii", r.read(12))
    desc.alpha_cutoff_less_equal = OpacityState(le)
    desc.alpha_cutoff_greater = OpacityState(gt)
    desc.format = Format(fmt)
    (n_formats,) = struct.unpack("<Q", r.read(8))
    if n_formats:
        desc.formats = np.frombuffer(r.read(4 * n_formats), np.int32).copy()
    (promotion,) = struct.unpack("<i", r.read(4))
    desc.unknown_state_promotion = UnknownStatePromotion(promotion)
    if version >= 2:
        (unresolved,) = struct.unpack("<i", r.read(4))
        desc.unresolved_tri_state = SpecialIndex(unresolved)
    (desc.max_subdivision_level,) = struct.unpack("<B", r.read(1))
    if version >= 4:
        (desc.max_array_data_size,) = struct.unpack("<I", r.read(4))
    (n_sub,) = struct.unpack("<Q", r.read(8))
    if n_sub:
        desc.subdivision_levels = np.frombuffer(r.read(n_sub), np.uint8).copy()
    (desc.max_workload_size,) = struct.unpack("<Q", r.read(8))

    # Old-version fixup: pre-V3 blobs carried SAT data but no embedded
    # cutoff; recover it from the input desc (serialize_impl.cpp:473-478).
    if version < 3 and getattr(tex, "_blob_had_sat", False):
        desc.texture = Texture([tex.mips[m] for m in range(tex.mip_count)],
                               tex.format, tex.flags,
                               alpha_cutoff=desc.alpha_cutoff)
    return desc


# ---------------------------------------------------------------------------
# Result desc (serialize_impl.cpp:159-186 / :483-512)
# ---------------------------------------------------------------------------

def _write_result_desc(w, res: BakeResult):
    def write_array(data: bytes, count: int):
        w(struct.pack("<I", count))
        if count:
            w(data)

    write_array(res.array_data.tobytes(), len(res.array_data))
    desc_bytes = b"".join(
        struct.pack("<IHH", d.offset, d.subdivision_level, d.format)
        for d in res.desc_array)
    write_array(desc_bytes, len(res.desc_array))
    hist_bytes = b"".join(
        struct.pack("<IHH", u.count, u.subdivision_level, u.format)
        for u in res.desc_array_histogram)
    write_array(hist_bytes, len(res.desc_array_histogram))
    w(struct.pack("<i", int(res.index_format)))
    packed = res.packed_index_buffer()
    write_array(packed.tobytes(), res.index_count)
    ih_bytes = b"".join(
        struct.pack("<IHH", u.count, u.subdivision_level, u.format)
        for u in res.index_histogram)
    write_array(ih_bytes, len(res.index_histogram))


def _read_result_desc(r: io.BytesIO, version: int) -> BakeResult:
    def read_array(width: int):
        (count,) = struct.unpack("<I", r.read(4))
        return r.read(width * count), count

    raw, n = read_array(1)
    array_data = np.frombuffer(raw, np.uint8).copy()
    raw, n = read_array(8)
    descs = [MicromapDesc(*struct.unpack_from("<IHH", raw, 8 * i))
             for i in range(n)]
    raw, n = read_array(8)
    arr_hist = [UsageCount(*struct.unpack_from("<IHH", raw, 8 * i))
                for i in range(n)]
    (idx_fmt,) = struct.unpack("<i", r.read(4))
    idx_fmt = IndexFormat(idx_fmt)
    width = _index_format_size(idx_fmt)
    raw, n = read_array(width)
    dt = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    index_buffer = np.frombuffer(raw, dt).astype(np.int32)
    raw, n = read_array(8)
    idx_hist = [UsageCount(*struct.unpack_from("<IHH", raw, 8 * i))
                for i in range(n)]
    return BakeResult(array_data=array_data, desc_array=descs,
                      desc_array_histogram=arr_hist,
                      index_buffer=index_buffer, index_format=idx_fmt,
                      index_histogram=idx_hist,
                      triangle_area=np.zeros(len(index_buffer), np.float32))


# ---------------------------------------------------------------------------
# Top level (serialize_impl.cpp:188-276 / :546-582)
# ---------------------------------------------------------------------------

_HEADER_FMT = "<Qiiiiii"  # hash, major, minor, patch, version, flags, decompSize
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 32


def serialize(desc: DeserializedDesc) -> bytes:
    body = io.BytesIO()
    w = body.write
    w(struct.pack("<i", len(desc.input_descs)))
    for d in desc.input_descs:
        _write_input_desc(w, d)
    w(struct.pack("<i", len(desc.result_descs)))
    for rdesc in desc.result_descs:
        _write_result_desc(w, rdesc)
    payload = body.getvalue()

    compress = bool(desc.flags & SerializeFlags.COMPRESS) \
        and len(payload) + _HEADER_SIZE < 0x7E000000
    decompressed_size = len(payload) if compress else 0
    if compress:
        payload = native.lz4_compress(payload)

    header = struct.pack(_HEADER_FMT, 0, VERSION_TRIPLE[0], VERSION_TRIPLE[1],
                         VERSION_TRIPLE[2], SERIALIZE_VERSION,
                         int(desc.flags), decompressed_size)
    blob = bytearray(header + payload)
    digest = native.xxh64(bytes(blob[8:]), seed=42)
    blob[0:8] = struct.pack("<Q", digest)
    return bytes(blob)


def deserialize(blob: bytes) -> DeserializedDesc:
    if blob is None or len(blob) == 0:
        raise BakeError(Result.INVALID_ARGUMENT, "blob is empty")
    if len(blob) < _HEADER_SIZE - 4:
        raise BakeError(Result.INVALID_ARGUMENT, "blob too small")
    digest = native.xxh64(blob[8:], seed=42)
    (stored,) = struct.unpack_from("<Q", blob, 0)
    if digest != stored:
        raise BakeError(Result.INVALID_ARGUMENT,
                        "serialized blob appears corrupted "
                        "(digest mismatch)")
    major, minor, patch, version, flags = struct.unpack_from("<iiiii", blob, 8)
    if version > SERIALIZE_VERSION:
        raise BakeError(Result.INVALID_ARGUMENT,
                        f"blob from incompatible SDK version "
                        f"({major}.{minor}.{patch}:{version})")
    decompressed_size = 0
    header_size = _HEADER_SIZE if version >= 2 else _HEADER_SIZE - 4
    if version >= 2:
        (decompressed_size,) = struct.unpack_from("<i", blob, 28)

    payload = blob[header_size:]
    if decompressed_size:
        payload = native.lz4_decompress(bytes(payload), decompressed_size)

    r = io.BytesIO(payload)
    out = DeserializedDesc(flags=flags)
    (n_inputs,) = struct.unpack("<i", r.read(4))
    for _ in range(n_inputs):
        out.input_descs.append(_read_input_desc(r, version))
    (n_results,) = struct.unpack("<i", r.read(4))
    for _ in range(n_results):
        out.result_descs.append(_read_result_desc(r, version))
    return out
