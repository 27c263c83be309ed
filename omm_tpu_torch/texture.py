"""Alpha texture object: mip chain, wrap modes, bilinear, SAT.

The port's copy of `omm_tpu/texture.py`, a re-design of the reference's
`src/texture_impl.*` and `src/util/texture.h`.  Texels are stored as dense
row-major numpy planes (one per mip) regardless of the requested tiling
mode; the Z-order flag is retained only for API and serialization parity.
All coordinate math mirrors the reference exactly in int32/fp32,
vectorized over numpy arrays.  The original's `fz` contraction fence in
`bilinear` is not carried over: numpy never contracts `a*b + c`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .bit_tricks import ctz, is_pow2
from .types import (BakeError, Result, TextureAddressMode, TextureFlags,
                    TextureFormat)

# Sentinel coordinates (texture.h:21-24).
TEXCOORD_INVALID = 0x7FFFFFFF
TEXCOORD_BORDER = 0x7FFFFFFE

MAX_TEXTURE_DIM = 65536  # texture_impl.h:148


@dataclass
class MipInfo:
    size: tuple[int, int]          # (w, h)
    size_log2: tuple[int, int]     # ctz of each dim (texture_impl.cpp:98-99)
    rcp_size: np.ndarray           # fp32 (1/w, 1/h)
    is_pow2: bool


def get_tex_coord(mode: TextureAddressMode, coords, size, size_log2,
                  size_is_pow2: bool, xp=np):
    """Vectorized GetTexCoord (texture.h:34-91).

    coords: (..., 2) int32 texel coordinates (possibly out of range).
    size: (2,) int32 (w, h); size_log2: (2,) int32.
    Returns (..., 2) int32 wrapped coordinates; Border mode yields
    TEXCOORD_BORDER on out-of-range axes.
    """
    c = xp.asarray(coords, dtype=xp.int32)
    size = xp.asarray(size, dtype=xp.int32)
    size_log2 = xp.asarray(size_log2, dtype=xp.int32)

    if mode == TextureAddressMode.Wrap:
        cu = c.astype(xp.uint32)
        if size_is_pow2:
            return (cu & (size.astype(xp.uint32) - xp.uint32(1))).astype(xp.int32)
        return (cu % size.astype(xp.uint32)).astype(xp.int32)

    if mode == TextureAddressMode.Mirror:
        if size_is_pow2:
            cabs = xp.abs(c) - (c < 0).astype(xp.int32)
            flipped = ((cabs >> size_log2) & 1).astype(xp.bool_)
            wrapped = (cabs.astype(xp.uint32)
                       & (size.astype(xp.uint32) - xp.uint32(1))).astype(xp.int32)
            return xp.where(flipped, size - wrapped - 1, wrapped)
        # Non-pow2 path goes through fp32 (texture.h:63-70).
        cabs = xp.abs(c.astype(xp.float32) + xp.float32(0.5)).astype(xp.int32)
        flipped = ((cabs // size).astype(xp.uint32) % xp.uint32(2)).astype(xp.bool_)
        wrapped = (cabs.astype(xp.uint32) % size.astype(xp.uint32)).astype(xp.int32)
        return xp.where(flipped, size - wrapped - 1, wrapped)

    if mode == TextureAddressMode.Clamp:
        return xp.clip(c, 0, size - 1)

    if mode == TextureAddressMode.Border:
        oob = (c >= size) | (c < 0)
        return xp.where(oob, xp.int32(TEXCOORD_BORDER), c)

    if mode == TextureAddressMode.MirrorOnce:
        cabs = xp.abs(c.astype(xp.float32) + xp.float32(0.5)).astype(xp.int32)
        return xp.clip(cabs, 0, size - 1)

    raise ValueError(f"bad address mode {mode}")


def gather_tex_coord4(mode: TextureAddressMode, coords, size, size_log2,
                      size_is_pow2: bool, xp=np):
    """2x2 gather footprint (texture.h:130-148).

    Returns (c00, c10, c01, c11), each (..., 2) int32, built from the wrapped
    base coordinate and the wrapped (base + 1) coordinate per axis.
    """
    off = get_tex_coord(mode, coords, size, size_log2, size_is_pow2, xp)
    off11 = get_tex_coord(mode, xp.asarray(coords, dtype=xp.int32) + 1,
                          size, size_log2, size_is_pow2, xp)
    c00 = off
    c10 = xp.stack([off11[..., 0], off[..., 1]], axis=-1)
    c01 = xp.stack([off[..., 0], off11[..., 1]], axis=-1)
    c11 = off11
    return c00, c10, c01, c11


class Texture:
    """Owns the mip chain; analogous to TextureImpl (texture_impl.h:32-176)."""

    def __init__(self, mips: list[np.ndarray], fmt: TextureFormat,
                 flags: TextureFlags = TextureFlags.NONE,
                 alpha_cutoff: float = -1.0):
        """mips: list of (h, w) arrays (uint8 for UNORM8, float32 for FP32),
        or (h, w, C) with C in 2..4 for a multi-channel (e.g. RGBA) texture.

        A multi-channel texture cannot be sampled directly: the GPU baker
        selects one channel per dispatch via alphaTextureChannel (the
        reference binds per-channel Gather PSOs, bake_gpu_impl.cpp:313-419,
        GatherRed/Green/Blue/Alpha in omm_resample_common.hlsli:201-209);
        channel_view(c) yields the equivalent single-channel Texture."""
        if len(mips) == 0:
            raise BakeError(Result.INVALID_ARGUMENT, "mipCount must be non-zero")
        self.format = TextureFormat(fmt)
        self.flags = TextureFlags(flags)
        self.alpha_cutoff = float(alpha_cutoff)
        self.channels = 1
        self._channel_views: dict[int, "Texture"] = {}
        self.mips: list[np.ndarray] = []
        self.info: list[MipInfo] = []
        for mi, m in enumerate(mips):
            m = np.asarray(m)
            if m.ndim == 3:
                if not 2 <= m.shape[2] <= 4:
                    raise BakeError(Result.INVALID_ARGUMENT,
                                    "multi-channel mip must have 2..4 channels")
                if mi == 0:
                    self.channels = m.shape[2]
                elif m.shape[2] != self.channels:
                    raise BakeError(Result.INVALID_ARGUMENT,
                                    "mips must agree on channel count")
            elif m.ndim != 2:
                raise BakeError(Result.INVALID_ARGUMENT,
                                "mip must be (h, w) or (h, w, channels)")
            elif self.channels != 1:
                raise BakeError(Result.INVALID_ARGUMENT,
                                "mips must agree on channel count")
            h, w = m.shape[:2]
            if w == 0 or h == 0:
                raise BakeError(Result.INVALID_ARGUMENT, "mip dims must be non-zero")
            if w > MAX_TEXTURE_DIM or h > MAX_TEXTURE_DIM:
                raise BakeError(Result.INVALID_ARGUMENT, "mip dims exceed 65536")
            if self.format == TextureFormat.UNORM8:
                m = m.astype(np.uint8)
            else:
                m = m.astype(np.float32)
            self.mips.append(np.ascontiguousarray(m))
            self.info.append(MipInfo(
                size=(w, h),
                size_log2=(ctz(w), ctz(h)),
                rcp_size=(np.float32(1.0) / np.array([w, h], dtype=np.float32)),
                is_pow2=is_pow2(w) and is_pow2(h),
            ))
        # SAT of the binarized (alpha > cutoff) image, built when the cutoff
        # is embedded (texture_impl.cpp:91,191-220).  uint32 per texel.
        # Multi-channel textures defer it to their channel views.
        self.sat: Optional[list[np.ndarray]] = None
        if self.alpha_cutoff >= 0.0 and self.channels == 1:
            self.sat = []
            for mi, m in enumerate(self.mips):
                binar = (self.load_plane(mi) > np.float32(self.alpha_cutoff))
                s = np.cumsum(np.cumsum(binar.astype(np.uint32), axis=1,
                                        dtype=np.uint32), axis=0, dtype=np.uint32)
                self.sat.append(s)

    # -- properties ---------------------------------------------------------
    @property
    def mip_count(self) -> int:
        return len(self.mips)

    def size(self, mip: int) -> tuple[int, int]:
        return self.info[mip].size

    def size_is_pow2(self) -> bool:
        return self.info[0].is_pow2

    def has_alpha_cutoff(self) -> bool:
        return self.alpha_cutoff >= 0.0

    def has_sat(self) -> bool:
        return self.sat is not None

    # -- channel selection ----------------------------------------------------
    def channel_view(self, channel: int) -> "Texture":
        """Single-channel Texture for one plane of a multi-channel texture
        (the analog of binding the GatherRed/Green/Blue/Alpha PSO,
        bake_gpu_impl.cpp:313-419).  Views are cached per channel so device
        plane/SAT caches attached to them persist across dispatches.  A
        single-channel texture returns itself for any channel index — the
        reference gathers the only plane regardless of the channel swizzle."""
        if self.channels == 1:
            return self
        if not 0 <= channel < self.channels:
            raise BakeError(
                Result.INVALID_ARGUMENT,
                f"alphaTextureChannel {channel} out of range for a "
                f"{self.channels}-channel texture")
        view = self._channel_views.get(channel)
        if view is None:
            view = Texture([m[..., channel] for m in self.mips], self.format,
                           self.flags, self.alpha_cutoff)
            self._channel_views[channel] = view
        return view

    # -- sampling -----------------------------------------------------------
    def load_plane(self, mip: int) -> np.ndarray:
        """Whole mip as fp32 (UNORM8 decoded as v * (1/255) like
        texture_impl.h:195-196)."""
        if self.channels != 1:
            raise BakeError(Result.INVALID_ARGUMENT,
                            "multi-channel texture: select a channel first "
                            "(alphaTextureChannel / channel_view)")
        m = self.mips[mip]
        if self.format == TextureFormat.UNORM8:
            return m.astype(np.float32) * np.float32(1.0 / 255.0)
        return m

    def load(self, coords, mip: int, xp=np):
        """Gather fp32 texels at int (x, y) coords (..., 2).  Coordinates must
        already be wrapped into range (no border sentinels)."""
        plane = self.load_plane(mip)
        c = xp.asarray(coords)
        return xp.asarray(plane)[c[..., 1], c[..., 0]]

    def load_or_border(self, coords, mip: int, border_alpha, xp=np):
        """Gather with border-sentinel handling (bake_kernels_cpu.h:255-273)."""
        c = xp.asarray(coords, dtype=xp.int32)
        is_border = (c[..., 0] == TEXCOORD_BORDER) | (c[..., 1] == TEXCOORD_BORDER)
        safe = xp.where(is_border[..., None], 0, c)
        v = self.load(safe, mip, xp)
        return xp.where(is_border, xp.float32(border_alpha), v)

    def bilinear(self, mode: TextureAddressMode, p, mip: int, xp=np):
        """Runtime bilinear sample (texture_impl.cpp:261-278).

        p: (..., 2) fp32 in [0,1] UV.  Border mode falls back to wrapped
        loads like the reference runtime variant (which does NOT apply
        borderAlpha — parity quirk).
        """
        info = self.info[mip]
        sizef = xp.asarray(np.array(info.size, dtype=np.float32))
        pixel = xp.asarray(p, dtype=xp.float32) * sizef - xp.float32(0.5)
        pixel_floor = xp.floor(pixel)
        c00, c10, c01, c11 = gather_tex_coord4(
            mode, pixel_floor.astype(xp.int32),
            np.array(info.size, dtype=np.int32),
            np.array(info.size_log2, dtype=np.int32), info.is_pow2, xp)
        # Border sentinel coords would index out of bounds; the reference
        # Load() would read out-of-range memory in that case (asserts in
        # debug).  Clamp defensively to stay in-bounds; tests never hit it.
        def safe(cc):
            return xp.clip(cc, 0, xp.asarray(np.array(info.size, np.int32)) - 1)
        a = self.load(safe(c00), mip, xp)
        b = self.load(safe(c01), mip, xp)
        c = self.load(safe(c10), mip, xp)
        d = self.load(safe(c11), mip, xp)
        w = pixel - xp.floor(pixel)  # glm::fract
        wx = w[..., 0]
        wy = w[..., 1]
        one = xp.float32(1.0)
        ac = a * (one - wx) + c * wx
        bd = b * (one - wx) + d * wx
        return ac * (one - wy) + bd * wy

    # -- SAT ----------------------------------------------------------------
    def sat_query(self, s, e, mip: int) -> np.ndarray:
        """Inclusive box sum of the binarized plane over [s, e]
        (texture_impl.h:110-125).  s, e: (..., 2) int (x, y), in range."""
        sat = self.sat[mip]
        s = np.asarray(s, dtype=np.int64)
        e = np.asarray(e, dtype=np.int64)
        sx1 = s[..., 0] - 1
        sy1 = s[..., 1] - 1
        ex = e[..., 0]
        ey = e[..., 1]
        zero = np.uint32(0)
        A = np.where((sx1 >= 0) & (sy1 >= 0),
                     sat[np.maximum(sy1, 0), np.maximum(sx1, 0)], zero)
        B = np.where(sy1 >= 0, sat[np.maximum(sy1, 0), ex], zero)
        C = np.where(sx1 >= 0, sat[ey, np.maximum(sx1, 0)], zero)
        D = sat[ey, ex]
        return (D.astype(np.int64) + A.astype(np.int64)
                - B.astype(np.int64) - C.astype(np.int64)).astype(np.uint32)

    def in_texture(self, coords, mip: int) -> np.ndarray:
        """texture_impl.h:97-103."""
        c = np.asarray(coords)
        w, h = self.info[mip].size
        return ((c[..., 0] >= 0) & (c[..., 1] >= 0)
                & (c[..., 0] < w) & (c[..., 1] < h))
