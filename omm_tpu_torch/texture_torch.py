"""Texture addressing and sampling in torch.

Counterparts of `texture.get_tex_coord` / `gather_tex_coord4` (the
port's numpy copies of texture.h:34-148) and of the loads and the
runtime bilinear sample the fine passes make, on int32 / fp32 tensors of
any device.  torch has no usable uint32 arithmetic, so the original's
uint32 casts become int64 values masked to 32 bits.  Each axis is
wrapped on its own: the numpy functions broadcast (x, y) pairs against
(w, h), which is the same thing.

Every coordinate these functions return lies inside the plane, except
Border mode's sentinel `TEXCOORD_BORDER`, which `load` replaces before
it indexes: a torch gather raises (CPU) or faults (CUDA) on an index out
of range where an XLA gather clamps.
"""
from __future__ import annotations

import numpy as np
import torch

from .texture import TEXCOORD_BORDER
from .types import TextureAddressMode

_M32 = 0xFFFFFFFF


def wrap_axis(mode, c, n: int, log2: int, is_pow2: bool):
    """GetTexCoord (texture.h:34-91) along one axis of size n: c int32
    tensor; returns int32."""
    c = c.to(torch.int32)
    if mode == TextureAddressMode.Wrap:
        cu = c.to(torch.int64) & _M32
        return (cu & (n - 1) if is_pow2 else cu % n).to(torch.int32)
    if mode == TextureAddressMode.Mirror:
        if is_pow2:
            cabs = c.abs() - (c < 0).to(torch.int32)
            flipped = ((cabs >> log2) & 1) != 0
            wrapped = ((cabs.to(torch.int64) & _M32) & (n - 1)).to(
                torch.int32)
        else:  # through fp32 (texture.h:63-70)
            cabs = (c.to(torch.float32) + 0.5).abs().to(torch.int32)
            cu = cabs.to(torch.int64) & _M32
            flipped = ((cabs.to(torch.int64) // n) & _M32) % 2 != 0
            wrapped = (cu % n).to(torch.int32)
        return torch.where(flipped, n - wrapped - 1, wrapped)
    if mode == TextureAddressMode.Clamp:
        return c.clamp(0, n - 1)
    if mode == TextureAddressMode.Border:
        return torch.where((c >= n) | (c < 0), TEXCOORD_BORDER, c)
    if mode == TextureAddressMode.MirrorOnce:
        cabs = (c.to(torch.float32) + 0.5).abs().to(torch.int32)
        return cabs.clamp(0, n - 1)
    raise ValueError(f"bad address mode {mode}")


def get_tex_coord(mode, x, y, info):
    """Wrapped (x, y) int32 coordinates of one mip (`info` a MipInfo)."""
    (w, h), (lw, lh) = info.size, info.size_log2
    return (wrap_axis(mode, x, w, lw, info.is_pow2),
            wrap_axis(mode, y, h, lh, info.is_pow2))


def gather_tex_coord4(mode, x, y, info):
    """2x2 gather footprint (texture.h:130-148): (c00, c10, c01, c11),
    each an (x, y) pair of int32 tensors."""
    x0, y0 = get_tex_coord(mode, x, y, info)
    x1, y1 = get_tex_coord(mode, x.to(torch.int32) + 1,
                           y.to(torch.int32) + 1, info)
    return (x0, y0), (x1, y0), (x0, y1), (x1, y1)


def load(plane, cx, cy, border_alpha=None):
    """plane[cy, cx] for wrapped coordinates.  With border_alpha given
    (Border mode), a coordinate holding the sentinel on either axis
    reads border_alpha (bake_kernels_cpu.h:255-273)."""
    w = plane.shape[1]
    if border_alpha is None:
        return plane.reshape(-1)[cy.to(torch.int64) * w + cx]
    isb = (cx == TEXCOORD_BORDER) | (cy == TEXCOORD_BORDER)
    idx = torch.where(isb, 0, cy.to(torch.int64) * w + cx)
    return torch.where(isb, float(np.float32(border_alpha)),
                       plane.reshape(-1)[idx])


def load_clamped(plane, cx, cy):
    """plane[clip(cy), clip(cx)]: the runtime bilinear's loads, which
    clamp Border's sentinel to the last texel (texture.bilinear)."""
    h, w = plane.shape
    return load(plane, cx.clamp(0, w - 1), cy.clamp(0, h - 1))


def bilinear(plane, mode, px, py, info):
    """Runtime bilinear sample at UV (px, py), fp32 tensors
    (texture_impl.cpp:261-278; `Texture.bilinear`'s operation order).
    Border mode reads wrapped texels and never borderAlpha, like the
    reference's runtime variant."""
    w, h = info.size
    pixx = px * float(w) - 0.5
    pixy = py * float(h) - 0.5
    fx = torch.floor(pixx)
    fy = torch.floor(pixy)
    c00, c10, c01, c11 = gather_tex_coord4(mode, fx.to(torch.int32),
                                           fy.to(torch.int32), info)
    a = load_clamped(plane, *c00)
    b = load_clamped(plane, *c01)
    c = load_clamped(plane, *c10)
    d = load_clamped(plane, *c11)
    wx = pixx - fx
    wy = pixy - fy
    ac = a * (1.0 - wx) + c * wx
    bd = b * (1.0 - wx) + d * wx
    return ac * (1.0 - wy) + bd * wy
