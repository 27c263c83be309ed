"""Bird-curve micro-triangle indexing in torch.

Counterparts of `omm_tpu.bird.index2dbary` and of
`pallas_classify.bary_cols` / `corner_cols`.  torch has no usable
uint32 arithmetic, so the curve's 32-bit logic runs in int64 with
explicit 32-bit masks (`~x` becomes `x ^ 0xFFFFFFFF`); every value stays
in [0, 2^32), where int64 bit operations equal uint32 ones.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _not32(x):
    return x ^ _M32


def extract_even_bits(x):
    """bird.h:36-44."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def prefix_eor(x):
    """Exclusive prefix XOR (bird.h:47-54)."""
    x = x ^ (x >> 1)
    x = x ^ (x >> 2)
    x = x ^ (x >> 4)
    x = x ^ (x >> 8)
    return x


def index2dbary(index):
    """Curve index -> discrete barycentrics (u, v, w) (bird.h:57-70).
    index: integer tensor of values in [0, 2^32); returns int64."""
    index = index.to(torch.int64) & _M32
    b0 = extract_even_bits(index)
    b1 = extract_even_bits(index >> 1)
    fx = prefix_eor(b0)
    fy = prefix_eor(b0 & _not32(b1))
    t = fy ^ b1
    nt = _not32(t)
    nb0 = _not32(b0)
    u = (fx & nt) | (b0 & nt) | (nb0 & _not32(fx) & t)
    v = fy ^ b0
    w = (_not32(fx) & nt) | (b0 & nt) | (nb0 & fx & t)
    return u, v, w


def bary_cols(index, level: int):
    """index2bary (bird.h:73-118) in column form: (u, v, d) fp32, so the
    corners are (u, v), (u+d, v), (u, v+d)."""
    iu, iv, iw = index2dbary(index)
    mask = (1 << level) - 1
    iu = iu & mask
    iv = iv & mask
    iw = iw & mask
    upright = ((iu & 1) ^ (iv & 1) ^ (iw & 1)) != 0
    iu = torch.where(upright, iu, iu + 1)
    iv = torch.where(upright, iv, iv + 1)
    ls = float(np.float32(2.0) ** np.float32(-level))
    d = torch.where(upright, ls, -ls).to(torch.float32)
    fu = iu.to(torch.float32)
    fv = iv.to(torch.float32)
    return fu * ls, fv * ls, d


def tri6_of(uv_flat, t):
    """The six UV columns (p0x, p0y, p1x, p1y, p2x, p2y) of items t;
    uv_flat: (T, 6) fp32."""
    u = uv_flat[t]
    return tuple(u[:, k] for k in range(6))


def corner_cols(tri6, bu, bv, bd):
    """InterpolateTriangleUV in column form (geometry.h:241-248):
    p = p0*(1-u-v) + p1*u + p2*v for the three subtriangle corners, in
    the operation order of `pallas_classify.corner_cols`.
    tri6: 6 fp32 columns (p0x, p0y, p1x, p1y, p2x, p2y)."""
    p0x, p0y, p1x, p1y, p2x, p2y = tri6

    def corner(u_, v_):
        w_ = 1.0 - u_ - v_
        return (p0x * w_ + p1x * u_ + p2x * v_,
                p0y * w_ + p1y * u_ + p2y * v_)

    ax, ay = corner(bu, bv)
    bx, by = corner(bu + bd, bv)
    cx, cy = corner(bu, bv + bd)
    return (ax, ay), (bx, by), (cx, cy)
