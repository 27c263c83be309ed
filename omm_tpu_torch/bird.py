"""Bird-curve micro-triangle indexing, vectorized in numpy.

The port's copy of the numpy functions of `omm_tpu/bird.py`.  The bird
curve is the space-filling order the DX/VK opacity-micromap spec uses to
lay out the 4^N micro-triangles of a subdivided triangle.  Semantics
mirror the reference's `src/util/bird.h` (which in turn derives from the
OptiX/DMM SDKs); the implementation is branch-free uint32 bit math over
whole index arrays.  The original's jax paths (its `fz` contraction
fence and `.at` updates) are not carried over; the torch column forms
the device stages use are in `bird_torch`.

  index2dbary   bird.h:57-70
  index2bary    bird.h:73-118
  dbary2index   bird.h:145-156
  bary2index    bird.h:159-167
  micro-triangle corner interpolation  bird.h:170-182
"""
from __future__ import annotations

import numpy as np


def _u32(xp, v):
    return xp.asarray(v, dtype=xp.uint32)


def extract_even_bits(xp, x):
    """bird.h:36-44."""
    x = x & _u32(xp, 0x55555555)
    x = (x | (x >> _u32(xp, 1))) & _u32(xp, 0x33333333)
    x = (x | (x >> _u32(xp, 2))) & _u32(xp, 0x0F0F0F0F)
    x = (x | (x >> _u32(xp, 4))) & _u32(xp, 0x00FF00FF)
    x = (x | (x >> _u32(xp, 8))) & _u32(xp, 0x0000FFFF)
    return x


def prefix_eor(xp, x):
    """Exclusive prefix XOR (bird.h:47-54)."""
    x = x ^ (x >> _u32(xp, 1))
    x = x ^ (x >> _u32(xp, 2))
    x = x ^ (x >> _u32(xp, 4))
    x = x ^ (x >> _u32(xp, 8))
    return x


def index2dbary(index, xp=np):
    """Curve index -> discrete barycentrics (u, v, w) (bird.h:57-70)."""
    index = _u32(xp, index)
    b0 = extract_even_bits(xp, index)
    b1 = extract_even_bits(xp, index >> _u32(xp, 1))
    fx = prefix_eor(xp, b0)
    fy = prefix_eor(xp, b0 & ~b1)
    t = fy ^ b1
    u = (fx & ~t) | (b0 & ~t) | (~b0 & ~fx & t)
    v = fy ^ b0
    w = (~fx & ~t) | (b0 & ~t) | (~b0 & fx & t)
    return u, v, w


def index2bary(index, subdivision_level: int, xp=np):
    """Curve index -> barycentric corner coordinates of the micro-triangle.

    Returns (uv0, uv1, uv2), each an array shaped like `index` + (2,), in the
    barycentric (u, v) frame of the macro triangle (bird.h:73-118).
    `subdivision_level` must be a static python int.
    """
    index = _u32(xp, index)
    if subdivision_level == 0:
        shp = index.shape + (2,)
        uv0 = xp.zeros(shp, dtype=xp.float32)
        uv1 = _const_uv(xp, shp, 1.0, 0.0)
        uv2 = _const_uv(xp, shp, 0.0, 1.0)
        return uv0, uv1, uv2

    iu, iv, iw = index2dbary(index, xp)
    mask = _u32(xp, (1 << subdivision_level) - 1)
    iu = iu & mask
    iv = iv & mask
    iw = iw & mask

    upright = ((iu & 1) ^ (iv & 1) ^ (iw & 1)).astype(xp.bool_)
    one = _u32(xp, 1)
    iu = xp.where(upright, iu, iu + one)
    iv = xp.where(upright, iv, iv + one)

    # levelScale = 2^-subdivisionLevel constructed via exponent bits
    # (bird.h:98-99); exact in fp32.
    level_scale = xp.float32(np.float32(2.0) ** np.float32(-subdivision_level))
    d = xp.where(upright, level_scale, -level_scale).astype(xp.float32)
    u = iu.astype(xp.float32) * level_scale
    v = iv.astype(xp.float32) * level_scale

    uv0 = xp.stack([u, v], axis=-1)
    uv1 = xp.stack([u + d, v], axis=-1)
    uv2 = xp.stack([u, v + d], axis=-1)
    return uv0, uv1, uv2


def _const_uv(xp, shp, x, y):
    a = np.zeros(shp, dtype=np.float32)
    a[..., 0] = x
    a[..., 1] = y
    return a


def prefix_eor2(xp, x):
    """Two 16-bit prefix XORs in one u32 (bird.h:123-130)."""
    x = x ^ ((x >> _u32(xp, 1)) & _u32(xp, 0x7FFF7FFF))
    x = x ^ ((x >> _u32(xp, 2)) & _u32(xp, 0x3FFF3FFF))
    x = x ^ ((x >> _u32(xp, 4)) & _u32(xp, 0x0FFF0FFF))
    x = x ^ ((x >> _u32(xp, 8)) & _u32(xp, 0x00FF00FF))
    return x


def interleave_bits2(xp, x, y):
    """Interleave 16 even bits of x with 16 odd bits of y (bird.h:133-142)."""
    x = (x & _u32(xp, 0xFFFF)) | (y << _u32(xp, 16))
    x = ((x >> _u32(xp, 8)) & _u32(xp, 0x0000FF00)) | ((x << _u32(xp, 8)) & _u32(xp, 0x00FF0000)) | (x & _u32(xp, 0xFF0000FF))
    x = ((x >> _u32(xp, 4)) & _u32(xp, 0x00F000F0)) | ((x << _u32(xp, 4)) & _u32(xp, 0x0F000F00)) | (x & _u32(xp, 0xF00FF00F))
    x = ((x >> _u32(xp, 2)) & _u32(xp, 0x0C0C0C0C)) | ((x << _u32(xp, 2)) & _u32(xp, 0x30303030)) | (x & _u32(xp, 0xC3C3C3C3))
    x = ((x >> _u32(xp, 1)) & _u32(xp, 0x22222222)) | ((x << _u32(xp, 1)) & _u32(xp, 0x44444444)) | (x & _u32(xp, 0x99999999))
    return x


def dbary2index(u, v, w, level: int, xp=np):
    """Discrete barycentrics -> curve index (bird.h:145-156)."""
    u = _u32(xp, u)
    v = _u32(xp, v)
    w = _u32(xp, w)
    coord_mask = _u32(xp, (1 << level) - 1)
    b0 = ~(u ^ w) & coord_mask
    t = (u ^ v) & b0
    c = (((u & v & w) | (~u & ~v & ~w)) & coord_mask) << _u32(xp, 16)
    f = prefix_eor2(xp, t | c) ^ u
    b1 = (f & ~b0) | t
    return interleave_bits2(xp, b0, b1)


def micro_triangle_uvs(uv_tri, index, subdivision_level: int, xp=np):
    """Corner UVs of micro-triangles in texture-UV space (bird.h:170-182).

    uv_tri: (..., 3, 2) float32 macro-triangle UVs.
    index:  integer array of curve indices (broadcast against uv_tri batch).
    Returns (..., N, 3, 2) float32 (N = index count).

    Interpolation matches InterpolateTriangleUV with InitBarycentrics
    (geometry.h:241-248): p = p0*(1-u-v) + p1*u + p2*v.
    """
    uv0, uv1, uv2 = index2bary(index, subdivision_level, xp)  # (N, 2) each
    p0 = xp.asarray(uv_tri[..., 0, :], dtype=xp.float32)
    p1 = xp.asarray(uv_tri[..., 1, :], dtype=xp.float32)
    p2 = xp.asarray(uv_tri[..., 2, :], dtype=xp.float32)

    def interp(buv):
        u = buv[..., 0:1]
        v = buv[..., 1:2]
        w = xp.float32(1.0) - u - v
        # separately-rounded products (numpy never contracts to an FMA)
        return p0 * w + p1 * u + p2 * v

    return xp.stack([interp(uv0), interp(uv1), interp(uv2)], axis=-2)
