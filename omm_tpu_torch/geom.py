"""Triangle/UV geometry helpers, vectorized fp32.

The port's copy of `omm_tpu/geom.py`.  Mirrors the reference's
`src/util/geometry.h` semantics exactly (fp32 op order matters for bake
parity); array-oriented so it vectorizes over batches of triangles.
"""
from __future__ import annotations

import numpy as np

from .types import TexCoordFormat


def fetch_uvs(tex_coords, tex_coord_format: TexCoordFormat,
              stride_in_bytes: int, indices: np.ndarray) -> np.ndarray:
    """FetchUV for a flat array of vertex indices (geometry.h:191-208).

    tex_coords: raw bytes (uint8 array) or float32 (V,2) array.
    Returns (len(indices), 2) float32.
    """
    indices = np.asarray(indices, dtype=np.int64)
    if tex_coord_format == TexCoordFormat.UV32_FLOAT:
        if tex_coords.dtype == np.float32 and tex_coords.ndim == 2:
            default_stride = 8
            if stride_in_bytes in (0, default_stride):
                return tex_coords[indices].astype(np.float32)
            raw = tex_coords.reshape(-1).view(np.uint8)
        else:
            raw = np.ascontiguousarray(tex_coords).view(np.uint8).reshape(-1)
        stride = stride_in_bytes if stride_in_bytes else 8
        offs = indices * stride
        out = np.empty((len(indices), 2), dtype=np.float32)
        b = np.stack([raw[offs + k] for k in range(8)], axis=-1)
        out[:, 0] = b[:, 0:4].copy().view(np.float32).reshape(-1)
        out[:, 1] = b[:, 4:8].copy().view(np.float32).reshape(-1)
        return out

    # 16-bit formats: one packed u32 per vertex.
    raw = np.ascontiguousarray(tex_coords).view(np.uint8).reshape(-1)
    stride = stride_in_bytes if stride_in_bytes else 4
    offs = indices * stride
    b = np.stack([raw[offs + k] for k in range(4)], axis=-1)
    packed = b.copy().view(np.uint32).reshape(-1)
    lo = (packed & np.uint32(0xFFFF)).astype(np.uint16)
    hi = (packed >> np.uint32(16)).astype(np.uint16)
    if tex_coord_format == TexCoordFormat.UV16_UNORM:
        # glm::unpackUnorm2x16: v / 65535
        u = lo.astype(np.float32) / np.float32(65535.0)
        v = hi.astype(np.float32) / np.float32(65535.0)
    else:  # UV16_FLOAT
        u = lo.view(np.float16).astype(np.float32)
        v = hi.view(np.float16).astype(np.float32)
    return np.stack([u, v], axis=-1)


def triangles_from_indices(index_buffer: np.ndarray, tex_coords,
                           tex_coord_format: TexCoordFormat,
                           stride_in_bytes: int) -> np.ndarray:
    """Fetch all UV triangles: returns (T, 3, 2) float32 (geometry.h:210-217)."""
    idx = np.asarray(index_buffer).astype(np.int64).reshape(-1, 3)
    flat = fetch_uvs(tex_coords, tex_coord_format, stride_in_bytes,
                     idx.reshape(-1))
    return flat.reshape(-1, 3, 2)


def is_invalid(tri: np.ndarray) -> np.ndarray:
    """NaN/Inf in any vertex (geometry.h:37-42). tri: (..., 3, 2)."""
    return ~np.isfinite(tri).all(axis=(-1, -2))


def is_degenerate(tri: np.ndarray) -> np.ndarray:
    """Area test in fp32 against 1e-9 (geometry.h:44-47)."""
    t = np.asarray(tri, dtype=np.float32)
    p0x, p0y = t[..., 0, 0], t[..., 0, 1]
    p1x, p1y = t[..., 1, 0], t[..., 1, 1]
    p2x, p2y = t[..., 2, 0], t[..., 2, 1]
    area = np.float32(0.5) * np.abs(
        p0x * (p1y - p2y) + p1x * (p2y - p0y) + p2x * (p0y - p1y))
    return area.astype(np.float64) < 1e-9


def winding_stable(tri, subdiv: int) -> np.ndarray:
    """True when every micro-triangle's winding test (is_ccw on the
    fp32-interpolated corners, as the oracle computes it per
    micro-triangle) provably agrees with the macro triangle's winding.

    Derivation: the true micro cross is cross_macro * 4^-subdiv; each
    fp32 corner coordinate carries <= ~4 ulp of |coord| interpolation
    error (3 products + 2 adds), perturbing the float64 cross of the
    rounded corners by <= 4 * L_micro * e with L_micro = L * 2^-subdiv
    and e = 4 * 2^-23 * Cmax.  The sign is stable when
    |cross_macro| * 4^-subdiv > SAFETY * 4 * L * 2^-subdiv * e, i.e.
    |cross_macro| > SAFETY * 16 * 2^-23 * L * Cmax * 2^subdiv (SAFETY=4).
    Thin slivers failing this bound must take an oracle-order path
    (per-micro-triangle is_ccw) instead of a macro-winding shortcut.
    tri: (..., 3, 2); returns bool array."""
    t = np.asarray(tri, dtype=np.float32).astype(np.float64)
    ax = t[..., 2, 0] - t[..., 0, 0]
    ay = t[..., 2, 1] - t[..., 0, 1]
    bx = t[..., 1, 0] - t[..., 0, 0]
    by = t[..., 1, 1] - t[..., 0, 1]
    cz = np.abs(ax * by - ay * bx)
    e0 = np.hypot(bx, by)
    e1 = np.hypot(ax, ay)
    e2 = np.hypot(ax - bx, ay - by)
    L = np.maximum(np.maximum(e0, e1), e2)
    cmax = np.abs(t).max(axis=(-1, -2))
    thresh = (4.0 * 16.0 * 2.0 ** -23) * L * np.maximum(cmax, 1e-30) \
        * float(2 ** subdiv)
    return cz > thresh


def is_ccw(tri) -> np.ndarray:
    """Double-precision winding test (geometry.h:49-55). tri: (..., 3, 2).

    Nz = cross(p2-p0, p1-p0).z computed in float64; CCW iff Nz < 0.
    Works with numpy input (host-side only, needs float64).
    """
    t = np.asarray(tri, dtype=np.float32).astype(np.float64)
    ax = t[..., 2, 0] - t[..., 0, 0]
    ay = t[..., 2, 1] - t[..., 0, 1]
    bx = t[..., 1, 0] - t[..., 0, 0]
    by = t[..., 1, 1] - t[..., 0, 1]
    nz = ax * by - ay * bx
    return nz < 0


def tri_aabb(tri, xp=np):
    """Returns (aabb_s, aabb_e) each (..., 2) fp32 (geometry.h:73-74)."""
    t = xp.asarray(tri, dtype=xp.float32)
    return t.min(axis=-2), t.max(axis=-2)


def point_in_triangle(tri, pt, xp=np):
    """Exact port of Triangle::PointInTriangle (geometry.h:101-114,
    CACHED_POINT_IN_TRI form).  tri: (..., 3, 2); pt: (..., 2) broadcastable.
    Returns bool array."""
    t = xp.asarray(tri, dtype=xp.float32)
    p0 = t[..., 0, :]
    p1 = t[..., 1, :]
    p2 = t[..., 2, :]
    p0p2 = p0 - p2
    p1p0 = p1 - p0
    p2p1 = p2 - p1
    ptp2 = pt - p2
    ptp0 = pt - p0
    ptp1 = pt - p1
    s = p0p2[..., 0] * ptp2[..., 1] - p0p2[..., 1] * ptp2[..., 0]
    tt = p1p0[..., 0] * ptp0[..., 1] - p1p0[..., 1] * ptp0[..., 0]
    early_false = ((s < 0) != (tt < 0)) & (s != 0) & (tt != 0)
    d = p2p1[..., 0] * ptp1[..., 1] - p2p1[..., 1] * ptp1[..., 0]
    ok = (d == 0) | ((d < 0) == (s + tt <= 0))
    return xp.where(early_false, False, ok)


def uv_area(tri: np.ndarray) -> np.ndarray:
    """GetArea2D (geometry.h:141-145): 0.5*|cross(p2-p0, p1-p0)| in fp32."""
    t = np.asarray(tri, dtype=np.float32)
    v0x = t[..., 2, 0] - t[..., 0, 0]
    v0y = t[..., 2, 1] - t[..., 0, 1]
    v1x = t[..., 1, 0] - t[..., 0, 0]
    v1y = t[..., 1, 1] - t[..., 0, 1]
    cz = v0x * v1y - v0y * v1x
    # The reference computes 0.5 * length(cross(...)) = 0.5 * sqrt(cz*cz)
    # in fp32; keep the sqrt form for bit parity (it can differ from |cz|
    # by one ulp, and downstream uint casts are sensitive).
    return np.float32(0.5) * np.sqrt(cz * cz)
