"""Subdivision level of each triangle, as the reference SDK picks it.

A copy of the reference CPU baker's heuristics (bake_cpu_impl.cpp:470-560,
GetSubdivisionLevel with ComputeAreaHeuristic and ComputeEdgeHeuristic),
vectorized over the triangles of a mesh in numpy fp32.  The GPU baker's
work setup uses the same area formula (omm_common.hlsli:180-195), so one
copy serves both.  The benchmark counts each bake's micro-triangles with
it, and the reference classifies each triangle at the level it gives.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


def _next_pow2_u32(v: np.ndarray) -> np.ndarray:
    """bit_tricks.h NextPow2 on uint32, wrapping as the C++ does (0 and
    anything above 2^31 give 0)."""
    v = v.astype(np.uint64) & np.uint64(M32)
    v = (v - np.uint64(1)) & np.uint64(M32)
    for s in (1, 2, 4, 8, 16):
        v |= v >> np.uint64(s)
    return (v + np.uint64(1)) & np.uint64(M32)


def _log2_u32(v: np.ndarray) -> np.ndarray:
    """floor(log2(v)) for v > 0, 0 for v == 0."""
    out = np.zeros(v.shape, np.int64)
    nz = v > 0
    out[nz] = np.floor(np.log2(v[nz].astype(np.float64))).astype(np.int64)
    return out


def _area_px(tris: np.ndarray, size) -> np.ndarray:
    """GetArea2D of the triangles scaled to texels, fp32."""
    s = tris.astype(np.float32) * np.array(size, np.float32)
    v0x = s[:, 2, 0] - s[:, 0, 0]
    v0y = s[:, 2, 1] - s[:, 0, 1]
    v1x = s[:, 1, 0] - s[:, 0, 0]
    v1y = s[:, 1, 1] - s[:, 0, 1]
    cz = v0x * v1y - v0y * v1x
    return np.float32(0.5) * np.sqrt(cz * cz)


def area_levels(tris: np.ndarray, size, scale: float,
                max_level: int) -> np.ndarray:
    """ComputeAreaHeuristic (bake_cpu_impl.cpp:470-509) per triangle."""
    target = np.float32(scale) * np.float32(scale)
    with np.errstate(all="ignore"):
        ratio_f = _area_px(tris, size) / target
    ok = np.isfinite(ratio_f) & (ratio_f >= 0)
    # uint32(ratio) as the port's copy takes it: the integer part, modulo
    # 2^32 (exact in float64 for every fp32 value)
    r = np.where(ok, np.fmod(np.floor(ratio_f.astype(np.float64)), 2.0 ** 32),
                 0.0).astype(np.uint64)
    level = _log2_u32(_next_pow2_u32(r)) >> 1
    return np.minimum(level, max_level)


def edge_levels(tris: np.ndarray, size, scale: float,
                max_level: int) -> np.ndarray:
    """ComputeEdgeHeuristic (bake_cpu_impl.cpp:511-528) per triangle."""
    sz = np.array(size, np.float32)
    t = tris.astype(np.float32)
    edges = [sz * (t[:, 1] - t[:, 0]), sz * (t[:, 2] - t[:, 0]),
             sz * (t[:, 2] - t[:, 1])]
    # glm::dot as the port's copy takes it, one row at a time
    le = np.array([[np.float32(np.dot(e[i], e[i])) for i in range(len(t))]
                   for e in edges], np.float32).reshape(3, len(t))
    e_max = le.max(axis=0)
    with np.errstate(all="ignore"):
        n = (np.log2(e_max) / np.float32(2.0)
             - np.log2(np.float32(scale))).astype(np.float64)
    n = np.where(e_max.astype(np.float64) < 1e-6, 0.0, n)
    with np.errstate(invalid="ignore"):
        return np.clip(np.ceil(n), 0, max_level).astype(np.int64)


def degenerate(tris: np.ndarray) -> np.ndarray:
    """IsDegenerate (geometry.h:44-47): fp32 area under 1e-9."""
    t = tris.astype(np.float32)
    p0x, p0y = t[:, 0, 0], t[:, 0, 1]
    p1x, p1y = t[:, 1, 0], t[:, 1, 1]
    p2x, p2y = t[:, 2, 0], t[:, 2, 1]
    area = np.float32(0.5) * np.abs(
        p0x * (p1y - p2y) + p1x * (p2y - p0y) + p2x * (p0y - p1y))
    return area.astype(np.float64) < 1e-9


def levels(tris: np.ndarray, size, scale: float, max_level: int,
           edge_heuristic: bool = False) -> np.ndarray:
    """GetSubdivisionLevel (bake_cpu_impl.cpp:542-560) without per-triangle
    level overrides: the area heuristic, or the edge heuristic for a
    degenerate triangle or where asked; max_level when scale is 0."""
    tris = np.asarray(tris, np.float32).reshape(-1, 3, 2)
    if not scale > 0:
        return np.full(len(tris), max_level, np.int64)
    out = area_levels(tris, size, scale, max_level)
    use_edge = degenerate(tris) | bool(edge_heuristic)
    if use_edge.any():
        out = np.where(use_edge, edge_levels(tris, size, scale, max_level),
                       out)
    return out


def micro_triangles(tris: np.ndarray, size, scale: float,
                    max_level: int) -> int:
    """Micro-triangles a bake of these triangles requests: the sum of
    4^level over the triangles that are finite."""
    tris = np.asarray(tris, np.float32).reshape(-1, 3, 2)
    lv = levels(tris, size, scale, max_level)
    fin = np.isfinite(tris).all(axis=(1, 2))
    return int((np.left_shift(np.int64(1), 2 * lv[fin])).sum())
