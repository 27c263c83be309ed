"""Static tessellated-triangle resources in bird-curve order.

The port's copy of `omm_tpu/gpu/static_data.py`.  Analog of
ommGpuGetStaticResourceData (bake_gpu_impl.cpp:90-234): per subdivision
level 0..9 a row-linear vertex buffer of packed (j<<16 | i) discrete
barycentrics and an index buffer whose primitives are shuffled into
bird-curve order.  Clients use these to tessellate macro triangles —
here also handy for visualization and renderer integration.
"""
from __future__ import annotations

import numpy as np

from .. import bird

MAX_STATIC_SUBDIV = 9  # HW-raster path limit (bake_gpu_impl.cpp:98)


def static_vertex_buffer(level: int) -> np.ndarray:
    """Packed (j << 16 | i) vertices, row-linear; (N+1)(N+2)/2 entries."""
    n = 1 << level
    out = []
    for j in range(n + 1):
        for i in range(j + 1):
            out.append((j << 16) | i)
    return np.asarray(out, dtype=np.uint32)


def static_index_buffer(level: int) -> np.ndarray:
    """Tessellated-triangle topology, primitives in bird-curve order,
    vertices row-linear (bake_gpu_impl.cpp:108-163).  The original's
    loop over (row j, primitive i of the row) runs here over all
    primitives at once; the bird curve is a bijection, so no two
    primitives write the same slot."""
    n = 1 << level
    j = np.repeat(np.arange(n, dtype=np.int64),
                  2 * np.arange(n, dtype=np.int64) + 1)
    i = np.arange(j.size, dtype=np.int64) - j * j  # row j starts at j^2
    u = i // 2
    v = n - 1 - j
    w = (n - 1 - u - v) - (i % 2)
    oc = bird.dbary2index(u.astype(np.uint32), v.astype(np.uint32),
                          w.astype(np.uint32), level).astype(np.int64)

    def vert_idx(x, y):
        return x + (y * (y + 1)) // 2

    x, y = i // 2, j
    even = i % 2 == 0
    tri = np.stack([vert_idx(x, y),
                    np.where(even, vert_idx(x + 1, y + 1), vert_idx(x + 1, y)),
                    np.where(even, vert_idx(x, y + 1),
                             vert_idx(x + 1, y + 1))], axis=1)
    out = np.zeros((4 ** level, 3), dtype=np.uint32)
    out[oc] = tri
    return out.reshape(-1)


def get_static_resource_data(resource: str) -> dict:
    """All levels concatenated with per-level offsets, mirroring the
    reference's single-blob layout."""
    if resource == "STATIC_VERTEX_BUFFER":
        bufs = [static_vertex_buffer(l) for l in range(MAX_STATIC_SUBDIV + 1)]
    elif resource == "STATIC_INDEX_BUFFER":
        bufs = [static_index_buffer(l) for l in range(MAX_STATIC_SUBDIV + 1)]
    else:
        raise ValueError(f"unknown static resource {resource}")
    offsets = np.cumsum([0] + [b.nbytes for b in bufs])
    return {"data": np.concatenate(bufs),
            "offsets": offsets[:-1].tolist(),
            "size": int(offsets[-1])}
