"""What the harness knows of a cell's inputs, whatever generator makes
them: the streams of bakes drawn from one seed, the seeded generator of
numpy, the triangles of an index buffer and the distinct ones among
them, and a texture's texels as the reference reads them.

A traffic file names its generator (`ommbench/generators/<name>.py`);
see `ommbench/generators/__init__.py` for what a generator gives.
"""
from __future__ import annotations

import numpy as np
import torch

#: streams of meshes drawn from one seed
WARMUP, TIMED = 1, 2


def rng(seed: int, *words: int) -> np.random.Generator:
    """numpy's generator for (seed, words): any whole seed, also one past
    64 bits, which is taken modulo 2^64."""
    return np.random.default_rng([int(seed) % (1 << 64), *words])


def triangles(uvs: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(T, 3, 2) fp32 UV triangles of an index buffer."""
    return uvs[indices.astype(np.int64)].reshape(-1, 3, 2)


def distinct(tris: np.ndarray) -> np.ndarray:
    """The triangles whose UVs first appear, in order: the bakers'
    duplicate detection gives the others the same result, so they ask
    for no micro-triangle of their own."""
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 3, 2)
    seen, keep = set(), []
    for t in range(len(tris)):
        key = tris[t].tobytes()
        if key not in seen:
            seen.add(key)
            keep.append(t)
    return tris[np.asarray(keep, np.int64)]


def decoded(texture: dict) -> list:
    """A generator's texture ({"format", "mips"}) as fp32 planes on the
    device that holds them: UNORM8 texels read as v / 255."""
    fmt = texture["format"]
    if fmt == "FP32":
        return [m.to(torch.float32) for m in texture["mips"]]
    if fmt == "UNORM8":
        return [m.to(torch.float32) / 255.0 for m in texture["mips"]]
    raise ValueError(f"no decoding of texture format {fmt}")
