"""Leaf cards on a foliage atlas, as `examples/vegetation_scene.py`
draws them: its `foliage_atlas` and its `quad_mesh`, with the sizes in a
traffic file's "params".

The atlas ("atlas"): `leaves` soft elliptic leaves with serrated edges
on a transparent background, the brightest leaf winning where two
overlap, leaf = clip(1.2 - r + serration * sin(lobes * atan2(dy, dx)),
0, 1) with r the leaf's elliptic radius.  The half-axes are given in
texels of a `reference_size` atlas and scaled with the texture's width,
so that a larger texture holds the same leaves at a higher resolution.
The leaves' parameters come from numpy's generator on the host; each
leaf is stamped in its own bounding box in a few large calls on the
device.  "textures" such planes are made, each from its own draw.

A bake's mesh ("mesh"): a number of quads uniform in `quads`, each a
UV rectangle split into two triangles as the example splits it, its
rectangle drawn from `uv_variants` variants of the bake (the example's
texture-coordinate instancing, which the bakers' duplicate detection
resolves): a variant's corner is uniform in `corner` and its sides in
`side`, in UV units.  UVs lie on a grid of `uv_grid` steps, so that
every corner is exact in fp32.

With a "library" in the mesh parameters, the bakes draw from a fixed
library of `library.meshes` such meshes, made from `library.seed` and
not from the run's seed: every run of that many bakes bakes each mesh of
the library once, in an order drawn from the run's seed.  So every seed
gives the same work, in another order, and a warm-up of one such run
meets every batch shape and window class of the timed bakes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ommbench.inputs import rng

#: elements of a stamping step, to bound its temporaries
STEP_ELEMENTS = 1 << 24
#: the stream of a library's meshes, drawn from the library's seed
LIBRARY = 3


def leaf_params(seed: int, k: int, size: int, atlas: dict) -> np.ndarray:
    """(leaves, 5) float64 of texture k: centre x, centre y (texels),
    angle, long and short half-axis (texels)."""
    n = int(atlas["leaves"])
    s = size / float(atlas["reference_size"])
    r = rng(seed, 0, k).random((n, 5))
    la0, la1 = atlas["long_axis"]
    lb0, lb1 = atlas["short_axis"]
    return np.stack([r[:, 0] * size, r[:, 1] * size, r[:, 2] * math.pi,
                     s * (la0 + r[:, 3] * (la1 - la0)),
                     s * (lb0 + r[:, 4] * (lb1 - lb0))], axis=1)


def foliage_atlas(seed: int, k: int, size: int, atlas: dict,
                  device) -> torch.Tensor:
    """(size, size) fp32 alpha plane of texture k on `device`."""
    p = leaf_params(seed, k, size, atlas)
    serr = float(atlas["serration"])
    lobes = float(atlas["lobes"])
    # where 1.2 - r + serr > 0 the leaf is seen: r < 1.2 + serr
    reach = math.ceil(math.sqrt(1.2 + serr) * float(p[:, 3].max(initial=0))) + 1
    off = torch.arange(-reach, reach + 1, device=device)
    step = max(1, STEP_ELEMENTS // len(off) ** 2)
    p = torch.from_numpy(p).to(device, torch.float32)
    plane = torch.zeros(size * size, dtype=torch.float32, device=device)
    for s in range(0, p.shape[0], step):
        q = p[s:s + step]
        cx, cy, ang, la, lb = (q[:, j, None, None] for j in range(5))
        xi = torch.floor(cx).to(torch.int64) + off[None, None, :]
        yi = torch.floor(cy).to(torch.int64) + off[None, :, None]
        xx = xi.to(torch.float32) - cx
        yy = yi.to(torch.float32) - cy
        cos, sin = torch.cos(ang), torch.sin(ang)
        dx = xx * cos + yy * sin
        dy = -xx * sin + yy * cos
        r = (dx / la) ** 2 + (dy / lb) ** 2
        leaf = torch.clamp(1.2 - r + serr * torch.sin(torch.atan2(dy, dx)
                                                       * lobes), 0.0, 1.0)
        inside = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size) \
            & (leaf > 0)
        idx = (yi * size + xi).expand_as(leaf)[inside]
        plane.scatter_reduce_(0, idx, leaf[inside], reduce="amax")
    return plane.reshape(size, size)


def quad_mesh(seed: int, stream: int, index: int, mesh: dict):
    """Bake `index` of a stream: (uvs (4n, 2) fp32, indices (6n,) uint32)
    of n quads, 4 vertices each, drawn from (seed, stream, index)."""
    r = rng(seed, stream, index)
    g = float(mesh["uv_grid"])
    q0, q1 = mesh["quads"]
    n = int(r.integers(q0, q1 + 1))
    v = int(mesh["uv_variants"])
    c0, c1 = mesh["corner"]
    s0, s1 = mesh["side"]
    u0, v0 = (np.floor((c0 + r.random((2, v)) * (c1 - c0)) * g) / g)
    du, dv = (np.round((s0 + r.random((2, v)) * (s1 - s0)) * g) / g)
    corners = np.stack([np.stack([u0, v0], 1), np.stack([u0, v0 + dv], 1),
                        np.stack([u0 + du, v0], 1),
                        np.stack([u0 + du, v0 + dv], 1)], 1)   # (v, 4, 2)
    pick = r.integers(0, v, n)
    uvs = corners[pick].reshape(-1, 2).astype(np.float32)
    base = 4 * np.arange(n, dtype=np.uint32)[:, None]
    indices = base + np.array([0, 1, 2, 3, 1, 2], np.uint32)[None, :]
    return uvs, indices.reshape(-1).astype(np.uint32)


def library_entry(seed: int, stream: int, i: int, meshes: int) -> int:
    """The library mesh that bake i of a stream bakes: bakes
    c * meshes ... (c + 1) * meshes - 1 bake every mesh once, in the order
    of a permutation drawn from (seed, stream, c)."""
    c, k = divmod(int(i), int(meshes))
    return int(rng(seed, stream, c).permutation(int(meshes))[k])


class LeafCards:
    """The generator's object (see `ommbench.generators`)."""

    def __init__(self, seed: int, config: dict, params: dict, device):
        tex = config["texture"]
        if tex["format"] != "FP32" or int(tex["mips"]) != 1 \
                or tex["width"] != tex["height"]:
            raise ValueError("leaf_cards draws one square FP32 mip")
        size = int(tex["width"])
        self.textures = [
            {"format": "FP32",
             "mips": [foliage_atlas(seed, k, size, params["atlas"], device)]}
            for k in range(int(params.get("textures", 1)))]
        self.per_bake_texture = bool(params.get("per_bake_texture", False))
        self.seed, self.mesh_params = seed, params["mesh"]

    def texture_of(self, stream: int, i: int) -> int:
        return i % len(self.textures)

    def mesh(self, stream: int, i: int):
        lib = self.mesh_params.get("library")
        if lib is None:
            return quad_mesh(self.seed, stream, i, self.mesh_params)
        j = library_entry(self.seed, stream, i, lib["meshes"])
        return quad_mesh(int(lib["seed"]), LIBRARY, j, self.mesh_params)


def make(seed: int, config: dict, params: dict, device) -> LeafCards:
    return LeafCards(seed, config, params, device)
