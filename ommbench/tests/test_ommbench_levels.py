"""The benchmark's copy of the level heuristic gives the reference SDK's
levels (the port's copy of bake_cpu_impl.cpp:470-560) on edge cases."""
import importlib

import numpy as np
import pytest

from ommbench.reference import levels

# the module (the package's `bake` is the function)
port = importlib.import_module("omm_tpu_torch.bake")


def _port_levels(tris, size, scale, max_level):
    import omm_tpu_torch as ot
    desc = ot.BakeInputDesc(dynamic_subdivision_scale=scale,
                            max_subdivision_level=max_level)
    opts = port.Options()
    return np.array([port.get_subdivision_level(desc, opts, i, t, size)
                     for i, t in enumerate(tris)])


def _right(w, h, x=0.1, y=0.2):
    return np.array([[x, y], [x, y + h], [x + w, y]], np.float32)


def _edge_cases(size):
    sx, sy = size
    tris = []
    # areas at and around each power of 4 of the target (scale 2: 4 px)
    for k in range(0, 16):
        area = 4.0 * 4 ** k
        for f in (1 - 1e-6, 1.0, 1 + 1e-6, 2.0):
            side = np.sqrt(2 * area * f)
            tris.append(_right(side / sx, side / sy, 0.0, 0.0))
    tris += [
        _right(0.0, 0.0),                       # a point
        np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3]], np.float32),  # line
        _right(1e-7, 0.5),                      # a sliver
        _right(1.0, 1.0, 0.0, 0.0),             # the whole texture
        _right(300.0, 300.0, -100.0, -100.0),   # far outside, huge area
        _right(3e4, 3e4, 0.0, 0.0),             # ratio above 2^31
        np.array([[np.nan, 0.1], [0.2, 0.2], [0.3, 0.1]], np.float32),
        np.array([[np.inf, 0.1], [0.2, 0.2], [0.3, 0.1]], np.float32),
        _right(-0.2, 0.3),                      # clockwise
    ]
    rng = np.random.default_rng(5)
    tris += list(rng.random((64, 3, 2)).astype(np.float32))
    return np.stack(tris).astype(np.float32)


@pytest.mark.parametrize("size", [(4096, 4096), (1024, 256), (3, 5)])
@pytest.mark.parametrize("scale,max_level", [(2.0, 8), (2.0, 12), (0.5, 5),
                                             (7.3, 12), (0.0, 6)])
def test_levels_match_the_sdk(size, scale, max_level):
    tris = _edge_cases(size)
    want = _port_levels(tris, size, scale, max_level)
    got = levels.levels(tris, size, scale, max_level)
    assert got.tolist() == want.tolist()


def test_micro_triangles_counts_finite_triangles():
    tris = _edge_cases((256, 256))
    lv = levels.levels(tris, (256, 256), 2.0, 8)
    fin = np.isfinite(tris).all(axis=(1, 2))
    assert levels.micro_triangles(tris, (256, 256), 2.0, 8) == \
        int(sum(4 ** int(v) for v in lv[fin]))
