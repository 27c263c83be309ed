"""Every triangle's subdivision level in one array pass
(`bake.subdivision_levels`) against the JAX package's per-triangle
heuristic (`omm_tpu.bake.get_subdivision_level`), triangle by triangle:
areas at and one ulp either side of each power of 4 of the target and
ratios past 2^31, 2^32 and 2^63; points, lines, slivers, clockwise
triangles and triangles far outside [0, 1]; NaN and Inf vertices;
EnableEdgeHeuristic; per-triangle overrides; random triangles and a
leaf-card mesh; at four scales, four maximum levels and three texture
sizes.  The port's one-triangle `get_subdivision_level` gives the same
ints, and `setup_work_items` the JAX package's work items.  A CPU bake
with a NaN triangle under EnableEdgeHeuristic runs to its end."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402

# the packages export a bake() function under the modules' name
jbake = importlib.import_module("omm_tpu.bake")
tbake = importlib.import_module("omm_tpu_torch.bake")

SIZES = [(4096, 4096), (1024, 256), (3, 5)]
SCALES = [0.0, 0.5, 2.0, 7.3]
MAX_LEVELS = [0, 5, 8, 12]
F32 = np.float32


class _SizedTexture:
    """All that setup_work_items reads of a texture: its size."""

    def __init__(self, size):
        self._size = tuple(size)

    def size(self, mip):
        return self._size


def _right(u, v, x=0.0, y=0.0):
    return np.array([[x, y], [x, y + v], [x + u, y]], F32)


def _ulps(v):
    """v and the fp32 values one ulp either side of it."""
    v = F32(v)
    return [v, np.nextafter(v, F32(np.inf)), np.nextafter(v, F32(0))]


def _ratios(size, scale):
    """Right triangles whose pixel area is the target (scale^2) times a
    power of 4 and one ulp either side (exactly so where the size and
    the target are powers of two); the same about twice a power of 4
    and one more, where the level steps; then ratios past 2^31, 2^32
    and 2^63, and vertices at the fp32 maximum."""
    sx, sy = size
    target = max(scale, 0.5) ** 2
    steps = [r for k in range(17) for r in (4.0 ** k, 2.0 * 4.0 ** k,
                                            2.0 * 4.0 ** k + 1.0)]
    out = []
    for ratio in steps + [2.0 ** 31, 2.0 ** 32, 2.0 ** 63]:
        twice = 2.0 * ratio * target
        a = 2.0 ** np.ceil(np.log2(np.sqrt(twice)))
        for v in _ulps((twice / a) / sy):
            out.append(_right(F32(a / sx), v))
    big = np.finfo(F32).max
    out.append(np.array([[0, 0], [0, big], [big, 0]], F32))
    out.append(np.array([[-big, -big], [-big, big], [big, -big]], F32))
    return out


def _shapes(size, scale):
    """Points, collinear lines, slivers on either side of the degenerate
    test, clockwise triangles, triangles far outside [0, 1], and lines
    whose squared pixel length is the target times a power of 4 and one
    ulp either side (the edge heuristic's boundaries)."""
    sx = size[0]
    out = [
        _right(0.0, 0.0, 0.3, 0.3),
        np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3]], F32),
        np.array([[0.0, 0.5], [1.0, 0.5], [0.25, 0.5]], F32),
        _right(1e-9, 0.5, 0.2, 0.1),
        _right(1e-7, 0.5, 0.2, 0.1),
        _right(0.5, 1e-8),
        _right(-0.2, 0.3, 0.5, 0.1),
        _right(0.3, -0.4, 0.2, 0.6),
        _right(0.25, 0.25, 1000.0, -500.0),
        _right(300.0, 300.0, -100.0, -100.0),
        np.array([[-50.0, 7.0], [120.0, 7.0], [35.0, 7.0]], F32),
    ]
    for k in range(9):
        for u in _ulps(max(scale, 0.5) * 2.0 ** k / sx):
            out.append(np.array([[0, 0.4], [u, 0.4], [u, 0.4]], F32))
    return out


def _non_finite():
    nan, inf = F32(np.nan), F32(np.inf)
    tris = []
    for v in range(3):
        for c in range(2):
            for bad in (nan, inf, -inf):
                t = _right(0.3, 0.2, 0.1, 0.1)
                t[v, c] = bad
                tris.append(t)
    tris.append(np.full((3, 2), nan, F32))
    tris.append(np.full((3, 2), inf, F32))
    return tris


def _random(n=64, seed=7):
    return list(np.random.default_rng(seed).random((n, 3, 2)).astype(F32))


def _leaf_cards(n_quads=100, n_variants=6, seed=11):
    """A mesh of leaf-card quads over a few UV rectangles (corner in
    0-0.5, sides 0.2-0.5), as a plant's cards share them."""
    rng = np.random.RandomState(seed)
    variants = []
    for _ in range(n_variants):
        u0, v0 = rng.rand(2) * 0.5
        du, dv = 0.2 + rng.rand(2) * 0.3
        q = np.array([[u0, v0], [u0, v0 + dv], [u0 + du, v0],
                      [u0 + du, v0 + dv]], F32)
        variants.append(q)
    tris = []
    for _ in range(n_quads):
        q = variants[rng.randint(n_variants)]
        tris += [q[[0, 1, 2]], q[[3, 1, 2]]]
    return tris


#: case -> (size, scale) -> (triangles, per-triangle overrides, bake flags)
CASES = {
    "ratios": lambda size, scale: (_ratios(size, scale), None, 0),
    "shapes": lambda size, scale: (_shapes(size, scale), None, 0),
    "non_finite": lambda size, scale: (_non_finite(), None, 0),
    "edge_heuristic": lambda size, scale: (
        _shapes(size, scale) + _random(16) + _ratios(size, scale)[:30], None,
        int(omm.BakeFlags.EnableEdgeHeuristic)),
    "overrides": lambda size, scale: (
        _random(48, seed=3), np.arange(48, dtype=np.uint8) % 16, 0),
    "random": lambda size, scale: (_random(), None, 0),
    "leaf_cards": lambda size, scale: (_leaf_cards(), None, 0),
    "empty": lambda size, scale: ([], None, 0),
}


def _desc(pkg, tris, size, scale, max_level, overrides, flags):
    n = len(tris)
    tc = (np.concatenate(tris) if n else np.zeros((0, 2), F32))
    return pkg.BakeInputDesc(
        texture=_SizedTexture(size), tex_coords=tc.reshape(-1, 2),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        max_subdivision_level=max_level, dynamic_subdivision_scale=scale,
        subdivision_levels=overrides, bake_flags=flags)


def _item_rows(items):
    return [(type(it.subdivision_level), it.subdivision_level,
             int(it.vm_format), it.uv_tri.tobytes(),
             list(it.primitive_indices)) for it in items]


@pytest.mark.parametrize("max_level", MAX_LEVELS)
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("case", sorted(CASES))
def test_levels_equal_the_per_triangle_heuristic(case, size, scale,
                                                 max_level):
    tris, overrides, flags = CASES[case](size, scale)
    jdesc = _desc(omm, tris, size, scale, max_level, overrides, flags)
    tdesc = _desc(ot, tris, size, scale, max_level, overrides, flags)
    jopts = jbake.Options.from_flags(flags)
    topts = tbake.Options.from_flags(flags)
    arr = (np.stack(tris) if tris else np.zeros((0, 3, 2), F32))
    with np.errstate(all="ignore"):
        want = [jbake.get_subdivision_level(jdesc, jopts, i, t, size)
                for i, t in enumerate(arr)]
    got = tbake.subdivision_levels(tdesc, topts, arr, size)
    assert got.dtype == np.int64 and got.shape == (len(tris),)
    assert got.tolist() == want
    one = [tbake.get_subdivision_level(tdesc, topts, i, t, size)
           for i, t in enumerate(arr)]
    assert one == want and all(type(v) is int for v in one)
    with np.errstate(all="ignore"):
        jitems = jbake.setup_work_items(jdesc, jopts)
    assert _item_rows(tbake.setup_work_items(tdesc, topts)) == \
        _item_rows(jitems)
    if case == "ratios" and scale > 0:
        # every level from 0 to the maximum
        assert set(want) == set(range(max_level + 1))


def test_nan_triangle_under_the_edge_heuristic_bakes_unresolved():
    """A NaN triangle under EnableEdgeHeuristic is skipped as invalid and
    takes the unresolved special index, as it does without the flag; the
    per-triangle heuristic raised there (NaN and Inf to int), and the JAX
    package still does, so this case is outside the parity test above."""
    n = 64
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    circle = (np.hypot(i - 31.5, j - 31.5) < 20).astype(F32)
    bad = np.full((3, 2), np.nan, F32)
    bad[1] = [0.5, 0.5]
    tris = [_right(0.6, 0.5, 0.1, 0.2), bad, _right(0.3, 0.4, 0.4, 0.3),
            np.array([[0.9, 0.1], [np.inf, 0.2], [0.5, 0.5]], F32)]
    flags = int(ot.BakeFlags.EnableEdgeHeuristic)
    desc = convert.bake_input(
        [circle], 1, tex_coords=np.concatenate(tris),
        index_buffer=np.arange(12, dtype=np.uint32), index_count=12,
        max_subdivision_level=4, dynamic_subdivision_scale=2.0,
        bake_flags=flags)
    res = ot.bake(desc, device="cpu")
    ib = np.asarray(res.index_buffer).tolist()
    unresolved = int(desc.unresolved_tri_state)
    assert ib[1] == unresolved and ib[3] == unresolved
    # the finite triangles bake as they do alone
    alone = ot.bake(dataclasses.replace(
        desc, tex_coords=np.concatenate([tris[0], tris[2]]),
        index_buffer=np.arange(6, dtype=np.uint32), index_count=6),
        device="cpu")
    assert [ib[0], ib[2]] == np.asarray(alone.index_buffer).tolist()
    assert np.array_equal(res.array_data, alone.array_data)
    assert res.desc_array == alone.desc_array and len(res.desc_array) > 0
