"""The atlas, the meshes and each bake's micro-triangle count are fixed by
the seed; the meshes share UVs as the example's `quad_mesh` does, and
the count covers each distinct triangle once."""
import numpy as np
import pytest
import torch

from ommbench import inputs, run
from ommbench.generators import leaf_cards
from ommbench.reference import levels

from ommbench_cells import ROOT, SEED

TRAFFIC = run.load_json(ROOT, "ommbench", "traffic", "shared_atlas.json")
ATLAS = TRAFFIC["params"]["atlas"]
MESH = TRAFFIC["params"]["mesh"]


def test_atlas_fixed_by_seed():
    a = leaf_cards.foliage_atlas(SEED, 0, 256, ATLAS, "cpu")
    b = leaf_cards.foliage_atlas(SEED, 0, 256, ATLAS, "cpu")
    c = leaf_cards.foliage_atlas(SEED + 1, 0, 256, ATLAS, "cpu")
    d = leaf_cards.foliage_atlas(SEED, 1, 256, ATLAS, "cpu")
    assert a.dtype == torch.float32 and a.shape == (256, 256)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert float(a.min()) == 0.0 and float(a.max()) == 1.0
    # soft edges: values strictly between 0 and 1 exist
    assert bool(((a > 0) & (a < 1)).any())


def test_atlas_leaf_matches_the_example_formula():
    """One leaf, stamped in its box, equals the example's dense formula
    over the whole plane."""
    p = dict(ATLAS, leaves=1)
    size = 128
    got = leaf_cards.foliage_atlas(SEED, 0, size, p, "cpu").numpy()
    cx, cy, ang, la, lb = leaf_cards.leaf_params(SEED, 0, size, p)[0]
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    dx = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
    dy = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
    r = (dx / la) ** 2 + (dy / lb) ** 2
    want = np.clip(1.2 - r + 0.12 * np.sin(np.arctan2(dy, dx) * 9.0), 0, 1)
    assert np.abs(got - want).max() < 1e-4


def test_atlas_leaves_scale_with_the_texture():
    """A 4096^2 atlas holds the example's 140 leaves at 8 times the size
    of its 512^2 atlas, in the same places of UV space."""
    small = leaf_cards.leaf_params(SEED, 0, 512, ATLAS)
    big = leaf_cards.leaf_params(SEED, 0, 4096, ATLAS)
    assert len(big) == ATLAS["leaves"] == 140
    assert np.allclose(big[:, [0, 1, 3, 4]], 8 * small[:, [0, 1, 3, 4]])
    assert np.array_equal(big[:, 2], small[:, 2])
    assert 8 * 8 <= big[:, 3].min() and big[:, 3].max() <= 8 * 48


@pytest.mark.parametrize("stream", [inputs.WARMUP, inputs.TIMED])
def test_meshes_fixed_by_seed(stream):
    a = leaf_cards.quad_mesh(SEED, stream, 3, MESH)
    b = leaf_cards.quad_mesh(SEED, stream, 3, MESH)
    c = leaf_cards.quad_mesh(SEED, stream, 4, MESH)
    d = leaf_cards.quad_mesh(SEED + 1, stream, 3, MESH)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], d[0])
    uvs, idx = a
    assert uvs.dtype == np.float32 and idx.dtype == np.uint32
    assert len(uvs) % 4 == 0 and idx.shape == (6 * len(uvs) // 4,)
    assert uvs.min() >= 0.0 and uvs.max() <= 1.0


def test_meshes_vary_and_share_uvs_as_the_example():
    """Quads per bake vary over the traffic's range; each bake's quads
    are drawn from its 6 variants, whose corners and sides lie in the
    example's ranges on the UV grid."""
    q0, q1 = MESH["quads"]
    g = MESH["uv_grid"]
    counts = set()
    for seed, i in ((SEED, 0), (SEED, 1), (7, 5), (2 ** 40, 9), (3, 2)):
        uvs, idx = leaf_cards.quad_mesh(seed, inputs.TIMED, i, MESH)
        quads = uvs.reshape(-1, 4, 2)
        counts.add(len(quads))
        assert q0 <= len(quads) <= q1
        variants = np.unique(quads.reshape(len(quads), 8), axis=0)
        assert len(variants) == MESH["uv_variants"]
        lo, hi = quads.min(1), quads.max(1)
        assert (lo >= 0.0).all() and (lo <= 0.5).all()
        sides = hi - lo
        assert (sides >= 0.2 - 1 / g).all() and (sides <= 0.5 + 1 / g).all()
        assert np.array_equal(uvs * g, np.round(uvs * g))
        tris = inputs.triangles(uvs, idx)
        assert len(inputs.distinct(tris)) == 2 * MESH["uv_variants"]
    assert len(counts) > 1


def test_distinct_keeps_first_occurrences():
    t = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    tris = t[[2, 0, 2, 3, 0]]
    assert np.array_equal(inputs.distinct(tris), t[[2, 0, 3]])


def test_micro_triangle_count_fixed_by_inputs():
    """At 4096^2 every distinct triangle of the traffic is at level 8: a
    bake requests 12 x 4^8 micro-triangles, whatever its quad count."""
    counts = {levels.micro_triangles(
        inputs.distinct(inputs.triangles(
            *leaf_cards.quad_mesh(s, inputs.TIMED, i, MESH))),
        (4096, 4096), 2.0, 8) for s in (SEED, 3) for i in range(4)}
    assert counts == {12 * 4 ** 8}


def test_library_gives_every_seed_the_same_work():
    """Each run of `meshes` bakes bakes every mesh of the library once:
    the same meshes for every seed, in an order drawn from the seed; the
    warm-up bakes the whole library, so it meets every shape the timed
    bakes meet."""
    lib = MESH["library"]
    m = int(lib["meshes"])
    assert TRAFFIC["warmup"]["bakes"] >= m
    config = {"texture": {"format": "FP32", "mips": 1, "width": 64,
                          "height": 64}}

    def order(seed, stream, start):
        gen = leaf_cards.make(seed, config, TRAFFIC["params"], "cpu")
        return [gen.mesh(stream, i)[0].tobytes()
                for i in range(start, start + m)]

    first = order(SEED, inputs.TIMED, 0)
    assert len(set(first)) == m
    for seed, stream, start in ((SEED, inputs.TIMED, m),
                                (7, inputs.TIMED, 0),
                                (2 ** 40, inputs.TIMED, 3 * m),
                                (SEED, inputs.WARMUP, 0)):
        again = order(seed, stream, start)
        assert set(again) == set(first)
        assert again != first
    assert order(SEED, inputs.TIMED, 0) == first
