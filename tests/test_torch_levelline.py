"""omm_tpu_torch.bird_torch and .levelline against the JAX package's numpy
and jnp functions: elementwise, bit for bit, on fuzzed fp32 input."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import omm_tpu as omm  # noqa: E402
from omm_tpu import bird  # noqa: E402
from omm_tpu.kernels import levelline as ll  # noqa: E402
from omm_tpu.kernels import pallas_classify as pk  # noqa: E402
from omm_tpu_torch import bird_torch as tbird  # noqa: E402
from omm_tpu_torch import levelline as tll  # noqa: E402


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


def _same_f32(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.array_equal(_bits(g), _bits(want))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_index2dbary_matches_bird():
    rng = np.random.RandomState(0)
    idx = np.concatenate([np.arange(4096, dtype=np.uint32),
                          rng.randint(0, 2 ** 32, 20000,
                                      dtype=np.uint64).astype(np.uint32)])
    want = bird.index2dbary(idx)
    got = tbird.index2dbary(_t(idx.astype(np.int64)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("level", [1, 2, 5, 9, 12])
def test_bary_and_corner_cols(level):
    M = 4 ** level
    rng = np.random.RandomState(level)
    idx = np.unique(np.concatenate([
        np.arange(min(M, 2048)), rng.randint(0, M, 4096)])).astype(np.uint32)
    tri = np.array([[0.05, 0.1], [0.1, 0.7], [0.7, 0.65]], np.float32) \
        + rng.rand(1, 2).astype(np.float32)
    # against the jnp column functions
    bu, bv, bd = tbird.bary_cols(_t(idx.astype(np.int64)), level)
    jbu, jbv, jbd = pk.bary_cols(jnp.asarray(idx), level)
    for g, w in ((bu, jbu), (bv, jbv), (bd, jbd)):
        _same_f32(g, np.asarray(w))
    tri6 = tuple(torch.full((len(idx),), float(v)) for v in tri.reshape(6))
    corners = tbird.corner_cols(tri6, bu, bv, bd)
    jtri6 = tuple(jnp.full((len(idx),), v, jnp.float32)
                  for v in tri.reshape(6))
    jcorners = pk.corner_cols(jtri6, jbu, jbv, jbd,
                              fz=jnp.zeros((), jnp.int32))
    # and against the host bird path (index2bary + micro_triangle_uvs)
    muv = bird.micro_triangle_uvs(tri, idx, level)  # (N, 3, 2)
    uv0, uv1, uv2 = bird.index2bary(idx, level)
    _same_f32(bu, uv0[:, 0])
    _same_f32(bv, uv0[:, 1])
    _same_f32(bu + bd, uv1[:, 0])
    _same_f32(bv + bd, uv2[:, 1])
    for k in range(3):
        for c in range(2):
            _same_f32(corners[k][c], np.asarray(jcorners[k][c]))
            _same_f32(corners[k][c], muv[:, k, c])


def _edge_inputs(n, seed):
    """Edge endpoints and hyperbola coefficients: random, near-vertical
    edges, straight-line (hd ~ 0) and degenerate-coefficient cases."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.uniform(-1.5, 2.5, s).astype(np.float32)  # noqa
    p0x, p0y, p1x, p1y = f(n), f(n), f(n), f(n)
    q = n // 4
    p1x[:q] = p0x[:q] + (rng.uniform(-2e-6, 2e-6, q)).astype(np.float32)
    ha = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    hb = rng.uniform(-1, 1, n).astype(np.float32)
    hc = rng.uniform(-1, 1, n).astype(np.float32)
    hd = rng.uniform(-1, 1, n).astype(np.float32)
    hd[q:2 * q] = rng.uniform(-2e-6, 2e-6, q).astype(np.float32)
    hc[2 * q:2 * q + q // 4] = 0.0
    hd[2 * q:2 * q + q // 4] = 0.0
    return p0x, p0y, p1x, p1y, ha, hb, hc, hd


def test_edge_hyperbola_hit_fuzz():
    for seed in range(3):
        args = _edge_inputs(40000, seed)
        want = ll.edge_hyperbola_hit(np, *args)
        got = tll.edge_hyperbola_hit(*[_t(a) for a in args])
        assert want.any() and not want.all()
        assert np.array_equal(got.numpy(), want)


def test_point_in_tri_fuzz():
    rng = np.random.RandomState(4)
    n = 30000
    tri = rng.rand(n, 3, 2).astype(np.float32)
    tp_np = {k: v[:, 0, 0] for k, v in ll.make_tri_params(np, tri).items()}
    px = rng.rand(n).astype(np.float32)
    py = rng.rand(n).astype(np.float32)
    px[:100] = tri[:100, 0, 0]  # on a vertex: the zero cases
    py[:100] = tri[:100, 0, 1]
    tp_t = tll.tri_params(*[_t(tri[:, k, c]) for k in range(3)
                            for c in range(2)])
    for k in tp_np:
        _same_f32(tp_t[k], tp_np[k])
    want = ll.point_in_tri_cached(np, tp_np, px, py)
    got = tll.point_in_tri_cached(tp_t, _t(px), _t(py))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("content", ["random", "smooth", "uniform"])
def test_level_line_values_kernel_fuzz(content):
    rng = np.random.RandomState({"random": 1, "smooth": 2, "uniform": 3}[
        content])
    n = 20000
    w, h = 256, 192
    size = (w, h)
    rcp = tuple(float(v) for v in np.float32(1.0) / np.array(size, np.float32))
    cutoff = 0.5
    # micro-triangles a few texels wide around texel (px, py)
    px = rng.randint(0, w, n).astype(np.int32)
    py = rng.randint(0, h, n).astype(np.int32)
    c = (np.stack([px, py], -1)[:, None, :].astype(np.float32)
         + rng.uniform(-2, 3, (n, 3, 2)).astype(np.float32)) \
        / np.array(size, np.float32)
    c = c.astype(np.float32)
    if content == "random":
        g = rng.rand(4, n).astype(np.float32)
    elif content == "smooth":
        # a smooth alpha ramp crossing the cutoff: small quad differences
        base = np.float32(0.5) + rng.uniform(-3e-3, 3e-3, n).astype(
            np.float32)
        g = (base[None] + rng.uniform(-2e-3, 2e-3, (4, n))).astype(
            np.float32)
    else:
        v = rng.choice(np.float32([0.25, 0.5, 0.75]), n)
        g = np.stack([v] * 4).astype(np.float32)
        g[:, : n // 2] += rng.uniform(-5e-7, 5e-7, (4, n // 2)).astype(
            np.float32)
    tp_np = {k: v[:, 0, 0] for k, v in ll.make_tri_params(np, c).items()}
    want = ll.level_line_values_kernel(np, None, tp_np, px, py, *g, size,
                                       rcp, cutoff, degenerate=False)
    tp_t = tll.tri_params(*[_t(c[:, k, j]) for k in range(3)
                            for j in range(2)])
    got = tll.level_line_values_kernel(tp_t, _t(px), _t(py),
                                       *[_t(x) for x in g], size, rcp,
                                       cutoff)
    for gg, ww in zip(got, want):
        assert np.array_equal(gg.numpy(), np.broadcast_to(ww, gg.shape))
    assert (got[0] > 0).any() and (got[1] > 0).any()


@pytest.mark.parametrize("fmt", [omm.Format.OC1_4_State,
                                 omm.Format.OC1_2_State])
def test_get_state_from_coverage(fmt):
    a, b = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    a = a.reshape(-1).astype(np.int32)
    b = b.reshape(-1).astype(np.int32)
    states = list(omm.OpacityState)
    for mode, gt, le in itertools.product(omm.UnknownStatePromotion,
                                          states, states):
        want = ll.get_state_from_coverage(np, fmt, mode, gt, le, a, b)
        got = tll.get_state_from_coverage(fmt, mode, gt, le, _t(a), _t(b))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.broadcast_to(want, a.shape))


def test_sqrt_rn_is_correctly_rounded():
    """numpy's fp32 sqrt is IEEE; torch's fp32 sqrt on the CPU is not,
    which is why the port takes its sqrt through float64."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, 0x7F800000, 2_000_000).astype(np.int32).view(
        np.float32)
    assert np.array_equal(_bits(tll.sqrt_rn(_t(x)).numpy()),
                          _bits(np.sqrt(x)))


def test_is_zero_constants():
    v = np.array([1e-6, -1e-6, 9.99e-7, 1e-5, 0.0, np.float32(1e-6)],
                 np.float32)
    for eps in (1e-6, 1e-5):
        assert np.array_equal(tll.is_zero(_t(v), eps).numpy(),
                              ll.is_zero(np, v, eps))


def _texel_inputs(seed, n=3000, w=64, h=48, degenerate=False):
    """Micro-triangles a few texels wide (lines when degenerate), one
    texel of each window per row, near and past the plane's edges."""
    rng = np.random.RandomState(seed)
    size = np.array([w, h], np.float32)
    base = rng.uniform(-3, [w + 3, h + 3], (n, 1, 2)).astype(np.float32)
    if degenerate:
        d = rng.uniform(-4, 4, (n, 1, 2)).astype(np.float32)
        t = np.float32([0.0, 0.5, 1.0])[None, :, None]
        tri = (base + d * t) / size
    else:
        tri = (base + rng.uniform(-2, 3, (n, 3, 2))) / size
    tri = tri.astype(np.float32)
    px = (np.floor(base[:, 0, 0]) + rng.randint(-1, 3, n)).astype(np.int32)
    py = (np.floor(base[:, 0, 1]) + rng.randint(-1, 3, n)).astype(np.int32)
    plane = rng.rand(h, w).astype(np.float32)
    plane[rng.rand(h, w) < 0.3] = 0.5  # flat quads, level lines on texels
    return tri, px, py, plane


@pytest.mark.parametrize("degenerate", [False, True], ids=["tri", "line"])
@pytest.mark.parametrize("mode", list(omm.TextureAddressMode),
                         ids=lambda m: m.name)
def test_level_line_texel_kernel_fuzz(mode, degenerate):
    """The gathering kernel, both branches, every address mode: the
    quads come through the port's texture addressing."""
    from omm_tpu_torch import texture as ttex
    from omm_tpu_torch import types as ttypes
    tri, px, py, plane = _texel_inputs(int(mode) + 10 * degenerate,
                                       degenerate=degenerate)
    tex = ttex.Texture([plane], ttypes.TextureFormat.FP32)
    info = tex.info[0]
    rcp = (float(info.rcp_size[0]), float(info.rcp_size[1]))
    tmode = ttypes.TextureAddressMode(int(mode))
    aabb_s, aabb_e = tri.min(axis=1), tri.max(axis=1)
    tp_np = ll.make_tri_params(np, tri)
    want = ll.level_line_texel_kernel(
        np, tri, tp_np, px[:, None, None], py[:, None, None], plane,
        info.size, info.size_log2, info.is_pow2, rcp, mode, 0.5, 0.3,
        degenerate, aabb_s=aabb_s, aabb_e=aabb_e)
    got = tll.level_line_texel_kernel(
        tll.make_tri_params(_t(tri)), _t(px)[:, None, None],
        _t(py)[:, None, None], _t(plane), info, tmode, 0.5, 0.3,
        degenerate=degenerate, aabb_s=_t(aabb_s), aabb_e=_t(aabb_e))
    for gg, ww in zip(got, want):
        assert np.array_equal(gg.numpy(), np.broadcast_to(ww, gg.shape))
    assert (got[0] > 0).any() and (got[1] > 0).any()
    if not degenerate:
        for k, v in tll.make_tri_params(_t(tri)).items():
            _same_f32(v, tp_np[k])


def test_conservative_raster_mask_fuzz():
    rng = np.random.RandomState(6)
    n = 4000
    q = (rng.uniform(0, 6, (n, 1, 2)) + rng.uniform(-3, 3, (n, 3, 2))
         ).astype(np.float32)
    q[: n // 8, 1] = q[: n // 8, 0]  # degenerate edges
    x = np.arange(-1, 9, dtype=np.int32)[None, None, :]
    y = np.arange(-1, 8, dtype=np.int32)[None, :, None]
    want = ll.conservative_raster_mask(np, q, np.broadcast_to(x, (n, 9, 10)),
                                       np.broadcast_to(y, (n, 9, 10)))
    got = tll.conservative_raster_mask(_t(q), _t(x), _t(y))
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want.all()
