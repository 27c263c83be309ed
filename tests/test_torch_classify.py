"""omm_tpu_torch's fine routes off the fast path, stage by stage, against
the JAX package's: texture addressing and the bilinear seed
(texture_torch), window bounds and the dense pass (classify_item,
classify_work_item with its sliver hand-off), the survivors passes
(linear and nearest), line triangles (classify_degenerate), the nearest
filter's phase-1 resolve (twophase.nearest_sides /
resolve_nearest_phase1), and the fine pass of engine.resample_fine_item
for nearest-filter line triangles and both AABB modes.  Inputs are
seeded numpy arrays at small sizes; every comparison is exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import omm_tpu as omm  # noqa: E402
from omm_tpu import engine as jengine  # noqa: E402
from omm_tpu import texture as jtexture  # noqa: E402
from omm_tpu.kernels import jax_classify as jc  # noqa: E402
from omm_tpu.kernels import twophase as jtp  # noqa: E402
from omm_tpu_torch import classify, convert, routes  # noqa: E402
from omm_tpu_torch import engine as tengine  # noqa: E402
from omm_tpu_torch import texture_torch as ttt  # noqa: E402
from omm_tpu_torch import twophase as ttp  # noqa: E402
from omm_tpu_torch import types as ttypes  # noqa: E402

from fixtures import sine_fp32, standard_circle  # noqa: E402

MODES = list(omm.TextureAddressMode)
UO = 3


def _cfgs(**over):
    """The JAX package's ResampleConfig and the port's, from ints."""
    base = dict(addr_mode=2, filter=1, alpha_cutoff=0.5, border_alpha=0.7,
                fmt=2, promotion=0, cutoff_gt=1, cutoff_le=0)
    base.update(over)
    enums = ("addr_mode", "filter", "fmt", "promotion", "cutoff_gt",
             "cutoff_le")
    names = dict(addr_mode="TextureAddressMode", filter="TextureFilterMode",
                 fmt="Format", promotion="UnknownStatePromotion",
                 cutoff_gt="OpacityState", cutoff_le="OpacityState")
    out = []
    for mod, Cfg in ((omm, jengine.ResampleConfig),
                     (ttypes, tengine.ResampleConfig)):
        out.append(Cfg(**{k: getattr(mod, names[k])(v) if k in enums else v
                          for k, v in base.items()}))
    return out


def _textures(planes, fmt=1):
    return (omm.Texture(planes, omm.TextureFormat(fmt)),
            convert.texture(planes, fmt))


def _circle2():
    """A 128^2 circle with its half-size mip (two mips)."""
    c = standard_circle(128, 128)
    return [c, c[::2, ::2].copy()]


def _tris(n, seed, lo=0.05, hi=0.6, size=0.35):
    rng = np.random.RandomState(seed)
    base = rng.uniform(lo, hi, size=(n, 1, 2))
    return list((base + rng.uniform(0, size, size=(n, 3, 2))).astype(
        np.float32))


def _bench_tris(n, seed):
    """bench.py's triangle shape at random offsets."""
    rng = np.random.RandomState(seed)
    return [np.array([b + [0.05, 0.1], b + [0.1, 0.7], b + [0.7, 0.65]],
                     np.float32)
            for b in rng.rand(n, 2).astype(np.float32) * 0.25]


SLIVER = np.array([[0.1, 0.3], [0.9, 0.3000001], [0.5, 0.3]], np.float32)
LINE = np.array([[0.2, 0.0], [0.2, 0.437582970], [0.2, 0.218791485]],
                np.float32)
DIAG = np.array([[0.15, 0.2], [0.55, 0.6], [0.35, 0.4]], np.float32)


def _partial(M, seed):
    """States with some micro-triangles resolved (a resumed item)."""
    st = np.full(M, UO, np.uint8)
    rng = np.random.RandomState(seed)
    st[rng.rand(M) < 0.4] = rng.randint(0, 2)
    return st


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_tex_coord_and_bilinear(mode):
    rng = np.random.RandomState(int(mode))
    for planes in ([sine_fp32(64, 64)], [sine_fp32(48, 80)]):
        jt, tt = _textures(planes)
        info = tt.info[0]
        xy = rng.randint(-300, 300, size=(2000, 2)).astype(np.int32)
        tm = ttypes.TextureAddressMode(int(mode))
        size = np.array(info.size, np.int32)
        log2 = np.array(info.size_log2, np.int32)
        want = jtexture.gather_tex_coord4(mode, xy, size, log2, info.is_pow2)
        got = ttt.gather_tex_coord4(tm, torch.from_numpy(xy[:, 0]),
                                    torch.from_numpy(xy[:, 1]), info)
        for (gx, gy), w in zip(got, want):
            assert np.array_equal(np.stack([gx.numpy(), gy.numpy()], -1), w)
        uv = rng.uniform(-0.6, 1.6, size=(2000, 2)).astype(np.float32)
        seed = jc._bilinear_seed(jnp.asarray(planes[0]), jnp.asarray(uv),
                                 info.size, info.size_log2, info.is_pow2,
                                 mode, 0.7, jnp.int32(0))
        got = ttt.bilinear(torch.from_numpy(planes[0]), tm,
                           torch.from_numpy(uv[:, 0]),
                           torch.from_numpy(uv[:, 1]), info)
        assert np.array_equal(got.numpy().view(np.int32),
                              np.asarray(seed).view(np.int32))
        assert np.array_equal(got.numpy().view(np.int32),
                              jt.bilinear(mode, uv, 0).view(np.int32))


def test_window_bounds():
    jt, tt = _textures(_circle2())
    for tri in _tris(3, 1) + [SLIVER, DIAG]:
        for sd in (0, 1, 3, 5):
            assert classify.window_bounds(tt, tri, sd) == \
                jc._window_bounds(jt, tri, sd)


ITEM_CASES = {
    "clamp_lvl3": (lambda: [standard_circle(128, 128)], dict(), 3),
    "wrap_lvl1": (lambda: [sine_fp32(64, 64)], dict(addr_mode=0), 1),
    "border_lvl0": (lambda: [standard_circle(64, 64)],
                    dict(addr_mode=3, fmt=1), 0),
    "mirror_2mip_lvl4": (_circle2, dict(addr_mode=1, promotion=2), 4),
}


@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_classify_item_and_work_item(case):
    """The dense pass's counts, and the work item's states from fresh
    and from partial states."""
    mk, over, sd = ITEM_CASES[case]
    jt, tt = _textures(mk())
    jcfg, tcfg = _cfgs(**over)
    M = 4 ** sd
    for tri in _tris(2, sd):
        tri = np.where(over.get("addr_mode") == 0, tri * 1.5 - 0.3,
                       tri).astype(np.float32)
        mip_meta = tuple((jt.info[m].size, jt.info[m].size_log2,
                          jt.info[m].is_pow2,
                          tuple(float(r) for r in jt.info[m].rcp_size))
                         for m in range(jt.mip_count))
        win = tuple((max(jc._bucket_pow2(W), 2), max(jc._bucket_pow2(H), 2))
                    for W, H in jc._window_bounds(jt, tri, sd))
        wa, wb = jc._classify_item(
            jc._dev_planes(jt), jnp.asarray(tri), jnp.asarray(
                bool(omm.geom.is_ccw(tri))), jnp.int32(0), subdiv=sd,
            addr_mode=jcfg.addr_mode, alpha_cutoff=0.5, border_alpha=0.7,
            mip_meta=mip_meta, win_wh=win, fmt=jcfg.fmt,
            promotion=jcfg.promotion, cutoff_gt=jcfg.cutoff_gt,
            cutoff_le=jcfg.cutoff_le)
        ga, gb = classify.classify_item(tt, tcfg, tri, sd, "cpu")
        assert np.array_equal(ga.numpy(), np.asarray(wa))
        assert np.array_equal(gb.numpy(), np.asarray(wb))
        for st in (np.full(M, UO, np.uint8), _partial(M, sd)):
            want = jc.classify_work_item_jax(jt, jcfg, tri, sd, st.copy())
            got = classify.classify_work_item(tt, tcfg, tri, sd, st.copy(),
                                              "cpu")
            assert np.array_equal(got, want)


def test_linear_survivors_batch():
    """One stream over partial items, an all-UnknownOpaque item (bounced
    to the dense pass) and a winding-unstable sliver (never bounced)."""
    jt, tt = _textures(_circle2())
    jcfg, tcfg = _cfgs(promotion=2)
    sd = 3
    M = 4 ** sd
    tris = _tris(3, 4) + [SLIVER]
    assert not bool(omm.geom.winding_stable(SLIVER, sd))
    sts = [_partial(M, 1), np.full(M, UO, np.uint8), _partial(M, 2),
           np.full(M, UO, np.uint8)]
    sts[2][:] = 0  # nothing left to classify
    want = jc.classify_linear_survivors_batch(
        jt, jcfg, [(t, s.copy()) for t, s in zip(tris, sts)], sd)
    got = classify.classify_linear_survivors_batch(
        tt, tcfg, [(t, s.copy()) for t, s in zip(tris, sts)], sd, "cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert not np.array_equal(want[3], sts[3])
    # the sliver alone, through the work item's hand-off
    assert np.array_equal(
        classify.classify_work_item(tt, tcfg, SLIVER, 5,
                                    np.full(4 ** 5, UO, np.uint8), "cpu"),
        jc.classify_work_item_jax(jt, jcfg, SLIVER, 5,
                                  np.full(4 ** 5, UO, np.uint8)))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_nearest_survivors(mode):
    jt, tt = _textures(_circle2())
    jcfg, tcfg = _cfgs(filter=0, addr_mode=int(mode), fmt=1 + int(mode) % 2)
    sd = 4
    M = 4 ** sd
    tris = [(t * 1.6 - 0.3).astype(np.float32) for t in _tris(2, 5)] \
        + [SLIVER]
    work = [(t, _partial(M, k)) for k, t in enumerate(tris)]
    got = classify.classify_nearest_survivors_batch(
        tt, tcfg, [(t, s.copy()) for t, s in work], sd, "cpu")
    for (t, s), g in zip(work, got):
        assert np.array_equal(
            g, jc.classify_nearest_survivors(jt, jcfg, t, sd, s.copy()))
        assert np.array_equal(
            classify.classify_nearest_survivors(tt, tcfg, t, sd, s.copy(),
                                                "cpu"), g)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_degenerate(mode):
    jt, tt = _textures(_circle2())
    jcfg, tcfg = _cfgs(addr_mode=int(mode), promotion=int(mode) % 3)
    line = LINE if int(mode) % 2 else np.array(  # across the plane's edges
        [[-0.6, 0.3], [1.4, 0.3], [0.4, 0.3]], np.float32)
    for tri, sd in ((line, 5), (np.full((3, 2), 0.3, np.float32), 2)):
        tri = tri.astype(np.float32)
        assert bool(omm.geom.is_degenerate(tri))
        for st in (np.full(4 ** sd, UO, np.uint8), _partial(4 ** sd, sd)):
            want = jc.classify_degenerate_device(jt, jcfg, tri, sd,
                                                 st.copy())
            got = classify.classify_degenerate(tt, tcfg, tri, sd, st.copy(),
                                               "cpu")
            assert np.array_equal(got, want)


NEAREST_P1 = {
    "clamp": (lambda: [standard_circle(128, 128)], 2, 4),
    "wrap_2mip": (_circle2, 0, 4),
    "border": (lambda: [standard_circle(128, 128)], 3, 4),
    "mirror": (lambda: [sine_fp32(128, 128)], 1, 3),
}


@pytest.mark.parametrize("case", sorted(NEAREST_P1))
def test_nearest_phase1(case):
    """The side map of every micro-triangle, and the resolved states."""
    mk, mode, sd = NEAREST_P1[case]
    jt, tt = _textures(mk())
    jcfg, tcfg = _cfgs(filter=0, addr_mode=mode)
    tris = _bench_tris(3, sd)
    items = [(tris[0], None), (tris[1], _partial(4 ** sd, 1)),
             (tris[2], np.full(4 ** sd, UO, np.uint8))]
    want = jtp.resolve_nearest_phase1(jt, jcfg, items, sd)
    routes.reset()
    got = ttp.resolve_nearest_phase1(tt, tcfg, items, sd, "cpu")
    assert want is not None and len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert any((w == UO).any() and (w != UO).any() for w in want)
    # the count holds only what phase 1 resolved, not earlier states
    before = [np.full(4 ** sd, UO, np.uint8) if s is None else s
              for _, s in items]
    assert routes.COUNTS["nearest_phase1_utri"] == sum(
        int(np.count_nonzero((b == UO) & (w != UO)))
        for b, w in zip(before, want))
    assert routes.COUNTS["nearest_phase1_utri"] < sum(
        int(np.count_nonzero(w != UO)) for w in want)
    # the device program alone, on the JAX package's class planes
    mips, pads, cls_t, cls_j, periods = [], [], [], [], []
    for mip in range(jt.mip_count):
        Hb = max(jtp._span_window(jt, t, sd, mip)[0] for t in tris)
        Wb = max(jtp._span_window(jt, t, sd, mip)[1] for t in tris)
        pad = jtp.TILE + max(Hb + 2, Wb + 2)
        period = jtp._period_for(jt, jcfg.addr_mode, mip)
        c = jtp._cls_cached(jt, mip, jcfg.addr_mode, pad, pad, Hb, Wb, 0.5,
                            jtp.PHASE1_MARGIN, 0.7, period)
        cls_j.append(c)
        cls_t.append(torch.from_numpy(np.array(c)))
        mips.append(jt.size(mip))
        pads.append(pad)
        periods.append(period)
    uv = np.stack([t.reshape(6) for t in tris]).astype(np.float32)
    ws = jtp._nearest_sides(tuple(cls_j), jnp.asarray(uv), subdiv=sd,
                            mips=tuple(mips), pads=tuple(pads),
                            periods=tuple(periods))
    gs = ttp.nearest_sides(cls_t, torch.from_numpy(uv), subdiv=sd,
                           mips=mips, pads=pads, periods=periods)
    assert np.array_equal(gs.numpy(), np.asarray(ws))


def test_nearest_phase1_preconditions():
    """None wherever the JAX package returns None: linear filter, low
    levels, a line triangle, micro-triangles under the span gate."""
    jt, tt = _textures([standard_circle(128, 128)])
    jn, tn = _cfgs(filter=0)
    jl, tl = _cfgs(filter=1)
    tri = _bench_tris(1, 0)[0]
    for jcfg, tcfg, items, sd in (
            (jl, tl, [(tri, None)], 4), (jn, tn, [(tri, None)], 1),
            (jn, tn, [(tri, None), (LINE, None)], 4),
            (jn, tn, [(tri * 0.05, None)], 5)):
        assert jtp.resolve_nearest_phase1(jt, jcfg, items, sd) is None
        assert ttp.resolve_nearest_phase1(tt, tcfg, items, sd, "cpu") is None


ENGINE_CASES = {
    "nearest_line_2mip": (_circle2, dict(filter=0, addr_mode=0), LINE, 5),
    "nearest_point_border": (_circle2, dict(filter=0, addr_mode=3),
                             np.full((3, 2), 0.5, np.float32), 3),
    "aabb_kernel": (lambda: [sine_fp32(128, 128)],
                    dict(disable_level_line=True, addr_mode=4), None, 4),
    "aabb_two_tris_border": (lambda: [standard_circle(128, 128)],
                             dict(disable_level_line=True, addr_mode=3,
                                  enable_aabb_testing=True), None, 4),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_resample_fine_item(case):
    mk, over, tri, sd = ENGINE_CASES[case]
    jt, tt = _textures(mk())
    jcfg, tcfg = _cfgs(**over)
    tris = [tri] if tri is not None else _tris(2, 7, size=0.5)
    for t in tris:
        for st in (np.full(4 ** sd, UO, np.uint8), _partial(4 ** sd, 3)):
            want = jengine.resample_fine_item(jt, jcfg, t, sd, st.copy())
            got = tengine.resample_fine_item(tt, tcfg, t, sd, st.copy(),
                                             "cpu")
            assert np.array_equal(got, want)
    disabled = _cfgs(disable_fine=True)[1]
    st = np.full(4 ** sd, UO, np.uint8)
    assert tengine.resample_fine_item(tt, disabled, tris[0], sd, st,
                                      "cpu") is st


def test_entry_points_default_to_the_card(monkeypatch):
    """Every new entry point runs on "cuda" unless told otherwise and
    raises where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tt = _textures([standard_circle(64, 64)])
    _, tcfg = _cfgs()
    _, ncfg = _cfgs(filter=0)
    tri = _tris(1, 0)[0]
    st = np.full(16, UO, np.uint8)
    calls = [
        lambda: classify.classify_item(tt, tcfg, tri, 2),
        lambda: classify.classify_work_item(tt, tcfg, tri, 2, st),
        lambda: classify.classify_linear_survivors_batch(
            tt, tcfg, [(tri, st)], 2),
        lambda: classify.classify_nearest_survivors_batch(
            tt, ncfg, [(tri, st)], 2),
        lambda: classify.classify_degenerate(tt, tcfg, LINE, 2, st),
        lambda: tengine.resample_fine_item(tt, ncfg, tri, 2, st),
        lambda: ttp.resolve_nearest_phase1(tt, ncfg, [(tri, st)], 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
