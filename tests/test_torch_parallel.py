"""omm_tpu_torch.parallel.shard against omm_tpu.parallel.shard.

The JAX functions run on the 8 virtual CPU devices of tests/conftest.py;
the port's on a mesh of eight CPU slots, make_mesh(["cpu"] * 8), each
slot a worker thread.  Both get the same seeded numpy inputs, and every
output must be equal: states, histograms, sides and counts, the errors
of sharded_classify_batch, and whole BakeResults of bake(mesh=).  The
process-wide counts the slots add to from their threads are held to
add up (a lost update would show), and a threaded mesh bake must count
what the meshless bake counts."""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu import engine, geom  # noqa: E402
from omm_tpu.kernels import twophase as jtp  # noqa: E402
from omm_tpu.parallel import shard as jshard  # noqa: E402
from omm_tpu_torch import convert, routes  # noqa: E402
from omm_tpu_torch import engine as tengine  # noqa: E402
from omm_tpu_torch import planes as tplanes  # noqa: E402
from omm_tpu_torch import types as ttypes  # noqa: E402
from omm_tpu_torch.kernels import exact  # noqa: E402
from omm_tpu_torch.parallel import shard as tshard  # noqa: E402

from fixtures import standard_circle  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

CPU8 = ["cpu"] * 8


def _jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return jshard.make_mesh()


def _cfg_kw(mode=omm.TextureAddressMode.Clamp):
    return dict(addr_mode=mode, alpha_cutoff=0.5, border_alpha=0.25,
                fmt=omm.Format.OC1_4_State,
                promotion=omm.UnknownStatePromotion.Nearest,
                cutoff_gt=omm.OpacityState.Opaque,
                cutoff_le=omm.OpacityState.Transparent)


def _tcfg_kw(mode=omm.TextureAddressMode.Clamp):
    """_cfg_kw with the port's enums."""
    j = _cfg_kw(mode)
    return dict(j, addr_mode=ttypes.TextureAddressMode(int(j["addr_mode"])),
                fmt=ttypes.Format(int(j["fmt"])),
                promotion=ttypes.UnknownStatePromotion(int(j["promotion"])),
                cutoff_gt=ttypes.OpacityState(int(j["cutoff_gt"])),
                cutoff_le=ttypes.OpacityState(int(j["cutoff_le"])))


def _item_setup(size=64, subdiv=3):
    """test_parallel._setup: the circle plane, one triangle, its window
    bounds and mip metadata."""
    from omm_tpu.kernels.jax_classify import _window_bounds
    tex = omm.Texture([standard_circle(size, size)], omm.TextureFormat.FP32)
    uv = np.array([[0.1, 0.1], [0.15, 0.9], [0.9, 0.85]], np.float32)
    info = tex.info[0]
    W, H = _window_bounds(tex, uv, subdiv)[0]
    meta = dict(size=info.size, size_log2=info.size_log2,
                is_pow2=info.is_pow2,
                rcp=(float(info.rcp_size[0]), float(info.rcp_size[1])),
                W=W, H=H)
    return tex, uv, meta


@pytest.mark.parametrize("mode", [omm.TextureAddressMode.Clamp,
                                  omm.TextureAddressMode.Wrap,
                                  omm.TextureAddressMode.Border],
                         ids=lambda m: m.name)
def test_classify_item_sharded_matches_jax(mode):
    """test_parallel.py:30: states and histogram equal the JAX function's
    and the fine-pass oracle's."""
    tex, uv, meta = _item_setup()
    plane = tex.load_plane(0)
    ccw = bool(geom.is_ccw(uv))
    j_states, j_hist = jshard.classify_item_sharded(
        _jmesh(), jnp.asarray(plane), uv, ccw, subdiv=3, **meta,
        **_cfg_kw(mode))
    states, hist = tshard.classify_item_sharded(
        tshard.make_mesh(CPU8), plane, uv, ccw, subdiv=3, **meta,
        **_tcfg_kw(mode))
    j_states, j_hist = np.asarray(j_states), np.asarray(j_hist)
    assert states.dtype == j_states.dtype and hist.dtype == j_hist.dtype
    assert np.array_equal(states, j_states)
    assert np.array_equal(hist, j_hist)
    assert hist.sum() == 64
    rcfg = engine.ResampleConfig(filter=omm.TextureFilterMode.Linear,
                                 **_cfg_kw(mode))
    want = engine.resample_fine_item(tex, rcfg, uv, 3,
                                     np.full(64, 3, np.uint8))
    assert (states == want).all()


def test_sharded_bake_step_matches_jax():
    """test_parallel.py:56: two items, states (T, M) and histogram."""
    tex, uv, meta = _item_setup()
    plane = tex.load_plane(0)
    ccw = bool(geom.is_ccw(uv))
    uvs = np.stack([uv, uv + np.float32(0.02)])
    j_states, j_hist = jshard.sharded_bake_step(
        _jmesh(), jnp.asarray(plane), uvs, np.array([ccw, ccw]), subdiv=3,
        **meta, **_cfg_kw())
    states, hist = tshard.sharded_bake_step(
        tshard.make_mesh(CPU8), torch.from_numpy(plane), uvs,
        np.array([ccw, ccw]), subdiv=3, **meta, **_tcfg_kw())
    assert states.shape == (2, 64)
    assert np.array_equal(states, np.asarray(j_states))
    assert np.array_equal(hist, np.asarray(j_hist))
    assert int(hist.sum()) == 2 * 64


@pytest.mark.parametrize("shift", [0.0, -0.3], ids=["inside", "clamped"])
def test_sharded_group_resolve_matches_jax(shift):
    """test_parallel.py:68: sides and counts of the phase-1 group
    resolve; "clamped" moves windows off the class plane, where both
    packages clamp the lookup."""
    plane = standard_circle(32, 32)
    pad = 8
    planeP = jnp.pad(jnp.asarray(plane), pad, mode="edge")
    cls = jtp._class_plane(planeP, 3, 3, 0.5, 2.0 ** -14)
    rng = np.random.RandomState(3)
    uv_tris = (rng.rand(2, 3, 2) * 0.7 + 0.1 + shift).astype(np.float32)
    kw = dict(subdiv=4, lg=2, pad=pad, size=(32, 32))
    j_side, j_counts = jshard.sharded_group_resolve(
        jshard.make_mesh(jax.devices()[:8]), cls, uv_tris, **kw)
    side, counts = tshard.sharded_group_resolve(
        tshard.make_mesh(CPU8), np.asarray(cls), uv_tris, **kw)
    j_side = np.asarray(j_side)
    assert side.dtype == j_side.dtype and side.shape == (2, 16)
    assert np.array_equal(side, j_side)
    assert np.array_equal(counts, np.asarray(j_counts))
    assert counts.sum() == 2 * 16


def _batch_tris(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.25
        out.append(np.array([b + [0.05, 0.08], b + [0.12, 0.7],
                             b + [0.72, 0.6]], np.float32))
    return out


def _engine_cfgs(mode=omm.TextureAddressMode.Clamp):
    kw = _cfg_kw(mode)
    kw["border_alpha"] = 0.0
    jcfg = engine.ResampleConfig(filter=omm.TextureFilterMode.Linear, **kw)
    t = _tcfg_kw(mode)
    t["border_alpha"] = 0.0
    tcfg = tengine.ResampleConfig(
        filter=ttypes.TextureFilterMode.Linear, **t)
    return jcfg, tcfg


@pytest.mark.parametrize("subdiv,shift,mode", [
    (5, 0.0, omm.TextureAddressMode.Clamp),
    (2, 0.0, omm.TextureAddressMode.Clamp),
    (3, 1.0, omm.TextureAddressMode.Wrap)],
    ids=["subdiv5", "subdiv2", "subdiv3-wrap-repeat"])
def test_sharded_classify_batch_matches_jax(subdiv, shift, mode):
    """test_parallel.py:109: the full two-phase pipeline per slot; every
    item's states and the histogram equal the JAX function's (which
    counts over the packed 2-bit rows), the single-device engine's and
    the fine-pass oracle's.  Subdivision 2 is the lowest level the fast
    path takes (4^N % 4 == 0 at every such level)."""
    jtex = omm.Texture([standard_circle(64, 64)], omm.TextureFormat.FP32)
    ttex = convert.texture(jtex.mips, 1)
    M = omm.get_num_micro_triangles(subdiv)
    tris = [t + np.float32(shift) for t in _batch_tris(8, 11)]
    jcfg, tcfg = _engine_cfgs(mode)
    j_got, j_hist = jshard.sharded_classify_batch(
        _jmesh(), jtex, jcfg, [(t, np.full(M, 3, np.uint8)) for t in tris],
        subdiv)
    got, hist = tshard.sharded_classify_batch(
        tshard.make_mesh(CPU8), ttex, tcfg,
        [(t, np.full(M, 3, np.uint8)) for t in tris], subdiv)
    assert hist.dtype == np.int32
    assert np.array_equal(hist, np.asarray(j_hist))
    assert hist.sum() == 8 * M
    single = ot.classify_work_items_batches(
        ttex, tcfg, [[(t, None) for t in tris]], subdiv, device="cpu")[0]
    for t, g, jg, s in zip(tris, got, j_got, single):
        assert g.dtype == np.uint8 and np.array_equal(g, jg)
        assert np.array_equal(g, s.unpack())
        want = engine.resample_fine_item(jtex, jcfg, t, subdiv,
                                         np.full(M, 3, np.uint8))
        assert np.array_equal(g, want)


def _error_of(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_sharded_classify_batch_errors_match_jax():
    """The ValueErrors of the JAX function, case by case: a count the
    mesh does not divide, an item not fresh, an item off the fast path
    (a line triangle), and a winding-unstable sliver."""
    jtex = omm.Texture([standard_circle(64, 64)], omm.TextureFormat.FP32)
    ttex = convert.texture(jtex.mips, 1)
    jcfg, tcfg = _engine_cfgs()
    subdiv = 4
    M = omm.get_num_micro_triangles(subdiv)
    fresh = np.full(M, 3, np.uint8)
    tris = _batch_tris(8, 5)
    used = fresh.copy()
    used[0] = 0
    line = np.array([[0.2, 0.2], [0.4, 0.4], [0.6, 0.6]], np.float32)
    sliver = np.array([[0.1, 0.2], [0.7, 0.2000001], [0.4, 0.2]],
                      np.float32)
    assert not geom.is_degenerate(sliver)
    assert not geom.winding_stable(sliver, subdiv)
    cases = {
        "count": [(t, fresh) for t in tris[:7]],
        "fresh": [(t, fresh) for t in tris[:7]] + [(tris[7], used)],
        "eligible": [(t, fresh) for t in tris[:7]] + [(line, fresh)],
        "winding": [(t, fresh) for t in tris[:7]] + [(sliver, fresh)],
    }
    jm, tm = _jmesh(), tshard.make_mesh(CPU8)
    for name, items in cases.items():
        want = _error_of(lambda: jshard.sharded_classify_batch(
            jm, jtex, jcfg, items, subdiv))
        got = _error_of(lambda: tshard.sharded_classify_batch(
            tm, ttex, tcfg, items, subdiv))
        assert want is not None and got == want, (name, got, want)


def _mesh_fields(n, seed, spread, more_uvs=(), more_tris=(),
                 duplicate=False):
    """UVs and index buffer of n triangles (test_parallel.py's bake
    meshes), then the extra triangles, then optionally a duplicate of
    triangle 0."""
    rng = np.random.RandomState(seed)
    uvs, idxb = [], []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * spread[0] + spread[1]
        base = len(uvs)
        uvs += [b, b + spread[2], b + spread[3]]
        idxb += [base, base + 1, base + 2]
    for tri in more_tris:
        base = len(uvs)
        uvs += [np.array(p, np.float32) for p in tri]
        idxb += [base, base + 1, base + 2]
    if duplicate:
        idxb += [0, 1, 2]
    return dict(tex_coords=np.asarray(uvs, np.float32),
                index_buffer=np.asarray(idxb, np.uint32),
                index_count=len(idxb), max_subdivision_level=5,
                dynamic_subdivision_scale=0.0)


def _lines(k):
    return [[[t, t], [t + 0.2, t + 0.2], [t + 0.4, t + 0.4]]
            for t in (0.05 + 0.08 * i for i in range(k))]


MESH_CASES = {
    # test_parallel.py:223: a line triangle and a duplicate of tri 0
    "line_and_duplicate": (128, omm.TextureAddressMode.Clamp, lambda:
                           _mesh_fields(5, 8, (0.4, 0.0, [0.05, 0.45],
                                               [0.45, 0.4]),
                                        more_tris=[[[0.2, 0.2], [0.4, 0.4],
                                                    [0.6, 0.6]]],
                                        duplicate=True)),
    # test_parallel.py:264: multi-repeat Wrap UVs
    "wrapped": (64, omm.TextureAddressMode.Wrap, lambda:
                _mesh_fields(8, 9, (2.0, 1.0, [0.1, 1.2], [1.3, 1.1]))),
    # test_parallel.py:297: 2 mesh items padded to 8, 9 line triangles
    "more_items_than_sharded": (128, omm.TextureAddressMode.Clamp, lambda:
                                _mesh_fields(0, 0, None, more_tris=[
                                    [[0.1, 0.1], [0.15, 0.5], [0.5, 0.45]],
                                    [[0.5, 0.45], [0.55, 0.85],
                                     [0.9, 0.8]]] + _lines(9))),
}


def _descs(case):
    size, mode, fields = MESH_CASES[case]
    f = fields()
    plane = standard_circle(size, size)
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture([plane], omm.TextureFormat.FP32),
        runtime_sampler=omm.SamplerDesc(addressing_mode=mode,
                                        filter=omm.TextureFilterMode.Linear),
        **f)
    tdesc = convert.bake_input([plane], 1, addressing_mode=int(mode),
                               filter=1, **f)
    return jdesc, tdesc


def _assert_same(a, b):
    a, b = convert.result_to_numpy(a), convert.result_to_numpy(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_bake_with_mesh_matches_jax(case):
    """test_parallel.py:223/:264/:297: ot.bake(desc, mesh=8 CPU slots) is
    byte-equal to omm.bake(backend="pallas", mesh=8 devices), to the
    numpy backend and to the meshless port bake."""
    jdesc, tdesc = _descs(case)
    got = ot.bake(tdesc, device="cpu", mesh=tshard.make_mesh(CPU8))
    want = omm.bake(jdesc, backend="pallas",
                    mesh=jax.sharding.Mesh(np.array(jax.devices()),
                                           ("omm",)))
    _assert_same(got, want)
    _assert_same(got, omm.bake(jdesc, backend="numpy"))
    _assert_same(got, ot.bake(tdesc, device="cpu"))


@pytest.mark.parametrize("mode", list(omm.TextureAddressMode),
                         ids=lambda m: m.name)
def test_mesh_selection_matches_jax_item_test(mode):
    """The port's mesh bake picks its items with the batched
    host._fast_path_mask; it must pick exactly what the JAX bake's
    per-item test picks (_fast_path_ok and winding_stable,
    omm_tpu/bake.py:1152-1155): straddling, small, degenerate, sliver
    and negative-coordinate triangles, levels 2-5."""
    from omm_tpu_torch import host
    jtex = omm.Texture([standard_circle(48, 80)], omm.TextureFormat.FP32)
    ttex = convert.texture(jtex.mips, 1)
    jcfg, tcfg = _engine_cfgs(mode)
    rng = np.random.RandomState(6)
    uv = np.concatenate([
        (rng.rand(24, 3, 2) * 1.2 - 0.1).astype(np.float32),
        (rng.rand(8, 1, 2) * 0.6 + 0.2
         + rng.rand(8, 3, 2) * 0.1).astype(np.float32),
        np.array([[[0.1, 0.1], [0.4, 0.4], [0.7, 0.7]],
                  [[0.1, 0.1], [0.9, 0.1000001], [0.5, 0.1]],
                  [[-0.2, -0.3], [-0.1, 0.2], [0.3, -0.1]]], np.float32)])
    for level in (2, 3, 5):
        lg = jtp._group_level(jtex, list(uv), level)
        want = [jtp._fast_path_ok(jtex, jcfg, t, level, lg)
                and bool(geom.winding_stable(t, level)) for t in uv]
        got = host._fast_path_mask(ttex, tcfg, uv, level, lg)
        assert got.tolist() == want
        assert 0 < sum(want) < len(uv)


def test_mesh_bake_counts_equal_meshless():
    """Launch and route counts after a threaded mesh bake (8 slots, and 4
    slots of a repeated device) equal the meshless bake's, on a mesh
    whose 8 eligible items need no padding (a padded mesh bake also
    classifies the copies it pads with)."""
    plane = standard_circle(128, 128)
    tdesc = convert.bake_input([plane], 1, **_mesh_fields(
        8, 8, (0.4, 0.0, [0.05, 0.45], [0.45, 0.4]),
        more_tris=[[[0.2, 0.2], [0.4, 0.4], [0.6, 0.6]]]))
    ot.reset_launches()
    ot.bake(tdesc, device="cpu")
    want = ot.launches()
    assert want["route.fast_path"] == 8 and want["route.degenerate"] == 1
    for mesh in (CPU8, ["cpu"] * 4):
        ot.reset_launches()
        ot.bake(tdesc, device="cpu", mesh=tshard.make_mesh(mesh))
        assert ot.launches() == want


def test_make_mesh():
    mesh = tshard.make_mesh(["cpu", torch.device("cpu")])
    assert mesh.size == 2 and mesh.axis == tshard.OMM_AXIS
    assert mesh.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        tshard.make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tshard.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tshard.make_mesh(["cuda:0"])


def test_slot_failure_raises():
    """A failing slot raises from the call, after every slot ran."""
    ran = []

    def fn(dev, lo, hi):
        ran.append(lo)
        if lo == 2:
            raise RuntimeError("slot 1 failed")
        return lo

    with pytest.raises(RuntimeError, match="slot 1 failed"):
        tshard._map_slots(tshard.make_mesh(["cpu"] * 4), fn, 8)
    assert sorted(ran) == [0, 2, 4, 6]


def _hammer(fn, threads=16, reps=2000):
    """fn() reps times in each of `threads` threads, with a short switch
    interval so that unlocked read-modify-writes would interleave."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [fn() for _ in range(reps)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    return threads * reps


def test_counts_add_up_across_threads():
    """Launch and route counts from many threads add up exactly, and
    launches() / reset_launches() hold the same lock."""
    ot.reset_launches()
    n = _hammer(exact.count_launch)
    m = _hammer(lambda: routes.count("fast_path", 3))
    got = ot.launches()
    assert got["exact_classify"] == n
    assert got["route.fast_path"] == 3 * m
    ot.reset_launches()
    assert set(ot.launches().values()) == {0}


def test_tex_cache_is_created_once_across_threads():
    """Threads that ask for a texture's cache at once share one dict."""
    tex = ot.Texture([np.zeros((4, 4), np.float32)], ot.TextureFormat.FP32)
    seen = []
    barrier = threading.Barrier(16)

    def ask():
        barrier.wait(timeout=30)
        seen.append(tplanes.tex_cache(tex, "cpu"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=ask) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert len(seen) == 16 and all(c is seen[0] for c in seen)
