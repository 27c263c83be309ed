"""omm_tpu_torch.gpu on the CPU against omm_tpu.gpu: the dispatch chain's
results, post-dispatch info, pre-dispatch plans, batching and recorded
command streams.

Each test builds the JAX package's DispatchConfigDesc and the port's
(through convert.dispatch_config) from the same numpy arrays and integer
enum values, runs the port's `Pipeline().dispatch(cfg, device="cpu")`
and the JAX package's `dispatch(cfg, backend=...)`, and compares the
results as convert.result_to_numpy gives them and the PostDispatchInfos
as convert.post_to_dict gives them, byte for byte.  The cases follow
tests/test_gpu_baker.py (its fixture matrix, the reference suite's
circle statistics, the packaging flags, setup before build, scratch
batching, the RHI) and the GPU leg of tests/test_differential_fuzz.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu import engine as jengine  # noqa: E402
from omm_tpu import gpu as jgpu  # noqa: E402
from omm_tpu_torch import convert, twophase  # noqa: E402
from omm_tpu_torch import gpu as tgpu  # noqa: E402
from omm_tpu_torch.types import BakeError, Result  # noqa: E402

from fixtures import (hexagons, mandelbrot, sine_fp32,  # noqa: E402
                      standard_circle)
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

_JENUMS = {"bake_flags": jgpu.GpuBakeFlags, "global_format": omm.Format,
           "unknown_state_promotion": omm.UnknownStatePromotion,
           "alpha_cutoff_less_equal": omm.OpacityState,
           "alpha_cutoff_greater": omm.OpacityState}

QUAD_TC = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
QUAD_IB = np.array([0, 1, 2, 3, 1, 2], np.uint32)


def _cfgs(planes, tex_fmt=1, sampler=None, **fields):
    """The JAX package's DispatchConfigDesc and the port's, from the same
    numpy planes, arrays and integer enum values."""
    sampler = sampler or {}
    jsampler = omm.SamplerDesc()
    if "addressing_mode" in sampler:
        jsampler.addressing_mode = omm.TextureAddressMode(
            sampler["addressing_mode"])
    if "filter" in sampler:
        jsampler.filter = omm.TextureFilterMode(sampler["filter"])
    jsampler.border_alpha = float(sampler.get("border_alpha", 0.0))
    jcfg = jgpu.DispatchConfigDesc(
        alpha_texture=omm.Texture(planes, omm.TextureFormat(tex_fmt)),
        runtime_sampler=jsampler,
        **{k: _JENUMS[k](int(v)) if k in _JENUMS else v
           for k, v in fields.items()})
    return jcfg, convert.dispatch_config(planes, tex_fmt, **sampler,
                                         **fields)


def _quad(plane, subdiv, **fields):
    """Both packages' configs of test_gpu_baker's two-triangle quad."""
    kw = dict(tex_coords=QUAD_TC, index_buffer=QUAD_IB, index_count=6,
              max_subdivision_level=subdiv, dynamic_subdivision_scale=0.0)
    kw.update(fields)
    return _cfgs([plane], **kw)


def assert_same(jout, tout):
    """(BakeResult or None, PostDispatchInfo) of each package: equal."""
    (rj, pj), (rt, pt) = jout, tout
    assert (rj is None) == (rt is None)
    if rj is not None:
        a, b = convert.result_to_numpy(rj), convert.result_to_numpy(rt)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert convert.post_to_dict(pj) == convert.post_to_dict(pt)


def _both(jcfg, tcfg, backend="numpy", jpipe=None, tpipe=None):
    """Dispatch and execute each package's chain; the outputs must be
    equal.  Returns the port's (BakeResult, PostDispatchInfo)."""
    jout = (jpipe or jgpu.Pipeline()).dispatch(jcfg, backend=backend).execute()
    tout = (tpipe or tgpu.Pipeline()).dispatch(tcfg, device="cpu").execute()
    assert_same(jout, tout)
    return tout


def _counts(res):
    s = ot.get_stats(res)
    return (s.total_opaque, s.total_transparent, s.total_unknown_transparent,
            s.total_unknown_opaque)


# ---------------------------------------------------------------------------
# The fixture matrix of tests/test_gpu_baker.py: 11 variants x 4 channels
# of one RGBA texture
# ---------------------------------------------------------------------------

_CHANNEL_FIXTURES = {0: standard_circle, 1: sine_fp32, 2: mandelbrot,
                     3: hexagons}

_MATRIX_VARIANTS = {
    "default": 0, "compute_only": 4, "setup_before_build": 0,
    "no_special": 16, "post_stats": 8, "force32": 64, "no_dedup": 32,
    "uint16_indices": 0, "no_special_force32": 16 | 64,
    "stats_compute_only": 8 | 4, "no_level_line": 128}


@pytest.fixture(scope="module")
def rgba():
    return np.stack([_CHANNEL_FIXTURES[c](128, 128)
                     for c in sorted(_CHANNEL_FIXTURES)], axis=-1)


@pytest.mark.parametrize("channel", sorted(_CHANNEL_FIXTURES))
@pytest.mark.parametrize("variant", sorted(_MATRIX_VARIANTS))
def test_gpu_fixture_matrix(variant, channel, rgba):
    tc = np.array([[0.07, 0.03], [0.06, 0.92], [0.96, 0.04], [0.9, 0.9]],
                  np.float32)
    ib = QUAD_IB.astype(np.uint16) if variant == "uint16_indices" \
        else QUAD_IB
    base = dict(alpha_texture_channel=channel, tex_coords=tc,
                index_buffer=ib, index_count=6, max_subdivision_level=3,
                dynamic_subdivision_scale=0.0)
    ot.reset_launches()
    if variant == "setup_before_build":
        jp, tp = jgpu.Pipeline(), tgpu.Pipeline()
        _both(*_cfgs([rgba], bake_flags=1, **base), jpipe=jp, tpipe=tp)
        res, _ = _both(*_cfgs([rgba], bake_flags=2, **base), jpipe=jp,
                       tpipe=tp)
    else:
        res, post = _both(*_cfgs(
            [rgba], bake_flags=3 | _MATRIX_VARIANTS[variant], **base))
    assert sum(_counts(res)) == 2 * 4 ** 3
    route = "host_engine" if variant == "no_level_line" else "fast_path"
    assert ot.launches()[f"route.{route}"] == 2


# ---------------------------------------------------------------------------
# The reference suite's statistics and the packaging flags
# ---------------------------------------------------------------------------

def test_gpu_circle():
    """test_gpu_baker.test_gpu_circle's reference statistics
    (test_omm_bake_gpu.cpp:897-921) through the port, with the post-
    dispatch stats of test_gpu_post_dispatch_stats."""
    res, post = _both(*_quad(standard_circle(1024, 1024), 4,
                             bake_flags=3 | 8))
    assert _counts(res) == (204, 219, 0, 89)
    assert post.out_stats_total_opaque_count == 204
    assert post.out_stats_total_unknown_count == 89
    assert post.out_omm_array_size_in_bytes == len(res.array_data)


def _mesh(n, seed, spread=0.5, size=0.4):
    rng = np.random.RandomState(seed)
    tc = (rng.rand(n, 1, 2) * spread
          + rng.rand(n, 3, 2) * size).astype(np.float32).reshape(-1, 2)
    return tc, np.arange(3 * n, dtype=np.uint32)


PACKAGING = {
    # planes, subdivision, fields, the port's index format and a check
    "disable_special": (lambda: np.full((64, 64), 0.9, np.float32), 2,
                        dict(bake_flags=3 | 16), 0,
                        lambda r: (r.index_buffer >= 0).all()),
    "special_indices": (lambda: np.full((64, 64), 0.9, np.float32), 2,
                        dict(bake_flags=3), 0,
                        lambda r: (r.index_buffer == -2).all()),
    "dedup": (lambda: standard_circle(128, 128), 3, dict(
        tex_coords=np.concatenate([QUAD_TC, QUAD_TC]),
        index_buffer=np.array([0, 1, 2, 3, 1, 2, 4, 5, 6], np.uint32),
        index_count=9), 0, lambda r: len(r.desc_array) == 2),
    "no_dedup": (lambda: standard_circle(128, 128), 3, dict(
        tex_coords=np.concatenate([QUAD_TC, QUAD_TC]),
        index_buffer=np.array([0, 1, 2, 3, 1, 2, 4, 5, 6], np.uint32),
        index_count=9, bake_flags=3 | 32), 0,
        lambda r: len(r.desc_array) == 3),
    "level_buffer": (lambda: standard_circle(128, 128), 4, dict(
        enable_subdivision_level_buffer=True, bake_flags=3 | 16,
        subdivision_levels=np.array([1, 3], np.int8)), 0,
        lambda r: sorted(d.subdivision_level for d in r.desc_array)
        == [1, 3]),
    "level_buffer_max_and_heuristic": (lambda: standard_circle(128, 128), 5,
                                       dict(enable_subdivision_level_buffer=True,
                                            bake_flags=3 | 16,
                                            dynamic_subdivision_scale=8.0,
                                            subdivision_levels=np.array(
                                                [255, 254], np.uint8)), 0,
                                       lambda r: sorted(
                                           d.subdivision_level
                                           for d in r.desc_array) == [3, 5]),
    "allow8": (lambda: standard_circle(128, 128), 3, dict(bake_flags=3 | 512),
               2, lambda r: True),
    "force32": (lambda: standard_circle(128, 128), 3, dict(bake_flags=3 | 64),
                1, lambda r: True),
    "force32_over_allow8": (lambda: standard_circle(128, 128), 3,
                            dict(bake_flags=3 | 64 | 512), 1,
                            lambda r: True),
    "allow8_over_127_tris": (lambda: standard_circle(64, 64), 1, dict(
        zip(("tex_coords", "index_buffer"), _mesh(130, 3)),
        index_count=390, bake_flags=3 | 512), 0,
        lambda r: r.index_count == 130),
}


@pytest.mark.parametrize("case", sorted(PACKAGING))
def test_gpu_packaging_flags(case):
    """Special indices, texcoord dedup, the subdivision-level buffer
    (levels, -1 = the maximum, -2 = the area heuristic) and the index
    formats (UINT_8 / UINT_16 / UINT_32, Allow8BitIndices,
    Force32BitIndices): byte-equal to the numpy backend, the port's
    pre-dispatch index format equal to the result's."""
    mk, subdiv, fields, fmt, check = PACKAGING[case]
    fields = dict(fields)
    if "tex_coords" in fields:
        jcfg, tcfg = _cfgs([mk()], max_subdivision_level=subdiv,
                           **{"dynamic_subdivision_scale": 0.0, **fields})
    else:
        jcfg, tcfg = _quad(mk(), subdiv, **fields)
    res, _ = _both(jcfg, tcfg)
    assert int(res.index_format) == fmt
    assert int(tgpu.Pipeline().get_pre_dispatch_info(
        tcfg).out_omm_index_buffer_format) == fmt
    assert check(res)


def test_gpu_disable_level_line_is_triangle_footprint():
    """DisableLevelLineIntersection takes the conservative-bilinear test
    over the rasterized triangle (the JAX engine's enable_aabb_testing=
    False), not the AABB split: the port's result is byte-equal to the
    numpy backend, and its counts are the triangle footprint's."""
    plane = standard_circle(128, 128)
    tc = np.array([[0.07, 0.03], [0.06, 0.92], [0.96, 0.04]], np.float32)
    jcfg, tcfg = _cfgs([plane], tex_coords=tc,
                       index_buffer=np.arange(3, dtype=np.uint32),
                       index_count=3, max_subdivision_level=4,
                       dynamic_subdivision_scale=0.0,
                       bake_flags=3 | 128 | 16)
    ot.reset_launches()
    res, _ = _both(jcfg, tcfg)
    assert ot.launches()["route.host_engine"] == 1
    base = dict(addr_mode=omm.TextureAddressMode.Clamp,
                filter=omm.TextureFilterMode.Linear, alpha_cutoff=0.5,
                border_alpha=0.0, fmt=omm.Format.OC1_4_State,
                promotion=omm.UnknownStatePromotion.ForceOpaque,
                cutoff_gt=omm.OpacityState.Opaque,
                cutoff_le=omm.OpacityState.Transparent,
                disable_level_line=True)
    M = 4 ** 4
    tex = omm.Texture([plane], omm.TextureFormat.FP32)
    counts = {}
    for aabb in (False, True):
        st = jengine.resample_fine_item(
            tex, jengine.ResampleConfig(**base, enable_aabb_testing=aabb),
            tc, 4, np.full(M, 3, np.uint8))
        cnt = np.bincount(st, minlength=4)
        counts[aabb] = (int(cnt[1]), int(cnt[0]), int(cnt[2]), int(cnt[3]))
    assert counts[False] != counts[True]
    assert _counts(res) == counts[False]


def test_gpu_rgba_channel_out_of_range():
    rgba = np.zeros((32, 32, 4), np.float32)
    _, tcfg = _cfgs([rgba], alpha_texture_channel=4,
                    tex_coords=np.array([[0, 0], [0, 1], [1, 0]], np.float32),
                    index_buffer=np.arange(3, dtype=np.uint32),
                    index_count=3, max_subdivision_level=2,
                    dynamic_subdivision_scale=0.0)
    with pytest.raises(BakeError) as ei:
        tgpu.Pipeline().dispatch(tcfg, device="cpu")
    assert ei.value.result == Result.INVALID_ARGUMENT


def test_gpu_rgba_channel_equals_single_plane(rgba):
    """An RGBA dispatch of channel 2 is byte-equal to a dispatch of that
    plane alone."""
    fields = dict(alpha_texture_channel=2, tex_coords=QUAD_TC,
                  index_buffer=QUAD_IB, index_count=6,
                  max_subdivision_level=4, dynamic_subdivision_scale=0.0)
    got = tgpu.Pipeline().dispatch(convert.dispatch_config(
        [rgba], 1, **fields), device="cpu").execute()
    want = tgpu.Pipeline().dispatch(convert.dispatch_config(
        [np.ascontiguousarray(rgba[..., 2])], 1, **fields),
        device="cpu").execute()
    assert_same(want, got)


# ---------------------------------------------------------------------------
# Setup before build, scratch batching
# ---------------------------------------------------------------------------

def test_gpu_setup_before_build_split():
    """PerformSetup then PerformBake on one Pipeline equals
    PerformSetupAndBake; the bake-only dispatch repeats (the stored setup
    is baked on copies); bake-only without a setup is INVALID_ARGUMENT.
    The chains' passes equal the JAX package's."""
    plane = standard_circle(32, 32)
    ref = _both(*_quad(plane, 4))
    jp, tp = jgpu.Pipeline(), tgpu.Pipeline()
    with pytest.raises(BakeError) as ei:
        tp.dispatch(_quad(plane, 4, bake_flags=2)[1], device="cpu").execute()
    assert ei.value.result == Result.INVALID_ARGUMENT
    jcfg, tcfg = _quad(plane, 4, bake_flags=1)
    none_res, post_s = _both(jcfg, tcfg, jpipe=jp, tpipe=tp)
    assert none_res is None and post_s.out_omm_desc_size_in_bytes > 0
    jcfg, tcfg = _quad(plane, 4, bake_flags=2)
    for _ in range(2):
        jchain = jp.dispatch(jcfg, backend="numpy")
        tchain = tp.dispatch(tcfg, device="cpu")
        assert [p.label for p in tchain.passes] == \
            [p.label for p in jchain.passes]
        assert not any(p.label == "WorkSetup" for p in tchain.passes)
        out = tchain.execute()
        assert_same(jchain.execute(), out)
        assert_same(ref, out)
    stored = next(iter(tp._setup_store.values()))
    assert all(getattr(it, "_fresh", False) and it.special_index == 0
               for it in stored)


def test_gpu_insufficient_scratch_memory():
    """A budget below one primitive's scratch raises
    INSUFFICIENT_SCRATCH_MEMORY in both packages."""
    jcfg, tcfg = _quad(standard_circle(64, 64), 12,
                       max_scratch_memory_size=int(
                           tgpu.ScratchMemoryBudget.MB_4))
    with pytest.raises(omm.BakeError) as je:
        jgpu.Pipeline().get_pre_dispatch_info(jcfg)
    with pytest.raises(BakeError) as te:
        tgpu.Pipeline().get_pre_dispatch_info(tcfg)
    with pytest.raises(BakeError):
        tgpu.Pipeline().dispatch(tcfg, device="cpu")
    assert int(te.value.result) == int(je.value.result) == int(
        Result.INSUFFICIENT_SCRATCH_MEMORY)
    assert str(te.value) == str(je.value)


def _quads(n_quads=8):
    rng = np.random.RandomState(4)
    quads, ib = [], []
    for q in range(n_quads):
        b = rng.rand(2).astype(np.float32) * 0.5
        quads += [b, b + [0, 0.4], b + [0.4, 0], b + [0.4, 0.4]]
        k = 4 * q
        ib += [k, k + 1, k + 2, k + 3, k + 1, k + 2]
    return dict(tex_coords=np.asarray(quads, np.float32),
                index_buffer=np.asarray(ib, np.uint32), index_count=len(ib))


TINY = 4 * 4 ** 4 * 8  # four subdivision-4 primitives of scratch

BATCHING = {
    "one_batch": dict(),
    "tiny_budget": dict(max_scratch_memory_size=TINY),
    "nsight": dict(bake_flags=3 | 256),
}


@pytest.mark.parametrize("case", sorted(BATCHING))
def test_gpu_scratch_batches(case):
    """Scratch batching executed: the port's results, post and
    last_dispatch_stats (batch count, live scratch, pools) equal the JAX
    package's; every batching gives the one-batch result."""
    plane = standard_circle(128, 128)
    fields = dict(_quads(), max_subdivision_level=4,
                  dynamic_subdivision_scale=0.0, **BATCHING[case])
    jp, tp = jgpu.Pipeline(), tgpu.Pipeline()
    out = _both(*_cfgs([plane], **fields), jpipe=jp, tpipe=tp)
    assert tp.last_dispatch_stats == jp.last_dispatch_stats
    batches = tp.last_dispatch_stats["batch_count"]
    assert batches == {"one_batch": 1, "tiny_budget": 4,
                       "nsight": 16}[case]
    assert tp.last_dispatch_stats["max_live_scratch_bytes"] <= \
        tp.last_dispatch_stats["transient_pool_sizes"][0]
    if case != "one_batch":
        one = tgpu.Pipeline().dispatch(convert.dispatch_config(
            [plane], 1, **_quads(), max_subdivision_level=4,
            dynamic_subdivision_scale=0.0), device="cpu").execute()
        assert_same(one, out)


PRE = {
    "quad": lambda: dict(tex_coords=QUAD_TC, index_buffer=QUAD_IB,
                         index_count=6, max_subdivision_level=4,
                         dynamic_subdivision_scale=0.0),
    "mesh_level9_mb4": lambda: dict(
        zip(("tex_coords", "index_buffer"), _mesh(1000, 0)),
        index_count=3000, max_subdivision_level=9,
        dynamic_subdivision_scale=0.0,
        max_scratch_memory_size=4 << 20),
    "mesh_heuristic_2state": lambda: dict(
        zip(("tex_coords", "index_buffer"), _mesh(40, 1)),
        index_count=120, max_subdivision_level=7,
        dynamic_subdivision_scale=2.0, global_format=1,
        max_out_omm_array_size=300),
    "nsight_allow8": lambda: dict(
        zip(("tex_coords", "index_buffer"), _mesh(10, 2)),
        index_count=30, max_subdivision_level=6,
        dynamic_subdivision_scale=0.0, bake_flags=3 | 256 | 512),
    "force32_level_buffer": lambda: dict(
        zip(("tex_coords", "index_buffer"), _mesh(6, 3)),
        index_count=18, max_subdivision_level=5,
        dynamic_subdivision_scale=3.0, bake_flags=3 | 64,
        enable_subdivision_level_buffer=True,
        subdivision_levels=np.array([0, 255, 254, 12, 3, 7], np.uint8),
        max_scratch_memory_size=1024 << 20),
}


@pytest.mark.parametrize("case", sorted(PRE))
def test_gpu_pre_dispatch_info(case):
    """get_pre_dispatch_info equal field by field, and the per-primitive
    levels and batch ranges the chain is built from."""
    jcfg, tcfg = _cfgs([standard_circle(64, 64)], **PRE[case]())
    jp, tp = jgpu.Pipeline(), tgpu.Pipeline()
    ji, ti = jp.get_pre_dispatch_info(jcfg), tp.get_pre_dispatch_info(tcfg)
    for f in dataclasses.fields(ji):
        a, b = getattr(ji, f.name), getattr(ti, f.name)
        assert (tuple(a) == tuple(b) if isinstance(a, tuple)
                else int(a) == int(b)), f.name
    levels = tp._subdiv_levels(tcfg)
    assert np.array_equal(levels, jp._subdiv_levels(jcfg))
    assert tp._batch_ranges(tcfg, levels) == jp._batch_ranges(jcfg, levels)


def test_gpu_pipeline_desc():
    want = jgpu.Pipeline().get_pipeline_desc()
    got = tgpu.Pipeline().get_pipeline_desc()
    assert got["passes"] == want["passes"] == tgpu.baker.PIPELINE_PASS_NAMES
    assert got["static_samplers"] == want["static_samplers"]
    assert got["render_api"] == "cuda"


# ---------------------------------------------------------------------------
# The recorded command stream (RecordingRHI)
# ---------------------------------------------------------------------------

def _stream(rec):
    """A recorded command list with ResourceRanges as tuples."""
    out = []
    for c in rec.commands:
        if c[0] == "bind":
            out.append(("bind", tuple(dataclasses.astuple(r) for r in c[1])))
        else:
            out.append(c)
    return out


@pytest.mark.parametrize("budget", [None, TINY], ids=["single", "multi"])
def test_rhi_command_streams_equal(budget):
    fields = dict(_quads(), max_subdivision_level=4,
                  dynamic_subdivision_scale=0.0)
    if budget:
        fields["max_scratch_memory_size"] = budget
    jcfg, tcfg = _cfgs([standard_circle(128, 128)], **fields)
    streams = []
    for mod, cfg, kw in ((jgpu, jcfg, dict(backend="numpy")),
                         (tgpu, tcfg, dict(device="cpu"))):
        pipe = mod.Pipeline()
        info = pipe.get_pre_dispatch_info(cfg)
        chain = pipe.dispatch(cfg, **kw)
        rec = mod.RecordingRHI(info.transient_pool_buffer_sizes)
        mod.record_chain(chain, rec)
        assert rec.labels == [p.label for p in chain.passes]
        assert rec.dispatch_count == len(chain.passes)
        assert all(hw <= s for hw, s in zip(
            rec.high_water, info.transient_pool_buffer_sizes))
        streams.append((_stream(rec), rec.high_water))
    assert streams[0] == streams[1]
    labels = [c[1] for c in streams[1][0] if c[0] == "begin_label"]
    assert any(lb.startswith("Batch 1 ") for lb in labels) == bool(budget)
    assert any(c[0] == "barrier" for c in streams[1][0])


def test_rhi_validation_rejects_bad_plans():
    """tests/test_gpu_baker.py's validation rules on the port's copy,
    with the unknown-pool and bind-without-dispatch rules."""
    mod = tgpu
    rec = mod.RecordingRHI((64, 64))
    with pytest.raises(ValueError, match="out of bounds"):
        rec.bind([mod.ResourceRange(0, 32, 64, "x")])
    with pytest.raises(ValueError, match="overlap"):
        rec.bind([mod.ResourceRange(0, 0, 32, "a"),
                  mod.ResourceRange(0, 16, 32, "b")])
    with pytest.raises(ValueError, match="unknown pool"):
        rec.bind([mod.ResourceRange(2, 0, 8, "c")])
    rec.bind([mod.ResourceRange(0, 0, 32, "a", "r"),
              mod.ResourceRange(0, 16, 32, "b", "r")])
    with pytest.raises(ValueError, match="without an intervening"):
        rec.bind([mod.ResourceRange(1, 0, 8, "d")])
    rec.begin_label("open")
    with pytest.raises(ValueError, match="unclosed"):
        rec.finish()
    with pytest.raises(ValueError, match="without begin"):
        mod.RecordingRHI((8,)).end_label()


# ---------------------------------------------------------------------------
# The engines: against the jax backend, and the exact stage's selector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [3, 3 | 4], ids=["default", "compute_only"])
def test_gpu_equals_jax_backend(flags):
    """The port's default and ComputeOnly engines against the JAX
    package's jax backend (its Pallas and XLA exact stages), 256^2
    circle at subdivision 4."""
    _both(*_quad(standard_circle(256, 256), 4, bake_flags=flags),
          backend="jax")


def _record_exact(monkeypatch):
    """Record the exact= keyword of every exact-stage call (the stage's
    one call site is twophase.stage_c_mip's `exact_counts`)."""
    seen = []
    orig = twophase.exact_counts

    def spy(*args, **kw):
        seen.append(kw.get("exact"))
        return orig(*args, **kw)

    monkeypatch.setattr(twophase, "exact_counts", spy)
    return seen


SELECTOR = {"default": (3, None), "compute_only": (3 | 4, "torch"),
            "bake": (None, None)}


@pytest.mark.parametrize("case", sorted(SELECTOR))
def test_exact_engine_selector(case, monkeypatch):
    """A default dispatch passes only exact=None to the exact stage, a
    ComputeOnly dispatch only "torch", and ot.bake only None."""
    flags, want = SELECTOR[case]
    seen = _record_exact(monkeypatch)
    plane = standard_circle(128, 128)
    if flags is None:
        ot.bake(convert.bake_input([plane], 1, tex_coords=QUAD_TC,
                                   index_buffer=QUAD_IB, index_count=6,
                                   max_subdivision_level=3,
                                   dynamic_subdivision_scale=0.0),
                device="cpu")
    else:
        tgpu.Pipeline().dispatch(_quad(plane, 3, bake_flags=flags)[1],
                                 device="cpu").execute()
    assert seen and set(seen) == {want}


def test_dispatch_default_device_is_the_card(monkeypatch):
    """dispatch() runs on "cuda" unless told otherwise and raises where
    there is no card, at dispatch: never a CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _quad(standard_circle(64, 64), 2)
    for kw in ({}, {"device": "cuda:0"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgpu.Pipeline().dispatch(tcfg, **kw)
    tgpu.Pipeline().dispatch(tcfg, device="cpu").execute()


# ---------------------------------------------------------------------------
# Seeded fuzz leg (tests/test_differential_fuzz.py's GPU route)
# ---------------------------------------------------------------------------

def _fuzz_planes(rng):
    h, w = ((32, 32), (64, 64), (64, 32), (48, 48))[rng.randint(4)]
    base = rng.rand(h, w).astype(np.float32)
    kind = rng.randint(3)
    if kind == 1:
        base = (base > 0.5).astype(np.float32)
    elif kind == 2:
        j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                           np.arange(w, dtype=np.float32), indexing="ij")
        r = np.hypot(i / w - 0.5, j / h - 0.5)
        base = np.clip((np.float32(0.4) - r) / np.float32(0.15), 0.0,
                       1.0).astype(np.float32)
    mips = [base]
    if rng.randint(2):
        mips.append(base[::2, ::2].copy())
    fmt = 1
    if rng.randint(3) == 0:
        mips, fmt = [np.round(m * 255).astype(np.uint8) for m in mips], 0
    chan = 3
    if rng.randint(2):  # an RGBA texture, one channel selected
        chan = int(rng.randint(4))
        mips = [np.stack([m if c == chan else np.roll(m, c + 1, axis=1)
                          for c in range(4)], axis=-1) for m in mips]
    return mips, fmt, chan


def _fuzz_geometry(rng):
    tris = []
    for _ in range(1 + rng.randint(5)):
        b = rng.rand(2).astype(np.float32) * 0.6
        t = np.stack([b + rng.rand(2).astype(np.float32) * 0.5
                      for _ in range(3)]).astype(np.float32)
        kind = rng.randint(6)
        if kind == 0:    # multi-repeat
            t = t * np.float32(1 + rng.randint(3)) \
                - rng.rand(2).astype(np.float32)
        elif kind == 1:  # line
            d = rng.rand(2).astype(np.float32) * 0.5
            t = np.stack([b, b + d, b + np.float32(2) * d])
            t[:, rng.randint(2)] = b[0]
        elif kind == 2:  # CW
            t = t[::-1]
        tris.append(np.ascontiguousarray(t, np.float32))
    if rng.randint(2):  # an exact duplicate for the setup's dedup
        tris.append(tris[0].copy())
    return tris


def _fuzz_case(seed):
    rng = np.random.RandomState(99500 + seed)
    planes, fmt, chan = _fuzz_planes(rng)
    tris = _fuzz_geometry(rng)
    n = len(tris)
    max_level = int(rng.randint(1, 6))
    fields = dict(
        alpha_texture_channel=chan, tex_coords=np.concatenate(tris),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        alpha_cutoff=0.5, max_subdivision_level=max_level,
        dynamic_subdivision_scale=[0.0, 2.0][rng.randint(2)],
        global_format=1 if rng.randint(3) == 0 else 2,
        unknown_state_promotion=int(rng.randint(3)),
        bake_flags=3 | (4 if seed % 2 else 0)
        | (128 if seed % 3 == 2 else 0)
        | (16 if rng.randint(3) == 0 else 0))
    if rng.randint(2):
        fields["enable_subdivision_level_buffer"] = True
        fields["subdivision_levels"] = np.array(
            [rng.choice([0, max_level, 255, 254]) for _ in range(n)],
            np.uint8)
    if fields["global_format"] == 2 and rng.randint(2):
        fields["alpha_cutoff_less_equal"] = int(rng.randint(4))
        fields["alpha_cutoff_greater"] = int(rng.randint(4))
    sampler = dict(addressing_mode=int(rng.randint(5)),
                   filter=int(seed % 3 != 0), border_alpha=float(rng.rand()))
    return planes, fmt, sampler, fields


@pytest.mark.parametrize("seed", range(6))
def test_gpu_fuzz_vs_numpy(seed):
    planes, fmt, sampler, fields = _fuzz_case(seed)
    _both(*_cfgs(planes, fmt, sampler=sampler, **fields))


def test_gpu_fuzz_draws_every_route():
    """The fuzz corpus is not vacuous: the port's dispatches take the
    two-phase engine, the AABB-kernel pass, the nearest filter's pass and
    the line-triangle pass, on both engines."""
    ot.reset_launches()
    flags = set()
    for seed in range(6):
        planes, fmt, sampler, fields = _fuzz_case(seed)
        flags.add(fields["bake_flags"] & 4)
        tgpu.Pipeline().dispatch(convert.dispatch_config(
            planes, fmt, **sampler, **fields), device="cpu").execute()
    taken = {k for k, v in ot.launches().items() if v}
    assert flags == {0, 4}
    assert taken >= {"route.fast_path", "route.host_engine",
                     "route.degenerate"}, taken
