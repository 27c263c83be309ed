"""omm_tpu_torch.bake end to end on the CPU: byte-equal BakeResults with
omm_tpu.bake's pallas and numpy backends, the reference suite's
mandelbrot statistics, planes carried over from the JAX package's cache,
and NotImplementedError on the routes the port does not have yet."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402
from omm_tpu_torch.planes import tex_cache  # noqa: E402

from fixtures import (DEFAULT_INDICES, DEFAULT_TEXCOORDS,  # noqa: E402
                      expect_stats, mandelbrot, standard_circle)


def _bench_desc(tex, n=8, subdiv=5):
    """bench.py's workload, cut to n triangles on a smaller texture."""
    rng = np.random.RandomState(42)
    tris = []
    for _ in range(n):
        base = rng.rand(2).astype(np.float32) * 0.2
        tris.append(np.array([base + [0.05, 0.1], base + [0.1, 0.7],
                              base + [0.7, 0.65]], np.float32))
    return omm.BakeInputDesc(
        texture=tex, tex_coords=np.concatenate(tris).astype(np.float32),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        alpha_cutoff=0.5, max_subdivision_level=subdiv,
        dynamic_subdivision_scale=0.0)


def _circle_tex():
    return omm.Texture([standard_circle(128, 128)], omm.TextureFormat.FP32)


def assert_results_equal(a, b):
    assert np.array_equal(a.array_data, b.array_data)
    assert a.desc_array == b.desc_array
    assert a.index_format == b.index_format
    assert np.array_equal(a.index_buffer, b.index_buffer)
    assert a.desc_array_histogram == b.desc_array_histogram
    assert a.index_histogram == b.index_histogram


@pytest.fixture(scope="module")
def pallas_bake():
    tex = _circle_tex()
    desc = _bench_desc(tex)
    return desc, omm.bake(desc, backend="pallas")


def test_bake_equals_pallas_and_numpy(pallas_bake):
    desc, want = pallas_bake
    got = ot.bake(desc, device="cpu")
    assert_results_equal(got, want)
    assert_results_equal(got, omm.bake(desc, backend="numpy"))
    assert len(got.desc_array) > 0


def test_cache_from_numpy_round_trip(pallas_bake):
    """The JAX package's cached planes, installed as the port's state on
    a fresh texture, give the same bake; the port computes no plane of
    its own, so both packages ran on identical state."""
    desc, want = pallas_bake
    jcache = desc.texture._omm_dev_cache
    entries = {k: np.asarray(v[0] if k[0] == "tiles" else v)
               for k, v in jcache.items() if k[0] in ("tiles", "cls")}
    assert {k[0] for k in entries} == {"tiles", "cls"}
    tex2 = _circle_tex()
    assert convert.cache_from_numpy(tex2, entries, "cpu") == len(entries)
    got = ot.bake(dataclasses.replace(desc, texture=tex2), device="cpu")
    assert_results_equal(got, want)
    assert set(tex_cache(tex2, "cpu")) == set(entries)
    with pytest.raises(ValueError):
        convert.cache_from_numpy(tex2, {("cls",) + (0,) * 10: np.zeros(
            (4, 4), np.float32)}, "cpu")


@pytest.mark.parametrize("fmt", [omm.Format.OC1_4_State,
                                 omm.Format.OC1_2_State],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("mode", list(omm.TextureAddressMode),
                         ids=lambda m: m.name)
def test_bake_modes_and_formats_equal_numpy(mode, fmt):
    desc = dataclasses.replace(
        _bench_desc(_circle_tex(), n=4), format=fmt,
        runtime_sampler=omm.SamplerDesc(
            addressing_mode=mode, filter=omm.TextureFilterMode.Linear,
            border_alpha=0.7))
    assert_results_equal(ot.bake(desc, device="cpu"),
                         omm.bake(desc, backend="numpy"))


def test_bake_without_survivors_equals_numpy():
    """A uniform texture resolves every node at the first level: the
    exact stage gets no survivor."""
    tex = omm.Texture([np.full((128, 128), 0.6, np.float32)],
                      omm.TextureFormat.FP32)
    desc = _bench_desc(tex)
    assert_results_equal(ot.bake(desc, device="cpu"),
                         omm.bake(desc, backend="numpy"))


def _stats_desc(tc=None, indices=None, subdiv=5):
    tex = omm.Texture([mandelbrot(1024, 1024)], omm.TextureFormat.FP32)
    tc = DEFAULT_TEXCOORDS if tc is None else tc
    ib = DEFAULT_INDICES if indices is None else np.asarray(indices,
                                                            np.uint32)
    # the fields fixtures.bake_stats sets
    return omm.BakeInputDesc(
        texture=tex, bake_flags=omm.BakeFlags.EnableInternalThreads,
        runtime_sampler=omm.SamplerDesc(
            addressing_mode=omm.TextureAddressMode.Clamp,
            filter=omm.TextureFilterMode.Linear),
        alpha_mode=omm.AlphaMode.Test,
        tex_coord_format=omm.TexCoordFormat.UV32_FLOAT, tex_coords=tc,
        index_format=omm.IndexFormat.UINT_32, index_buffer=ib,
        index_count=len(ib), alpha_cutoff=0.5,
        format=omm.Format.OC1_4_State,
        unknown_state_promotion=omm.UnknownStatePromotion.Nearest,
        max_subdivision_level=subdiv, dynamic_subdivision_scale=0.0,
        unresolved_tri_state=omm.SpecialIndex.FullyUnknownOpaque,
        alpha_cutoff_less_equal=omm.OpacityState.Transparent,
        alpha_cutoff_greater=omm.OpacityState.Opaque)


def test_mandelbrot():
    """test_bake_oracles.test_mandelbrot through the port."""
    expect_stats(omm.get_stats(ot.bake(_stats_desc(), device="cpu")),
                 total_opaque=1212, total_transparent=484,
                 total_unknown_transparent=124, total_unknown_opaque=228)


def test_mandelbrot2():
    """test_bake_oracles.test_mandelbrot2 through the port."""
    tc = np.array([[0.2, 0.0], [0.1, 0.8], [0.9, 0.1]], dtype=np.float32)
    expect_stats(omm.get_stats(ot.bake(_stats_desc(tc, [0, 1, 2]),
                                       device="cpu")),
                 total_opaque=521, total_transparent=286,
                 total_unknown_transparent=82, total_unknown_opaque=135)


def test_nearest_filter_not_implemented():
    desc = dataclasses.replace(
        _bench_desc(_circle_tex(), n=2),
        runtime_sampler=omm.SamplerDesc(
            filter=omm.TextureFilterMode.Nearest))
    with pytest.raises(NotImplementedError, match="nearest"):
        ot.bake(desc, device="cpu")


def test_degenerate_triangle_not_implemented():
    tc = np.array([[0.1, 0.1], [0.1, 0.1], [0.7, 0.3]], np.float32)
    desc = omm.BakeInputDesc(
        texture=_circle_tex(), tex_coords=tc,
        index_buffer=np.arange(3, dtype=np.uint32), index_count=3,
        alpha_cutoff=0.5, max_subdivision_level=4,
        dynamic_subdivision_scale=0.0)
    with pytest.raises(NotImplementedError, match="degenerate"):
        ot.bake(desc, device="cpu")


def test_circle_quad_off_fast_path_not_implemented():
    """test_bake_oracles.test_circle's level-4 quad: its micro-triangle
    windows (68 texels) exceed the exact stage's tile."""
    tex = omm.Texture([standard_circle(1024, 1024)], omm.TextureFormat.FP32)
    desc = omm.BakeInputDesc(
        texture=tex, tex_coords=DEFAULT_TEXCOORDS,
        index_buffer=DEFAULT_INDICES, index_count=6, alpha_cutoff=0.5,
        max_subdivision_level=4, dynamic_subdivision_scale=0.0)
    with pytest.raises(NotImplementedError, match="window"):
        ot.bake(desc, device="cpu")
