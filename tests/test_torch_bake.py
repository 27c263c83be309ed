"""omm_tpu_torch.bake end to end on the CPU: byte-equal BakeResults with
omm_tpu.bake's pallas and numpy backends, the reference suite's
mandelbrot statistics, planes carried over from the JAX package's cache,
the routes the first slice refused (nearest filter, a line triangle,
windows beyond the exact stage's tile), and the card as the default
device.  Each test builds the JAX package's
descriptor and the port's (through convert.bake_input) from the same
numpy arrays and enum values, and compares the results as
convert.result_to_numpy gives them."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import batch, convert  # noqa: E402
from omm_tpu_torch.planes import tex_cache  # noqa: E402

from fixtures import (DEFAULT_INDICES, DEFAULT_TEXCOORDS,  # noqa: E402
                      expect_stats, mandelbrot, standard_circle)
from torch_native_guard import jax_native_pinned  # noqa: E402,F401


def _bench_fields(n=8, subdiv=5):
    """bench.py's workload, cut to n triangles (on a smaller texture)."""
    rng = np.random.RandomState(42)
    tris = []
    for _ in range(n):
        base = rng.rand(2).astype(np.float32) * 0.2
        tris.append(np.array([base + [0.05, 0.1], base + [0.1, 0.7],
                              base + [0.7, 0.65]], np.float32))
    return dict(tex_coords=np.concatenate(tris).astype(np.float32),
                index_buffer=np.arange(3 * n, dtype=np.uint32),
                index_count=3 * n, alpha_cutoff=0.5,
                max_subdivision_level=subdiv, dynamic_subdivision_scale=0.0)


def _descs(planes, tex_fmt=1, sampler=None, **fields):
    """The JAX package's descriptor and the port's, from the same numpy
    planes, arrays and integer enum values."""
    sampler = sampler or {}
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat(tex_fmt)),
        runtime_sampler=omm.SamplerDesc(**sampler), **fields)
    return jdesc, convert.bake_input(planes, tex_fmt, **sampler, **fields)


def _circle():
    return [standard_circle(128, 128)]


def assert_results_equal(a, b):
    ra, rb = convert.result_to_numpy(a), convert.result_to_numpy(b)
    assert ra.keys() == rb.keys()
    for k in ra:
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k


@pytest.fixture(scope="module")
def pallas_bake():
    jdesc, tdesc = _descs(_circle(), **_bench_fields())
    return jdesc, tdesc, omm.bake(jdesc, backend="pallas")


def test_bake_equals_pallas_and_numpy(pallas_bake):
    jdesc, tdesc, want = pallas_bake
    got = ot.bake(tdesc, device="cpu")
    assert isinstance(got, ot.BakeResult)
    assert_results_equal(got, want)
    assert_results_equal(got, omm.bake(dataclasses.replace(jdesc),
                                       backend="numpy"))
    assert len(got.desc_array) > 0


def test_cache_from_numpy_round_trip(pallas_bake):
    """The JAX package's cached planes, installed as the port's state on
    a fresh texture, give the same bake; the port computes no plane of
    its own, so both packages ran on identical state."""
    jdesc, tdesc, want = pallas_bake
    jcache = jdesc.texture._omm_dev_cache
    entries = {k: np.asarray(v[0] if k[0] == "tiles" else v)
               for k, v in jcache.items() if k[0] in ("tiles", "cls")}
    assert {k[0] for k in entries} == {"tiles", "cls"}
    tex2 = convert.texture(_circle(), 1)
    assert convert.cache_from_numpy(tex2, entries, "cpu") == len(entries)
    got = ot.bake(dataclasses.replace(tdesc, texture=tex2), device="cpu")
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
    jdesc, tdesc = _descs(
        _circle(), sampler=dict(addressing_mode=int(mode), filter=1,
                                border_alpha=0.7),
        format=int(fmt), **_bench_fields(n=4))
    assert_results_equal(ot.bake(tdesc, device="cpu"),
                         omm.bake(jdesc, backend="numpy"))


def test_bake_without_survivors_equals_numpy():
    """A uniform texture resolves every node at the first level: the
    exact stage gets no survivor."""
    jdesc, tdesc = _descs([np.full((128, 128), 0.6, np.float32)],
                          **_bench_fields())
    assert_results_equal(ot.bake(tdesc, device="cpu"),
                         omm.bake(jdesc, backend="numpy"))


def _stats_desc(tc=None, indices=None, subdiv=5):
    tc = DEFAULT_TEXCOORDS if tc is None else tc
    ib = DEFAULT_INDICES if indices is None else np.asarray(indices,
                                                            np.uint32)
    # the fields fixtures.bake_stats sets
    return convert.bake_input(
        [mandelbrot(1024, 1024)], 1, addressing_mode=2, filter=1,
        bake_flags=int(omm.BakeFlags.EnableInternalThreads),
        alpha_mode=0, tex_coord_format=2, tex_coords=tc, index_format=1,
        index_buffer=ib, index_count=len(ib), alpha_cutoff=0.5,
        format=int(omm.Format.OC1_4_State),
        unknown_state_promotion=int(omm.UnknownStatePromotion.Nearest),
        max_subdivision_level=subdiv, dynamic_subdivision_scale=0.0,
        unresolved_tri_state=int(omm.SpecialIndex.FullyUnknownOpaque),
        alpha_cutoff_less_equal=int(omm.OpacityState.Transparent),
        alpha_cutoff_greater=int(omm.OpacityState.Opaque))


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


def test_default_device_is_the_card(monkeypatch):
    """bake() and classify_work_items_batches() run on "cuda" unless told
    otherwise, and raise where there is no card: never a CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tdesc = _descs(_circle(), **_bench_fields(n=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.bake(tdesc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.bake(tdesc, device="cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.classify_work_items_batches(tdesc.texture, None, [], 5)
    assert batch.check_device("cpu") == torch.device("cpu")


def test_nearest_filter_not_implemented():
    """Once refused by the port, the nearest filter now bakes: byte-equal
    to the pallas and numpy backends."""
    jdesc, desc = _descs(_circle(), sampler=dict(filter=0),
                         **_bench_fields(n=2))
    got = ot.bake(desc, device="cpu")
    assert_results_equal(got, omm.bake(jdesc, backend="pallas"))
    assert_results_equal(got, omm.bake(dataclasses.replace(jdesc),
                                       backend="numpy"))


def test_degenerate_triangle_not_implemented():
    """Once refused by the port, a line triangle now bakes through the
    degenerate route: byte-equal to the pallas and numpy backends."""
    tc = np.array([[0.1, 0.1], [0.1, 0.1], [0.7, 0.3]], np.float32)
    fields = dict(tex_coords=tc, index_buffer=np.arange(3, dtype=np.uint32),
                  index_count=3, alpha_cutoff=0.5, max_subdivision_level=4,
                  dynamic_subdivision_scale=0.0)
    jdesc, desc = _descs(_circle(), **fields)
    got = ot.bake(desc, device="cpu")
    assert_results_equal(got, omm.bake(jdesc, backend="pallas"))
    assert_results_equal(got, omm.bake(_descs(_circle(), **fields)[0],
                                       backend="numpy"))


def test_circle_quad_off_fast_path_not_implemented():
    """test_bake_oracles.test_circle's level-4 quad: its micro-triangle
    windows (68 texels) exceed the exact stage's tile, so both items take
    the dense pass; the port gives the reference suite's statistics and
    the numpy backend's BakeResult."""
    fields = dict(tex_coords=DEFAULT_TEXCOORDS, index_buffer=DEFAULT_INDICES,
                  index_count=6, alpha_cutoff=0.5, max_subdivision_level=4,
                  dynamic_subdivision_scale=0.0,
                  unknown_state_promotion=int(
                      omm.UnknownStatePromotion.Nearest))
    planes = [standard_circle(1024, 1024)]
    jdesc, desc = _descs(planes, sampler=dict(addressing_mode=2, filter=1),
                         **fields)
    got = ot.bake(desc, device="cpu")
    expect_stats(omm.get_stats(got), total_opaque=204, total_transparent=219,
                 total_unknown_transparent=39, total_unknown_opaque=50)
    assert_results_equal(got, omm.bake(jdesc, backend="numpy"))
