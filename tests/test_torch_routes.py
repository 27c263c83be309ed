"""omm_tpu_torch.bake on the routes off the two-phase engine's fast path,
end to end on the CPU: the nearest filter under every address mode and
both formats, multi-mip textures, winding-unstable slivers, windows
beyond the exact stage's tile, subdivision levels 0 and 1, line and
point triangles, the AABB debug modes, and a mixed mesh that sends items
down every route at once.  Each BakeResult is byte-equal to
omm_tpu.bake's pallas and numpy backends; the reference suite's
degenerate-triangle statistics hold through the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402

from fixtures import expect_stats, standard_circle  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401


def _descs(planes, tex_fmt=1, sampler=None, **fields):
    """The JAX package's descriptor and the port's, from the same numpy
    planes, arrays and integer enum values."""
    sampler = sampler or {}
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat(tex_fmt)),
        runtime_sampler=omm.SamplerDesc(**sampler), **fields)
    return jdesc, convert.bake_input(planes, tex_fmt, **sampler, **fields)


def _assert_equal(a, b):
    ra, rb = convert.result_to_numpy(a), convert.result_to_numpy(b)
    assert ra.keys() == rb.keys()
    for k in ra:
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k


def _bake_all(jdesc, tdesc, backends=("pallas", "numpy")):
    """The port's CPU bake, held byte-equal to each JAX backend; returns
    the port's result and its route counts."""
    ot.reset_launches()
    got = ot.bake(tdesc, device="cpu")
    counts = {k[6:]: v for k, v in ot.launches().items()
              if k.startswith("route.") and v}
    for b in backends:
        _assert_equal(got, omm.bake(jdesc, backend=b))
    return got, counts


def _bench_tris(n, seed=42, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = rng.rand(2).astype(np.float32) * 0.2
        out.append(((np.array([base + [0.05, 0.1], base + [0.1, 0.7],
                               base + [0.7, 0.65]], np.float32) * scale)
                    + shift).astype(np.float32))
    return out


LINE = np.array([[0.2, 0.0], [0.2, 0.437582970], [0.2, 0.218791485]],
                np.float32)
POINT = np.full((3, 2), 0.45, np.float32)
SLIVER = np.array([[0.1, 0.3], [0.9, 0.3000001], [0.5, 0.3]], np.float32)
WIDE = np.array([[0.02, 0.03], [0.97, 0.1], [0.4, 0.95]], np.float32)


def _fields(tris, subdiv, **more):
    n = len(tris)
    return dict(tex_coords=np.concatenate(tris).astype(np.float32),
                index_buffer=np.arange(3 * n, dtype=np.uint32),
                index_count=3 * n, alpha_cutoff=0.5,
                max_subdivision_level=subdiv,
                dynamic_subdivision_scale=0.0, **more)


@pytest.mark.parametrize("fmt", [omm.Format.OC1_4_State,
                                 omm.Format.OC1_2_State],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("mode", list(omm.TextureAddressMode),
                         ids=lambda m: m.name)
def test_nearest_filter(mode, fmt):
    """Phase-1 resolve and survivors pass for the bench-shaped items, the
    host engine for the line triangle; the wrapped items reach past the
    plane in the periodic modes."""
    tris = _bench_tris(3) + _bench_tris(1, seed=3, scale=1.5, shift=-0.2) \
        + [LINE]
    jdesc, tdesc = _descs([standard_circle(128, 128)],
                          sampler=dict(addressing_mode=int(mode), filter=0,
                                       border_alpha=0.7),
                          **_fields(tris, 4, format=int(fmt)))
    _, counts = _bake_all(jdesc, tdesc)
    assert counts.get("nearest_survivors", 0) > 0
    assert counts.get("host_engine", 0) == 1


def _mips(kind):
    c = standard_circle(128, 128)
    mips = [c, c[::2, ::2].copy()]
    if kind == "unorm8":
        return [np.round(m * 255).astype(np.uint8) for m in mips], 0
    return mips, 1


@pytest.mark.parametrize("filt", [0, 1], ids=["nearest", "linear"])
@pytest.mark.parametrize("kind", ["fp32", "unorm8"])
def test_multi_mip(kind, filt):
    mips, tex_fmt = _mips(kind)
    tris = _bench_tris(3) + [LINE, SLIVER]
    jdesc, tdesc = _descs(mips, tex_fmt, sampler=dict(filter=filt),
                          **_fields(tris, 4))
    _bake_all(jdesc, tdesc)


SLOW = {
    # route, triangles, subdivision level(s)
    "sliver": ("linear_survivors", [SLIVER], 5, None),
    "wide_window": ("dense", [WIDE], 2, None),
    "level_0_and_1": ("dense", _bench_tris(2), 5, [0, 1]),
    "line": ("degenerate", [LINE], 5, None),
    "point": ("degenerate", [POINT], 3, None),
}


@pytest.mark.parametrize("case", sorted(SLOW))
def test_slow_linear_route(case):
    route, tris, sd, levels = SLOW[case]
    more = {} if levels is None else dict(
        subdivision_levels=np.array(levels, np.uint8))
    jdesc, tdesc = _descs([standard_circle(256, 256)], sampler=dict(filter=1),
                          **_fields(tris, sd, **more))
    _, counts = _bake_all(jdesc, tdesc)
    assert counts == {route: len(tris)}


@pytest.mark.parametrize("flags", [
    omm.BakeFlags.DisableLevelLineIntersection,
    omm.BakeFlags.DisableLevelLineIntersection
    | omm.BakeFlags.EnableAABBTesting,
    omm.BakeFlags.DisableFineClassification],
    ids=["no_level_line", "aabb_testing", "no_fine"])
def test_debug_flags(flags):
    tris = _bench_tris(3) + [SLIVER, LINE]
    jdesc, tdesc = _descs([standard_circle(128, 128)],
                          sampler=dict(addressing_mode=3, border_alpha=0.6),
                          **_fields(tris, 4, bake_flags=int(flags)))
    _, counts = _bake_all(jdesc, tdesc)
    want = {} if flags & omm.BakeFlags.DisableFineClassification \
        else {"host_engine": 4}  # the line is disabled without level lines
    assert counts == want


def test_aabb_testing_needs_no_level_line():
    jdesc, tdesc = _descs([standard_circle(64, 64)], **_fields(
        _bench_tris(1), 3, bake_flags=int(omm.BakeFlags.EnableAABBTesting)))
    with pytest.raises(ot.types.BakeError) as ei:
        ot.bake(tdesc, device="cpu")
    with pytest.raises(omm.BakeError) as ej:
        omm.bake(jdesc, backend="pallas")
    assert int(ei.value.result) == int(ej.value.result)


def test_mixed_mesh():
    """The mixed mesh of the chip smoke test, cut down: bench-shaped
    items on the fast path, line triangles, slivers, levels 0 and 1, and
    texture-spanning items, in one descriptor."""
    lines = [LINE, np.array([[0.1, 0.6], [0.8, 0.6], [0.45, 0.6]],
                            np.float32)]
    slivers = [SLIVER, (SLIVER + [0.0, 0.4]).astype(np.float32)]
    bench = _bench_tris(4)
    low = _bench_tris(2, seed=5)
    wide = [WIDE, WIDE[::-1].copy()]
    tris = bench + lines + slivers + low + wide
    levels = ([5] * (len(bench) + len(lines) + len(slivers)) + [0, 1]
              + [2, 2])
    jdesc, tdesc = _descs([standard_circle(256, 256)], **_fields(
        tris, 5, subdivision_levels=np.array(levels, np.uint8)))
    _, counts = _bake_all(jdesc, tdesc)
    assert counts == {"fast_path": len(bench), "degenerate": len(lines),
                      "linear_survivors": len(slivers),
                      "dense": len(low) + len(wide)}


DEGEN_TC = np.array([[0.2, 0.0], [0.2, 0.437582970], [0.2, 0.218791485]],
                    dtype=np.float32)

# test_bake_oracles.py's degenerate cases: (subdivision level,
# dynamic scale, tex coords, address mode, expected stats)
DEGEN = {
    "default_lvl1": (1, 0.0, DEGEN_TC, 2, dict(
        total_opaque=1, total_unknown_transparent=1,
        total_unknown_opaque=2)),
    "default_lvl2": (2, 0.0, DEGEN_TC, 2, dict(
        total_opaque=6, total_transparent=3, total_unknown_transparent=3,
        total_unknown_opaque=4)),
    "default_horizontal": (1, 0.0, np.array(
        [[0.2, 0.2], [0.3, 0.2], [0.41, 0.2]], np.float32), 2, dict(
        total_transparent=3, total_unknown_transparent=1)),
    "default_diagonal": (2, 0.0, np.array(
        [[0.2, 0.2], [0.3, 0.2], [0.4, 0.2]], np.float32), 2, dict(
        total_transparent=13, total_unknown_transparent=2,
        total_unknown_opaque=1)),
    "default_lvl3": (3, 0.0, DEGEN_TC, 2, dict(
        total_opaque=28, total_transparent=21, total_unknown_transparent=7,
        total_unknown_opaque=8)),
    "default_lvl4": (4, 0.0, DEGEN_TC, 2, dict(
        total_opaque=136, total_transparent=91,
        total_unknown_transparent=14, total_unknown_opaque=15)),
    "default_lvl4_wrap": (4, 0.0, np.where(
        [[True, False]] * 3, np.float32(-0.8), DEGEN_TC).astype(np.float32),
        0, dict(total_opaque=136, total_transparent=91,
                total_unknown_transparent=14, total_unknown_opaque=15)),
    "dyn_lvl_2": (12, 2.0, DEGEN_TC, 2, dict(
        total_opaque=37333, total_transparent=27495,
        total_unknown_transparent=353, total_unknown_opaque=355)),
    "dyn_lvl_3": (12, 3.0, DEGEN_TC, 2, dict(
        total_opaque=37333, total_transparent=27495,
        total_unknown_transparent=353, total_unknown_opaque=355)),
    "dyn_lvl_10": (12, 10.0, DEGEN_TC, 2, dict(
        total_opaque=2266, total_transparent=1653,
        total_unknown_transparent=87, total_unknown_opaque=90)),
    "point_transparent": (12, 2.0, np.array([[0.2, 0.437582970]] * 3,
                                            np.float32), 2,
                          dict(total_fully_transparent=1)),
    "point_opaque": (12, 2.0, np.array([[0.2, 0.1]] * 3, np.float32), 2,
                     dict(total_fully_opaque=1)),
}


@pytest.fixture(scope="module")
def circle1024():
    return standard_circle(1024, 1024)


@pytest.mark.parametrize("case", sorted(DEGEN))
def test_degenerate_oracle_stats(case, circle1024):
    """test_bake_oracles.py's test_degen_* cases through the port (the
    reference suite's statistics, test_omm_bake_cpu.cpp:2306-2534)."""
    level, dyn, tc, mode, want = DEGEN[case]
    desc = convert.bake_input(
        [circle1024], 1, addressing_mode=mode, filter=1,
        bake_flags=int(omm.BakeFlags.EnableInternalThreads), alpha_mode=0,
        tex_coord_format=2, tex_coords=tc, index_format=1,
        index_buffer=np.arange(3, dtype=np.uint32), index_count=3,
        alpha_cutoff=0.5, format=int(omm.Format.OC1_4_State),
        unknown_state_promotion=int(omm.UnknownStatePromotion.Nearest),
        max_subdivision_level=level, dynamic_subdivision_scale=dyn,
        unresolved_tri_state=int(omm.SpecialIndex.FullyUnknownOpaque),
        alpha_cutoff_less_equal=int(omm.OpacityState.Transparent),
        alpha_cutoff_greater=int(omm.OpacityState.Opaque))
    expect_stats(omm.get_stats(ot.bake(desc, device="cpu")), **want)
