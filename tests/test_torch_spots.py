"""omm_tpu_torch on the CPU at bench.py's spot configurations, at reduced
size with their shapes kept: subdivision levels 10, 11 and 12 (one item
per batch at 12), multi-repeat UVs (t * 3 + 1) under Wrap and Mirror,
bench.py _spot_multimip's 3-mip chain, a UNORM8 soft contour, mixed
per-triangle levels 7/8/9 through the public bake, and the GPU baker's
dispatch of a mip chain in an RGBA texture's alpha channel under Wrap;
and, as bench.py's 1024-triangle mesh, repeated triangles classified
once each (DisableDuplicateDetection).
Each BakeResult is byte-equal to omm_tpu.bake's numpy backend and, where
the JAX package's own tests run it at that size, its pallas backend.
chip_smoke.py phase 13 runs the same configurations at full size on the
card and holds them to this CPU path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu import gpu as jgpu  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402

from fixtures import standard_circle  # noqa: E402
from test_torch_gpu_baker import _cfgs  # noqa: E402
from test_torch_routes import (_assert_equal, _bake_all,  # noqa: E402
                               _bench_tris, _descs, _fields)
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

#: the base triangle of bench.py's _spot_highsubdiv and _spot_subdiv12
SPOT_BASE = np.array([[0.05, 0.1], [0.1, 0.8], [0.75, 0.7]], np.float32)
#: bench.py's engine configuration promotes unknown states to the nearest
NEAREST = int(omm.UnknownStatePromotion.Nearest)
WRAP = int(omm.TextureAddressMode.Wrap)
FP32, UNORM8 = int(omm.TextureFormat.FP32), int(omm.TextureFormat.UNORM8)


@pytest.fixture(autouse=True)
def _drop_jit_caches():
    """The pallas backend compiles new programs for each case; dropping
    them after each case bounds what one process accumulates."""
    yield
    import jax
    jax.clear_caches()


def _soft_contour(w):
    """bench.py _spot_unorm8's texture at w x w: a soft radial edge
    quantized to UNORM8, a wide band of texels near the cutoff."""
    j, i = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    r = np.hypot(i / w - 0.5, j / w - 0.5)
    a = np.clip((np.float32(0.45) - r) / np.float32(0.08), 0.0, 1.0)
    return np.round(a * 255).astype(np.uint8)


def _multimip():
    """bench.py _spot_multimip's chain (128/64/32 crops of one
    RandomState(5) plane) and its two triangles, at its size."""
    rng = np.random.RandomState(5)
    base = rng.rand(128, 128).astype(np.float32)
    mips = [base[:w, :w].copy() for w in (128, 64, 32)]
    tris = [np.array([[0.1, 0.12], [0.2, 0.8], [0.82, 0.7]], np.float32),
            np.array([[0.3, 0.05], [0.35, 0.6], [0.9, 0.5]], np.float32)]
    return mips, tris


def _case(name):
    """(planes, texture format, sampler, fields, the JAX backends held
    against) of a case.  The pallas backend compiles for 10-20 s a case
    here, so it runs only where it is cheap and at level 12, where the
    numpy oracle takes about a minute (16.7 M micro-triangles): there
    the JAX package holds pallas to numpy (tests/test_bake_oracles.py,
    marked slow), and so does test_level12_against_numpy for the port."""
    circle = [standard_circle(256, 256)]
    wrapped = _bench_tris(8, scale=3.0, shift=1.0)
    mm_planes, mm_tris = _multimip()
    cases = {
        "level10": (circle, FP32, {}, [SPOT_BASE], 10, {}, ("numpy",)),
        "level11": (circle, FP32, {}, [SPOT_BASE + np.float32(0.02)], 11,
                    {}, ("numpy",)),
        "level12": ([standard_circle(1024, 1024)], FP32, {}, [SPOT_BASE],
                    12, {}, ("pallas",)),
        "wrapped": ([standard_circle(64, 64)], FP32,
                    dict(addressing_mode=WRAP), wrapped, 5, {},
                    ("pallas", "numpy")),
        "mirror": ([standard_circle(64, 64)], FP32, dict(
            addressing_mode=int(omm.TextureAddressMode.Mirror)), wrapped,
            5, {}, ("pallas", "numpy")),
        "multimip": (mm_planes, FP32, {}, mm_tris, 6, {}, ("numpy",)),
        "unorm8": ([_soft_contour(128)], UNORM8, {}, _bench_tris(8), 5, {},
                   ("pallas", "numpy")),
        # bench.py's 1024-triangle mesh repeats its triangles; without
        # duplicate detection every repeat is classified
        "large_mesh": ([standard_circle(64, 64)], FP32, {},
                       _bench_tris(8) * 4, 5, dict(bake_flags=int(
                           omm.BakeFlags.DisableDuplicateDetection)),
                       ("pallas", "numpy")),
        "mixed_levels": (circle, FP32, {}, _bench_tris(6), 9, dict(
            subdivision_levels=np.array([7, 8, 9] * 2, np.uint8)),
            ("numpy",)),
    }
    planes, tex_fmt, sampler, tris, level, more, backends = cases[name]
    return (planes, tex_fmt, sampler, _fields(
        tris, level, unknown_state_promotion=NEAREST, **more), backends)


CASES = ("level10", "level11", "level12", "wrapped", "mirror", "multimip",
         "unorm8", "large_mesh", "mixed_levels")


@pytest.mark.parametrize("name", CASES)
def test_spot_bake(name):
    """The port's CPU bake of the spot is byte-equal to the JAX package's
    backends, and every item takes the two-phase fast path (the path the
    card runs through the exact kernel) at its level."""
    planes, tex_fmt, sampler, fields, backends = _case(name)
    jdesc, tdesc = _descs(planes, tex_fmt, sampler, **fields)
    got, counts = _bake_all(jdesc, tdesc, backends)
    n = fields["index_count"] // 3
    assert counts == {"fast_path": n}
    levels = fields.get("subdivision_levels",
                        [fields["max_subdivision_level"]] * n)
    assert {d.subdivision_level for d in got.desc_array} == {
        int(lv) for lv in levels}


@pytest.mark.slow
def test_level12_against_numpy():
    """The level-12 spot against the numpy oracle (16.7 M micro-triangles
    through the oracle: about a minute on one core)."""
    planes, tex_fmt, sampler, fields, _ = _case("level12")
    _bake_all(*_descs(planes, tex_fmt, sampler, **fields), ("numpy",))


@pytest.mark.parametrize("engine", ["default", "compute_only"])
def test_gpu_dispatch_mip_chain_wrap(engine):
    """The GPU baker's dispatch of bench triangles on a 3-mip circle
    chain in channel 3 of an RGBA texture under Wrap (BASELINE.json
    config 4): BakeResult and PostDispatchInfo equal to the JAX
    package's numpy dispatch, with either engine."""
    chain = [standard_circle(w, w) for w in (64, 32, 16)]
    planes = [np.stack([p.T, np.roll(p, 3, axis=1), np.float32(1.0) - p, p],
                       axis=-1) for p in chain]
    flags = int(jgpu.GpuBakeFlags.PerformSetupAndBake
                | jgpu.GpuBakeFlags.EnablePostDispatchInfoStats)
    if engine == "compute_only":
        flags |= int(jgpu.GpuBakeFlags.ComputeOnly)
    jcfg, tcfg = _cfgs(planes, FP32, dict(addressing_mode=WRAP),
                       bake_flags=flags, alpha_texture_channel=3,
                       **_fields(_bench_tris(8), 5))
    ot.reset_launches()
    r_t, p_t = ot.gpu.Pipeline().dispatch(tcfg, device="cpu").execute()
    assert ot.launches()["route.fast_path"] == 8
    r_j, p_j = jgpu.Pipeline().dispatch(jcfg, backend="numpy").execute()
    _assert_equal(r_t, r_j)
    assert convert.post_to_dict(p_t) == convert.post_to_dict(p_j)


def test_chip_smoke_spot_inputs_equal_these():
    """chip_smoke.py phase 13 keeps its own copy of the spot inputs (it
    blocks the JAX package): the bench triangles, the circle at each mip
    size, the UNORM8 contour, the small 3-mip chain and the level-11/12
    base triangle equal this file's, and its workloads have bench.py's
    sizes.  In a child process, because importing chip_smoke blocks jax
    there."""
    import os
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    code = f"""
import sys
sys.path[:0] = [{os.path.dirname(tests)!r}, {tests!r}]
import numpy as np
import test_torch_spots as sp
from fixtures import standard_circle
import chip_smoke as cs
tex, uv = cs._workload()
assert all(np.array_equal(a, b) for a, b in zip(uv, sp._bench_tris(256)))
for w in (1024, 512, 256):
    assert np.array_equal(cs._circle(w), standard_circle(w, w))
assert np.array_equal(cs._soft_contour().mips[0], sp._soft_contour(1024))
small, tris = cs._multimip_small()
mips, tris2 = sp._multimip()
assert all(np.array_equal(a, b) for a, b in zip(small.mips, mips))
assert all(np.array_equal(a, b) for a, b in zip(tris, tris2))
assert np.array_equal(cs.SPOT_BASE, sp.SPOT_BASE)
utri = {{name: u for name, _, u, _ in cs.spot_workloads(tex, uv)}}
assert utri == {{"subdiv11": 16777216, "subdiv12": 33554432,
                "subdiv10": 16777216, "wrapped": 67108864,
                "mirror": 67108864, "multimip_small": 8192,
                "multimip": 67108864, "unorm8": 67108864,
                "large_mesh": 268435456,
                "mixed_levels": 128 * (4 ** 7 + 4 ** 8 + 4 ** 9)}}, utri
print("OK")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("OK")
