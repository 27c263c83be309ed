"""Differential fuzz of omm_tpu_torch.bake against omm_tpu.bake(backend=
"pallas"): seeded random small descriptors, the port's outcome on the
CPU against the JAX package's, byte for byte, and the same BakeError
Result code where both refuse.

Axes drawn per case: texture (size, one or two mips, FP32 or UNORM8,
random / binary / radial / near-cutoff content, DisableZOrder, the
cutoff embedded, which turns on the coarse SAT pass), sampler (five address
modes, both filters, border alpha), geometry (ordinary, multi-repeat,
CW, line, point, fp32-thin sliver), per-triangle subdivision levels
0-6, global and per-triangle formats, promotion modes, cutoff-state
remaps, and the DisableLevelLineIntersection / EnableAABBTesting /
DisableFineClassification flags."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402

UTRI_BUDGET = 60_000


@pytest.fixture(autouse=True)
def _drop_jit_caches():
    """Each case compiles new programs in the JAX package; dropping them
    after each case bounds what one process accumulates (as
    tests/test_differential_fuzz.py does)."""
    yield
    import jax
    jax.clear_caches()


def _planes(rng):
    h, w = ((32, 32), (64, 64), (64, 32), (48, 48))[rng.randint(4)]
    base = rng.rand(h, w).astype(np.float32)
    kind = rng.randint(4)
    if kind == 1:
        base = (base > 0.5).astype(np.float32)
    elif kind == 2:
        j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                           np.arange(w, dtype=np.float32), indexing="ij")
        r = np.hypot(i / w - 0.5, j / h - 0.5)
        base = np.clip((np.float32(0.4) - r) / np.float32(0.15), 0.0,
                       1.0).astype(np.float32)
    elif kind == 3:  # near-cutoff band
        base = (np.float32(0.5) + (base - np.float32(0.5))
                * np.float32(1e-3)).astype(np.float32)
    mips = [base]
    if rng.randint(2):
        mips.append(base[::2, ::2].copy())
    if rng.randint(3) == 0:
        return [np.round(m * 255).astype(np.uint8) for m in mips], 0
    return mips, 1


def _geometry(rng):
    tris = []
    for _ in range(1 + rng.randint(6)):
        b = rng.rand(2).astype(np.float32) * 0.6
        t = np.stack([b + rng.rand(2).astype(np.float32) * 0.5
                      for _ in range(3)]).astype(np.float32)
        kind = rng.randint(7)
        if kind == 0:    # multi-repeat
            t = t * np.float32(1 + rng.randint(3)) \
                - rng.rand(2).astype(np.float32)
        elif kind == 1:  # line
            d = rng.rand(2).astype(np.float32) * 0.5
            t = np.stack([b, b + d, b + np.float32(2) * d])
            t[:, rng.randint(2)] = b[0]  # axis-aligned: exactly degenerate
        elif kind == 2:  # point
            t = np.stack([b, b, b])
        elif kind == 3:  # fp32-thin sliver
            t = np.array([b, b + [0.6, 1e-7], b + [0.3, 0.0]], np.float32)
        elif kind == 4:  # CW
            t = t[::-1]
        tris.append(np.ascontiguousarray(t, np.float32))
    return tris


def _random_case(rng, k):
    planes, tex_fmt = _planes(rng)
    tris = _geometry(rng)
    n = len(tris)
    max_level = int(rng.randint(0, 7))
    while n * 4 ** max_level > UTRI_BUDGET:
        max_level -= 1
    fields = dict(
        tex_coords=np.concatenate(tris), index_buffer=np.arange(
            3 * n, dtype=np.uint32), index_count=3 * n, alpha_cutoff=0.5,
        max_subdivision_level=max_level, dynamic_subdivision_scale=0.0,
        unknown_state_promotion=int(rng.randint(3)))
    if rng.randint(2):
        fields["subdivision_levels"] = rng.randint(
            0, max_level + 1, n).astype(np.uint8)
    fmt = 1 if rng.randint(3) == 0 else 2
    fields["format"] = fmt
    if rng.randint(4) == 0:
        fields["formats"] = rng.randint(1, 3, n).astype(np.uint16)
    elif fmt == 2 and rng.randint(3) == 0:  # 4-state cutoff remap
        fields["alpha_cutoff_less_equal"] = int(rng.randint(4))
        fields["alpha_cutoff_greater"] = int(rng.randint(4))
    flags = 0
    r = k % 8  # the flags cycle over the corpus
    if r == 0:
        flags |= int(omm.BakeFlags.DisableLevelLineIntersection)
    elif r == 1:
        flags |= int(omm.BakeFlags.DisableLevelLineIntersection
                     | omm.BakeFlags.EnableAABBTesting)
    elif r == 2:
        flags |= int(omm.BakeFlags.EnableAABBTesting)  # refused: no pair
    elif r == 3:
        flags |= int(omm.BakeFlags.DisableFineClassification)
    if rng.randint(3) == 0:
        flags |= int(omm.BakeFlags.DisableSpecialIndices)
    fields["bake_flags"] = flags
    sampler = dict(addressing_mode=int(rng.randint(5)),
                   filter=int(k % 3 != 0),
                   border_alpha=float(rng.rand()))
    # the texture's flags and embedded cutoff come from a stream of their
    # own, so that the axes above keep their draws
    trng = np.random.RandomState(78000 + k)
    texture = dict(
        texture_flags=int(omm.TextureFlags.DisableZOrder)
        if trng.randint(2) else 0,
        texture_alpha_cutoff=fields["alpha_cutoff"]
        if trng.randint(4) == 0 else -1.0)
    return planes, tex_fmt, sampler, dict(fields, **texture)


def _jax_desc(planes, tex_fmt, sampler, fields):
    enums = dict(format=omm.Format, unknown_state_promotion=(
        omm.UnknownStatePromotion), bake_flags=omm.BakeFlags,
        alpha_cutoff_less_equal=omm.OpacityState,
        alpha_cutoff_greater=omm.OpacityState)
    f = {k: enums[k](v) if k in enums else v for k, v in fields.items()
         if not k.startswith("texture_")}
    return omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat(tex_fmt),
                            omm.TextureFlags(fields["texture_flags"]),
                            fields["texture_alpha_cutoff"]),
        runtime_sampler=omm.SamplerDesc(
            addressing_mode=omm.TextureAddressMode(sampler["addressing_mode"]),
            filter=omm.TextureFilterMode(sampler["filter"]),
            border_alpha=sampler["border_alpha"]), **f)


def _outcome(bake, desc, error, **kw):
    try:
        return convert.result_to_numpy(bake(desc, **kw))
    except error as e:
        return int(e.result)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_port_vs_pallas(seed):
    rng = np.random.RandomState(77000 + seed)
    for trial in range(2):
        planes, tex_fmt, sampler, fields = _random_case(rng, 2 * seed + trial)
        ctx = (seed, trial, tex_fmt, [p.shape for p in planes], sampler,
               {k: v for k, v in fields.items() if np.isscalar(v)})
        want = _outcome(omm.bake, _jax_desc(planes, tex_fmt, sampler,
                                            fields), omm.BakeError,
                        backend="pallas")
        got = _outcome(ot.bake, convert.bake_input(planes, tex_fmt,
                                                   **sampler, **fields),
                       ot.types.BakeError, device="cpu")
        if isinstance(want, int) or isinstance(got, int):
            assert got == want, ctx
            continue
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), (k, ctx)


def test_fuzz_draws_every_route():
    """The corpus is not vacuous: over the seeds above, the port's bakes
    take every route, both packages refuse some descriptor, and some
    texture has DisableZOrder and some the cutoff embedded."""
    ot.reset_launches()
    refused = 0
    drawn = set()
    for seed in range(8):
        rng = np.random.RandomState(77000 + seed)
        for trial in range(2):
            planes, tex_fmt, sampler, fields = _random_case(
                rng, 2 * seed + trial)
            drawn |= {k for k, v in (("zorder_off", fields["texture_flags"]),
                                     ("embedded_cutoff",
                                      fields["texture_alpha_cutoff"] >= 0))
                      if v}
            try:
                ot.bake(convert.bake_input(planes, tex_fmt, **sampler,
                                           **fields), device="cpu")
            except ot.types.BakeError:
                refused += 1
    counts = ot.launches()
    taken = {k for k, v in counts.items() if k.startswith("route.") and v}
    assert refused > 0
    assert drawn == {"zorder_off", "embedded_cutoff"}
    assert taken >= {"route.fast_path", "route.dense", "route.degenerate",
                     "route.nearest_survivors", "route.host_engine",
                     "route.linear_survivors"}, counts
