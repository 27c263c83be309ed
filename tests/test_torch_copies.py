"""The port's own copies of the JAX package's host code, each pinned to
its original on the same seeded numpy inputs: enum values and
descriptor defaults (types), Options, validation messages,
setup_work_items, finalize_items (the whole host tail, compared as
serialized BakeResults), the native library's functions, texture
addressing and sampling, the bird curve, geometry, the coarse SAT pass,
MT19937 and the bit tricks, the debug stats, and the GPU baker's static
resources."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
from omm_tpu import bird as jbird  # noqa: E402
from omm_tpu import bit_tricks as jbits  # noqa: E402
from omm_tpu import engine as jengine  # noqa: E402
from omm_tpu import geom as jgeom  # noqa: E402
from omm_tpu import native as jnative  # noqa: E402
from omm_tpu import stats as jstats  # noqa: E402
from omm_tpu import texture as jtexture  # noqa: E402
from omm_tpu import types as jtypes  # noqa: E402
from omm_tpu.mt19937 import MT19937 as JMT  # noqa: E402
from omm_tpu_torch import bird as tbird  # noqa: E402
from omm_tpu_torch import bit_tricks as tbits  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402
from omm_tpu_torch import engine as tengine  # noqa: E402
from omm_tpu_torch import geom as tgeom  # noqa: E402
from omm_tpu_torch import native as tnative  # noqa: E402
from omm_tpu_torch import stats as tstats  # noqa: E402
from omm_tpu_torch import texture as ttexture  # noqa: E402
from omm_tpu_torch import types as ttypes  # noqa: E402
from omm_tpu_torch.mt19937 import MT19937 as TMT  # noqa: E402

# the packages export a bake() function under the modules' name
jbake = importlib.import_module("omm_tpu.bake")
tbake = importlib.import_module("omm_tpu_torch.bake")

ENUMS = ["Result", "OpacityState", "SpecialIndex", "Format",
         "UnknownStatePromotion", "TexCoordFormat", "IndexFormat",
         "TextureAddressMode", "TextureFilterMode", "AlphaMode",
         "TextureFormat", "TextureFlags", "BakeFlags"]


@pytest.mark.parametrize("name", ENUMS)
def test_enum_values(name):
    j, t = getattr(jtypes, name), getattr(ttypes, name)
    assert {m.name: int(m) for m in j} == {m.name: int(m) for m in t}


def test_descriptor_defaults_and_constants():
    for cls in ("BakeInputDesc", "SamplerDesc", "DebugStats"):
        jd = {f.name: f.default for f in dataclasses.fields(
            getattr(jtypes, cls))}
        td = {f.name: f.default for f in dataclasses.fields(
            getattr(ttypes, cls))}
        assert jd.keys() == td.keys()
        for k in jd:
            if jd[k] is dataclasses.MISSING:
                continue
            assert (jd[k] is None) == (td[k] is None) and \
                (jd[k] is None or int(jd[k]) == int(td[k])
                 if not isinstance(jd[k], float) else jd[k] == td[k]), k
    assert ttypes.MAX_SUBDIV_LEVEL == jtypes.MAX_SUBDIV_LEVEL
    for lv in range(13):
        assert ttypes.get_num_micro_triangles(lv) == \
            jtypes.get_num_micro_triangles(lv)
    for fmt in (1, 2):
        assert ttypes.get_bit_count(fmt) == jtypes.get_bit_count(fmt)


def test_options_from_flags():
    rng = np.random.RandomState(0)
    for flags in [0, 0xFFF] + list(rng.randint(0, 1 << 12, 64)):
        j = jbake.Options.from_flags(jtypes.BakeFlags(int(flags)))
        t = tbake.Options.from_flags(ttypes.BakeFlags(int(flags)))
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def _tris(n, seed, lo=0.05, hi=0.6, size=0.35):
    rng = np.random.RandomState(seed)
    base = rng.uniform(lo, hi, size=(n, 1, 2))
    return (base + rng.uniform(0, size, size=(n, 3, 2))).astype(np.float32)


def _plane(seed=0, w=64, h=48):
    return np.random.RandomState(seed).rand(h, w).astype(np.float32)


def _descs(planes=None, tex_fmt=1, sampler=None, **fields):
    """The same numpy input as a JAX-package desc and as the port's."""
    planes = planes if planes is not None else [_plane()]
    sampler = sampler or {}
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat(tex_fmt)),
        runtime_sampler=omm.SamplerDesc(**{
            k: v for k, v in sampler.items()}), **fields)
    tfields = dict(fields)
    tdesc = convert.bake_input(planes, tex_fmt, **sampler, **tfields)
    return jdesc, tdesc


def _item_rows(items):
    return [(it.subdivision_level, int(it.vm_format), it.uv_tri.tobytes(),
             list(it.primitive_indices)) for it in items]


SETUPS = {
    "duplicates_and_invalid": lambda: dict(
        tex_coords=np.concatenate([_tris(6, 1), _tris(2, 1),
                                   np.full((1, 3, 2), np.nan, np.float32)]
                                  ).reshape(-1, 2),
        index_buffer=np.arange(27, dtype=np.uint32), index_count=27,
        max_subdivision_level=5, dynamic_subdivision_scale=0.0),
    "area_heuristic": lambda: dict(
        tex_coords=_tris(12, 2, size=0.5).reshape(-1, 2),
        index_buffer=np.arange(36, dtype=np.uint32), index_count=36,
        max_subdivision_level=9, dynamic_subdivision_scale=2.0),
    "edge_heuristic_levels_formats": lambda: dict(
        tex_coords=_tris(10, 3).reshape(-1, 2),
        index_buffer=np.arange(30, dtype=np.uint32), index_count=30,
        bake_flags=int(omm.BakeFlags.EnableEdgeHeuristic),
        max_subdivision_level=7, dynamic_subdivision_scale=3.0,
        subdivision_levels=np.array([3, 13, 14, 5, 2, 13, 1, 0, 4, 13],
                                    np.uint8),
        formats=np.array([1, 2, 0, 2, 1, 0, 2, 2, 1, 0], np.uint8)),
}


@pytest.mark.parametrize("case", sorted(SETUPS))
def test_setup_work_items(case):
    fields = SETUPS[case]()
    jdesc, tdesc = _descs(**fields)
    jopts = jbake.Options.from_flags(jdesc.bake_flags)
    topts = tbake.Options.from_flags(tdesc.bake_flags)
    want = jbake.setup_work_items(jdesc, jopts)
    got = tbake.setup_work_items(tdesc, topts)
    assert _item_rows(got) == _item_rows(want) and len(want) > 0
    jbake.validate_workload_size(jdesc, jopts, want)
    tbake.validate_workload_size(tdesc, topts, got)


BAD_DESCS = {
    "no_tex_coords": dict(tex_coords=None),
    "subdiv_13": dict(max_subdivision_level=13),
    "near_dup_without_dedup": dict(bake_flags=int(
        omm.BakeFlags.EnableNearDuplicateDetection
        | omm.BakeFlags.DisableDuplicateDetection)),
    "two_state_unknown": dict(format=int(omm.Format.OC1_2_State),
                              alpha_cutoff_greater=int(
                                  omm.OpacityState.UnknownOpaque)),
    "workload_too_big": dict(max_workload_size=1),
}


@pytest.mark.parametrize("case", sorted(BAD_DESCS))
def test_validation_errors_match(case):
    fields = dict(tex_coords=_tris(2, 4).reshape(-1, 2),
                  index_buffer=np.arange(6, dtype=np.uint32), index_count=6,
                  max_subdivision_level=4)
    fields.update(BAD_DESCS[case])
    jdesc, tdesc = _descs(**fields)
    errs = []
    for mod, desc in ((jbake, jdesc), (tbake, tdesc)):
        opts = mod.Options.from_flags(desc.bake_flags)
        with pytest.raises(Exception) as ei:
            mod.validate_desc(desc, opts)
            items = mod.setup_work_items(desc, opts)
            mod.validate_workload_size(desc, opts, items)
        errs.append((type(ei.value).__name__, int(ei.value.result),
                     str(ei.value)))
    assert errs[0] == errs[1]


def _states_pool(M, rng):
    """A few distinct state patterns (uniform, mixed, near-duplicate) so
    that dedup, promotion and merges all have work."""
    a = rng.randint(0, 4, M).astype(np.uint8)
    b = a.copy()
    b[: max(1, M // 50)] ^= 1
    return [np.zeros(M, np.uint8), np.ones(M, np.uint8),
            np.full(M, 3, np.uint8), a, b,
            (rng.rand(M) < 0.5).astype(np.uint8)]


FINALIZE = {
    "default": dict(),
    "no_special_indices": dict(bake_flags=int(
        omm.BakeFlags.DisableSpecialIndices)),
    "near_duplicates_lsh": dict(bake_flags=int(
        omm.BakeFlags.EnableNearDuplicateDetection)),
    "near_duplicates_brute_force": dict(bake_flags=int(
        omm.BakeFlags.EnableNearDuplicateDetection
        | omm.BakeFlags.EnableNearDuplicateDetectionBruteForce)),
    "compress_budget": dict(max_array_data_size=200),
    "two_state": dict(format=int(omm.Format.OC1_2_State)),
    "rejection_8bit": dict(rejection_threshold=0.6, bake_flags=int(
        omm.BakeFlags.Allow8BitIndices)),
}


@pytest.mark.parametrize("case", sorted(FINALIZE))
def test_finalize_items(case):
    """The host tail on identical items: serialized results are equal."""
    n = 24
    fields = dict(tex_coords=_tris(n, 5).reshape(-1, 2),
                  index_buffer=np.arange(3 * n, dtype=np.uint32),
                  index_count=3 * n, max_subdivision_level=4,
                  dynamic_subdivision_scale=0.0)
    fields.update(FINALIZE[case])
    jdesc, tdesc = _descs(**fields)
    jopts = jbake.Options.from_flags(jdesc.bake_flags)
    topts = tbake.Options.from_flags(tdesc.bake_flags)
    jitems = jbake.setup_work_items(jdesc, jopts)
    titems = tbake.setup_work_items(tdesc, topts)
    rng = np.random.RandomState(7)
    for ji, ti in zip(jitems, titems):
        M = jtypes.get_num_micro_triangles(ji.subdivision_level)
        pool = _states_pool(M, rng)
        st = pool[rng.randint(len(pool))]
        if jdesc.format == omm.Format.OC1_2_State:
            st = st & 1
        ji.states = st.copy()
        ti.states = st.copy()
    want = convert.result_to_numpy(jbake.finalize_items(jdesc, jopts,
                                                        jitems))
    got = convert.result_to_numpy(tbake.finalize_items(tdesc, topts, titems))
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert len(want["desc_array"]) > 0


def test_finalize_packed_states_row_copy():
    """Items holding device-packed rows (PackedStates) serialize to the
    same bytes as items holding the unpacked states."""
    from omm_tpu_torch.twophase import PackedStates
    n = 6
    fields = dict(tex_coords=_tris(n, 8).reshape(-1, 2),
                  index_buffer=np.arange(3 * n, dtype=np.uint32),
                  index_count=3 * n, max_subdivision_level=5,
                  dynamic_subdivision_scale=0.0)
    jdesc, tdesc = _descs(**fields)
    jopts = jbake.Options.from_flags(jdesc.bake_flags)
    topts = tbake.Options.from_flags(tdesc.bake_flags)
    jitems = jbake.setup_work_items(jdesc, jopts)
    titems = tbake.setup_work_items(tdesc, topts)
    rng = np.random.RandomState(9)
    M = 4 ** 5
    for ji, ti in zip(jitems, titems):
        st = rng.randint(0, 4, M).astype(np.uint8)
        ji.states = st.copy()
        ti.set_packed_states(PackedStates(tnative.pack_states(st, 2), M))
    want = convert.result_to_numpy(jbake.finalize_items(jdesc, jopts,
                                                        jitems))
    got = convert.result_to_numpy(tbake.finalize_items(tdesc, topts, titems))
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _native_inputs():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 4, m).astype(np.uint8)
            for m in (1, 3, 4, 17, 256, 4096, 65536)]


NATIVE = ["pack_states", "unpack_2bit_seq", "states3_digest", "xxh64",
          "lz4_round_trip", "all_uniform_u8", "hamming_u8",
          "pack_states_batch"]


@pytest.mark.parametrize("fn", NATIVE)
def test_native(fn):
    arrs = _native_inputs()
    if fn == "pack_states":
        for a in arrs:
            for bits in (1, 2):
                x = a & 1 if bits == 1 else a
                assert np.array_equal(tnative.pack_states(x, bits),
                                      jnative.pack_states(x, bits))
    elif fn == "unpack_2bit_seq":
        for a in arrs:
            p = jnative.pack_states(a, 2)
            assert np.array_equal(tnative.unpack_2bit_seq(p, len(a)), a)
            assert np.array_equal(tnative.unpack_2bit_seq(p, len(a)),
                                  jnative.unpack_2bit_seq(p, len(a)))
    elif fn == "states3_digest":
        for a in arrs:
            for seed in (0, 42):
                assert tnative.states3_digest(a, seed) == \
                    jnative.states3_digest(a, seed)
    elif fn == "xxh64":
        for a in arrs:
            for seed in (0, 42, 2 ** 63 + 5):
                assert tnative.xxh64(a.tobytes(), seed) == \
                    jnative.xxh64(a.tobytes(), seed)
    elif fn == "lz4_round_trip":
        for a in arrs + [np.zeros(100000, np.uint8)]:
            data = a.tobytes()
            c = tnative.lz4_compress(data)
            assert c == jnative.lz4_compress(data)
            assert tnative.lz4_decompress(c, len(data)) == data
            assert jnative.lz4_decompress(c, len(data)) == data
        with pytest.raises(RuntimeError):
            tnative.lz4_decompress(b"\xff\xff\xff", 10)
    elif fn == "all_uniform_u8":
        for a in arrs + [np.full(1000, 2, np.uint8),
                         np.full(999, 3, np.uint8)]:
            assert tnative.all_uniform_u8(a) == jnative.all_uniform_u8(a)
    elif fn == "hamming_u8":
        for a in arrs:
            b = np.roll(a, 1)
            assert tnative.hamming_u8(a, b) == jnative.hamming_u8(a, b)
    elif fn == "pack_states_batch":
        sts = [a for a in arrs if len(a) % 4 == 0]
        bits = [2, 1, 2, 1, 2][:len(sts)]
        sts = [s & 1 if b == 1 else s for s, b in zip(sts, bits)]
        offs, o = [], 0
        for s, b in zip(sts, bits):
            offs.append(o)
            o += max(len(s) * b // 8, 1)
        got = np.zeros(o, np.uint8)
        want = np.zeros(o, np.uint8)
        assert tnative.pack_states_batch(sts, bits, offs, got)
        assert jnative.pack_states_batch(sts, bits, offs, want)
        assert np.array_equal(got, want)


MODES = list(omm.TextureAddressMode)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_texture_addressing_and_sampling(mode):
    rng = np.random.RandomState(12)
    coords = rng.randint(-300, 300, size=(500, 2)).astype(np.int32)
    for (w, h) in ((64, 32), (48, 80)):
        size = np.array([w, h], np.int32)
        log2 = np.array([jbits.ctz(w), jbits.ctz(h)], np.int32)
        pow2 = jbits.is_pow2(w) and jbits.is_pow2(h)
        assert np.array_equal(
            ttexture.get_tex_coord(ttypes.TextureAddressMode(int(mode)),
                                   coords, size, log2, pow2),
            jtexture.get_tex_coord(mode, coords, size, log2, pow2))
        for g, want in zip(
                ttexture.gather_tex_coord4(
                    ttypes.TextureAddressMode(int(mode)), coords, size,
                    log2, pow2),
                jtexture.gather_tex_coord4(mode, coords, size, log2, pow2)):
            assert np.array_equal(g, want)
        planes = [_plane(3, w, h), _plane(4, w // 2, h // 2)]
        jt = omm.Texture(planes, omm.TextureFormat.FP32)
        tt = convert.texture(planes, 1)
        uv = rng.uniform(-0.5, 1.5, size=(400, 2)).astype(np.float32)
        for mip in (0, 1):
            assert np.array_equal(
                tt.bilinear(ttypes.TextureAddressMode(int(mode)), uv,
                            mip).view(np.int32),
                jt.bilinear(mode, uv, mip).view(np.int32))
            assert np.array_equal(tt.load_plane(mip), jt.load_plane(mip))
            assert tt.info[mip].size == jt.info[mip].size
            assert np.array_equal(tt.info[mip].rcp_size,
                                  jt.info[mip].rcp_size)


def test_texture_unorm8_sat_queries():
    rng = np.random.RandomState(13)
    plane = rng.randint(0, 256, size=(40, 56)).astype(np.uint8)
    jt = omm.Texture([plane], omm.TextureFormat.UNORM8, alpha_cutoff=0.4)
    tt = convert.texture([plane], 0, alpha_cutoff=0.4)
    assert np.array_equal(tt.load_plane(0), jt.load_plane(0))
    assert tt.has_sat() and np.array_equal(tt.sat[0], jt.sat[0])
    s = rng.randint(0, 40, size=(300, 2))
    e = s + rng.randint(0, 16, size=(300, 2))
    e = np.minimum(e, [55, 39])
    assert np.array_equal(tt.sat_query(s, e, 0), jt.sat_query(s, e, 0))
    c = rng.randint(-5, 60, size=(300, 2))
    assert np.array_equal(tt.in_texture(c, 0), jt.in_texture(c, 0))


def test_bird_curve():
    rng = np.random.RandomState(14)
    tri = rng.rand(3, 2).astype(np.float32)
    for level in range(0, 7):
        idx = np.arange(4 ** level, dtype=np.uint32)
        g = tbird.micro_triangle_uvs(tri, idx, level)
        w = jbird.micro_triangle_uvs(tri, idx, level)
        assert np.array_equal(g.view(np.int32), w.view(np.int32))
        for a, b in zip(tbird.index2dbary(idx), jbird.index2dbary(idx)):
            assert np.array_equal(a, b)
        u, v, ww = jbird.index2dbary(idx)
        assert np.array_equal(tbird.dbary2index(u, v, ww, level),
                              jbird.dbary2index(u, v, ww, level))


def test_geometry():
    rng = np.random.RandomState(15)
    tris = np.concatenate([
        _tris(200, 15, lo=-1.0, hi=1.0, size=0.5),
        np.array([[[0.1, 0.1], [0.4, 0.4], [0.7, 0.7]],
                  [[0.1, 0.1], [0.9, 0.1000001], [0.5, 0.1]]], np.float32)])
    for fn in ("is_invalid", "is_degenerate", "is_ccw", "uv_area"):
        assert np.array_equal(getattr(tgeom, fn)(tris),
                              getattr(jgeom, fn)(tris)), fn
    for sd in (2, 6, 10):
        assert np.array_equal(tgeom.winding_stable(tris, sd),
                              jgeom.winding_stable(tris, sd))
    for a, b in zip(tgeom.tri_aabb(tris), jgeom.tri_aabb(tris)):
        assert np.array_equal(a, b)
    pts = rng.rand(len(tris), 2).astype(np.float32)
    assert np.array_equal(tgeom.point_in_triangle(tris, pts),
                          jgeom.point_in_triangle(tris, pts))
    raw = rng.randint(0, 2 ** 16, size=(30, 2)).astype(np.uint16)
    idx = rng.randint(0, 30, 60).astype(np.uint32)
    for fmt in (0, 1):
        assert np.array_equal(
            tgeom.triangles_from_indices(idx, raw, ttypes.TexCoordFormat(fmt),
                                         0),
            jgeom.triangles_from_indices(idx, raw,
                                         omm.TexCoordFormat(fmt), 0),
            equal_nan=True)


def test_coarse_sat_pass():
    """engine.resample_coarse_item on a texture with an embedded cutoff
    (the SAT route), linear filter, every address mode."""
    planes = [(_plane(16, 32, 32) > 0.5).astype(np.float32)]
    planes[0][8:24, 8:24] = 1.0
    jt = omm.Texture(planes, omm.TextureFormat.FP32, alpha_cutoff=0.5)
    tt = convert.texture(planes, 1, alpha_cutoff=0.5)
    tris = _tris(4, 16, lo=0.1, hi=0.5, size=0.4)
    for mode in MODES:
        kw = dict(filter=1, alpha_cutoff=0.5, border_alpha=0.0, fmt=2,
                  promotion=0, cutoff_gt=1, cutoff_le=0)
        jc = jengine.ResampleConfig(addr_mode=mode, **kw)
        tc = tengine.ResampleConfig(addr_mode=ttypes.TextureAddressMode(
            int(mode)), **kw)
        for tri in tris:
            st = np.full(4 ** 5, 3, np.uint8)
            want = jengine.resample_coarse_item(jt, jc, tri, 5, st)
            got = tengine.resample_coarse_item(tt, tc, tri, 5, st.copy())
            assert np.array_equal(got, want)
            assert (want != 3).any()


def test_mt19937_and_bit_tricks():
    j, t = JMT(42), TMT(42)
    assert [t() for _ in range(1500)] == [j() for _ in range(1500)]
    rng = np.random.RandomState(17)
    x = rng.randint(0, 2 ** 16, 1000).astype(np.uint32)
    y = rng.randint(0, 2 ** 16, 1000).astype(np.uint32)
    assert np.array_equal(tbits.xy_to_morton(x, y), jbits.xy_to_morton(x, y))
    m = jbits.xy_to_morton(x, y)
    for a, b in zip(tbits.morton_to_xy(m), jbits.morton_to_xy(m)):
        assert np.array_equal(a, b)
    assert np.array_equal(tbits.next_pow2(x), jbits.next_pow2(x))
    for v in (0, 1, 2, 3, 96, 1 << 20):
        assert tbits.ctz(v) == jbits.ctz(v)
        assert tbits.is_pow2(v) == jbits.is_pow2(v)


def test_raster_line_walks():
    """raster.py: the Bresenham and conservative DDA walks, scalar and
    batched, on seeded segments (points, axis-aligned and steep ones)."""
    from omm_tpu.kernels import raster as jraster
    from omm_tpu_torch import raster as traster
    rng = np.random.RandomState(18)
    p0 = rng.uniform(-0.2, 1.2, (300, 2)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.1, 0.1, (300, 2))).astype(np.float32)
    p1[:20] = p0[:20]          # points
    p1[20:40, 0] = p0[20:40, 0]  # vertical
    p1[40:60, 1] = p0[40:60, 1]  # horizontal
    for size, off in (((64, 48), (-0.5, -0.5)), ((37, 80), (0.0, 0.0))):
        for a, b in zip(traster.conservative_line_cells_batch(p0, p1, size,
                                                              off),
                        jraster.conservative_line_cells_batch(p0, p1, size,
                                                              off)):
            assert np.array_equal(a, b)
        for k in range(0, 300, 7):
            assert np.array_equal(
                traster.conservative_line_cells(p0[k], p1[k], size, off),
                jraster.conservative_line_cells(p0[k], p1[k], size, off))
            assert np.array_equal(
                traster.bresenham_line_cells(p0[k], p1[k], size),
                jraster.bresenham_line_cells(p0[k], p1[k], size))


@pytest.mark.parametrize("case", ["default", "no_special_indices",
                                  "rejection_8bit", "two_state"])
def test_stats(case):
    """stats.collect_stats / get_stats (with and without triangle areas)
    and decode_states on seeded results of the host tail."""
    n = 24
    fields = dict(tex_coords=_tris(n, 19).reshape(-1, 2),
                  index_buffer=np.arange(3 * n, dtype=np.uint32),
                  index_count=3 * n, max_subdivision_level=3,
                  dynamic_subdivision_scale=0.0)
    fields.update(FINALIZE[case])
    jdesc, _ = _descs(**fields)
    jopts = jbake.Options.from_flags(jdesc.bake_flags)
    items = jbake.setup_work_items(jdesc, jopts)
    rng = np.random.RandomState(20)
    for it in items:
        pool = _states_pool(4 ** it.subdivision_level, rng)
        st = pool[rng.randint(len(pool))].copy()
        it.states = st & 1 if jdesc.format == omm.Format.OC1_2_State else st
    res = jbake.finalize_items(jdesc, jopts, items)
    assert len(res.desc_array) > 0
    asdict = dataclasses.asdict
    for area in (None, res.triangle_area):
        assert asdict(tstats.collect_stats(res, area)) == \
            asdict(jstats.collect_stats(res, area))
    for use_area in (False, True):
        got = asdict(tstats.get_stats(res, use_area))
        assert got == asdict(jstats.get_stats(res, use_area))
        assert got["known_area_metric"] != 0.0 or not use_area
    for d in res.desc_array:
        assert np.array_equal(
            tstats.decode_states(res.array_data, d.offset,
                                 d.subdivision_level, d.format),
            jstats.decode_states(res.array_data, d.offset,
                                 d.subdivision_level, d.format))
    data = rng.randint(0, 256, 4096).astype(np.uint8)
    for level in range(6):
        for fmt in (1, 2):
            off = int(rng.randint(0, 4096 - 4 ** level // 2))
            assert np.array_equal(tstats.decode_states(data, off, level, fmt),
                                  jstats.decode_states(data, off, level, fmt))


@pytest.mark.parametrize("resource", ["STATIC_VERTEX_BUFFER",
                                      "STATIC_INDEX_BUFFER"])
def test_static_resource_blobs(resource):
    """gpu.static_data: the blobs of levels 0-9 equal the JAX package's."""
    from omm_tpu.gpu import static_data as jsd
    from omm_tpu_torch.gpu import static_data as tsd
    want = jsd.get_static_resource_data(resource)
    got = tsd.get_static_resource_data(resource)
    assert got["data"].dtype == want["data"].dtype
    assert np.array_equal(got["data"], want["data"])
    assert got["offsets"] == want["offsets"] and got["size"] == want["size"]


@pytest.mark.parametrize("level", [0, 1, 2, 3, 5])
def test_static_buffers_consistent(level):
    """tests/test_static_data.py's check on the port's copy: every
    bird-index primitive tessellates to index2bary's corners."""
    from omm_tpu_torch.gpu.static_data import (static_index_buffer,
                                               static_vertex_buffer)
    vb = static_vertex_buffer(level)
    ib = static_index_buffer(level)
    n = 1 << level
    assert len(vb) == (n + 1) * (n + 2) // 2
    assert len(ib) == 3 * 4 ** level
    assert ib.max() < len(vb)
    uv0, uv1, uv2 = tbird.index2bary(np.arange(4 ** level, dtype=np.uint32),
                                     level)
    scale = np.float32(1.0 / n)
    for prim in range(4 ** level):
        corners = []
        for k in range(3):
            packed = int(vb[ib[3 * prim + k]])
            i, j = packed & 0xFFFF, packed >> 16
            corners.append((i * scale, (n - j) * scale))
        got = {tuple(np.round(c, 6)) for c in corners}
        want = {tuple(np.round(c, 6)) for c in
                [uv0[prim], uv1[prim], uv2[prim]]}
        assert got == want, (level, prim, got, want)


def test_static_resource_blob():
    """tests/test_static_data.py's blob check on the port's copy."""
    from omm_tpu_torch.gpu.static_data import get_static_resource_data
    d = get_static_resource_data("STATIC_INDEX_BUFFER")
    assert len(d["offsets"]) == 10
    assert d["size"] == d["data"].nbytes
    with pytest.raises(ValueError):
        get_static_resource_data("NOPE")


def _debug_case(filter_, seed):
    """The same descriptor for both packages, and the JAX package's
    numpy bake of it (the renders read only the result's arrays): two
    mips with
    uniform corners (special indices), random and degenerate
    triangles, a 2-state and a 4-state format."""
    rng = np.random.RandomState(seed)
    plane = _plane(seed, 48, 40)
    plane[:12, :16] = 1.0
    plane[-10:, -12:] = 0.0
    planes = [plane, plane[::2, ::2].copy()]
    tris = np.concatenate([
        _tris(5, seed),
        np.array([[[0.02, 0.02], [0.2, 0.02], [0.02, 0.2]],
                  [[0.1, 0.5], [0.5, 0.5], [0.3, 0.5]]], np.float32)])
    fields = dict(tex_coords=tris.reshape(-1, 2),
                  index_buffer=np.arange(3 * len(tris), dtype=np.uint32),
                  index_count=3 * len(tris), max_subdivision_level=3,
                  dynamic_subdivision_scale=0.0,
                  format=1 + int(rng.randint(2)))
    jdesc, tdesc = _descs(planes, 1, {
        "addressing_mode": omm.TextureAddressMode(rng.randint(5)),
        "filter": omm.TextureFilterMode(filter_)}, **fields)
    return jdesc, tdesc, omm.bake(jdesc, backend="numpy")


def test_debug_canvas_and_de_degenerate():
    from omm_tpu import debug as jdebug
    from omm_tpu_torch import debug as tdebug
    plane = _plane(21, 24, 20)
    for fmt, p in ((1, plane), (0, (plane * 255).astype(np.uint8))):
        jt = omm.Texture([p], omm.TextureFormat(fmt))
        tt = ttexture.Texture([p], ttypes.TextureFormat(fmt))
        for scale in (1, 3):
            assert np.array_equal(tdebug._canvas(tt, scale),
                                  jdebug._canvas(jt, scale))
    rng = np.random.RandomState(22)
    for _ in range(30):
        a, d = rng.rand(2).astype(np.float32), rng.rand(2).astype(np.float32)
        line = np.stack([a, a + d * rng.rand(), a + d])[rng.permutation(3)]
        line = line.astype(np.float32)
        assert np.array_equal(tdebug._de_degenerate(line),
                              jdebug._de_degenerate(line))


@pytest.mark.parametrize("filter_", [1, 0], ids=["linear", "nearest"])
def test_debug_renders(filter_):
    """render_overlay (every option) and render_cutout of each
    primitive, on the same descriptor and result."""
    from omm_tpu import debug as jdebug
    from omm_tpu_torch import debug as tdebug
    jdesc, tdesc, res = _debug_case(filter_, 23 + filter_)
    assert (np.asarray(res.index_buffer) < 0).any()
    for kw in ({}, {"monochrome_unknowns": True, "highlight_reuse": False},
               {"scale": 2}):
        assert np.array_equal(tdebug.render_overlay(tdesc, res, **kw),
                              jdebug.render_overlay(jdesc, res, **kw)), kw
    for prim in range(tdesc.index_count // 3):
        kw = dict(max_dim=512, max_pixels=1 << 14,
                  monochrome_unknowns=bool(prim % 2),
                  highlight_reuse=prim == 3)
        assert np.array_equal(tdebug.render_cutout(tdesc, res, prim, **kw),
                              jdebug.render_cutout(jdesc, res, prim, **kw)), \
            prim


def test_viewer_uv_to_micro_index():
    from omm_tpu import viewer as jviewer
    from omm_tpu_torch import viewer as tviewer
    rng = np.random.RandomState(24)
    for tri in _tris(6, 24):
        for level in (0, 1, 3, 6):
            for _ in range(5):
                w = rng.dirichlet([1.0, 1.0, 1.0])
                uv = (w @ tri.astype(np.float64)).astype(np.float32)
                assert tviewer.uv_to_micro_index(tri, uv, level) \
                    == jviewer.uv_to_micro_index(tri, uv, level)


def test_integration_conservative_memory_estimate():
    from omm_tpu import integration as jint
    from omm_tpu_torch import integration as tint
    for tris, level, bits in ((1, 0, 2), (7, 5, 2), (300, 9, 1), (0, 12, 2),
                              (1 << 20, 12, 2)):
        assert tint.conservative_memory_estimate(tris, level, bits) \
            == jint.conservative_memory_estimate(tris, level, bits)
