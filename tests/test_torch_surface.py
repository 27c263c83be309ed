"""The port's library surface against the JAX package's: `Baker`, `capi`,
`debug` and `integration`, on the CPU (device="cpu").

Every case builds the same inputs, from seeded numpy arrays, for both
packages and compares exactly: the same messages and severities, the
same BakeError Result codes, byte-equal BakeResults and blobs, equal
DebugStats, byte-equal PNG files, equal D3D12/Vulkan build inputs.  The
tests of tests/test_log_and_debug.py and tests/test_minimal_sample.py
run through `ot.Baker` and `ot.capi`."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu import capi as jcapi  # noqa: E402
from omm_tpu import integration as jint  # noqa: E402
from omm_tpu.allocator import StdAllocator as JAllocator  # noqa: E402
from omm_tpu_torch import capi, convert, integration, planes  # noqa: E402
from omm_tpu_torch.allocator import StdAllocator  # noqa: E402

from fixtures import standard_circle  # noqa: E402

QUAD_TC = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
QUAD_IB = np.array([0, 1, 2, 3, 1, 2], np.uint32)
TRI_TC = np.array([[0, 0], [0, 1], [1, 0]], np.float32)
TRI_IB = np.array([0, 1, 2], np.uint32)


def _assert_results_equal(a, b, skip=()):
    x, y = convert.result_to_numpy(a), convert.result_to_numpy(b)
    assert x.keys() == y.keys()
    for k in x.keys() - set(skip):
        assert np.array_equal(x[k], y[k]), k


def _both(plane, cutoff=-1.0, **fields):
    """(JAX desc, port desc) over the same numpy arrays."""
    out = []
    for pkg in (omm, ot):
        tex = pkg.Texture([plane], pkg.TextureFormat.FP32,
                          alpha_cutoff=cutoff)
        out.append(pkg.BakeInputDesc(texture=tex, **fields))
    return out


# -- messages (tests/test_log_and_debug.py's validation cases) ---------------

def _no_texture(d, b, pkg):
    d.texture = None


def _no_index_format(d, b, pkg):
    d.index_format = None


def _max_subdiv(d, b, pkg):
    d.max_subdivision_level = 13


def _cutoff_mismatch(d, b, pkg):
    d.texture = b.create_texture([standard_circle(16, 16)],
                                 pkg.TextureFormat.FP32, alpha_cutoff=0.3)
    d.alpha_cutoff = 0.4


def _two_state_unknown(d, b, pkg):
    d.format = pkg.Format.OC1_2_State
    d.alpha_cutoff_less_equal = pkg.OpacityState.UnknownOpaque


def _unclassifiable(d, b, pkg):
    d.tex_coords = np.array([[0, 0], [0, np.nan], [1, 0]], np.float32)
    d.bake_flags = pkg.BakeFlags.EnableValidation


MESSAGE_CASES = {
    "no_texture": (_no_texture, "INVALID_ARGUMENT",
                   "[Invalid Argument] - ommCpuBakeInputDesc has no texture "
                   "set"),
    "no_index_format": (_no_index_format, "INVALID_ARGUMENT",
                        "[Invalid Argument] - indexFormat is not set"),
    "max_subdiv": (_max_subdiv, "INVALID_ARGUMENT",
                   "[Invalid Argument] - maxSubdivisionLevel (13) is greater "
                   "than maximum supported (12)"),
    "alpha_cutoff_mismatch": (
        _cutoff_mismatch, "INVALID_ARGUMENT",
        "[Invalid Argument] - Texture object alpha cutoff threshold "
        "(0.300000) is different from alpha cutoff threshold in bake input "
        "(0.400000)"),
    "2state_incompatible": (
        _two_state_unknown, "INVALID_ARGUMENT",
        "[Invalid Argument] - alphaCutoffLessEqual=UnknownOpaque is not "
        "compatible with OC1_2_State"),
    "unclassifiable_info": (
        _unclassifiable, "SUCCESS",
        "[Info] - The workload consists of 1 unclassifiable triangles, these "
        "will be classified as unresolvedTriState = Fully Unknown Opaque."),
}


def _bake_with_messages(pkg, mutate, **kw):
    """(messages as (int severity, text), outcome) of one baker's bake:
    the result as numpy arrays, or the BakeError's Result name."""
    msgs = []
    baker = pkg.Baker(lambda sev, m: msgs.append((int(sev), m)))
    tex = baker.create_texture([standard_circle(16, 16)],
                               pkg.TextureFormat.FP32)
    desc = pkg.BakeInputDesc(
        texture=tex, dynamic_subdivision_scale=0.0, tex_coords=TRI_TC,
        index_buffer=TRI_IB, index_count=3, max_subdivision_level=2)
    mutate(desc, baker, pkg)
    try:
        return msgs, convert.result_to_numpy(baker.bake(desc, **kw))
    except pkg.BakeError as e:
        return msgs, e.result.name


@pytest.mark.parametrize("case", sorted(MESSAGE_CASES))
def test_messages_match(case):
    mutate, result, text = MESSAGE_CASES[case]
    jmsgs, jout = _bake_with_messages(omm, mutate)
    tmsgs, tout = _bake_with_messages(ot, mutate, device="cpu")
    assert tmsgs == jmsgs
    assert any(text in m for _, m in tmsgs), tmsgs
    if result == "SUCCESS":
        assert tmsgs[0][0] == int(ot.MessageSeverity.Info)
        assert not isinstance(jout, str) and not isinstance(tout, str)
        assert all(np.array_equal(tout[k], jout[k]) for k in jout)
    else:
        assert tout == jout == result


def test_perf_warning_matches():
    """129 texture-sized triangles: more than 2^27 texels to classify.
    The warning comes from validation, before classification, so the
    bake skips the fine pass (DisableFineClassification)."""
    tc = np.array([[0, 0], [0, 1.1], [1.1, 0]], np.float32)
    ib = np.tile(TRI_IB, 129)
    out = []
    for pkg, kw in ((omm, {}), (ot, {"device": "cpu"})):
        msgs = []
        baker = pkg.Baker(lambda sev, m: msgs.append((int(sev), m)))
        tex = baker.create_texture([standard_circle(1024, 1024)],
                                   pkg.TextureFormat.FP32)
        F = pkg.BakeFlags
        desc = pkg.BakeInputDesc(
            texture=tex, dynamic_subdivision_scale=0.0, tex_coords=tc,
            index_buffer=ib, index_count=len(ib), max_subdivision_level=0,
            bake_flags=(F.EnableValidation | F.DisableDuplicateDetection
                        | F.DisableFineClassification))
        baker.bake(desc, **kw)
        out.append(msgs)
    assert out[1] == out[0]
    warns = [m for s, m in out[1]
             if s == int(ot.MessageSeverity.PerfWarning)]
    assert warns and "unusually large" in warns[0] \
        and "1024x1024 textures" in warns[0]


# -- debug images ------------------------------------------------------------

def _png_bytes(files):
    out = []
    for f in files:
        with open(f, "rb") as fh:
            out.append((os.path.basename(f), fh.read()))
    return out


def _quad_bakes(plane, tc, level):
    jd, td = _both(plane, dynamic_subdivision_scale=0.0, tex_coords=tc,
                   index_buffer=QUAD_IB, index_count=6,
                   max_subdivision_level=level)
    jr = omm.Baker().bake(jd)
    tr = ot.Baker().bake(td, device="cpu")
    _assert_results_equal(tr, jr)
    return (jd, jr), (td, tr)


@pytest.mark.parametrize("case", ["one_file", "per_primitive",
                                  "detailed_cutout"])
def test_save_as_images_png_bytes_equal(case, tmp_path):
    """ommDebugSaveAsImages: the port's PNG files are byte-equal to the
    JAX package's for the same result (a circle quad; the cutout case on
    asymmetric quad halves, whose UV AABBs differ)."""
    tc = QUAD_TC
    if case == "detailed_cutout":
        tc = np.array([[0.05, 0.1], [0.1, 0.9], [0.6, 0.2], [0.95, 0.85]],
                      np.float32)
    (jd, jr), (td, tr) = _quad_bakes(standard_circle(64, 64), tc, 3)
    kw = {"one_file": case == "one_file",
          "detailed_cutout": case == "detailed_cutout",
          "file_postfix": case}
    jfiles = omm.Baker().save_as_images(jd, jr, str(tmp_path / "j"), **kw)
    tfiles = ot.Baker().save_as_images(td, tr, str(tmp_path / "t"), **kw)
    assert len(tfiles) == (1 if case == "one_file" else 2)
    assert _png_bytes(tfiles) == _png_bytes(jfiles)
    from PIL import Image
    img = np.asarray(Image.open(tfiles[0]))
    assert (img[..., 1] > 200).any() and (img[..., 2] > 200).any()


def test_save_as_images_cutout_needs_per_primitive(tmp_path):
    """oneFile + detailedCutout is INVALID_ARGUMENT in both packages
    (debug_impl.cpp:137-138)."""
    (jd, jr), (td, tr) = _quad_bakes(standard_circle(32, 32), QUAD_TC, 2)
    with pytest.raises(omm.BakeError) as je:
        omm.Baker().save_as_images(jd, jr, str(tmp_path), one_file=True,
                                   detailed_cutout=True)
    with pytest.raises(ot.BakeError) as te:
        ot.Baker().save_as_images(td, tr, str(tmp_path), one_file=True,
                                  detailed_cutout=True)
    assert te.value.result.name == je.value.result.name == "INVALID_ARGUMENT"
    assert str(te.value) == str(je.value)


def test_get_stats2_known_area():
    jd, td = _both(np.full((64, 64), 0.9, np.float32),
                   dynamic_subdivision_scale=0.0, tex_coords=QUAD_TC,
                   index_buffer=QUAD_IB, index_count=6,
                   max_subdivision_level=2)
    jb, tb = omm.Baker(), ot.Baker()
    s = tb.get_stats2(tb.bake(td, device="cpu"))
    assert s.known_area_metric == pytest.approx(1.0)
    assert s.__dict__ == jb.get_stats2(jb.bake(jd)).__dict__


def test_user_allocator_receives_output_buffers():
    """StdAllocator analog (std_allocator.h): the port's user callbacks
    see the JAX package's allocations, and the byte accounting is the
    same."""
    jd, td = _both(standard_circle(32, 32), tex_coords=TRI_TC,
                   index_buffer=TRI_IB, index_count=3,
                   max_subdivision_level=3)
    out = []
    for pkg, alloc_cls, desc, kw in ((omm, JAllocator, jd, {}),
                                     (ot, StdAllocator, td,
                                      {"device": "cpu"})):
        calls = []

        def user_alloc(nbytes, alignment, arg, calls=calls):
            calls.append((nbytes, alignment, arg))
            return np.zeros(nbytes, np.uint8)

        alloc = alloc_cls(allocate=user_alloc, user_arg="ctx")
        res = pkg.Baker(allocator=alloc).bake(desc, **kw)
        assert calls and all(arg == "ctx" for _, _, arg in calls)
        assert alloc.stats.total_bytes >= len(res.array_data)
        # the default allocator gives the same result
        _assert_results_equal(res, pkg.Baker().bake(desc, **kw))
        out.append((calls, alloc.stats.total_bytes, alloc.stats.peak_bytes,
                    res))
    assert out[1][:3] == out[0][:3]
    _assert_results_equal(out[1][3], out[0][3])


# -- capi (the flat omm.h names) ---------------------------------------------

def test_capi_names_and_call_shapes():
    """The same __all__, and every function takes the JAX package's
    arguments, with device= where the JAX package has backend=."""
    import inspect
    assert capi.__all__ == jcapi.__all__
    renamed = {"backend": "device"}
    for name in capi.__all__:
        jp = list(inspect.signature(getattr(jcapi, name)).parameters)
        tp = list(inspect.signature(getattr(capi, name)).parameters)
        if name == "omm_gpu_dispatch":
            jp = jp + ["device"]
        assert tp == [renamed.get(p, p) for p in jp], name


def test_capi_flat_surface_roundtrip():
    """Create baker and texture, bake, serialize, stats, static GPU data,
    a GPU dispatch: equal to the JAX package's capi on the same
    inputs."""
    plane = standard_circle(32, 32)
    ld = capi.omm_get_library_desc()
    assert tuple(ld) == tuple(jcapi.omm_get_library_desc()) == (1, 9, 0)
    bk, jbk = capi.omm_create_baker(), jcapi.omm_create_baker()
    tex = capi.omm_cpu_create_texture(bk, [plane], ot.TextureFormat.FP32)
    jtex = jcapi.omm_cpu_create_texture(jbk, [plane], omm.TextureFormat.FP32)
    td = capi.omm_cpu_get_texture_desc(tex)
    jtd = jcapi.omm_cpu_get_texture_desc(jtex)
    assert td.format == ot.TextureFormat.FP32 and td.mip_count == 1
    assert td.mips == ((32, 32, 32),) and td.alpha_cutoff == -1.0
    assert tuple(td) == tuple(jtd)
    desc = ot.BakeInputDesc(texture=tex, tex_coords=TRI_TC,
                            index_buffer=TRI_IB, index_count=3,
                            max_subdivision_level=3)
    jdesc = omm.BakeInputDesc(texture=jtex, tex_coords=TRI_TC,
                              index_buffer=TRI_IB, index_count=3,
                              max_subdivision_level=3)
    res = capi.omm_cpu_bake(bk, desc, device="cpu")
    jres = jcapi.omm_cpu_bake(jbk, jdesc)
    _assert_results_equal(res, jres)
    assert capi.omm_cpu_get_bake_result_desc(res) is res
    s = capi.omm_debug_get_stats(res)
    assert s.__dict__ == jcapi.omm_debug_get_stats(jres).__dict__
    assert capi.omm_debug_get_stats2(res).__dict__ \
        == jcapi.omm_debug_get_stats2(jres).__dict__
    assert (s.total_opaque + s.total_transparent + s.total_unknown_opaque
            + s.total_unknown_transparent) == 4 ** 3
    blob = capi.omm_cpu_serialize(bk, input_descs=[desc],
                                  result_descs=[res], compress=True)
    assert blob == jcapi.omm_cpu_serialize(jbk, input_descs=[jdesc],
                                           result_descs=[jres],
                                           compress=True)
    d = capi.omm_cpu_deserialize(bk, blob)
    assert len(d.result_descs) == 1
    # a blob holds no per-triangle UV areas
    _assert_results_equal(d.result_descs[0], res, skip=["triangle_area"])
    for r in ("STATIC_VERTEX_BUFFER", "STATIC_INDEX_BUFFER"):
        sd = capi.omm_gpu_get_static_resource_data(r)
        jsd = jcapi.omm_gpu_get_static_resource_data(r)
        assert sd["size"] > 0 and sd.keys() == jsd.keys()
        for k in sd:
            assert np.array_equal(np.asarray(sd[k]), np.asarray(jsd[k])), k
    pipe = capi.omm_gpu_create_pipeline(bk)
    pd = capi.omm_gpu_get_pipeline_desc(pipe)
    assert pd["render_api"] == "cuda"
    assert pd["passes"] == jcapi.omm_gpu_get_pipeline_desc(
        jcapi.omm_gpu_create_pipeline(jbk))["passes"]
    cfg = convert.dispatch_config([plane], 1, tex_coords=TRI_TC,
                                  index_buffer=TRI_IB, index_count=3,
                                  max_subdivision_level=3, bake_flags=3)
    assert capi.omm_gpu_get_pre_dispatch_info(pipe, cfg) \
        == pipe.get_pre_dispatch_info(cfg)
    got, post = capi.omm_gpu_dispatch(pipe, cfg, device="cpu").execute()
    want, wpost = ot.gpu.Pipeline().dispatch(cfg, device="cpu").execute()
    _assert_results_equal(got, want)
    assert convert.post_to_dict(post) == convert.post_to_dict(wpost)
    capi.omm_cpu_destroy_bake_result(res)
    capi.omm_cpu_destroy_texture(bk, tex)
    capi.omm_destroy_baker(bk)


def test_capi_save_binary_to_disk(tmp_path):
    p = str(tmp_path / "b.bin")
    assert capi.omm_debug_save_binary_to_disk(b"OMM\x00", p) == p
    with open(p, "rb") as f:
        assert f.read() == b"OMM\x00"


def test_destroy_texture_then_bake():
    """omm_cpu_destroy_texture drops the texture's device planes; the
    next bake builds them again and gives the same bytes."""
    bk = capi.omm_create_baker()
    tex = capi.omm_cpu_create_texture(bk, [standard_circle(64, 64)],
                                      ot.TextureFormat.FP32)
    tc = np.array([[0.05, 0.1], [0.1, 0.7], [0.7, 0.65]], np.float32)
    desc = ot.BakeInputDesc(texture=tex, tex_coords=tc, index_buffer=TRI_IB,
                            index_count=3, max_subdivision_level=5,
                            dynamic_subdivision_scale=0.0)
    first = capi.omm_cpu_bake(bk, desc, device="cpu")
    cache = planes.tex_cache(tex, "cpu")
    assert cache, "the bake cached no plane"
    capi.omm_cpu_destroy_texture(bk, tex)
    assert not planes.tex_cache(tex, "cpu")
    again = capi.omm_cpu_bake(bk, desc, device="cpu")
    assert planes.tex_cache(tex, "cpu")
    _assert_results_equal(again, first)


# -- integration --------------------------------------------------------------

def _scene_pair(level=4):
    j, i = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    plane = (np.hypot(i - 30.0, j - 22.0) < 15).astype(np.float32)
    tc = np.array([[0.05, 0.1], [0.1, 0.9], [0.6, 0.2], [0.95, 0.85],
                   [0.05, 0.1], [0.1, 0.9]], np.float32)
    ib = np.array([0, 1, 2, 3, 1, 2, 4, 5, 2], np.uint32)
    jd, td = _both(plane, tex_coords=tc, index_buffer=ib, index_count=9,
                   max_subdivision_level=level,
                   dynamic_subdivision_scale=0.0)
    jr = omm.bake(jd)
    tr = ot.bake(td, device="cpu")
    _assert_results_equal(tr, jr)
    return (jd, jr), (td, tr)


def test_build_inputs_equal_jax():
    """to_d3d12_build_inputs / to_vulkan_build_inputs of the port's
    result equal the JAX package's of its result, and agree with each
    other."""
    (_, jr), (_, tr) = _scene_pair()
    a, b = integration.to_d3d12_build_inputs(tr), \
        jint.to_d3d12_build_inputs(jr)
    assert a.input_buffer == b.input_buffer
    assert np.array_equal(a.per_omm_descs, b.per_omm_descs)
    assert a.per_omm_descs.dtype == b.per_omm_descs.dtype == np.uint32
    assert a.omm_index_buffer == b.omm_index_buffer
    for k in ("per_omm_counts", "omm_index_counts", "omm_index_format"):
        assert getattr(a, k) == getattr(b, k), k
    v = integration.to_vulkan_build_inputs(tr)
    assert v == jint.to_vulkan_build_inputs(jr)
    assert v["data"] == a.input_buffer
    assert v["indexBuffer"] == a.omm_index_buffer
    assert [(u["count"], u["subdivisionLevel"], u["format"])
            for u in v["usageCounts"]] == a.per_omm_counts
    assert len(a.input_buffer) == tr.array_data.size > 0


def test_dump_debug_compare():
    """The card-against-CPU check, here CPU against CPU: equal stats for
    the bake's own result, unequal for another result."""
    (jd, jr), (td, tr) = _scene_pair()
    msgs = []
    s1, s2, equal = integration.dump_debug_compare(
        td, tr, logger=ot.Logger(lambda s, m: msgs.append(m)))
    assert equal and s1 == s2 and not msgs
    assert s1.__dict__ == jint.dump_debug_compare(jd, jr)[0].__dict__
    _, (_, other) = _scene_pair(level=2)
    assert not integration.dump_debug_compare(td, other)[2]


def test_minimal_sample():
    """The documentation example (test_minimal_sample.cpp:17-158)
    through ot.Baker: a donut under a 4-triangle diamond with mixed
    per-triangle levels, 2-state, byte-equal to the JAX package."""
    r_min, r_max = 0.2, 0.3
    n = 256
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    u = i.astype(np.float32) / np.float32(n)
    v = j.astype(np.float32) / np.float32(n)
    r = np.sqrt((u - np.float32(0.5)) ** 2 + (v - np.float32(0.5)) ** 2)
    alpha = ((r > np.float32(r_min)) & (r < np.float32(r_max))).astype(
        np.float32)
    tex_coords = np.array([[0.05, 0.50], [0.50, 0.05], [0.50, 0.50],
                           [0.95, 0.50], [0.50, 0.95]], np.float32)
    indices = np.array([0, 1, 2, 1, 3, 2, 3, 4, 2, 2, 4, 0], np.uint32)
    levels = np.array([2, 3, 4, 5], np.uint8)

    out = []
    for pkg, kw in ((omm, {}), (ot, {"device": "cpu"})):
        messages = []
        baker = pkg.Baker(lambda sev, m: messages.append(m))
        tex = baker.create_texture([alpha], pkg.TextureFormat.FP32)
        desc = pkg.BakeInputDesc(
            texture=tex, bake_flags=pkg.BakeFlags.EnableValidation,
            alpha_cutoff=0.5, alpha_mode=pkg.AlphaMode.Test,
            runtime_sampler=pkg.SamplerDesc(
                addressing_mode=pkg.TextureAddressMode.Clamp,
                filter=pkg.TextureFilterMode.Linear),
            tex_coord_format=pkg.TexCoordFormat.UV32_FLOAT,
            tex_coords=tex_coords, index_buffer=indices,
            index_count=len(indices), subdivision_levels=levels,
            format=pkg.Format.OC1_2_State,
            unknown_state_promotion=pkg.UnknownStatePromotion.ForceOpaque,
            dynamic_subdivision_scale=0.0)
        out.append((baker, desc, baker.bake(desc, **kw), messages))
    (jb, jd, jr, jm), (tb, td, tr, tm) = out
    _assert_results_equal(tr, jr)
    assert tm == jm
    assert tr.index_count == 4
    lvls = sorted(tr.desc_array[v].subdivision_level
                  for v in tr.index_buffer if v >= 0)
    assert lvls == [lvl for i, lvl in enumerate([2, 3, 4, 5])
                    if int(tr.index_buffer[i]) >= 0]
    s = tb.get_stats(tr)
    assert s.total_unknown_opaque == 0 and s.total_unknown_transparent == 0
    assert s.total_opaque > 0 and s.total_transparent > 0
    d3d = integration.to_d3d12_build_inputs(tr)
    assert len(d3d.input_buffer) == tr.array_data.size
    assert integration.dump_debug_compare(td, tr)[2]


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """Every surface entry point that bakes runs on "cuda" unless told
    otherwise, and raises where there is no card: never a CPU
    fallback."""
    from omm_tpu_torch import cli
    from omm_tpu_torch.viewer import ViewerSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tex = ot.Texture([standard_circle(32, 32)], ot.TextureFormat.FP32)
    desc = ot.BakeInputDesc(texture=tex, tex_coords=TRI_TC,
                            index_buffer=TRI_IB, index_count=3,
                            max_subdivision_level=3)
    bk = ot.Baker()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bk.bake(desc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capi.omm_cpu_bake(bk, desc)
    cfg = convert.dispatch_config([standard_circle(32, 32)], 1,
                                  tex_coords=TRI_TC, index_buffer=TRI_IB,
                                  index_count=3, max_subdivision_level=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capi.omm_gpu_dispatch(capi.omm_gpu_create_pipeline(bk), cfg)
    blob = bk.serialize(input_descs=[desc])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViewerSession(blob).stats()
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bake", "--input-blob", str(p)])
    # the CPU is there when asked for
    assert ViewerSession(blob, device="cpu").stats() \
        == bk.get_stats(bk.bake(desc, device="cpu"))
