"""The port's tools against the JAX package's, on the CPU: the headless
viewer (`viewer.ViewerSession`), the terminal viewer (`tui`), and every
CLI subcommand called in-process through `main(argv)`; the vegetation
scene through `ot.Baker`; and `chip_smoke.py`'s copy of the scene's
generators.

The same blob goes to both packages' sessions; the same key presses
drive both terminal viewers, whose frames must be equal; each CLI
subcommand runs in its own working directory for each package, with
`--device cpu` for the port and `--backend numpy` for the JAX package,
and must print the same text and write the same bytes."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu import bird as jbird  # noqa: E402
from omm_tpu import cli as jcli  # noqa: E402
from omm_tpu import tui as jtui  # noqa: E402
from omm_tpu import viewer as jviewer  # noqa: E402
from omm_tpu_torch import cli, convert, tui, viewer  # noqa: E402

from fixtures import standard_circle  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _blob(tc, ib, level):
    tex = omm.Texture([standard_circle(32, 32)], omm.TextureFormat.FP32)
    desc = omm.BakeInputDesc(texture=tex, tex_coords=tc, index_buffer=ib,
                             index_count=len(ib), max_subdivision_level=level,
                             dynamic_subdivision_scale=0.0)
    res = omm.bake(desc)
    return omm.Baker().serialize(input_descs=[desc], result_descs=[res],
                                 compress=True)


@pytest.fixture(scope="module")
def session_blob():
    """tests/test_tui.py's session: a circle under a 0.7-wide quad."""
    tex = omm.Texture([standard_circle(32, 32)], omm.TextureFormat.FP32)
    desc = omm.BakeInputDesc(
        texture=tex,
        tex_coords=np.array([[0, 0], [0, 0.7], [0.7, 0], [0.7, 0.7]],
                            np.float32),
        index_buffer=np.array([0, 1, 2, 3, 1, 2], np.uint32), index_count=6,
        max_subdivision_level=4)
    res = omm.bake(desc)
    return omm.Baker().serialize(input_descs=[desc], result_descs=[res],
                                 compress=True)


@pytest.fixture(scope="module")
def reuse_blob():
    """Two quads over identical UV rectangles: 4 triangles sharing OMMs
    (tests/test_log_and_debug.py's inspect-and-reuse session)."""
    tc = np.array([[0, 0], [0, 1], [1, 0], [1, 1],
                   [0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    ib = np.array([0, 1, 2, 3, 1, 2, 4, 5, 6, 7, 5, 6], np.uint32)
    return _blob(tc, ib, 4)


def _pair(blob):
    """(JAX terminal viewer, port terminal viewer) over one blob."""
    return (jtui.TuiViewer(jviewer.ViewerSession(blob)),
            tui.TuiViewer(viewer.ViewerSession(blob, device="cpu")))


def _same_state(jv, tv):
    """The two viewers hold the same status, parameters and viewport
    (without rendering, which would re-bake a dirty session)."""
    assert tv.status_lines() == jv.status_lines()
    assert tv.s.params() == jv.s.params()
    assert tv.s._dirty == jv.s._dirty
    assert tv.cur_prim == jv.cur_prim and tv.span == jv.span
    assert np.array_equal(tv.center, jv.center)


def _same_frame(pair, rows=6, cols=20):
    jv, tv = pair
    assert tui.render_ansi(tv, rows, cols) == jtui.render_ansi(jv, rows,
                                                               cols)
    _same_state(jv, tv)


def _press(pair, keys):
    """Press each key on both viewers; they must agree after each and
    return the same keep-running flag."""
    jv, tv = pair
    for k in keys:
        assert tv.handle_key(k) == jv.handle_key(k)
        _same_state(jv, tv)


# -- terminal viewer (tests/test_tui.py, mirrored) ---------------------------

def test_frame_and_pan_zoom(session_blob):
    pair = _pair(session_blob)
    jv, tv = pair
    f0 = tv.frame_rgb(12, 40)
    assert f0.shape == (24, 40, 3) and f0.max() > 0.1
    assert np.array_equal(f0, jv.frame_rgb(12, 40))
    c0 = tv.center.copy()
    _press(pair, ["KEY_RIGHT"])
    assert tv.center[0] > c0[0]
    _press(pair, ["+"])
    assert tv.span < 1.0
    _press(pair, ["-", "-"])
    assert tv.span > 1.0
    _press(pair, ["h"] * 20)
    _same_frame(pair)
    f = tv.frame_rgb(8, 16)
    assert np.isfinite(f).all() and np.array_equal(f, jv.frame_rgb(8, 16))
    assert not tv.handle_key("q") and not jv.handle_key("q")


def test_zoom_to_prim_and_cycle(session_blob):
    pair = _pair(session_blob)
    jv, tv = pair
    _press(pair, ["g"])
    assert tv.span < 1.0
    _press(pair, ["n"])
    assert tv.cur_prim == 1
    _press(pair, ["p"])
    assert tv.cur_prim == 0
    assert tv.prim_at(tv.center) == jv.prim_at(jv.center) == 0
    _same_frame(pair)


def test_inspect_and_reuse_messages(session_blob):
    pair = _pair(session_blob)
    _, tv = pair
    _press(pair, ["g", "i"])
    assert tv.messages and ("µtri" in tv.messages[-1]
                            or "prim 0" in tv.messages[-1])
    _press(pair, ["u"])
    assert len(tv.messages) >= 2
    _same_frame(pair)


def test_param_step_rebake_reset(session_blob):
    pair = _pair(session_blob)
    _, tv = pair
    names = list(viewer.TWEAKABLE)
    assert names == list(jviewer.TWEAKABLE)
    while names[tv.param_i] != "alpha_cutoff":
        _press(pair, ["c"])
    v0 = tv.s.params()["alpha_cutoff"]
    _press(pair, ["]"])
    assert tv.s.params()["alpha_cutoff"] == pytest.approx(v0 + 0.05)
    assert tv.s._dirty
    _press(pair, ["r"])
    assert not tv.s._dirty
    _press(pair, ["x"])
    assert tv.s.params()["alpha_cutoff"] == pytest.approx(v0)
    while names[tv.param_i] != "format":
        _press(pair, ["c"])
    f0 = tv.s.params()["format"]
    _press(pair, ["]"])
    assert tv.s.params()["format"] != f0
    _same_frame(pair)  # re-bakes both at the other format
    _press(pair, ["R"])
    assert tv.s.params()["format"] == f0
    _same_frame(pair)


def test_param_clamps_and_enum_domains(session_blob):
    pair = _pair(session_blob)
    _, tv = pair
    names = list(viewer.TWEAKABLE)
    while names[tv.param_i] != "max_subdivision_level":
        _press(pair, ["c"])
    _press(pair, ["]"] * 15)
    assert tv.s.params()["max_subdivision_level"] == 12
    while names[tv.param_i] != "alpha_cutoff_greater":
        _press(pair, ["c"])
    seen = set()
    for _ in range(6):
        _press(pair, ["]"])
        seen.add(int(tv.s.params()["alpha_cutoff_greater"]))
    assert seen <= {0, 1, 2, 3}
    _same_frame(pair)


def test_failed_rebake_is_a_message_not_a_crash(session_blob):
    jv, tv = _pair(session_blob)
    assert np.array_equal(tv.frame_rgb(4, 8), jv.frame_rgb(4, 8))
    for v in (jv, tv):
        v.s.set_param("max_workload_size", 1)  # WORKLOAD_TOO_BIG
        assert v.handle_key("r")
    assert any("bake failed" in m for m in tv.messages)
    assert tv.messages == jv.messages
    f = tv.frame_rgb(4, 8)
    assert np.isfinite(f).all() and np.array_equal(f, jv.frame_rgb(4, 8))


def test_zoom_to_prim_validates_index(session_blob):
    _, tv = _pair(session_blob)
    for bad in (99, -1):
        with pytest.raises(IndexError):
            tv.zoom_to_prim(bad)


def test_status_and_ansi_frame(session_blob):
    jv, tv = _pair(session_blob)
    lines = tv.status_lines()
    assert lines == jv.status_lines()
    assert any("prim 0" in ln for ln in lines)
    assert any("param>" in ln for ln in lines)
    s = tui.render_ansi(tv, rows=6, cols=20)
    assert "\x1b[38;2;" in s and s.count("▀") == 6 * 20
    assert s == jtui.render_ansi(jv, rows=6, cols=20)


# -- headless viewer sessions -------------------------------------------------

def _sessions(blob):
    return jviewer.ViewerSession(blob), viewer.ViewerSession(blob,
                                                             device="cpu")


def test_viewer_session_tweak_rebake(tmp_path):
    """Load, tweak, re-bake, render, zoom, reset, save: the same stats,
    images and blob as the JAX package's session."""
    blob = _blob(np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32),
                 np.array([0, 1, 2, 3, 1, 2], np.uint32), 4)
    js, ts = _sessions(blob)
    assert ts.stats().__dict__ == js.stats().__dict__  # the stored result
    for s in (js, ts):
        s.set_param("max_subdivision_level", 3)
        s.set_param("alpha_cutoff", 0.4)
    st = ts.stats()  # re-baked with the tweaks
    assert st.__dict__ == js.stats().__dict__
    assert st.total_opaque + st.total_transparent \
        + st.total_unknown_opaque + st.total_unknown_transparent \
        == 2 * 4 ** 3
    img = ts.render(scale=2)
    assert img.shape == (64, 64, 3) and np.array_equal(img,
                                                       js.render(scale=2))
    assert np.array_equal(ts.zoom(0, scale=4), js.zoom(0, scale=4))
    for s in (js, ts):
        s.reset_all()
    assert ts.params()["max_subdivision_level"] == 4
    assert ts.params() == js.params()
    p = ts.save_blob(str(tmp_path / "t.bin"))
    q = js.save_blob(str(tmp_path / "j.bin"))
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    assert viewer.ViewerSession(p, device="cpu").stats() == ts.stats()


def test_viewer_inspect_and_reuse(reuse_blob):
    """Zoom-to-micro-triangle inspection and OMM-reuse browsing: the
    same groups and inspection records as the JAX package's session."""
    js, ts = _sessions(reuse_blob)
    groups = ts.reuse_groups()
    assert groups == js.reuse_groups()
    assert groups and all(len(prims) >= 2 for _, prims in groups)
    cases = [dict(micro=5), dict(micro=3), dict(uv=(0.4, 0.55)), {}]
    for prim in range(ts.result.index_count):
        for kw in cases:
            a, b = ts.inspect(prim, **kw), js.inspect(prim, **kw)
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert ts.inspect(0, micro=5)["micro_index"] == 5
    uv_tri = np.array([[0, 0], [0, 1], [1, 0]], np.float32)
    for k in (0, 7, 42, 255):
        cen = jbird.micro_triangle_uvs(
            uv_tri, np.asarray([k], np.uint32), 4)[0].mean(axis=0)
        assert viewer.uv_to_micro_index(uv_tri, cen, 4) == k
    with pytest.raises(IndexError):
        ts.inspect(99)
    with pytest.raises(KeyError):
        ts.set_param("texture", None)


def test_viewer_needs_input_descs():
    blob = omm.Baker().serialize(result_descs=[omm.bake(omm.BakeInputDesc(
        texture=omm.Texture([standard_circle(16, 16)],
                            omm.TextureFormat.FP32),
        tex_coords=np.array([[0, 0], [0, 1], [1, 0]], np.float32),
        index_buffer=np.arange(3, dtype=np.uint32), index_count=3,
        max_subdivision_level=2))])
    with pytest.raises(ValueError, match="input descs"):
        viewer.ViewerSession(blob, device="cpu")


# -- the CLI, subcommand by subcommand ----------------------------------------

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, reuse_blob):
    """Absolute paths of the CLI's inputs: an RGBA PNG (the circle in
    alpha), a UV JSON, and the reuse session's blob."""
    from PIL import Image
    d = tmp_path_factory.mktemp("cli_inputs")
    a = (standard_circle(48, 48) * 255).astype(np.uint8)
    rgba = np.stack([a.T, a, 255 - a, a], axis=-1)
    Image.fromarray(rgba, "RGBA").save(d / "alpha.png")
    (d / "uvs.json").write_text(
        '{"texCoords": [[0.05, 0.1], [0.1, 0.9], [0.6, 0.2], [0.95, 0.85]],'
        ' "indices": [0, 1, 2, 3, 1, 2]}')
    (d / "in.bin").write_bytes(reuse_blob)
    return {"png": str(d / "alpha.png"), "uvs": str(d / "uvs.json"),
            "blob": str(d / "in.bin")}


# argv per case ({png}, {uvs}, {blob}: the inputs), and whether the
# subcommand bakes (takes --device / --backend)
CLI_CASES = {
    "bake_png": ("bake --texture {png} --subdivision-level 4 --out r.bin", 1),
    "bake_png_uvs": ("bake --texture {png} --uvs {uvs} --channel 0 "
                     "--two-state --embed-cutoff --alpha-cutoff 0.4 "
                     "--subdivision-level 5 --out r.bin --compress", 1),
    "bake_blob": ("bake --input-blob {blob} --out r.bin --compress", 1),
    "stats": ("stats {blob}", 1),
    "dump_images": ("dump-images {blob} --out-dir imgs --postfix p "
                    "--scale 2", 1),
    "dump_images_per_primitive": ("dump-images {blob} --out-dir imgs "
                                  "--per-primitive --monochrome --scale 1",
                                  1),
    "info": ("info {blob}", 0),
    "viewer_frame": ("viewer {blob} --frame --frame-rows 4 --frame-cols 12 "
                     "--zoom 0", 1),
    "viewer_inspect_reuse": ("viewer {blob} --reuse --inspect 0:5 --params",
                             1),
    "viewer_inspect_uv": ("viewer {blob} --inspect 1:0.4,0.55", 1),
    "viewer_tweak_save": ("viewer {blob} --set max_subdivision_level=3 "
                          "--set alpha_cutoff=0.4 --stats --render f.png "
                          "--scale 2 --zoom 1 --zoom-out z.png --save s.bin",
                          1),
    "viewer_bad_zoom": ("viewer {blob} --frame --zoom 99", 1),
}


def _run_cli(main, argv, cwd, monkeypatch, capsys):
    """(exit code, stdout, {file: bytes} written under cwd)."""
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    rc = main(argv)
    out = capsys.readouterr().out
    files = {}
    for root, _, names in os.walk(cwd):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, cwd)] = f.read()
    return rc, out, files


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_subcommand_equals_jax(case, cli_inputs, tmp_path, monkeypatch,
                                   capsys):
    template, bakes = CLI_CASES[case]
    argv = template.format(**cli_inputs).split()
    jargv = argv + (["--backend", "numpy"] if bakes else [])
    targv = argv + (["--device", "cpu"] if bakes else [])
    want = _run_cli(jcli.main, jargv, tmp_path / "j", monkeypatch, capsys)
    got = _run_cli(cli.main, targv, tmp_path / "t", monkeypatch, capsys)
    assert got[0] == want[0] == (2 if case == "viewer_bad_zoom" else 0)
    assert got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        assert got[2][k] == want[2][k], k
    if case.startswith("bake") or case.startswith("dump"):
        assert got[2], "the subcommand wrote nothing"


def test_cli_bench_runs_bench_py_in_a_child(monkeypatch):
    """`bench` starts bench.py as a child process (which may import jax;
    this process does not) and returns its exit code."""
    seen = []

    def fake_run(args, **kw):
        seen.append(args)
        return subprocess.CompletedProcess(args, 3)

    monkeypatch.setattr(cli.subprocess, "run", fake_run)
    assert cli.main(["bench"]) == 3
    assert seen == [[sys.executable, "bench.py"]]


def test_cli_rejects_unknown_device(capsys):
    with pytest.raises(SystemExit):
        cli.main(["stats", "x.bin", "--device", "tpu"])
    assert "invalid choice" in capsys.readouterr().err


# -- the vegetation scene (BASELINE.json config 5) ----------------------------

def test_vegetation_scene_through_baker():
    """tests/test_scene_e2e.py's scene (atlas 256, 60 quads over 5 UV
    variants, level 5, embedded cutoff, near-duplicate detection)
    through ot.Baker on the CPU: byte-equal to the JAX package's numpy
    backend, blob included."""
    sys.path.insert(0, EXAMPLES)
    try:
        from vegetation_scene import foliage_atlas, quad_mesh
    finally:
        sys.path.remove(EXAMPLES)
    atlas = foliage_atlas(256)
    uvs, indices = quad_mesh(60, n_uv_variants=5)
    out = []
    for pkg, kw in ((omm, {"backend": "numpy"}), (ot, {"device": "cpu"})):
        baker = pkg.Baker()
        tex = baker.create_texture([atlas], pkg.TextureFormat.FP32,
                                   alpha_cutoff=0.5)
        desc = pkg.BakeInputDesc(
            texture=tex, tex_coords=uvs, index_buffer=indices,
            index_count=len(indices), alpha_cutoff=0.5,
            max_subdivision_level=5,
            bake_flags=pkg.BakeFlags.EnableNearDuplicateDetection)
        res = baker.bake(desc, **kw)
        blob = baker.serialize(input_descs=[desc], result_descs=[res],
                               compress=True)
        out.append((res, blob, baker.get_stats(res)))
    (jr, jblob, js), (tr, tblob, ts) = out
    a, b = convert.result_to_numpy(jr), convert.result_to_numpy(tr)
    for k in a:
        assert np.array_equal(b[k], a[k]), k
    assert tblob == jblob and ts.__dict__ == js.__dict__
    tri_count = len(indices) // 3
    assert len(tr.desc_array) < tri_count // 3  # UV instances share OMMs
    rt = ot.serialize.deserialize(tblob).result_descs[0]
    assert np.array_equal(rt.array_data, tr.array_data)


def test_chip_smoke_scene_generators_equal_the_example():
    """chip_smoke.py keeps its own copy of the example's foliage_atlas and
    quad_mesh (it blocks the JAX package, which the example imports):
    the same arrays, at the chip run's sizes and at the tests'.  In a
    child process, because importing chip_smoke blocks jax there."""
    code = f"""
import sys
sys.path[:0] = [{REPO!r}, {EXAMPLES!r}]
import numpy as np
import vegetation_scene as ex
import chip_smoke as cs
assert np.array_equal(cs.foliage_atlas(512), ex.foliage_atlas(512))
assert np.array_equal(cs.foliage_atlas(64, seed=3), ex.foliage_atlas(64, 3))
for a, b in ((cs.quad_mesh(200), ex.quad_mesh(200)),
             (cs.quad_mesh(60, 5), ex.quad_mesh(60, n_uv_variants=5))):
    assert all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))
print("OK")
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("OK")
