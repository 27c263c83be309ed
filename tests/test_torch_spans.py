"""omm_tpu_torch's profiler spans (`spans.span`): no `record_function`
entered while no profiler runs; spans on the calling thread and on
worker threads under `profile_all_threads`; `spans.py` the only module
of the port that imports `record_function`; every span of the set-up
and the batch pipeline in a CPU bake, the set-up's inside `omm.setup`;
the pinned host tensors of a graph replay counted (card only); and
`setup_work_items`, whose triangle loop runs as a level pass and a dedup
pass, against the single loop it replaced, kept here as the reference.

This file imports no jax; its card test also runs where jax is not
installed:

    python -m pytest --noconftest tests/test_torch_spans.py -q -k pinned
"""
import ast
import importlib
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import convert, spans  # noqa: E402
from omm_tpu_torch.types import (BakeError, Format,  # noqa: E402
                                 MAX_SUBDIV_LEVEL, Result)

# the package exports a bake() function under the module's name
tbake = importlib.import_module("omm_tpu_torch.bake")

PKG = os.path.dirname(os.path.abspath(ot.__file__))

#: the spans this file requires of a CPU bake that takes every step
SETUP_SPANS = ("omm.setup.validate", "omm.setup.triangles",
               "omm.setup.levels", "omm.setup.dedup")
CLASSIFY_SPANS = ("omm.plan", "omm.chunk", "omm.submit", "omm.slow",
                  "omm.post_wait", "omm.discovery", "omm.set_states")


def _all_threads():
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=cfg)


def test_span_outside_a_profiler_enters_no_record_function(monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(spans, "record_function", counting)
    for _ in range(5):
        with spans.span("omm.test"):
            pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("omm.test"):
            pass
    assert entered == ["omm.test"]
    with spans.span("omm.test"):
        pass
    assert entered == ["omm.test"]


def test_spans_on_calling_and_worker_threads():
    def work():
        with spans.span("omm.test_worker"):
            pass

    with _all_threads() as prof:
        with spans.span("omm.test_caller"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    threads = {}
    for e in prof.events():
        threads.setdefault(e.name, set()).add(e.thread)
    assert "omm.test_caller" in threads and "omm.test_worker" in threads
    assert threads["omm.test_caller"] != threads["omm.test_worker"]


def test_only_spans_imports_record_function():
    """No module of the port but spans.py names record_function: no
    import of it and no attribute access to it."""
    users = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                named = (
                    isinstance(node, ast.alias)
                    and node.name.split(".")[-1] == "record_function"
                ) or (isinstance(node, ast.Attribute)
                      and node.attr == "record_function")
                if named:
                    users.append(os.path.relpath(path, PKG))
    assert sorted(set(users)) == ["spans.py"]


def _circle(n=128):
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = (n - 1) / 2
    return (np.hypot(i - c, j - c) < 0.3 * n).astype(np.float32)


def _mixed_desc(slow=True):
    """Two small triangles at level 5 (the fast path; on a new texture
    the discovery path), one of them twice (dedup), and with `slow` the
    whole texture at level 1 (below the two-phase engine's levels: the
    slow route)."""
    small = np.array([[0.2, 0.2], [0.3, 0.6], [0.6, 0.5]], np.float32)
    tris = [small, small + 0.1, small]
    if slow:
        tris.append(np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]],
                             np.float32))
    n = len(tris)
    return convert.bake_input(
        [_circle()], 1, tex_coords=np.concatenate(tris),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        max_subdivision_level=5, dynamic_subdivision_scale=0.0,
        subdivision_levels=np.array([5, 5, 5, 1][:n], np.uint8))


def test_cpu_bake_shows_every_span():
    desc = _mixed_desc()
    with _all_threads() as prof:
        ot.bake(desc, device="cpu")
    ev = [(e.name, e.thread, e.time_range.start, e.time_range.end)
          for e in prof.events() if e.name.startswith("omm.")]
    names = {n for n, *_ in ev}
    for label in SETUP_SPANS + CLASSIFY_SPANS:
        assert label in names, label
    setup = [x for x in ev if x[0] == "omm.setup"]
    assert len(setup) == 1
    _, th, s0, s1 = setup[0]
    inner = [x for x in ev if x[0] in SETUP_SPANS]
    assert len(inner) == 5  # validate twice
    for name, t, s, e in inner:
        assert t == th and s0 <= s <= e <= s1, name
    classify = [x for x in ev if x[0] == "omm.classify"]
    assert len(classify) == 1
    _, th, c0, c1 = classify[0]
    for name, t, s, e in ev:
        if name in CLASSIFY_SPANS:
            assert t == th and c0 <= s <= e <= c1, name


def test_cpu_bake_enters_no_slow_or_discovery_span_without_their_work():
    """A second bake of the same mesh finds its caps entry, and its items
    all take the fast path: neither span is entered."""
    desc = _mixed_desc(slow=False)
    ot.bake(desc, device="cpu")
    with _all_threads() as prof:
        ot.bake(desc, device="cpu")
    names = {e.name for e in prof.events()}
    assert "omm.slow" not in names and "omm.discovery" not in names
    assert "omm.plan" in names and "omm.post_wait" in names


def test_pinned_alloc_counts_three_per_graph_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    small = np.array([[0.2, 0.2], [0.3, 0.6], [0.6, 0.5]], np.float32)
    desc = convert.bake_input(
        [_circle(256)], 1,
        tex_coords=np.concatenate([small, small + 0.1, small + 0.2]),
        index_buffer=np.arange(9, dtype=np.uint32), index_count=9,
        max_subdivision_level=6, dynamic_subdivision_scale=0.0)
    for _ in range(3):  # discovery, capture, replay
        ot.bake(desc, device="cuda")
    ot.reset_launches()
    for _ in range(2):
        ot.bake(desc, device="cuda")
    torch.cuda.synchronize()
    pc = ot.pipeline_counts()
    assert pc["graph_replay"] == 2 and pc["graph_capture"] == 0
    assert pc["pinned_alloc"] == 3 * pc["graph_replay"]


# ---------------------------------------------------------------------------
# setup_work_items against the single loop it replaced
# ---------------------------------------------------------------------------

def _one_loop_setup(desc, opts):
    """setup_work_items as one loop over the triangles (level, skip,
    format, key and item per triangle): the reference for the two-pass
    form."""
    tex = desc.texture
    from omm_tpu_torch import geom
    tris = geom.triangles_from_indices(
        np.asarray(desc.index_buffer)[:desc.index_count], desc.tex_coords,
        desc.tex_coord_format, desc.tex_coord_stride_in_bytes)
    tri_count = desc.index_count // 3
    tris = tris[:tri_count]
    items, key_to_item = [], {}
    inv_arr = np.asarray(geom.is_invalid(tris)).reshape(tri_count)
    if opts.disable_level_line_intersection:
        inv_arr = inv_arr | np.asarray(
            geom.is_degenerate(tris)).reshape(tri_count)
    const_subdiv = (desc.subdivision_levels is None
                    and not desc.dynamic_subdivision_scale > 0)
    for i in range(tri_count):
        uv_tri = tris[i]
        subdiv = desc.max_subdivision_level if const_subdiv \
            else tbake.get_subdivision_level(desc, opts, i, uv_tri,
                                             tex.size(0))
        if subdiv == tbake.DISABLED_PRIMITIVE or bool(inv_arr[i]):
            continue
        fmt = desc.format
        if desc.formats is not None \
                and int(desc.formats[i]) != int(Format.INVALID):
            fmt = Format(int(desc.formats[i]))
        key = (uv_tri.tobytes(), subdiv, int(fmt))
        hit = key_to_item.get(key)
        if hit is None or opts.disable_duplicate_detection:
            if subdiv > MAX_SUBDIV_LEVEL:
                raise BakeError(Result.INVALID_ARGUMENT,
                                "subdivisionLevel exceeds kMaxSubdivLevel")
            key_to_item[key] = len(items)
            items.append((subdiv, int(fmt), uv_tri.tobytes(), [i]))
        else:
            items[hit][3].append(i)
    return items


def _tris(n, seed, size=0.35):
    rng = np.random.RandomState(seed)
    base = rng.uniform(0.05, 0.6, size=(n, 1, 2))
    return (base + rng.uniform(0, size, size=(n, 3, 2))).astype(np.float32)


def _with_repeats(tris, invalid=True):
    """tris, two of them again, and a triangle of NaNs (invalid; the
    edge heuristic, like the SDK's, takes no NaN)."""
    nan = np.full((int(invalid), 3, 2), np.nan, np.float32)
    return np.concatenate([tris, tris[:2], nan])


LEVELS = {
    "constant": lambda: dict(
        tex_coords=_with_repeats(_tris(8, 1)),
        max_subdivision_level=5, dynamic_subdivision_scale=0.0),
    "area_heuristic": lambda: dict(
        tex_coords=_with_repeats(_tris(12, 2, size=0.5)),
        max_subdivision_level=9, dynamic_subdivision_scale=2.0),
    "edge_heuristic": lambda: dict(
        tex_coords=_with_repeats(_tris(10, 3), invalid=False),
        bake_flags=int(ot.BakeFlags.EnableEdgeHeuristic),
        max_subdivision_level=7, dynamic_subdivision_scale=3.0),
    "per_triangle": lambda: dict(
        tex_coords=_with_repeats(_tris(10, 4)),
        max_subdivision_level=7, dynamic_subdivision_scale=3.0,
        subdivision_levels=np.array([3, 13, 14, 5, 2, 13, 1, 0, 4, 13,
                                     3, 13, 6], np.uint8),
        formats=np.array([1, 2, 0, 2, 1, 0, 2, 2, 1, 0, 1, 2, 0],
                         np.uint8)),
}


def _setup_desc(fields):
    tc = fields.pop("tex_coords")
    n = tc.shape[0]
    return convert.bake_input(
        [_circle(64)], 1, tex_coords=tc.reshape(-1, 2),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        **fields)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("case", sorted(LEVELS))
def test_setup_work_items_equals_the_single_loop(case, dedup):
    fields = LEVELS[case]()
    if not dedup:
        fields["bake_flags"] = fields.get("bake_flags", 0) | int(
            ot.BakeFlags.DisableDuplicateDetection)
    desc = _setup_desc(fields)
    opts = tbake.Options.from_flags(desc.bake_flags)
    want = _one_loop_setup(desc, opts)
    got = [(it.subdivision_level, int(it.vm_format), it.uv_tri.tobytes(),
            list(it.primitive_indices))
           for it in tbake.setup_work_items(desc, opts)]
    assert got == want and len(want) > 1
    assert len({lv for lv, *_ in want}) > (case != "constant")


@pytest.mark.parametrize("case", sorted(LEVELS))
def test_setup_work_items_level_above_the_maximum_raises(case):
    """A level above the maximum (a descriptor that skipped validation)
    raises the same BakeError from both forms."""
    fields = LEVELS[case]()
    fields["max_subdivision_level"] = MAX_SUBDIV_LEVEL + 1
    if case == "per_triangle":
        # levels above 12 in the list take the maximum
        fields["dynamic_subdivision_scale"] = 0.0
    elif case != "constant":
        # a heuristic clamped at the maximum
        fields["dynamic_subdivision_scale"] = 1e-3
    desc = _setup_desc(fields)
    opts = tbake.Options.from_flags(desc.bake_flags)
    errs = []
    for fn in (_one_loop_setup, tbake.setup_work_items):
        with pytest.raises(BakeError) as ei:
            fn(desc, opts)
        errs.append((int(ei.value.result), str(ei.value)))
    assert errs[0] == errs[1]
    assert errs[0][0] == int(Result.INVALID_ARGUMENT)
