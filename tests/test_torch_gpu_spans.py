"""omm_tpu_torch.gpu's profiler spans and its scratch-batch counter: a
small GPU-baker dispatch on the CPU under a profiler opens every span
of the baker's host path, each nested as `gpu/baker.py` opens it (the
levels once, directly inside `omm.gpu.dispatch`, and a lone
`get_pre_dispatch_info` opens them once; the execute's parts directly
inside it, the bake's fine pass and the batch pipeline's spans inside
`omm.gpu.batches`, the CPU tail's names inside `omm.gpu.tail`); with no
profiler it enters no `record_function`; `pipeline_counts()["gpu_batch"]`
counts the dispatch's
`last_dispatch_stats["batch_count"]`; and a profiled dispatch gives the
bytes of an unprofiled one.

This file imports no jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import convert, spans  # noqa: E402
from omm_tpu_torch import gpu as tgpu  # noqa: E402

#: the spans gpu/baker.py opens directly inside omm.gpu.dispatch
DISPATCH_CHILDREN = ("omm.gpu.levels",)
#: the spans gpu/baker.py opens directly inside omm.gpu.execute
EXECUTE_CHILDREN = ("omm.gpu.work_setup", "omm.gpu.batches",
                    "omm.desc_patch", "omm.gpu.tail")
#: the CPU tail's names, inside omm.gpu.tail
TAIL_CHILDREN = ("omm.histograms", "omm.sort", "omm.serialize")
#: the bake's fine pass (bake.classify_fine) and the batch pipeline's
#: calling-thread spans, inside omm.gpu.batches
BATCH_CHILDREN = ("omm.chunk", "omm.plan", "omm.submit", "omm.drain",
                  "omm.post_wait", "omm.set_states")

TINY = 4 * 4 ** 4 * 8  # four level-4 primitives of scratch

BATCHING = {"one_batch": ({}, 1),
            "tiny_budget": ({"max_scratch_memory_size": TINY}, 4),
            "nsight": ({"bake_flags": 3 | 256}, 16)}


def _circle(n=128):
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = (n - 1) / 2
    return (np.hypot(i - c, j - c) < 0.3 * n).astype(np.float32)


def _cfg(**fields):
    """8 quads (16 triangles) on a 128^2 circle, each at level 4 by the
    area heuristic (dynamic scale 2); the first quad twice, so WorkSetup
    folds a duplicate."""
    rng = np.random.RandomState(4)
    quads, ib = [], []
    for q in range(8):
        b = rng.rand(2).astype(np.float32) * 0.5
        quads += [b, b + [0, 0.4], b + [0.4, 0], b + [0.4, 0.4]]
        k = 4 * q
        ib += [k, k + 1, k + 2, k + 3, k + 1, k + 2]
    ib += ib[:6]
    kw = dict(tex_coords=np.asarray(quads, np.float32),
              index_buffer=np.asarray(ib, np.uint32), index_count=len(ib),
              max_subdivision_level=4, dynamic_subdivision_scale=2.0)
    kw.update(fields)
    return convert.dispatch_config([_circle()], 1, **kw)


def _dispatch(cfg, pipe=None):
    return (pipe or tgpu.Pipeline()).dispatch(cfg, device="cpu").execute()


def _same(a, b):
    (ra, pa), (rb, pb) = a, b
    x, y = convert.result_to_numpy(ra), convert.result_to_numpy(rb)
    assert x.keys() == y.keys()
    for k in x:
        assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
    assert convert.post_to_dict(pa) == convert.post_to_dict(pb)


def _profiled(cfg):
    """(the dispatch's output, [(name, thread, start, end)] of its omm.*
    spans), profiled on every thread."""
    exp = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=exp) as prof:
        out = _dispatch(cfg)
    return out, [(e.name, e.thread, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name.startswith("omm.")]


def _inside(x, y):
    return x[1] == y[1] and y[2] <= x[2] <= x[3] <= y[3]


def test_dispatch_shows_every_span_nested():
    _, ev = _profiled(_cfg())
    names = {n for n, *_ in ev}
    for label in ("omm.gpu.dispatch", "omm.gpu.execute", *DISPATCH_CHILDREN,
                  *EXECUTE_CHILDREN, *BATCH_CHILDREN, *TAIL_CHILDREN):
        assert label in names, label
    (dispatch,) = [x for x in ev if x[0] == "omm.gpu.dispatch"]
    (execute,) = [x for x in ev if x[0] == "omm.gpu.execute"]
    assert dispatch[3] <= execute[2]
    # _subdiv_levels once a dispatch: the chain and its execute() share
    # the levels and the pre-dispatch info
    (levels,) = [x for x in ev if x[0] == "omm.gpu.levels"]
    assert _inside(levels, dispatch) and not _inside(levels, execute)
    children = [x for x in ev
                if x[0] in DISPATCH_CHILDREN + EXECUTE_CHILDREN]
    for x in children:
        assert _inside(x, dispatch if x[0] in DISPATCH_CHILDREN
                       else execute), x[0]
        # direct children: none inside another
        assert not any(_inside(x, y) for y in children if y is not x), x[0]
    # the schedule key and WorkSetup
    assert sum(x[0] == "omm.gpu.work_setup" for x in ev) == 2
    (batches,) = [x for x in ev if x[0] == "omm.gpu.batches"]
    (tail,) = [x for x in ev if x[0] == "omm.gpu.tail"]
    for x in ev:
        if x[0] in BATCH_CHILDREN:
            assert _inside(x, batches), x[0]
        if x[0] in TAIL_CHILDREN:
            assert _inside(x, tail), x[0]


def test_lone_pre_dispatch_info_opens_one_levels_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tgpu.Pipeline().get_pre_dispatch_info(_cfg())
    names = [e.name for e in prof.events() if e.name.startswith("omm.")]
    assert names == ["omm.gpu.levels"]


def test_dispatch_without_a_profiler_enters_no_record_function(
        monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(spans, "record_function", counting)
    _dispatch(_cfg())
    assert entered == []


@pytest.mark.parametrize("case", sorted(BATCHING))
def test_gpu_batch_counts_the_dispatch_batches(case):
    fields, want = BATCHING[case]
    pipe = tgpu.Pipeline()
    before = ot.pipeline_counts()["gpu_batch"]
    _dispatch(_cfg(**fields), pipe)
    got = ot.pipeline_counts()["gpu_batch"] - before
    assert got == pipe.last_dispatch_stats["batch_count"] == want


@pytest.mark.parametrize("case", sorted(BATCHING))
def test_profiled_dispatch_gives_the_same_bytes(case):
    cfg = _cfg(**BATCHING[case][0])
    plain = _dispatch(cfg)
    traced, ev = _profiled(cfg)
    assert any(x[0] == "omm.gpu.execute" for x in ev)
    _same(plain, traced)
