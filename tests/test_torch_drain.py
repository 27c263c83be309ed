"""omm_tpu_torch's concurrent batch drain against the JAX package's
classify_work_items_batches (Pallas in interpret mode): the enqueue
thread, the slow items before the drain, the write-back pool and the
discovery reruns after it.  One call of seven batches that mixes cached
and uncached cap keys, a forced overflow, a partial batch, two
subdivision levels and slow-path items gives the JAX package's results,
posts and caps entries; the pool finishing out of order gives the same
bytes; errors in a write-back or an enqueue reach the caller with no
thread left running; a single batch is enqueued inline; bakes and GPU
baker dispatches on the drained chain are byte-equal to the numpy
oracle.  All comparisons are exact."""
import importlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
from omm_tpu import gpu as jgpu  # noqa: E402
from omm_tpu import native as jnative  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import batch, convert, routes  # noqa: E402
from omm_tpu_torch import gpu as tgpu  # noqa: E402
from omm_tpu_torch.twophase import PackedStates  # noqa: E402

from fixtures import standard_circle  # noqa: E402
from test_torch_post import _interp_pallas  # noqa: E402
from test_torch_twophase import _cfg, port_inputs  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

# the module, not the function the package exports under its name
tbake = importlib.import_module("omm_tpu_torch.bake")

UO = 3
#: a line triangle (exactly collinear in fp32): off the fast path, on
#: the degenerate route
LINE = np.array([[0.125, 0.25], [0.25, 0.375], [0.5, 0.625]], np.float32)


def _tris(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.25
        out.append(np.array([b + [0.05, 0.08], b + [0.12, 0.7],
                             b + [0.72, 0.6]], np.float32))
    return out


def _partial(tri, subdiv, k):
    st = np.full(omm.get_num_micro_triangles(subdiv), UO, np.uint8)
    st[k % 2::3] = 0  # resolved by an earlier pass: kept
    return (tri, st)


#: the call's batches: (subdiv, items); every fresh batch of one level
#: and size shares a cap key
def _mixed_call():
    t = _tris(15, seed=3)
    return [
        (5, [(t[0], None), (t[1], None)]),                 # key A5
        (5, [(t[2], None), (t[3], None)]),                 # key A5
        (5, [(t[4], None), (t[5], None), (t[6], None)]),   # key B5
        (5, [(t[7], None), _partial(t[8], 5, 1)]),         # partial, C5
        (4, [(t[9], None), (t[10], None)]),                # key A4
        (4, [(t[11], None), (LINE, None), (t[12], None)]),  # A4 + slow
        (4, [(t[13], None), (t[14], None), (LINE, None)]),  # A4 + slow
    ]


def _copy(call):
    return [[(tri, None if st is None else st.copy()) for tri, st in items]
            for _, items in call]


def _states(x):
    """(M,) states of a result: either package's PackedStates unpacked."""
    return x.unpack() if isinstance(x, (PackedStates, tp.PackedStates)) \
        else x


def _key(caps, subdiv, T, all_active=True):
    ks = [k for k in caps if k[0] == subdiv and k[2] == T
          and k[3] == all_active]
    assert len(ks) == 1, (subdiv, T, all_active, list(caps))
    return ks[0]


def _eighth(entry):
    Cs, K, nb = entry
    return (tuple(max(c // 8, 1) for c in Cs), max(K // 8, 1),
            tuple(max(n // 8, 1) for n in nb))


def _live_pool_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("omm-enqueue", "omm-post"))]


def test_mixed_call_matches_jax(monkeypatch):
    """Both packages classify the call once (every batch discovers),
    then again with B5's entry dropped (discovery) and A4's at an eighth
    (the three A4 batches overflow and rerun): results, posts and caps
    entries equal the JAX package's; the port's reruns run on the
    calling thread, in batch order, after the enqueue thread and the
    pool have stopped; its counts are the path of each batch."""
    _interp_pallas(monkeypatch)
    tex = omm.Texture([standard_circle(64, 64)], omm.TextureFormat.FP32)
    cfg = _cfg()
    ptex, pcfg = port_inputs(tex, cfg)
    call = _mixed_call()
    levels = [sd for sd, _ in call]
    tp.classify_work_items_batches(tex, cfg, _copy(call), levels)
    batch.classify_work_items_batches(ptex, pcfg, _copy(call), levels,
                                      device="cpu")
    assert ptex._omm_torch_caps == tex._omm_caps
    caps = dict(tex._omm_caps)
    assert len(caps) == 4
    b5, a4 = _key(caps, 5, 3), _key(caps, 4, 2)
    for c in (tex._omm_caps, ptex._omm_torch_caps):
        del c[b5]
        c[a4] = _eighth(caps[a4])

    jposts = []
    want = tp.classify_work_items_batches(tex, cfg, _copy(call), levels,
                                          post_out=jposts, packed_out=True)
    reruns = []
    run_batch = batch._run_batch

    def rerun(job):
        assert threading.current_thread() is threading.main_thread()
        assert not _live_pool_threads()
        before = routes.COUNTS["count_sync"]
        run_batch(job)
        reruns.append((job.subdiv, job.T,
                       routes.COUNTS["count_sync"] - before))

    monkeypatch.setattr(batch, "_run_batch", rerun)
    posts = []
    ot.reset_launches()
    got = batch.classify_work_items_batches(ptex, pcfg, _copy(call), levels,
                                            device="cpu", post_out=posts)
    pc = ot.pipeline_counts()
    fast = ot.launches()["route.fast_path"]
    # batches 0, 1, 3, 4, 5, 6 take the chain, 4-6 overflow; 2 and 4-6
    # rerun after the drain, in batch order
    assert [(sd, T) for sd, T, _ in reruns] == [(5, 3)] + [(4, 2)] * 3
    assert pc["spec"] == 6 and pc["spec_overflow"] == 3
    assert pc["discovery"] == 4
    assert pc["count_sync"] == 6 + sum(n for _, _, n in reruns)
    assert fast == sum(len(items) for _, items in call) - 2
    assert ot.launches()["route.degenerate"] == 2
    assert ptex._omm_torch_caps == tex._omm_caps == caps

    n_jax = 0
    for (sd, items), g, w, pd, jd in zip(call, got, want, posts, jposts):
        assert len(g) == len(items)
        for i, (tri, st) in enumerate(items):
            gs = _states(g[i])
            assert np.array_equal(gs, _states(w[i])), (sd, i)
            if st is not None:
                assert i not in pd
                keep = st != UO
                assert np.array_equal(gs[keep], st[keep])
            elif tri is not LINE:
                assert pd[i] == (jnative.states3_digest(gs),
                                 jnative.all_uniform_u8(gs)), (sd, i)
        for i, post in jd.items():
            assert pd[i] == post
            n_jax += 1
    assert n_jax > 0


def _chain_call(n=6, subdiv=4):
    t = _tris(2 * n, seed=9)
    return [[(t[2 * k], None), (t[2 * k + 1], None)] for k in range(n)]


def _on_chain(ptex, pcfg, subdiv=4):
    """Discover the chain call's caps: (results, posts) of the discovery
    call, the reference of the drained calls."""
    posts = []
    got = batch.classify_work_items_batches(ptex, pcfg, _chain_call(),
                                            subdiv, device="cpu",
                                            post_out=posts)
    return [[r.packed.copy() for r in out] for out in got], posts


def _rows_equal(got, ref):
    return all(np.array_equal(r.packed, w) for out, rw in zip(got, ref)
               for r, w in zip(out, rw))


def _port_circle():
    return port_inputs(omm.Texture([standard_circle(64, 64)],
                                   omm.TextureFormat.FP32), _cfg())


def test_pool_out_of_order_same_bytes(monkeypatch):
    """The post pass of the first batch sleeps longest, so the pool
    finishes it last: the results and posts equal the discovery call's,
    and the post passes ran on more than one thread, none of them the
    calling thread."""
    ptex, pcfg = _port_circle()
    ref, ref_posts = _on_chain(ptex, pcfg)
    first = np.stack(ref[0])
    orig = batch.native.row_post_packed
    lock = threading.Lock()
    threads, finished = [], []

    def post(packed, M, row_base=None):
        is_first = (packed.shape == first.shape
                    and np.array_equal(packed, first))
        with lock:
            threads.append(threading.get_ident())
        time.sleep(0.4 if is_first else 0.02)
        out = orig(packed, M, row_base=row_base)
        with lock:
            finished.append(is_first)
        return out

    monkeypatch.setattr(batch.native, "row_post_packed", post)
    ot.reset_launches()
    posts = []
    got = batch.classify_work_items_batches(ptex, pcfg, _chain_call(), 4,
                                            device="cpu", post_out=posts)
    assert ot.pipeline_counts()["spec"] == 6
    assert len(finished) == 6 and finished[-1] and not any(finished[:-1])
    assert len(set(threads)) >= 2
    assert threading.main_thread().ident not in threads
    assert _rows_equal(got, ref) and posts == ref_posts


def test_post_error_reaches_caller(monkeypatch):
    """An error in batch 3's post pass is raised by the call, every
    thread it started has stopped, and the next call is whole."""
    ptex, pcfg = _port_circle()
    ref, ref_posts = _on_chain(ptex, pcfg)
    third = np.stack(ref[3])
    orig = batch.native.row_post_packed

    def post(packed, M, row_base=None):
        if packed.shape == third.shape and np.array_equal(packed, third):
            raise RuntimeError("post pass of batch 3")
        return orig(packed, M, row_base=row_base)

    n0 = threading.active_count()
    monkeypatch.setattr(batch.native, "row_post_packed", post)
    with pytest.raises(RuntimeError, match="batch 3"):
        batch.classify_work_items_batches(ptex, pcfg, _chain_call(), 4,
                                          device="cpu", post_out=[])
    assert threading.active_count() == n0 and not _live_pool_threads()
    monkeypatch.setattr(batch.native, "row_post_packed", orig)
    posts = []
    got = batch.classify_work_items_batches(ptex, pcfg, _chain_call(), 4,
                                            device="cpu", post_out=posts)
    assert _rows_equal(got, ref) and posts == ref_posts


def test_enqueue_error_reaches_caller(monkeypatch):
    """An error in the third batch's chain, on the enqueue thread, is
    raised by the call, every thread it started has stopped, and the
    next call is whole."""
    ptex, pcfg = _port_circle()
    ref, ref_posts = _on_chain(ptex, pcfg)
    orig = batch.spec_chain
    calls = []

    def chain(*a, **k):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise RuntimeError("chain of batch 2")
        return orig(*a, **k)

    n0 = threading.active_count()
    monkeypatch.setattr(batch, "spec_chain", chain)
    with pytest.raises(RuntimeError, match="batch 2"):
        batch.classify_work_items_batches(ptex, pcfg, _chain_call(), 4,
                                          device="cpu", post_out=[])
    assert threading.active_count() == n0 and not _live_pool_threads()
    assert all(n.startswith("omm-enqueue") for n in calls)
    monkeypatch.setattr(batch, "spec_chain", orig)
    posts = []
    got = batch.classify_work_items_batches(ptex, pcfg, _chain_call(), 4,
                                            device="cpu", post_out=posts)
    assert _rows_equal(got, ref) and posts == ref_posts


@pytest.mark.parametrize("n", [1, 6])
def test_enqueue_thread_only_for_several_batches(n, monkeypatch):
    """A call of one fast batch enqueues it inline, on the calling
    thread, and makes no enqueue executor; a call of six issues every
    chain from one enqueue thread."""
    ptex, pcfg = _port_circle()
    call = _chain_call()[:n]
    batch.classify_work_items_batches(ptex, pcfg, call, 4, device="cpu")
    made, where = [], []
    pool_cls, orig = batch.ThreadPoolExecutor, batch.spec_chain

    class Recording(pool_cls):
        def __init__(self, max_workers, **kw):
            made.append(max_workers)
            super().__init__(max_workers, **kw)

    def chain(*a, **k):
        where.append(threading.get_ident())
        return orig(*a, **k)

    monkeypatch.setattr(batch, "ThreadPoolExecutor", Recording)
    monkeypatch.setattr(batch, "spec_chain", chain)
    ot.reset_launches()
    batch.classify_work_items_batches(ptex, pcfg, _chain_call()[:n], 4,
                                      device="cpu")
    assert ot.pipeline_counts()["spec"] == n and len(where) == n
    if n == 1:
        assert made == [batch.POST_WORKERS]
        assert where == [threading.get_ident()]
    else:
        assert made == [1, batch.POST_WORKERS]
        assert len(set(where)) == 1 and where[0] != threading.get_ident()


def test_concurrent_calls_under_fast_switching():
    """Six threads drain calls of six batches on one texture at once (as
    mesh slots do: 6 callers, 6 enqueue threads, up to 24 pool threads)
    with a switch interval of 10 us: every result and post equals the
    discovery call's, and no count is lost."""
    import sys
    ptex, pcfg = _port_circle()
    ref, ref_posts = _on_chain(ptex, pcfg)
    n0 = threading.active_count()

    def one(_):
        posts = []
        got = batch.classify_work_items_batches(
            ptex, pcfg, _chain_call(), 4, device="cpu", post_out=posts)
        return _rows_equal(got, ref) and posts == ref_posts

    si = sys.getswitchinterval()
    ot.reset_launches()
    sys.setswitchinterval(1e-5)
    try:
        callers = [threading.Thread(target=lambda k=k: ok.append(one(k)))
                   for k in range(6)]
        ok = []
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(si)
    assert not any(t.is_alive() for t in callers)
    assert ok == [True] * 6
    pc = ot.pipeline_counts()
    assert pc["spec"] == pc["count_sync"] == 36
    assert pc["discovery"] == pc["spec_overflow"] == 0
    assert ot.launches()["route.fast_path"] == 72
    assert threading.active_count() == n0


def _mesh_fields(n=12, subdiv=4):
    rng = np.random.RandomState(21)
    tris = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.3
        tris.append(np.array([b + [0.05, 0.1], b + [0.1, 0.6],
                              b + [0.6, 0.55]], np.float32))
    return dict(tex_coords=np.concatenate(tris),
                index_buffer=np.arange(3 * n, dtype=np.uint32),
                index_count=3 * n, max_subdivision_level=subdiv,
                dynamic_subdivision_scale=0.0)


def _small_batches(monkeypatch):
    """Batches of 4 items at subdivision 4, so the mesh takes 3: the
    bake's chunk rule, which the GPU baker runs too."""
    monkeypatch.setattr(tbake, "MAX_UTRI_PER_BATCH", 4 * 4 ** 4)


def test_bake_on_drained_chain_equals_oracle(monkeypatch):
    """ot.bake twice on one texture, in batches of 4: the first
    discovers, the second drains 3 batches on the chain (enqueue thread,
    post pool); both byte-equal to omm.bake(backend="numpy")."""
    _small_batches(monkeypatch)
    planes = [standard_circle(128, 128)]
    fields = dict(_mesh_fields(), alpha_cutoff=0.5)
    want = convert.result_to_numpy(omm.bake(omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat.FP32), **fields),
        backend="numpy"))
    tdesc = convert.bake_input(planes, 1, **fields)
    for path in ("discovery", "spec"):
        ot.reset_launches()
        got = convert.result_to_numpy(ot.bake(tdesc, device="cpu"))
        assert ot.pipeline_counts()[path] == 3
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_gpu_dispatch_on_drained_chain_equals_oracle(monkeypatch):
    """The GPU baker's dispatch twice on one config, in batches of 4:
    the second drains 3 batches on the chain; both byte-equal, result
    and PostDispatchInfo, to omm_tpu.gpu's numpy backend."""
    _small_batches(monkeypatch)
    plane = standard_circle(128, 128)
    fields = dict(_mesh_fields(), bake_flags=3 | 8)
    jcfg = jgpu.DispatchConfigDesc(
        alpha_texture=omm.Texture([plane], omm.TextureFormat.FP32),
        **fields)
    rj, pj = jgpu.Pipeline().dispatch(jcfg, backend="numpy").execute()
    want = convert.result_to_numpy(rj)
    tcfg = convert.dispatch_config([plane], 1, **fields)
    for path in ("discovery", "spec"):
        ot.reset_launches()
        rt, pt = tgpu.Pipeline().dispatch(tcfg, device="cpu").execute()
        assert ot.pipeline_counts()[path] == 3
        got = convert.result_to_numpy(rt)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
        assert convert.post_to_dict(pt) == convert.post_to_dict(pj)
