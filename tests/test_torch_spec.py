"""omm_tpu_torch's single-sync batch pipeline against the JAX package's:
the capacity buckets, compaction to a capacity, the descent at
capacities (`stage_ab_spec` against `_stageAB`, the jitted XLA program,
no Pallas), the caps cache's entries, and bakes that take the capacity
chain (on the CPU, eagerly) byte-equal to the discovery path and to the
numpy oracle, overflow and partial batches included.  All comparisons
are exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import omm_tpu as omm  # noqa: E402
from omm_tpu import engine  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import batch, convert, host  # noqa: E402
from omm_tpu_torch import twophase as ttp  # noqa: E402

from fixtures import standard_circle  # noqa: E402
from test_torch_twophase import _cfg, port_inputs  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

UO = 3
WRAP = omm.TextureAddressMode.Wrap

_RNG_NS = np.random.RandomState(5).randint(0, 1 << 22, size=12).tolist()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13, 95,
                               96, 97, 127, 128, 129, 191, 192, 193,
                               (1 << 20) - 1, 1 << 20, (1 << 20) + 1]
                         + _RNG_NS)
def test_bucket_matches_jax(n):
    """host._bucket and _next_pow2 are twophase's, on edge cases and a
    seeded sample."""
    assert host._next_pow2(n) == tp._next_pow2(n)
    assert host._bucket(n) == tp._bucket(n)
    assert host._bucket(n) >= n


@pytest.mark.parametrize("cap_of", ["below", "equal", "above"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_scan_matches_compact_sort(cap_of, seed):
    """compact_scan and _compact_sort give the same count and the same
    first min(count, cap) lanes, for caps below, at and above n."""
    rng = np.random.RandomState(seed)
    n = 1000
    mask = rng.rand(n) < 0.3
    payload = rng.randint(0, 1 << 20, size=n).astype(np.int32)
    cnt_true = int(mask.sum())
    cap = {"below": cnt_true // 2, "equal": n, "above": n + 77}[cap_of]
    want, wcnt = tp._compact_sort(jnp.asarray(mask), jnp.asarray(payload),
                                  cap)
    got, gcnt = ttp.compact_scan(torch.from_numpy(mask),
                                 torch.from_numpy(payload.astype(np.int64)),
                                 cap)
    assert int(gcnt) == int(wcnt) == cnt_true
    k = min(cnt_true, cap)
    assert got.shape == (cap,)
    assert np.array_equal(got.numpy()[:k], np.asarray(want)[:k])


def _tris(n, seed=7, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.25
        t = np.array([b + [0.05, 0.08], b + [0.12, 0.7], b + [0.72, 0.6]],
                     np.float32)
        out.append((t * np.float32(scale) + np.float32(shift)).astype(
            np.float32))
    return out


def _partial(tris, subdiv):
    M = omm.get_num_micro_triangles(subdiv)
    out = []
    for k, t in enumerate(tris):
        st = np.full(M, UO, np.uint8)
        st[k % 2::3] = 0  # resolved by an earlier pass: must be kept
        out.append((t, st))
    return out


def _chain_wrap():
    """A wrapped 3-mip chain of the circle (64/32/16) under triangles
    spanning three periods."""
    mips = [standard_circle(64, 64)]
    mips += [mips[0][::2, ::2].copy(), mips[0][::4, ::4].copy()]
    return omm.Texture(mips, omm.TextureFormat.FP32)


#: name -> (texture, cfg, items); subdivision 5
AB_CASES = {
    "circle2": lambda: (omm.Texture([standard_circle(64, 64)],
                                    omm.TextureFormat.FP32), _cfg(),
                        [(t, None) for t in _tris(2)]),
    "circle6": lambda: (omm.Texture([standard_circle(64, 64)],
                                    omm.TextureFormat.FP32), _cfg(),
                        [(t, None) for t in _tris(6, seed=11)]),
    "chain_wrap": lambda: (_chain_wrap(), _cfg(addr_mode=WRAP),
                           [(t, None) for t in _tris(3, seed=3, scale=3.0,
                                                     shift=1.0)]),
    "partial": lambda: (omm.Texture([standard_circle(64, 64)],
                                    omm.TextureFormat.FP32), _cfg(),
                        _partial(_tris(3, seed=5), 5)),
}


def _fast_items(tex, cfg, items, subdiv):
    uvs = np.stack([t for t, _ in items])
    lg = tp._group_level(tex, list(uvs), subdiv)
    mask = tp._fast_path_mask(tex, cfg, uvs, subdiv, lg)
    return [it for it, ok in zip(items, mask) if ok]


@pytest.mark.parametrize("roomy", [True, False], ids=["roomy", "tight"])
@pytest.mark.parametrize("case", sorted(AB_CASES))
def test_stage_ab_spec_matches_stageAB(case, roomy):
    """stage_ab_spec and _stageAB at the same capacities: equal meta
    (counts, flag and padded slot totals), equal validity, and equal
    sides, nodes, survivor ids and slots on the valid lanes.  Tight
    capacities (half the true counts) must set the flag on both."""
    subdiv = 5
    tex, cfg, items = AB_CASES[case]()
    items = _fast_items(tex, cfg, items, subdiv)
    T = len(items)
    assert T >= 2
    all_active = all(st is None for _, st in items)
    ctx = tp._BatchCtx(tex, cfg, items, subdiv, list(range(T)), [None] * T,
                       all_active=all_active)
    m = len(ctx.levels) - 1
    M = ctx.M
    # the true counts, at capacities that hold everything
    full = ctx.stage_ab([T * 4 ** ctx.levels[i] for i in range(m)], T * M)
    meta_full = np.asarray(full[4])
    assert int(meta_full[m + 1]) == 0
    if roomy:
        Cs = [host._bucket(int(c) + 64) for c in meta_full[:m]]
        K_cap = host._bucket(int(meta_full[m]) + 64)
    else:
        Cs = [max(int(c) // 2, 1) for c in meta_full[:m]]
        K_cap = max(int(meta_full[m]) // 2, 1)
    sides, nodes, ids, kvalid, meta, slots = ctx.stage_ab(Cs, K_cap)
    want_meta = np.asarray(meta)
    assert int(want_meta[m + 1]) == (0 if roomy else 1)

    uvs = [t for t, _ in items]
    ptex, pcfg = port_inputs(tex, cfg)
    pre = batch.precompute(ptex, uvs, subdiv,
                           host._group_level(ptex, uvs, subdiv))
    bp = batch.batch_planes(ptex, pcfg, pre, "cpu")
    uv_flat, _ = batch.item_tables(np.stack(uvs), "cpu")
    active = None if all_active else torch.from_numpy(np.stack(
        [st == UO for _, st in items]))
    got = ttp.stage_ab_spec(
        bp["cls_lv"], uv_flat, active, subdiv=subdiv,
        levels=tuple(bp["levels"]), caps=tuple(Cs), K_cap=K_cap,
        mips=bp["mips"], pads=bp["pads"], ntxs=bp["ntxs"],
        periods=bp["periods"], all_active=all_active)
    assert got["meta"].dtype == torch.int32
    assert np.array_equal(got["meta"].numpy(), want_meta)

    assert len(got["sides"]) == len(sides)
    assert np.array_equal(got["sides"][0].numpy(), np.asarray(sides[0]))
    for i, ((gn, gv), (wn, wv)) in enumerate(zip(got["nodes"], nodes)):
        wv = np.asarray(wv)
        assert np.array_equal(gv.numpy(), wv)
        assert np.array_equal(gn.numpy()[wv], np.asarray(wn)[wv])
        assert np.array_equal(got["sides"][i + 1].numpy()[wv],
                              np.asarray(sides[i + 1])[wv])
    kv = np.asarray(kvalid)
    assert kv.any()
    assert np.array_equal(got["kvalid"].numpy(), kv)
    assert np.array_equal(got["ids"].numpy()[kv], np.asarray(ids)[kv])
    for g, (w, _) in zip(got["slots"], slots):
        assert np.array_equal(g.numpy()[kv], np.asarray(w)[kv])


def _payload_rows(buf, levels, nmips, T, M):
    m = len(levels) - 1
    hdr = 4 * (m + 2 + nmips)
    return buf[:hdr].view(np.int32), buf[hdr:].reshape(T, M // 4)


@pytest.mark.parametrize("case", sorted(AB_CASES))
def test_spec_chain_equals_discovery_stages(case):
    """The capacity chain's payload at the caps the discovery path
    records: the meta's counts are the true ones, the flag is 0, and
    the packed rows equal stage_d's."""
    subdiv = 5
    tex, cfg, items = AB_CASES[case]()
    items = _fast_items(tex, cfg, items, subdiv)
    ptex, pcfg = port_inputs(tex, cfg)
    uvs = [t for t, _ in items]
    all_active = all(st is None for _, st in items)
    pre = batch.precompute(ptex, uvs, subdiv,
                           host._group_level(ptex, uvs, subdiv))
    job = batch._Batch(ptex, pcfg, items, subdiv, list(range(len(items))),
                       [None] * len(items), all_active, pre,
                       torch.device("cpu"), None)
    batch._run_batch(job)
    disc = list(job.out)
    entry = ptex._omm_torch_caps[job.cap_key]
    caps, buf, ev = batch._enqueue_spec(job)
    assert caps == entry and ev is None
    meta, rows = _payload_rows(buf.numpy(), job.bp["levels"],
                               len(job.bp["mips"]), job.T, job.M)
    m = len(job.bp["levels"]) - 1
    assert int(meta[m + 1]) == 0
    rows = batch._drain_spec(job, (caps, buf, ev))
    assert rows is not None
    job.write_back(rows)
    for a, b in zip(disc, job.out):
        a = a.packed if isinstance(a, ttp.PackedStates) else a
        b = b.packed if isinstance(b, ttp.PackedStates) else b
        assert np.array_equal(a, b)


def _jax_batches(tris, subdiv, partial):
    if partial:
        return [_partial(tris[k:k + 2], subdiv) for k in range(0, 6, 2)]
    return [[(t, None) for t in tris[k:k + 2]] for k in range(0, 6, 2)]


@pytest.mark.parametrize("partial", [False, True], ids=["fresh", "partial"])
def test_caps_entries_equal_jax(partial):
    """After the same batches, the port's caps cache equals the JAX
    package's texture._omm_caps (its discovery path, exact engine
    "xla"), keys and entries; then a second call takes the capacity
    chain for every batch, byte-equal to the first and to the oracle."""
    subdiv = 5
    M = omm.get_num_micro_triangles(subdiv)
    tex = omm.Texture([standard_circle(64, 64)], omm.TextureFormat.FP32)
    cfg = _cfg()
    tris = _tris(6, seed=11)
    tp.classify_work_items_batches(tex, cfg, _jax_batches(tris, subdiv,
                                                          partial),
                                   subdiv, exact_engine="xla")
    ptex, pcfg = port_inputs(tex, cfg)
    first = batch.classify_work_items_batches(
        ptex, pcfg, _jax_batches(tris, subdiv, partial), subdiv,
        device="cpu")
    assert ptex._omm_torch_caps == tex._omm_caps
    assert len(tex._omm_caps) == 1

    ot.reset_launches()
    second = batch.classify_work_items_batches(
        ptex, pcfg, _jax_batches(tris, subdiv, partial), subdiv,
        device="cpu")
    counts = ot.launches()
    pc = ot.pipeline_counts()
    assert pc["spec"] == 3
    assert pc["discovery"] == pc["spec_overflow"] == 0
    assert pc["count_sync"] == 3
    flat = []
    for a, b in zip(first, second):
        for x, y in zip(a, b):
            x = x.unpack() if isinstance(x, ttp.PackedStates) else x
            y = y.unpack() if isinstance(y, ttp.PackedStates) else y
            assert np.array_equal(x, y)
            flat.append(y)
    for (t, st), got in zip([it for b in _jax_batches(tris, subdiv, partial)
                             for it in b], flat):
        want = engine.resample_fine_item(
            tex, cfg, t, subdiv, np.full(M, UO, np.uint8) if st is None
            else st)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("small", ["all", "blocks"])
@pytest.mark.parametrize("partial", [False, True], ids=["fresh", "partial"])
def test_speculative_overflow_recovers(partial, small):
    """tests/test_twophase.py's overflow recovery on the port: a caps
    cache seeded with capacities far too small ("all"), or with only the
    exact stage's block capacity too small ("blocks": the flag comes from
    the padded slot total), makes the capacity chain flag an overflow;
    the batch is rerun on the discovery path, exactly, and its entry is
    replaced by the one the discovery path records."""
    subdiv = 5
    M = omm.get_num_micro_triangles(subdiv)
    tex = omm.Texture([standard_circle(64, 64)], omm.TextureFormat.FP32)
    cfg = _cfg()
    tris = _tris(2)
    items = (_partial(tris, subdiv) if partial
             else [(t, np.full(M, UO, np.uint8)) for t in tris])
    ptex, pcfg = port_inputs(tex, cfg)
    lg = host._group_level(ptex, tris, subdiv)
    levels = host._descend_levels(ptex, tris, subdiv, lg)
    key = (subdiv, levels, 2, not partial)
    if small == "all":
        small = (tuple(8 for _ in levels[1:]), 8, (1,))
    else:
        batch.classify_work_items_batches(ptex, pcfg, [items], subdiv,
                                          device="cpu")
        Cs, K_cap, _ = ptex._omm_torch_caps[key]
        small = (Cs, K_cap, (1,))
    ptex._omm_torch_caps = {key: small}
    ot.reset_launches()
    got, = batch.classify_work_items_batches(ptex, pcfg, [items], subdiv,
                                             device="cpu")
    counts = ot.launches()
    pc = ot.pipeline_counts()
    assert pc["spec"] == pc["spec_overflow"] == 1
    assert pc["discovery"] == 1
    entry = ptex._omm_torch_caps[key]
    assert entry != small and entry[2][0] > small[2][0]
    for (t, st), res in zip(items, got):
        res = res.unpack() if isinstance(res, ttp.PackedStates) else res
        assert np.array_equal(res, engine.resample_fine_item(
            tex, cfg, t, subdiv, st))


def test_bake_twice_takes_the_capacity_chain():
    """ot.bake(desc, device="cpu") twice on one texture: the first bake
    discovers, the second runs every fast-path batch through the
    capacity chain; both byte-equal to omm.bake(backend="numpy")."""
    rng = np.random.RandomState(42)
    n, subdiv = 8, 5
    tris = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.2
        tris.append(np.array([b + [0.05, 0.1], b + [0.1, 0.7],
                              b + [0.7, 0.65]], np.float32))
    planes = [standard_circle(128, 128)]
    fields = dict(tex_coords=np.concatenate(tris),
                  index_buffer=np.arange(3 * n, dtype=np.uint32),
                  index_count=3 * n, alpha_cutoff=0.5,
                  max_subdivision_level=subdiv,
                  dynamic_subdivision_scale=0.0)
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture(planes, omm.TextureFormat.FP32), **fields)
    tdesc = convert.bake_input(planes, 1, **fields)
    want = convert.result_to_numpy(omm.bake(jdesc, backend="numpy"))
    for k in range(2):
        ot.reset_launches()
        got = convert.result_to_numpy(ot.bake(tdesc, device="cpu"))
        counts = ot.launches()
        pc = ot.pipeline_counts()
        assert got.keys() == want.keys()
        for key in want:
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(want[key])), key
        path = "discovery" if k == 0 else "spec"
        assert pc[path] >= 1
        assert pc["spec"] + pc["discovery"] == pc[path]
    assert tdesc.texture._omm_torch_caps
