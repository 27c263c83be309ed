"""omm_tpu_torch's descent and tile-slot kernels (`kernels.chain`): the
plain versions against the JAX package's `_sides_for` and the slots and
tile keys of `_stageAB` (the jitted XLA program), the g++ build of the
kernels' code (`csrc/chain_host.cpp`) against the plain versions, and
the first batch of the benchmark workload through the capacity chain,
byte-equal to the payload the port gave before these kernels existed.
All comparisons are exact, on inputs made from seeded numpy draws."""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import omm_tpu as omm  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu_torch import batch, host  # noqa: E402
from omm_tpu_torch import twophase as ttp  # noqa: E402
from omm_tpu_torch.kernels import build, chain  # noqa: E402

from fixtures import sine_fp32, standard_circle  # noqa: E402
from test_torch_twophase import _cfg, port_inputs  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

B = host.B
UO = 3
INVALID = chain.INVALID_TILE

# ---------------------------------------------------------------------------
# kernel A: one descent level against _sides_for, levels 0-12
# ---------------------------------------------------------------------------

MIPS = [(64, 48), (32, 24), (16, 12)]
#: small pads, so that clamp-mode anchors pass the class plane's far
#: edges.  They stay at or above its near edges: the fast path keeps
#: every window inside the padded plane, and below 0 jnp's indexing adds
#: the axis length before XLA's gather clamps, where the port clamps.
PADS = [4, 6, 9]


def _periods(mode, mips):
    if mode == "wrap":
        return [(w, h) for w, h in mips]
    if mode == "mirror":
        return [(2 * w, 2 * h) for w, h in mips]
    return [None] * len(mips)


def _class_plane(w, h, pad, period):
    """A class plane of one mip (+1 / -1 / 0 int8, one period plus the
    apron in periodic modes): the sign of sin(7u) cos(5v) at each texel's
    UV, 0 in a band around the cutoff, so that the mips mostly agree."""
    pw, ph = period if period is not None else (w, h)
    u = (np.arange(pw + 2 * pad) - pad + 0.5) / w
    v = (np.arange(ph + 2 * pad) - pad + 0.5) / h
    f = np.sin(7 * u)[None, :] * np.cos(5 * v)[:, None]
    return np.where(f > 0.3, 1, np.where(f < -0.3, -1, 0)).astype(np.int8)


def _level_inputs(level, mode, nmips, seed):
    """(uv (T, 6) fp32, class planes, mips, pads, periods, parents or
    None, E) for one descent level: 40 items; level 0 takes every item as
    a parent (E = 1), later levels 200 parents at level - 1 (E = 4)."""
    rng = np.random.RandomState(seed)
    T = 40
    # clamp: every corner at or above 0 (level 0's is p1 + p2 - p0), and
    # past the plane's far edge
    lo, hi = (0.6, 1.25) if mode == "clamp" else (-1.7, 2.6)
    uv = rng.uniform(lo, hi, (T, 6)).astype(np.float32)
    mips, pads = MIPS[:nmips], PADS[:nmips]
    periods = _periods(mode, mips)
    cls = [_class_plane(w, h, pad, per)
           for (w, h), pad, per in zip(mips, pads, periods)]
    if level == 0:
        return uv, cls, mips, pads, periods, None, 1
    n_par = 200
    par = (rng.randint(0, T, n_par).astype(np.int64) * 4 ** (level - 1)
           + rng.randint(0, 4 ** (level - 1), n_par).astype(np.int64))
    return uv, cls, mips, pads, periods, par, 4


def _jax_sides(node, level, uv, cls, mips, pads, periods):
    return np.asarray(tp._sides_for(
        jnp.asarray((node & (4 ** level - 1)).astype(np.uint32)),
        jnp.asarray((node >> (2 * level)).astype(np.int32)), level,
        jnp.asarray(uv), tuple(jnp.asarray(c) for c in cls), tuple(mips),
        tuple(pads), periods=tuple(periods)))


@pytest.mark.parametrize("nmips", [1, 3])
@pytest.mark.parametrize("mode", ["clamp", "wrap", "mirror"])
@pytest.mark.parametrize("level", list(range(13)))
def test_descend_sides_matches_sides_for(level, mode, nmips):
    """descend_sides on the CPU (its plain version) and the g++ build of
    kernel A: the children's nodes are parent * E + j, every lane valid,
    the sides equal _sides_for's on those nodes, open = side == 0."""
    uv, cls, mips, pads, periods, par, E = _level_inputs(
        level, mode, nmips, 100 * level + 10 * nmips + len(mode))
    T = uv.shape[0]
    n_par = T if par is None else par.shape[0]
    parent = np.arange(T, dtype=np.int64) if par is None else par
    want_node = (parent[:, None] * E + np.arange(E)).reshape(-1)
    want = _jax_sides(want_node, level, uv, cls, mips, pads, periods)
    kw = dict(E=E, level=level, n_out=n_par * E,
              uv_flat=torch.from_numpy(uv),
              cls=[torch.from_numpy(c) for c in cls], mips=mips, pads=pads,
              periods=periods)
    par_t = None if par is None else torch.from_numpy(par)
    for fn in (chain.descend_sides, chain.descend_sides_host):
        side, node, valid, open_ = fn(par_t, None, **kw)
        assert side.dtype == torch.int8
        assert np.array_equal(node.numpy(), want_node)
        assert np.array_equal(side.numpy(), want)
        assert valid.numpy().all()
        assert np.array_equal(open_.numpy(), want == 0)
    # both outcomes of the window test occur
    assert (want == 0).any() and (want != 0).any()


#: (count, n_out as a share of n_par * E, window test, active test)
DESCEND_CASES = {
    "count_below": (57, 1, True, None),
    "count_above": (10 ** 6, 1, True, None),   # an overflowing count
    "tail_pad": (57, 2, False, None),          # n_out past n_par * E
    "tail_cut": (57, 0.5, False, None),        # n_out below n_par * E
    "group_test": (None, 1, True, "group"),    # level 0 of a partial batch
    "final_active": (150, 1, True, "final"),   # its final level
}


@pytest.mark.parametrize("case", sorted(DESCEND_CASES))
def test_descend_host_build_matches_plain(case):
    """Kernel A's g++ build against the plain version on the capacity
    path's cases: a device count below and above the parents' lanes,
    the step-1 tail padded or cut to K_cap, and the partial batch's
    group test (level 3 of subdivision 8) and final active lookup
    (level 8)."""
    count, share, test, act = DESCEND_CASES[case]
    level = {"group": 3, "final": 8}.get(act, 6)
    uv, cls, mips, pads, periods, par, E = _level_inputs(level, "clamp", 3,
                                                         7)
    T, M = uv.shape[0], 4 ** 8
    active = np.random.RandomState(3).rand(T, M) < 0.02
    active[:, :M // 2] = False  # empty groups for the group test
    active = torch.from_numpy(active)
    par_t = torch.from_numpy(par)
    act_span = {"group": M // 4 ** 3, "final": 1}.get(act, 0)
    if act == "group":
        par_t, E = None, 4 ** 3
    n_par = T if par_t is None else par_t.shape[0]
    n_out = int(n_par * E * share)
    kw = dict(E=E, level=level, n_out=n_out, uv_flat=torch.from_numpy(uv),
              cls=[torch.from_numpy(c) for c in cls], mips=mips, pads=pads,
              periods=periods, test=test,
              active=active if act_span else None, act_span=act_span)
    cnt = None if count is None else torch.tensor(count, dtype=torch.int64)
    got = chain.descend_sides_host(par_t, cnt, **kw)
    want = chain.descend_sides_torch(par_t, cnt, **kw)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
    side, node, valid, open_ = want
    n_valid = n_par if count is None else min(count, n_par)
    assert int(valid.sum()) == min(n_valid * E, n_out)
    assert (node[n_par * E:] == 0).all()
    if act_span:
        # the active test closes some lanes that the side left open
        assert open_.any()
        assert (open_ != (valid & (side == 0))).any()


def test_descend_host_overflow_writes_in_bounds():
    """A count above the parents' lanes writes nothing past n_out."""
    uv, cls, mips, pads, periods, par, E = _level_inputs(4, "wrap", 1, 9)
    n_out = par.shape[0] * E
    guard = 64
    side = torch.full((n_out + guard,), 77, dtype=torch.int8)
    node = torch.full((n_out + guard,), 77, dtype=torch.int64)
    valid = torch.full((n_out + guard,), True)
    open_ = torch.full((n_out + guard,), True)
    cls_t = [torch.from_numpy(c) for c in cls]
    args = chain._descend_args(
        torch.from_numpy(par), torch.tensor(10 ** 9), E, 4, n_out,
        torch.from_numpy(uv), cls_t, mips, pads, periods, True, None, 0,
        (side, node, valid, open_))
    assert build.chain_host_library().omm_descend_sides_host(*args) == 0
    assert (side[n_out:] == 77).all() and (node[n_out:] == 77).all()
    assert valid[n_out:].all() and open_[n_out:].all()
    assert valid[:n_out].all()


# ---------------------------------------------------------------------------
# kernels B and C against _stageAB's tile keys and slots
# ---------------------------------------------------------------------------

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


def _chain(base):
    mips = [base]
    mips += [base[::2, ::2].copy(), base[::4, ::4].copy()]
    return omm.Texture(mips, omm.TextureFormat.FP32)


def _partial(tris, subdiv):
    M = omm.get_num_micro_triangles(subdiv)
    out = []
    for k, t in enumerate(tris):
        st = np.full(M, UO, np.uint8)
        st[k % 2::3] = 0
        out.append((t, st))
    return out


WRAP = omm.TextureAddressMode.Wrap
MIRROR = omm.TextureAddressMode.Mirror

#: name -> (texture, cfg, items); subdivision 5
AB_CASES = {
    "clamp": lambda: (omm.Texture([standard_circle(64, 64)],
                                  omm.TextureFormat.FP32), _cfg(),
                      [(t, None) for t in _tris(3, seed=2)]),
    "clamp_3mip": lambda: (_chain(standard_circle(64, 64)), _cfg(),
                           [(t, None) for t in _tris(3, seed=4)]),
    "wrap": lambda: (omm.Texture([sine_fp32(64, 64)],
                                 omm.TextureFormat.FP32),
                     _cfg(addr_mode=WRAP),
                     [(t, None) for t in _tris(3, seed=3, scale=3.0,
                                               shift=1.0)]),
    "mirror_3mip": lambda: (_chain(sine_fp32(64, 64)),
                            _cfg(addr_mode=MIRROR),
                            [(t, None) for t in _tris(2, seed=8, scale=2.5,
                                                      shift=-0.7)]),
    "partial": lambda: (omm.Texture([standard_circle(64, 64)],
                                    omm.TextureFormat.FP32), _cfg(),
                        _partial(_tris(3, seed=5), 5)),
    "empty": lambda: (omm.Texture([np.ones((64, 64), np.float32)],
                                  omm.TextureFormat.FP32), _cfg(),
                      [(t, None) for t in _tris(2, seed=6)]),
}


def _fast_items(tex, cfg, items, subdiv):
    uvs = np.stack([t for t, _ in items])
    lg = tp._group_level(tex, list(uvs), subdiv)
    mask = tp._fast_path_mask(tex, cfg, uvs, subdiv, lg)
    return [it for it, ok in zip(items, mask) if ok]


def _ab_case(case, roomy):
    """The JAX package's _stageAB and the port's stage_ab_spec of one
    case at the same capacities (tight: half the true counts)."""
    subdiv = 5
    tex, cfg, items = AB_CASES[case]()
    items = _fast_items(tex, cfg, items, subdiv)
    T = len(items)
    assert T >= 2
    all_active = all(st is None for _, st in items)
    ctx = tp._BatchCtx(tex, cfg, items, subdiv, list(range(T)), [None] * T,
                       all_active=all_active)
    m = len(ctx.levels) - 1
    full = np.asarray(ctx.stage_ab([T * 4 ** ctx.levels[i]
                                    for i in range(m)], T * ctx.M)[4])
    if roomy:
        Cs = [host._bucket(int(c) + 64) for c in full[:m]]
        K_cap = host._bucket(int(full[m]) + 64)
    else:
        Cs = [max(int(c) // 2, 1) for c in full[:m]]
        K_cap = max(int(full[m]) // 2, 1)
    jres = ctx.stage_ab(Cs, K_cap)

    uvs = [t for t, _ in items]
    ptex, pcfg = port_inputs(tex, cfg)
    pre = batch.precompute(ptex, uvs, subdiv,
                           host._group_level(ptex, uvs, subdiv))
    bp = batch.batch_planes(ptex, pcfg, pre, "cpu")
    uv_flat, _ = batch.item_tables(np.stack(uvs), "cpu")
    active = None if all_active else torch.from_numpy(np.stack(
        [st == UO for _, st in items]))
    geo = dict(mips=bp["mips"], pads=bp["pads"], ntxs=bp["ntxs"],
               periods=bp["periods"])
    # streams that fit (roomy) or hold half the padded total (tight)
    nblks = [max(int(p) // B // (1 if roomy else 2), 1)
             for p in full[m + 2:]]
    pres = ttp.stage_ab_spec(
        bp["cls_lv"], uv_flat, active, subdiv=subdiv,
        levels=tuple(bp["levels"]), caps=tuple(Cs), K_cap=K_cap,
        all_active=all_active, nblks=nblks, **geo)
    return dict(jres=jres, pres=pres, full=full, m=m, subdiv=subdiv,
                uv_flat=uv_flat, geo=geo, K_cap=K_cap)


@pytest.mark.parametrize("roomy", [True, False], ids=["roomy", "tight"])
@pytest.mark.parametrize("case", sorted(AB_CASES))
def test_keys_and_slots_match_stageAB(case, roomy):
    """tile_keys equals _stageAB's tile keys on every lane (INVALID_TILE
    on the invalid ones), the slots on the valid lanes and the meta
    (counts, flag, padded totals) equal; the stream holds each valid
    lane's id at its slot when the slot fits, and nothing else."""
    r = _ab_case(case, roomy)
    jres, pres, m = r["jres"], r["pres"], r["m"]
    sides, nodes, ids, kvalid, meta, slots = jres
    want_meta = np.asarray(meta)
    assert np.array_equal(pres["meta"].numpy(), want_meta)
    kv = np.asarray(kvalid)
    assert np.array_equal(pres["kvalid"].numpy(), kv)
    if case == "empty":
        assert int(want_meta[m]) == 0 and not kv.any()
    else:
        assert kv.any()
    assert int(want_meta[m + 1]) == (0 if roomy or case == "empty" else 1)
    keys = chain.tile_keys(pres["ids"], pres["kvalid"], subdiv=r["subdiv"],
                           uv_flat=r["uv_flat"], **r["geo"])
    assert keys.dtype == torch.int32
    for mi, (wslot, wtile) in enumerate(slots):
        assert np.array_equal(keys[mi].numpy(), np.asarray(wtile))
        g = pres["slots"][mi].numpy()
        assert np.array_equal(g[kv], np.asarray(wslot)[kv])
        assert (g[~kv] == chain.SENTINEL).all()
        bt, ids_slot = pres["streams"][mi]
        cap = ids_slot.numel()
        flat = ids_slot.reshape(-1).numpy()
        ok = kv & (g < cap)
        assert np.array_equal(flat[g[ok]], pres["ids"].numpy()[ok])
        assert (flat >= 0).sum() == ok.sum()
        firsts = ok & (g % B == 0)
        assert np.array_equal(bt.numpy()[g[firsts] // B],
                              keys[mi].numpy()[firsts])
        assert (bt.numpy() != 0).sum() <= firsts.sum()


# ---------------------------------------------------------------------------
# kernels B and C: the g++ build against the plain versions
# ---------------------------------------------------------------------------

def _sorted_keys(K, ngroups, seed, invalid=0.1):
    """(st, order) of a (2, K) int32 key table: per row keys drawn from
    `ngroups` tiles of skewed sizes (some far past B and past a chunk of
    the kernel's scan), a share of INVALID_TILE lanes."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(2):
        w = rng.pareto(0.8, ngroups) + 0.05
        keys = rng.choice(np.arange(ngroups) * 7 + 3, K, p=w / w.sum())
        keys[rng.rand(K) < invalid] = INVALID
        rows.append(keys.astype(np.int32))
    st, order = torch.sort(torch.from_numpy(np.stack(rows)), dim=1,
                           stable=True)
    return st.contiguous(), order.contiguous()


@pytest.mark.parametrize("nblk", ["fit", "short", "none"])
@pytest.mark.parametrize("K,ngroups", [(0, 1), (1, 1), (129, 2),
                                       (5000, 9), (20011, 40)],
                         ids=["K0", "K1", "K129", "K5000", "K20011"])
def test_tile_slots_host_build_matches_plain(K, ngroups, nblk):
    """Kernel C's g++ build (the kernel's chunked scan) against the
    plain version (the cummax form): slots, padded totals and slot
    streams, with streams that fit, streams too short (their overflow
    left out) and none."""
    st, order = _sorted_keys(K, ngroups, seed=K + ngroups)
    ids = torch.from_numpy(np.random.RandomState(K).randint(
        0, 1 << 30, K).astype(np.int64))
    want = chain.tile_slots_torch(st, order, ids, [0, 0])
    pad = want[1].tolist()
    nblks = {"fit": [p // B for p in pad],
             "short": [max(p // B // 2, 1) for p in pad],
             "none": [0, 0]}[nblk]
    want = chain.tile_slots(st, order, ids, nblks)   # on the CPU: plain
    got = chain.tile_slots_host(st, order, ids, nblks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for (gb, gi), (wb, wi) in zip(got[2], want[2]):
        assert torch.equal(gb, wb) and torch.equal(gi, wi)
    if K > 2 * 2048:
        assert pad[0] > 2048  # the scan crosses chunks
    valid = st != INVALID
    for mi in range(2):
        s = want[0][mi]
        assert (s[order[mi][~valid[mi]]] == chain.SENTINEL).all()


def test_tile_slots_host_short_stream_writes_in_bounds():
    """A stream shorter than the padded total: the host build writes
    nothing past its ids_slot and block_tile buffers."""
    st, order = _sorted_keys(5000, 9, seed=1)
    ids = torch.arange(5000, dtype=torch.int64)
    nblks = [3, 5]
    guard = 256
    cap = sum(nblks)
    slot = torch.empty((2, 5000), dtype=torch.int64)
    padM = torch.empty(2, dtype=torch.int64)
    ids_slot = torch.full((cap * B + guard,), 12345, dtype=torch.int32)
    block_tile = torch.full((cap + guard,), 12345, dtype=torch.int32)
    args = chain._slots_args(st, order, ids, nblks, slot, padM, ids_slot,
                             block_tile)
    assert build.chain_host_library().omm_tile_slots_host(*args) == 0
    assert (ids_slot[cap * B:] == 12345).all()
    assert (block_tile[cap:] == 12345).all()
    assert int(padM.max()) > cap * B


@pytest.mark.parametrize("mode", ["clamp", "wrap", "mirror"])
def test_tile_keys_host_build_matches_plain(mode):
    """Kernel B's g++ build against the plain version at subdivision 7,
    three mips, with and without a validity mask."""
    rng = np.random.RandomState(len(mode))
    T, subdiv = 4, 7
    lo, hi = (0.05, 0.95) if mode == "clamp" else (-1.7, 2.6)
    uv = torch.from_numpy(rng.uniform(lo, hi, (T, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, T * 4 ** subdiv, 3000).astype(
        np.int64))
    kvalid = torch.from_numpy(rng.rand(3000) < 0.8)
    kw = dict(subdiv=subdiv, uv_flat=uv, mips=MIPS,
              pads=[30, 20, 9], ntxs=[3, 2, 2],
              periods=_periods(mode, MIPS))
    for kv in (None, kvalid):
        got = chain.tile_keys_host(ids, kv, **kw)
        want = chain.tile_keys(ids, kv, **kw)
        assert torch.equal(got, want)
        assert len(torch.unique(want[0])) > 1
    assert (want[:, ~kvalid] == INVALID).all()


def test_slot_stream_host_build_matches_plain():
    """The discovery form of kernel C: the stream of placed lanes, in
    the g++ build and the plain version, with slots past the stream and
    negative ones left out."""
    rng = np.random.RandomState(11)
    n, nblk = 700, 5
    slot = torch.from_numpy(rng.permutation(nblk * B + 100)[:n].astype(
        np.int64))
    slot[:3] = -1
    ids = torch.from_numpy(rng.randint(0, 1 << 20, n).astype(np.int64))
    keys = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32))
    got = chain.slot_stream_host(ids, slot, keys, nblk)
    want = chain.slot_stream(ids, slot, keys, nblk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] >= 0).sum() == ((slot >= 0) & (slot < nblk * B)).sum()


def test_wrappers_check_inputs():
    """Each wrapper raises on a bad dtype, shape or layout, on the CPU
    as on the card."""
    uv = torch.zeros((2, 6))
    cls = [torch.zeros((8, 8), dtype=torch.int8)]
    kw = dict(E=4, level=2, n_out=8, uv_flat=uv, cls=cls, mips=[(8, 8)],
              pads=[1], periods=[None])
    with pytest.raises(ValueError):
        chain.descend_sides(torch.zeros(2, dtype=torch.int32), None, **kw)
    with pytest.raises(ValueError):
        chain.descend_sides(None, None, **{**kw, "uv_flat": uv.double()})
    with pytest.raises(ValueError):
        chain.descend_sides(None, None, **{**kw, "n_out": 7})
    with pytest.raises(ValueError):
        chain.descend_sides(None, None, **{**kw, "act_span": 4})
    with pytest.raises(ValueError):
        chain.tile_keys(torch.zeros(4, dtype=torch.int64),
                        torch.zeros(3, dtype=torch.bool), subdiv=2,
                        uv_flat=uv, mips=[(8, 8)], pads=[1], ntxs=[1],
                        periods=[None])
    st = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        chain.tile_slots(st, torch.zeros((1, 6), dtype=torch.int32),
                         torch.zeros(6, dtype=torch.int64), [1])
    with pytest.raises(ValueError):
        chain.tile_slots(st[:, ::2], torch.zeros((1, 3), dtype=torch.int64),
                         torch.zeros(3, dtype=torch.int64), [1])
    with pytest.raises(ValueError):
        chain.slot_stream(torch.zeros(3, dtype=torch.int64),
                          torch.zeros(3, dtype=torch.int64),
                          torch.zeros(3, dtype=torch.int64), 1)


# ---------------------------------------------------------------------------
# the benchmark's first batch through the capacity chain
# ---------------------------------------------------------------------------

#: sha256 of the payload [meta | packed rows] of the benchmark's first
#: batch (48 triangles at subdivision 9) through twophase.spec_chain on
#: the CPU at its discovered capacities, as the port gave it before the
#: chain's kernels (its torch code, kept as their plain versions)
BENCH_PAYLOAD = ("7b36b5ee89401dc1d50fb734d67bbd474a03d69fd7c2008f4ba2ff1cd7"
                 "22195b")
BENCH_META = [1006, 4925, 34616, 138464, 0, 140928]
BENCH_CAPS = ((1536, 6144, 49152), 196608, (1536,))


def _bench_job():
    """The benchmark workload's first batch (bench.py's _workload: a
    1024^2 FP32 clamp circle, 256 triangles from RandomState(42), the
    first 48 at subdivision 9) as the port's batch job on the CPU."""
    from omm_tpu_torch.bake import Options, _config, setup_work_items
    j, i = np.meshgrid(np.arange(1024, dtype=np.float32),
                       np.arange(1024, dtype=np.float32), indexing="ij")
    r = np.sqrt((i / np.float32(1024) - 0.5) ** 2
                + (j / np.float32(1024) - 0.5) ** 2)
    plane = np.where(r < np.float32(0.4), np.float32(0.0),
                     np.float32(1.0)).astype(np.float32)
    plane[0, 0] = np.float32(0.6)
    tex = ot.Texture([plane], ot.TextureFormat.FP32)
    rng = np.random.RandomState(42)
    tris = []
    for _ in range(256):
        base = rng.rand(2).astype(np.float32) * 0.2
        tris.append(np.array([base + [0.05, 0.1], base + [0.1, 0.7],
                              base + [0.7, 0.65]], dtype=np.float32))
    desc = ot.BakeInputDesc(
        texture=tex, tex_coords=np.concatenate(tris),
        index_buffer=np.arange(768, dtype=np.uint32), index_count=768,
        alpha_cutoff=0.5, max_subdivision_level=9,
        dynamic_subdivision_scale=0.0)
    opts = Options.from_flags(desc.bake_flags)
    uvs = [it.uv_tri for it in setup_work_items(desc, opts)][:48]
    cfg = _config(desc, opts)
    pre = batch.precompute(tex, uvs, 9, host._group_level(tex, uvs, 9))
    job = batch._Batch(tex, cfg, [(u, None) for u in uvs], 9,
                       list(range(48)), [None] * 48, True, pre,
                       torch.device("cpu"), None)
    tex._omm_torch_caps = {job.cap_key: BENCH_CAPS}
    return job


@pytest.mark.parametrize("build_", ["plain", "host_build"])
def test_bench_batch_payload_equals_parent(build_, monkeypatch):
    """The benchmark's first batch through the capacity chain on the CPU
    at its caps entry (levels 4/6/8/9, the step-1 tail, one mip), with
    the chain's kernels as their plain versions or as the g++ build of
    the kernels' code: the payload is byte-equal to the one the port
    gave before these kernels existed."""
    if build_ == "host_build":
        monkeypatch.setattr(ttp, "descend_sides", chain.descend_sides_host)
        monkeypatch.setattr(ttp, "tile_keys", chain.tile_keys_host)
        monkeypatch.setattr(ttp, "tile_slots", chain.tile_slots_host)
    job = _bench_job()
    assert tuple(job.bp["levels"]) == (4, 6, 8, 9)
    caps, buf, ev = batch._enqueue_spec(job)
    assert caps == BENCH_CAPS and ev is None
    b = buf.numpy()
    assert b[:24].view(np.int32).tolist() == BENCH_META
    assert hashlib.sha256(b.tobytes()).hexdigest() == BENCH_PAYLOAD


@pytest.mark.parametrize("case", ["clamp_3mip", "partial", "wrap"])
def test_recorded_calls_host_build_matches_plain(case):
    """Every kernel call of a batch's discovery path and capacity chain
    (chain.recording), through the g++ build on the same inputs: equal
    to the plain version's result on every lane."""
    host_of = {"descend_sides": chain.descend_sides_host,
               "tile_keys": chain.tile_keys_host,
               "tile_slots": chain.tile_slots_host,
               "slot_stream": chain.slot_stream_host}
    tex, cfg, items = AB_CASES[case]()
    subdiv = 5
    items = _fast_items(tex, cfg, items, subdiv)
    ptex, pcfg = port_inputs(tex, cfg)
    uvs = [t for t, _ in items]
    pre = batch.precompute(ptex, uvs, subdiv,
                           host._group_level(ptex, uvs, subdiv))
    job = batch._Batch(ptex, pcfg, items, subdiv, list(range(len(items))),
                       [None] * len(items),
                       all(st is None for _, st in items), pre,
                       torch.device("cpu"), None)
    calls = []
    with chain.recording(calls):
        batch._run_batch(job)
        entry = ptex._omm_torch_caps[job.cap_key]
        batch.spec_fn(job, entry)(*job.host_inputs())
    names = [c[1] for c in calls]
    for name in host_of:
        assert name in names
    assert ttp.descend_sides is chain.descend_sides  # restored
    for kernel, name, fn, plain, args, kw, out in calls:
        assert chain.result_diff(out, plain(*args, **kw)) == 0
        assert chain.result_diff(out, host_of[name](*args, **kw)) == 0
