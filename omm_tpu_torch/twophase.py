"""The two-phase engine's stage programs in torch ops.

Counterparts of `omm_tpu.kernels.twophase`'s device programs, in two
forms.  The exact-size form is the discovery path, which learns a
batch's counts:

  stage_ab     _stageAB: dense level-0 window resolve, per-level
               compaction and child expansion, survivor compaction, and
               the per-mip stable tile sort with B-padded slot assignment
  stage_c_mip  _stageC_mip: slot stream -> exact kernel -> survivor counts
  stage_d      _stageD: per-mip count merge, per-level row overwrites,
               survivor scatter, 2-bit state pack
  nearest_sides, resolve_nearest_phase1
               _nearest_sides and the nearest filter's phase-1 resolve

Here each level's count is read on the host when it is needed and every
tensor has its exact size: compaction is boolean-mask selection (scan
order, like the stable sort it replaces) and no lane is invalid.

The capacity form is the speculative path, which runs at the counts the
discovery path saw (with headroom, `host.caps_entry`) and reads nothing
on the host, so that a batch's whole chain can be captured as one CUDA
graph:

  compact_scan   _compact_sort: compaction in scan order to a capacity
  stage_ab_spec  _stageAB at capacities, with its meta [C_1..C_m, K,
                 flag, padM per mip]
  stage_c_spec   _stageC_mip at a block capacity
  stage_d_spec   the count merge and 2-bit pack over the capacity lanes,
                 and the payload [meta int32s | packed rows]

A count above its capacity sets the meta's flag, and the batch is
rerun on the discovery path.  Lanes past a count are invalid.  XLA
drops out-of-range scatters and clamps gathers, where torch faults, so
every capacity buffer has a dump lane past its end that takes the
invalid lanes' writes, every invalid lane holds an in-range id (0), and
every consumer masks by the lanes' validity, as `kvalid` does in the JAX
programs.  The window test's class-plane lookup clamps explicitly, as
XLA's 2-D gather does.

Both forms run the descent, the tile keys and the slot assignment
through the hand-written kernels of `kernels.chain` (each level's
window test and child expansion, the survivors' tile keys, the slots
and slot streams after the stable sort), the exact stage through
`kernels.exact`; on the CPU each takes its plain torch version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import routes
from .bird_torch import bary_cols, corner_cols
from .host import (B, TILE, _nearest_phase1_windows, _period_for,
                   _skip_final_p, wrap_origin)
from .kernels.chain import descend_sides, tile_keys, tile_slots
from .kernels.chain import slot_stream as chain_slot_stream
from .kernels.exact import exact_counts
from .levelline import f32, get_state_from_coverage
from .planes import check_device, class_plane_cached
from .native import unpack_2bit_seq
from .spans import span
from .types import OpacityState, get_num_micro_triangles

UO = int(OpacityState.UnknownOpaque)
UT = int(OpacityState.UnknownTransparent)


class PackedStates:
    """A classified item's states in serialize's sequential 2-bit
    OC1_4_State layout (state j in byte j>>2 at shift (j&3)*2), as
    `WorkItem.set_packed_states` and `serialize_result` use it.  The
    JAX package's class of this name also carries a `blob_offset` into
    its speculative serialize blob, which the port does not have."""

    __slots__ = ("packed", "M")

    def __init__(self, packed: np.ndarray, M: int):
        self.packed = packed
        self.M = M

    def unpack(self) -> np.ndarray:
        return unpack_2bit_seq(self.packed, self.M)


def _geo(uv_flat, mips, pads, periods):
    return dict(uv_flat=uv_flat, mips=mips, pads=pads, periods=periods)


def stage_ab(cls_levels, uv_flat, active, *, subdiv, levels, mips, pads,
             ntxs, periods, all_active):
    """Hierarchical descent over `levels` (l0 < ... < subdiv).

    cls_levels: per level, the per-mip class planes.  uv_flat: (T, 6)
    fp32.  active: (T, M) bool, or None when all_active.
    Returns a dict: sides (per-level int8), nodes (per-level flat ids
    t*4^l + n of the tested nodes after level 0), ids (the K exact-stage
    survivors, flat t*M + m, in scan order), Cs (per-level parent
    counts), K, slots (per mip, each survivor's slot) and padMs (per
    mip, the B-padded slot total).  Each level is one `descend_sides`
    call at its exact size (the count is the parents' length), the tile
    keys one `tile_keys` call and the slots one `tile_slots` call after
    the stable sort.  Each count it reads on the host is counted as
    routes' count_sync."""
    T = uv_flat.shape[0]
    M = get_num_micro_triangles(subdiv)
    m = len(levels) - 1
    N0 = 4 ** levels[0]
    skip = _skip_final_p(levels, all_active)
    geo = _geo(uv_flat, mips, pads, periods)

    side0, node, _, unres = descend_sides(
        None, None, E=N0, level=levels[0], n_out=T * N0, cls=cls_levels[0],
        active=active, act_span=0 if all_active else M // N0, **geo)
    sides = [side0]
    Cs = []
    nodes = []
    ids = None
    for i in range(1, m + 1):
        li = levels[i]
        E = 4 ** (li - levels[i - 1])
        par = node[unres]
        Cs.append(int(par.shape[0]))
        routes.count("count_sync")
        if i == m and skip:
            # step-1 tail: every child goes to the exact stage
            _, ids, _, _ = descend_sides(
                par, None, E=E, level=li, n_out=par.shape[0] * E, cls=None,
                test=False, **geo)
            break
        final = i == m and not all_active
        side_i, node, _, unres = descend_sides(
            par, None, E=E, level=li, n_out=par.shape[0] * E,
            cls=cls_levels[i], active=active if final else None,
            act_span=1 if final else 0, **geo)
        sides.append(side_i)
        nodes.append(node)
        if i == m:
            ids = node[unres]
            routes.count("count_sync")
    K = int(ids.shape[0])

    keys = tile_keys(ids, None, subdiv=subdiv, uv_flat=uv_flat, mips=mips,
                     pads=pads, ntxs=ntxs, periods=periods)
    if K == 0:
        return {"sides": sides, "nodes": nodes, "ids": ids, "Cs": Cs,
                "K": K, "slots": list(keys.to(torch.int64)),
                "padMs": [0] * len(mips)}
    # stable tile sort; each tile group starts at a multiple of B
    st, order = torch.sort(keys, dim=1, stable=True)
    slot, padM, _ = tile_slots(st, order, ids, [0] * len(mips))
    padMs = []
    for mi in range(len(mips)):
        padMs.append(int(padM[mi].item()))
        routes.count("count_sync")
    return {"sides": sides, "nodes": nodes, "ids": ids, "Cs": Cs, "K": K,
            "slots": list(slot), "padMs": padMs}


def slot_stream(uv_flat, ids, slot, padM, *, subdiv, w, h, pad, ntx,
                period=None):
    """The exact stage's input: (block_tile (nblk,) int32, ids_slot
    (nblk, B) int32) with survivor k's id at slot[k] and -1 elsewhere.
    Tile groups are B-aligned, so each block's first slot holds a
    survivor, whose tile (`tile_keys`) is the block's (`chain.slot_stream`,
    kernel C's discovery form)."""
    keys = tile_keys(ids, None, subdiv=subdiv, uv_flat=uv_flat,
                     mips=[(w, h)], pads=[pad], ntxs=[ntx], periods=[period])
    return chain_slot_stream(ids, slot, keys[0], padM // B)


def stage_c_mip(planeP, uv_flat, ccw, ids, slot, padM, *, subdiv, w, h,
                pad, ntx, H, W, rcp, alpha_cutoff, period=None, exact=None):
    """Exact-stage counts of one mip for the K survivors `ids` (flat
    t*M + m) placed at `slot`: build the slot stream, run the exact
    stage (`exact_counts`, with its `exact=` engine choice) and gather
    (above, below) int32 (K,) back into survivor order."""
    if ids.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int32, device=ids.device)
        return z, z
    block_tile, ids_slot = slot_stream(uv_flat, ids, slot, padM,
                                       subdiv=subdiv, w=w, h=h, pad=pad,
                                       ntx=ntx, period=period)
    above, below = exact_counts(
        planeP, block_tile, ids_slot, uv_flat, ccw, subdiv=subdiv, pad=pad,
        ntx=ntx, size=(w, h), period=period, H=H, W=W, rcp=rcp,
        alpha_cutoff=alpha_cutoff, exact=exact)
    return above.reshape(-1)[slot], below.reshape(-1)[slot]


def stage_d(sides, nodes, ids, mip_counts, *, T, subdiv, levels, fmt,
            promotion, cutoff_gt, cutoff_le):
    """Final states of the batch, packed on the device in serialize's
    sequential 2-bit layout: (T, M/4) uint8.  Level 0's sides are the
    base; each later level overwrites its tested nodes' rows; the exact
    survivors' states come last."""
    M = get_num_micro_triangles(subdiv)
    N0 = 4 ** levels[0]
    final = merge_counts(mip_counts, fmt, promotion, cutoff_gt, cutoff_le)
    base = map_side(sides[0], cutoff_gt, cutoff_le)[:, None].expand(
        T * N0, M // N0).reshape(-1)
    for i in range(1, len(sides)):
        span = M // (4 ** levels[i])
        base.view(-1, span)[nodes[i - 1]] = map_side(
            sides[i], cutoff_gt, cutoff_le)[:, None]
    base[ids] = final.to(torch.uint8)

    s = base.view(T, M // 4, 4)
    return (s[..., 0] | (s[..., 1] << 2) | (s[..., 2] << 4)
            | (s[..., 3] << 6))


def map_side(s, cutoff_gt, cutoff_le):
    """uint8 state of a window side: +1 -> cutoff_gt, -1 -> cutoff_le,
    0 -> 0 (Transparent; overwritten by a finer level or the exact
    stage)."""
    return torch.where(s == 1, int(cutoff_gt),
                       torch.where(s == -1, int(cutoff_le), 0)
                       ).to(torch.uint8)


def merge_counts(mip_counts, fmt, promotion, cutoff_gt, cutoff_le):
    """Final int32 states of the survivors from their per-mip (above,
    below) counts: a mip adds to a survivor only while the mips before
    it left the survivor's state unknown."""
    above = torch.zeros_like(mip_counts[0][0])
    below = torch.zeros_like(above)
    alive = torch.ones_like(above, dtype=torch.bool)
    for a, b in mip_counts:
        above = above + torch.where(alive, a, 0)
        below = below + torch.where(alive, b, 0)
        st = get_state_from_coverage(fmt, promotion, cutoff_gt, cutoff_le,
                                     above, below)
        alive = alive & ~((st == UO) | (st == UT))
    return get_state_from_coverage(fmt, promotion, cutoff_gt, cutoff_le,
                                   above, below)


# ---------------------------------------------------------------------------
# the capacity form (speculative path)
# ---------------------------------------------------------------------------

def compact_scan(mask, payload, cap: int):
    """payload[mask] in scan order, in `cap` lanes: (compacted (cap,),
    count, a 0-d int64 tensor).  Lanes past the count hold 0; a count
    above cap keeps the first cap.  One cumulative sum and one scatter,
    whose masked-out lanes land in a dump lane past the end."""
    pos = torch.cumsum(mask, 0) - 1
    cnt = pos[-1] + 1
    tgt = torch.where(mask & (pos < cap), pos, cap)
    out = torch.zeros(cap + 1, dtype=payload.dtype, device=payload.device)
    return out.scatter_(0, tgt, payload)[:cap], cnt


def stage_ab_spec(cls_levels, uv_flat, active, *, subdiv, levels, caps,
                  K_cap, mips, pads, ntxs, periods, all_active, nblks=None):
    """stage_ab at capacities: caps[i-1] parent lanes at level i, K_cap
    survivor lanes; `_stageAB`'s program (the step-1 tail included).
    Each level is one `descend_sides` call that reads the compacted
    parents' count on the device.

    Returns a dict: sides (per level, int8 over the level's lanes),
    nodes (per level after 0: (flat ids, valid)), ids (K_cap,) int64
    and kvalid (K_cap,) bool, slots (per mip, (K_cap,) int64, SENTINEL
    on invalid lanes), streams (per mip, the exact stage's (block_tile,
    ids_slot) at nblks[mip] blocks; nblks None: no streams) and meta,
    int32 [C_1..C_m, K, flag, padM per mip] on the device: the true
    counts, flag 1 where a count passed its capacity (the lanes past it
    are dropped).  Nothing is read on the host."""
    device = uv_flat.device
    T = uv_flat.shape[0]
    M = get_num_micro_triangles(subdiv)
    m = len(levels) - 1
    N0 = 4 ** levels[0]
    skip = _skip_final_p(levels, all_active)
    geo = _geo(uv_flat, mips, pads, periods)

    side0, node, _, unres = descend_sides(
        None, None, E=N0, level=levels[0], n_out=T * N0, cls=cls_levels[0],
        active=active, act_span=0 if all_active else M // N0, **geo)
    sides = [side0]
    flag = torch.zeros((), dtype=torch.int64, device=device)
    metas, nodes = [], []
    for i in range(1, m + 1):
        li = levels[i]
        E = 4 ** (li - levels[i - 1])
        cap = caps[i - 1]
        par, Ci = compact_scan(unres, node, cap)
        flag = torch.maximum(flag, (Ci > cap).to(torch.int64))
        metas.append(Ci)
        if i == m and skip:
            # step-1 tail: the expanded children (a prefix, since `par`
            # is compacted) are the survivors, in scan order
            _, ids, kvalid, _ = descend_sides(
                par, Ci, E=E, level=li, n_out=K_cap, cls=None, test=False,
                **geo)
            K = torch.clamp_max(Ci, cap) * E
            flag = torch.maximum(flag, (Ci * E > K_cap).to(torch.int64))
            break
        final = i == m and not all_active
        side_i, node, valid, unres = descend_sides(
            par, Ci, E=E, level=li, n_out=cap * E, cls=cls_levels[i],
            active=active if final else None, act_span=1 if final else 0,
            **geo)
        sides.append(side_i)
        nodes.append((node, valid))
        if i == m:
            ids, K = compact_scan(unres, node, K_cap)
            kvalid = (torch.arange(K_cap, device=device)
                      < torch.clamp_max(K, K_cap))
            flag = torch.maximum(flag, (K > K_cap).to(torch.int64))

    keys = tile_keys(ids, kvalid, subdiv=subdiv, uv_flat=uv_flat, mips=mips,
                     pads=pads, ntxs=ntxs, periods=periods)
    # stable tile sort (invalid lanes last); each group starts at a
    # multiple of B
    st, order = torch.sort(keys, dim=1, stable=True)
    slot, padM, streams = tile_slots(
        st, order, ids, nblks if nblks is not None else [0] * len(mips))
    meta = torch.cat([torch.stack(metas + [K, flag]), padM])
    return {"sides": sides, "nodes": nodes, "ids": ids, "kvalid": kvalid,
            "slots": list(slot), "streams": streams,
            "meta": meta.to(torch.int32)}


def stage_c_spec(planeP, uv_flat, ccw, kvalid, slot, stream, *, subdiv, w,
                 h, pad, ntx, H, W, rcp, alpha_cutoff, period=None,
                 exact=None):
    """Exact-stage counts of one mip on its slot stream (block_tile,
    ids_slot) from stage_ab_spec: the exact stage (`exact_counts`) over
    every block, empty ones included, and (above, below) int32 (K_cap,)
    gathered back into survivor order, 0 on the lanes the stream left
    out (invalid, or slot past the stream)."""
    block_tile, ids_slot = stream
    padM = ids_slot.numel()
    above, below = exact_counts(
        planeP, block_tile, ids_slot, uv_flat, ccw, subdiv=subdiv, pad=pad,
        ntx=ntx, size=(w, h), period=period, H=H, W=W, rcp=rcp,
        alpha_cutoff=alpha_cutoff, exact=exact)
    ok = kvalid & (slot < padM)
    safe = torch.clamp_max(torch.where(ok, slot, padM), padM - 1)
    return (torch.where(ok, above.reshape(-1)[safe], 0),
            torch.where(ok, below.reshape(-1)[safe], 0))


def stage_d_spec(res, mip_counts, nblks, *, T, subdiv, levels, fmt,
                 promotion, cutoff_gt, cutoff_le):
    """The batch's payload, a uint8 tensor [meta int32s | (T, M/4)
    packed rows in serialize's sequential 2-bit layout]: stage_d over
    stage_ab_spec's lanes (`res`), each level's rows and the survivors'
    states written through the valid lanes only.  The meta is
    stage_ab_spec's with the flag also raised where a mip's padded slot
    total passes its block capacity nblks[mip] * B."""
    device = res["ids"].device
    M = get_num_micro_triangles(subdiv)
    N0 = 4 ** levels[0]
    meta = res["meta"]
    m = len(levels) - 1
    flag = meta[m + 1]
    for mi, nblk in enumerate(nblks):
        flag = torch.maximum(flag, (meta[m + 2 + mi] > nblk * B).to(
            torch.int32))
    meta = torch.cat([meta[:m + 1], flag[None], meta[m + 2:]])

    final = merge_counts(mip_counts, fmt, promotion, cutoff_gt, cutoff_le)
    # the level-0 base, then each level's rows; an item's worth of dump
    # rows past T*M takes the invalid lanes' writes
    base = torch.empty(T * M + M, dtype=torch.uint8, device=device)
    base[:T * M].view(T * N0, M // N0).copy_(
        map_side(res["sides"][0], cutoff_gt, cutoff_le)[:, None].expand(
            T * N0, M // N0))
    for i in range(1, len(res["sides"])):
        span = M // (4 ** levels[i])
        Nl = T * (4 ** levels[i])
        node, valid = res["nodes"][i - 1]
        rows = map_side(res["sides"][i], cutoff_gt, cutoff_le)
        base[:(Nl + 1) * span].view(Nl + 1, span).index_put_(
            (torch.where(valid, node, Nl),),
            rows[:, None].expand(rows.shape[0], span))
    base.index_put_((torch.where(res["kvalid"], res["ids"], T * M),),
                    final.to(torch.uint8))

    s = base[:T * M].view(T, M // 4, 4)
    packed = (s[..., 0] | (s[..., 1] << 2) | (s[..., 2] << 4)
              | (s[..., 3] << 6))
    return torch.cat([meta.view(torch.uint8), packed.reshape(-1)])


def spec_chain(cls_levels, planes, uv_flat, ccw, active, *, subdiv, levels,
               caps, K_cap, nblks, mips, pads, ntxs, periods, HWs, rcps,
               all_active, alpha_cutoff, fmt, promotion, cutoff_gt,
               cutoff_le, exact=None):
    """A batch's whole capacity chain (`_spec_chain`): stage_ab_spec, a
    stage_c_spec per mip, stage_d_spec; returns the payload.  It reads
    no count on the host and makes no host-to-device copy, so on a card
    it can be captured as one CUDA graph."""
    T = uv_flat.shape[0]
    res = stage_ab_spec(cls_levels, uv_flat, active, subdiv=subdiv,
                        levels=levels, caps=caps, K_cap=K_cap, mips=mips,
                        pads=pads, ntxs=ntxs, periods=periods,
                        all_active=all_active, nblks=nblks)
    mip_counts = []
    for mi, (w, h) in enumerate(mips):
        mip_counts.append(stage_c_spec(
            planes[mi], uv_flat, ccw, res["kvalid"], res["slots"][mi],
            res["streams"][mi], subdiv=subdiv, w=w, h=h,
            pad=pads[mi], ntx=ntxs[mi], H=HWs[mi][0], W=HWs[mi][1],
            rcp=rcps[mi], alpha_cutoff=alpha_cutoff, period=periods[mi],
            exact=exact))
    return stage_d_spec(res, mip_counts, nblks, T=T, subdiv=subdiv,
                        levels=levels, fmt=fmt, promotion=promotion,
                        cutoff_gt=cutoff_gt, cutoff_le=cutoff_le)


# ---------------------------------------------------------------------------
# nearest-filter phase-1 resolve (bake_cpu_impl.cpp:969-1022 semantics)
# ---------------------------------------------------------------------------

#: (item, micro-triangle) pairs per chunk of nearest_sides
SIDES_CHUNK = 1 << 22


def nearest_sides(cls_planes, uv_flat, *, subdiv, mips, pads, periods):
    """Per-micro-triangle side (+1 / -1 / 0, int8 (T, M)) of every
    micro-triangle of every item for the nearest filter, combined over
    mips (twophase._nearest_sides): the class plane at the zero-offset
    window origin floor(min q), q = muv * size.  Items go in chunks that
    bound the (chunk, M) temporaries."""
    device = uv_flat.device
    T = uv_flat.shape[0]
    M = get_num_micro_triangles(subdiv)
    bu, bv, bd = bary_cols(torch.arange(M, dtype=torch.int64,
                                        device=device), subdiv)
    out = torch.empty((T, M), dtype=torch.int8, device=device)
    step = max(1, SIDES_CHUNK // M)
    for t0 in range(0, T, step):
        tri6 = tuple(uv_flat[t0:t0 + step, k:k + 1] for k in range(6))
        (ax, ay), (bx, by), (cx, cy) = corner_cols(
            tri6, bu[None, :], bv[None, :], bd[None, :])
        side = None
        for mi, (w, h) in enumerate(mips):
            pad = pads[mi]
            qxm = torch.minimum(torch.minimum(ax, bx), cx) * f32(float(w))
            qym = torch.minimum(torch.minimum(ay, by), cy) * f32(float(h))
            x0 = torch.floor(qxm).to(torch.int32)
            y0 = torch.floor(qym).to(torch.int32)
            x0, y0 = wrap_origin(x0, y0, periods[mi])
            cls = cls_planes[mi]
            H2, W2 = cls.shape
            yy = (y0.to(torch.int64) - 1 + pad).clamp(0, H2 - 1)
            xx = (x0.to(torch.int64) - 1 + pad).clamp(0, W2 - 1)
            s = cls[yy, xx]
            side = s if side is None else torch.where(s == side, side,
                                                      torch.zeros_like(s))
        out[t0:t0 + step] = side
    return out


def resolve_nearest_phase1(texture, cfg, items, subdiv: int,
                           device="cuda"):
    """Phase-1 window resolve for nearest-filter work items
    (twophase.resolve_nearest_phase1): a micro-triangle whose texel
    window lies strictly on one side of the cutoff gets its final state;
    the rest stay UnknownOpaque for classify.classify_nearest_survivors.
    items: (uv_tri, states or None) pairs.  Returns the new state list,
    or None when the preconditions (host._nearest_phase1_windows) fail.
    The side map comes to the host as int8, one byte per micro-triangle.
    Profiler label omm.nearest_phase1."""
    device = check_device(device)
    with span("omm.nearest_phase1"):
        windows = _nearest_phase1_windows(texture, cfg,
                                          [it[0] for it in items], subdiv)
        if windows is None:
            return None
        out, resolved = _nearest_phase1(texture, cfg, items, subdiv,
                                        windows, device)
    routes.count("nearest_phase1", len(out))
    routes.count("nearest_phase1_utri", resolved)
    return out


def _nearest_phase1(texture, cfg, items, subdiv, windows, device):
    """(new state list, micro-triangles this pass resolved) for the
    items, with the largest (Hb, Wb) window over them at each mip."""
    cutoff = float(cfg.alpha_cutoff)
    ba = float(getattr(cfg, "border_alpha", 0.0))
    mips, pads, cls_planes, periods = [], [], [], []
    for mip, (Hb, Wb) in enumerate(windows):
        pad = TILE + max(Hb + 2, Wb + 2)
        period = _period_for(texture, cfg.addr_mode, mip)
        periods.append(period)
        mips.append(texture.size(mip))
        pads.append(pad)
        cls_planes.append(class_plane_cached(texture, mip, cfg.addr_mode,
                                             pad, Hb, Wb, cutoff, ba, period,
                                             device))
    uv_flat = torch.from_numpy(np.stack(
        [it[0].reshape(6) for it in items]).astype(np.float32)).to(device)
    side = nearest_sides(cls_planes, uv_flat, subdiv=subdiv, mips=mips,
                         pads=pads, periods=periods).cpu().numpy()

    st_gt = np.uint8(int(cfg.cutoff_gt))
    st_le = np.uint8(int(cfg.cutoff_le))
    M = get_num_micro_triangles(subdiv)
    out, resolved = [], 0
    for t, (uv_tri, states) in enumerate(items):
        st = np.full(M, UO, np.uint8) if states is None else states.copy()
        act = st == UO
        st[act & (side[t] == 1)] = st_gt
        st[act & (side[t] == -1)] = st_le
        resolved += int(np.count_nonzero(act & (side[t] != 0)))
        out.append(st)
    return out, resolved
