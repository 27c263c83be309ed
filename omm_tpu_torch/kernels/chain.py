"""The two-phase engine's descent and tile-slot assignment: wrappers of
three hand-written CUDA kernels, and their plain torch versions.

They replace XLA programs of the JAX package's `_stageAB` (and the slot
stream of `_stageC_mip`), not Pallas kernels:

  descend_sides  kernel A (csrc/chain_descend.cu): one descent level,
                 `_sides_for` (bird-curve decode, subtriangle corners,
                 per mip the window origin, its wrap and the clamped
                 class-plane lookup, the sides combined over the mips)
                 with the child expansion flat' = flat * E + j, each
                 lane's validity against the parents' count, and the
                 open mask the next compaction reads
  tile_keys      kernel B (csrc/chain_descend.cu): every survivor's tile
                 key per mip (the tile of its wrapped window origin,
                 INVALID_TILE on an invalid lane)
  tile_slots     kernel C (csrc/chain_slots.cu): from each mip's stably
                 sorted keys, every survivor's slot (group offset padded
                 to B plus rank in the group), the padded slot total and
                 the exact stage's slot stream (ids_slot, block_tile);
                 `slot_stream` is its discovery form, the stream of lanes
                 already placed

The sort between B and C stays `torch.sort(stable=True)`, as the JAX
package leaves it to `jax.lax.sort`.  The per-lane math is
`csrc/chain_math.cuh`, shared with `csrc/chain_host.cpp`, a g++ build
that the CPU tests hold against the plain versions (`*_host`).

Each wrapper checks its tensors' device, dtype, shape and contiguity.
It takes the plain version (`*_torch`) for CPU tensors; for CUDA
tensors it launches its kernel on the current stream, or raises.  The
kernels read every count on the device, so their launches can be
captured into a batch's CUDA graph; each launch counts under its
kernel's name (`counts`), at each replay for a captured one.
`*_work` count the bytes and operations of a call and `bound` (the
exact stage's: bytes at 3.35 TB/s, operations at 67 TFLOP/s) turns them
into the least time the card could take.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import counts
from .exact import bound  # noqa: F401  (the chain kernels' bound too)
from ..bird_torch import bary_cols, corner_cols, tri6_of
from ..host import B, TILE, wrap_origin
from ..levelline import f32

#: tile key of an invalid survivor lane (sorts after every real tile) and
#: the slot of one (past every block capacity): twophase's values
INVALID_TILE = 0x7FFFFF00
SENTINEL = 0x7FFFFF00
#: mips a kernel call takes (csrc/chain_math.cuh MAX_MIPS)
MAX_MIPS = 16
#: fp32 operations per lane of the subtriangle corners, and per mip of a
#: window origin (for `*_work`)
OPS_CORNERS = 38
OPS_MIP = 10


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def window_origin(tri6, bu, bv, bd, w, h):
    """floor(min corner * size - 0.5) per element, int32."""
    (ax, ay), (bx, by), (cx, cy) = corner_cols(tri6, bu, bv, bd)
    wf = f32(float(w))
    hf = f32(float(h))
    qxm = torch.minimum(torch.minimum(ax, bx), cx) * wf - 0.5
    qym = torch.minimum(torch.minimum(ay, by), cy) * hf - 0.5
    return (torch.floor(qxm).to(torch.int32),
            torch.floor(qym).to(torch.int32))


def tile_of(x0, y0, pad, ntx):
    """Exact-stage tile id of a (wrapped) window origin."""
    return ((y0 + pad) // TILE) * ntx + (x0 + pad) // TILE


def node_sides_torch(node, level, uv_flat, cls, mips, pads, periods):
    """Combined-over-mips side (+1 / -1 / 0, int8) of the subtriangles
    with flat ids `node` (t*4^level + curve index) at `level`
    (`_sides_for`).  The class-plane lookup clamps out-of-range anchors
    per axis, as XLA's gather does."""
    bu, bv, bd = bary_cols(node & (4 ** level - 1), level)
    tri6 = tri6_of(uv_flat, node >> (2 * level))
    side = None
    for mi, (w, h) in enumerate(mips):
        x0, y0 = window_origin(tri6, bu, bv, bd, w, h)
        x0, y0 = wrap_origin(x0, y0, periods[mi])
        c = cls[mi]
        H2, W2 = c.shape
        yy = (y0.to(torch.int64) - 1 + pads[mi]).clamp(0, H2 - 1)
        xx = (x0.to(torch.int64) - 1 + pads[mi]).clamp(0, W2 - 1)
        s = c[yy, xx]
        side = s if side is None else torch.where(s == side, side,
                                                  torch.zeros_like(s))
    return side


def descend_sides_torch(par, count, *, E, level, n_out, uv_flat, cls, mips,
                        pads, periods, test=True, active=None, act_span=0):
    """Plain version of `descend_sides`."""
    dev = uv_flat.device
    n_par = n_out // E if par is None else par.shape[0]
    parent = (torch.arange(n_par, dtype=torch.int64, device=dev)
              if par is None else par)
    jj = torch.arange(E, dtype=torch.int64, device=dev)
    node = (parent[:, None] * E + jj[None, :]).reshape(-1)
    lim = n_par if count is None else torch.clamp_max(count, n_par)
    valid = (torch.arange(n_par, device=dev) < lim)[:, None].expand(
        n_par, E).reshape(-1)
    if n_out < node.shape[0]:
        node, valid = node[:n_out], valid[:n_out]
    elif n_out > node.shape[0]:
        extra = n_out - node.shape[0]
        node = torch.cat([node, torch.zeros(extra, dtype=torch.int64,
                                            device=dev)])
        valid = torch.cat([valid, torch.zeros(extra, dtype=torch.bool,
                                              device=dev)])
    side = None
    open_ = valid
    if test:
        side = node_sides_torch(node, level, uv_flat, cls, mips, pads,
                                periods)
        open_ = valid & (side == 0)
    if act_span:
        open_ = open_ & active.reshape(-1, act_span).any(dim=1)[node]
    return side, node, valid, open_


def tile_keys_torch(ids, kvalid, *, subdiv, uv_flat, mips, pads, ntxs,
                    periods):
    """Plain version of `tile_keys`."""
    M = 4 ** subdiv
    bu, bv, bd = bary_cols(ids % M, subdiv)
    tri6 = tri6_of(uv_flat, ids // M)
    keys = []
    for mi, (w, h) in enumerate(mips):
        x0, y0 = window_origin(tri6, bu, bv, bd, w, h)
        x0, y0 = wrap_origin(x0, y0, periods[mi])
        tile = tile_of(x0.to(torch.int64), y0.to(torch.int64), pads[mi],
                       ntxs[mi])
        if kvalid is not None:
            tile = torch.where(kvalid, tile, INVALID_TILE)
        keys.append(tile.to(torch.int32))
    return torch.stack(keys)


def _stream_torch(ok, slot, ids, keys, first, nblk):
    """(block_tile (nblk,) int32, ids_slot (nblk, B) int32): ids[k] at
    slot[k] where ok, and keys[k] as the tile of block slot[k] / B where
    also `first`; -1 and 0 elsewhere.  The lanes left out write to a dump
    lane past the end."""
    dev = ids.device
    cap = nblk * B
    tgt = torch.where(ok, slot, cap)
    ids_slot = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    ids_slot = ids_slot.scatter_(0, tgt, ids.to(torch.int32))[:cap]
    tb = torch.where(ok & first, slot // B, nblk)
    block_tile = torch.zeros(nblk + 1, dtype=torch.int32, device=dev)
    block_tile = block_tile.scatter_(0, tb, keys.to(torch.int32))[:nblk]
    return block_tile, ids_slot.reshape(nblk, B)


def tile_slots_torch(st, order, ids, nblks):
    """Plain version of `tile_slots`."""
    dev = st.device
    nm, K = st.shape
    ar = torch.arange(K, dtype=torch.int64, device=dev)
    slot = torch.empty((nm, K), dtype=torch.int64, device=dev)
    padM = torch.zeros(nm, dtype=torch.int64, device=dev)
    streams = []
    for m in range(nm):
        s = st[m]
        if K:
            # each tile group starts at a multiple of B
            is_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                             device=dev), s[1:] != s[:-1]])
            start_pos = torch.cummax(torch.where(is_start, ar, 0), 0).values
            rank = ar - start_pos
            start_prev = torch.cat([torch.zeros(1, dtype=torch.int64,
                                                device=dev), start_pos[:-1]])
            inc = torch.where(is_start & (ar > 0),
                              ((ar - start_prev + B - 1) // B) * B, 0)
            offsets = torch.cumsum(inc, 0)
            valid_el = s != INVALID_TILE
            slot_sorted = torch.where(valid_el, offsets + rank, SENTINEL)
            slot[m] = torch.empty_like(ar).scatter_(0, order[m],
                                                    slot_sorted)
            padM[m] = torch.where(valid_el,
                                  offsets + ((rank + B) // B) * B, 0).max()
        else:
            valid_el = torch.zeros(0, dtype=torch.bool, device=dev)
            rank = slot_sorted = ar
        nblk = int(nblks[m])
        streams.append(_stream_torch(
            valid_el & (slot_sorted < nblk * B), slot_sorted,
            ids[order[m]], s, rank % B == 0, nblk))
    return slot, padM, streams


def slot_stream_torch(ids, slot, keys, nblk):
    """Plain version of `slot_stream`."""
    ok = (slot >= 0) & (slot < nblk * B)
    return _stream_torch(ok, slot, ids, keys, slot % B == 0, nblk)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _want(name, t, dev, dtype, ndim):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_mips(mips, pads, periods, ntxs=None, cls=None):
    nm = len(mips)
    if not 1 <= nm <= MAX_MIPS:
        raise ValueError(f"1 to {MAX_MIPS} mips expected, got {nm}")
    if len(pads) != nm or len(periods) != nm or (
            ntxs is not None and len(ntxs) != nm) or (
            cls is not None and len(cls) != nm):
        raise ValueError("one pad, period, tile count and class plane per "
                         "mip expected")


def _mip_ints(mips, pads, ntxs, periods, cls=None):
    """The kernels' per-mip ints (H2, W2, w, h, pad, ntx, Pw, Ph)."""
    vals = []
    for mi, (w, h) in enumerate(mips):
        H2, W2 = cls[mi].shape if cls is not None else (0, 0)
        Pw, Ph = periods[mi] if periods[mi] is not None else (0, 0)
        vals += [H2, W2, w, h, pads[mi], ntxs[mi] if ntxs else 0, Pw, Ph]
    return (ctypes.c_int * len(vals))(*vals)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on(dev, what):
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {dev}")
    return dev.type == "cpu"


def _cuda(dev, entry, what, launches):
    """The run of a C entry of the CUDA library on `dev`'s current stream:
    raises if the launch failed, else counts it when `launches` (the
    call has lanes)."""
    def run(args):
        from .build import chain_cuda_library
        lib = chain_cuda_library()
        with torch.cuda.device(dev):
            rc = getattr(lib, entry)(
                *args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.omm_chain_error_string(rc).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({rc})")
        if launches:
            counts.count(what)
    return run


def _host(entry):
    """The run of a C entry of the g++ build (CPU tensors)."""
    def run(args):
        from .build import chain_host_library
        if getattr(chain_host_library(), entry)(*args) != 0:
            raise RuntimeError(f"{entry} failed")
    return run


def _check_descend(par, count, *, E, level, n_out, uv_flat, cls, mips,
                   pads, periods, test=True, active=None, act_span=0):
    dev = uv_flat.device
    _want("uv_flat", uv_flat, dev, torch.float32, 2)
    if uv_flat.shape[1] != 6:
        raise ValueError("uv_flat must be (T, 6)")
    _check_mips(mips, pads, periods, cls=cls if test else None)
    if E < 1 or n_out < 0:
        raise ValueError(f"E must be >= 1 and n_out >= 0, got {E}, {n_out}")
    if par is None:
        if n_out % E:
            raise ValueError("without parents n_out must be a multiple of E")
    else:
        _want("par", par, dev, torch.int64, 1)
    if count is not None:
        _want("count", count.reshape(-1), dev, torch.int64, 1)
        if count.numel() != 1:
            raise ValueError("count must hold one value")
    if test:
        for c in cls:
            _want("class plane", c, dev, torch.int8, 2)
    if act_span:
        if active is None:
            raise ValueError("act_span needs the active mask")
        _want("active", active, dev, torch.bool, 2)


def _descend_run(run, par, count, *, E, level, n_out, uv_flat, cls, mips,
                 pads, periods, test=True, active=None, act_span=0):
    dev = uv_flat.device
    outs = (torch.empty(n_out, dtype=torch.int8, device=dev) if test
            else None,
            torch.empty(n_out, dtype=torch.int64, device=dev),
            torch.empty(n_out, dtype=torch.bool, device=dev),
            torch.empty(n_out, dtype=torch.bool, device=dev))
    run(_descend_args(par, count, E, level, n_out, uv_flat, cls, mips, pads,
                      periods, test, active, act_span, outs))
    return outs


def _descend_args(par, count, E, level, n_out, uv_flat, cls, mips, pads,
                  periods, test, active, act_span, outs):
    n_par = n_out // E if par is None else par.shape[0]
    cls_ptrs = (ctypes.c_int64 * len(mips))(
        *[c.data_ptr() for c in cls]) if test else None
    side, node, valid, open_ = outs
    return (_ptr(par), _ptr(count), n_par, n_out, E, level, int(test),
            _ptr(active), act_span, uv_flat.data_ptr(), len(mips), cls_ptrs,
            _mip_ints(mips, pads, None, periods, cls if test else None),
            _ptr(side), node.data_ptr(), valid.data_ptr(), open_.data_ptr())


def descend_sides(par, count, **kw):
    """One descent level (kernel A), keywords E, level, n_out, uv_flat,
    cls, mips, pads, periods, test=True, active=None, act_span=0: child
    lane j of n_out has parent lane p = j // E.  A parent lane below
    n_par (par's length; n_out // E without par, whose parent p is node
    p) expands to node par[p] * E + j % E, valid while p < min(count,
    n_par) (count: a one-value int64 tensor on the device, None for
    every parent lane); lanes past n_par * E hold node 0 and are
    invalid.  With `test` each child's window side at `level` is
    computed from cls (the level's int8 class plane per mip).  `open`
    is valid & side == 0 (without test: valid), and where act_span > 0
    also has some active flag in active.reshape(-1)[node * act_span :
    + act_span] (active: (T, M) bool).

    Returns (side int8 or None, node int64, valid bool, open bool), each
    (n_out,)."""
    dev = kw["uv_flat"].device
    cpu = _on(dev, "descend_sides")
    _check_descend(par, count, **kw)
    if cpu:
        return descend_sides_torch(par, count, **kw)
    return _descend_run(_cuda(dev, "omm_descend_sides", "descend_sides",
                              kw["n_out"] > 0), par, count, **kw)


def descend_sides_host(par, count, **kw):
    """descend_sides through the g++ build of the kernel's code (CPU
    tensors; the CPU tests)."""
    _check_descend(par, count, **kw)
    return _descend_run(_host("omm_descend_sides_host"), par, count, **kw)


def _check_keys(ids, kvalid, *, subdiv, uv_flat, mips, pads, ntxs,
                periods):
    dev = uv_flat.device
    _want("uv_flat", uv_flat, dev, torch.float32, 2)
    _want("ids", ids, dev, torch.int64, 1)
    if kvalid is not None:
        _want("kvalid", kvalid, dev, torch.bool, 1)
        if kvalid.shape != ids.shape:
            raise ValueError("kvalid must have ids' shape")
    _check_mips(mips, pads, periods, ntxs=ntxs)


def _keys_run(run, ids, kvalid, *, subdiv, uv_flat, mips, pads, ntxs,
              periods):
    keys = torch.empty((len(mips), ids.shape[0]), dtype=torch.int32,
                       device=ids.device)
    run((ids.data_ptr(), _ptr(kvalid), ids.shape[0], subdiv,
         uv_flat.data_ptr(), len(mips), _mip_ints(mips, pads, ntxs, periods),
         keys.data_ptr()))
    return keys


def tile_keys(ids, kvalid, **kw):
    """Survivor tile keys (kernel B), keywords subdiv, uv_flat, mips,
    pads, ntxs, periods: for each lane of ids (flat ids t*4^subdiv + m,
    int64) and each mip, the exact-stage tile of its wrapped window
    origin; INVALID_TILE where kvalid (bool, or None for every lane) is
    False.  Returns (nmips, n) int32."""
    dev = kw["uv_flat"].device
    cpu = _on(dev, "tile_keys")
    _check_keys(ids, kvalid, **kw)
    if cpu:
        return tile_keys_torch(ids, kvalid, **kw)
    return _keys_run(_cuda(dev, "omm_tile_keys", "tile_keys",
                           ids.shape[0] > 0), ids, kvalid, **kw)


def tile_keys_host(ids, kvalid, **kw):
    """tile_keys through the g++ build of the kernel's code."""
    _check_keys(ids, kvalid, **kw)
    return _keys_run(_host("omm_tile_keys_host"), ids, kvalid, **kw)


def _check_slots(st, order, ids, nblks):
    dev = st.device
    _want("st", st, dev, torch.int32, 2)
    _want("order", order, dev, torch.int64, 2)
    _want("ids", ids, dev, torch.int64, 1)
    nm, K = st.shape
    if order.shape != st.shape or ids.shape[0] != K:
        raise ValueError("st and order must be (nmips, K) and ids (K,)")
    if not 1 <= nm <= MAX_MIPS or len(nblks) != nm:
        raise ValueError(f"1 to {MAX_MIPS} rows and a block capacity per "
                         "row expected")
    if any(int(n) < 0 for n in nblks):
        raise ValueError("block capacities must be >= 0")


def _slots_run(run, st, order, ids, nblks, scratch=()):
    """Allocate tile_slots' outputs (the streams end to end in one
    ids_slot and one block_tile buffer) and run the C entry on them
    (the CUDA entry takes its scratch last)."""
    nm, K = st.shape
    nb = [int(n) for n in nblks]
    dev = st.device
    slot = torch.empty((nm, K), dtype=torch.int64, device=dev)
    padM = torch.empty(nm, dtype=torch.int64, device=dev)
    ids_slot = torch.empty(sum(nb) * B, dtype=torch.int32, device=dev)
    block_tile = torch.empty(sum(nb), dtype=torch.int32, device=dev)
    run(_slots_args(st, order, ids, nb, slot, padM, ids_slot, block_tile)
        + tuple(scratch))
    streams, o = [], 0
    for n in nb:
        streams.append((block_tile[o:o + n],
                        ids_slot[o * B:(o + n) * B].view(n, B)))
        o += n
    return slot, padM, streams


def _slots_args(st, order, ids, nblks, slot, padM, ids_slot, block_tile):
    nm, K = st.shape
    return (st.data_ptr(), order.data_ptr(), ids.data_ptr(), K, nm,
            (ctypes.c_int64 * nm)(*[int(n) for n in nblks]),
            slot.data_ptr(), padM.data_ptr(), ids_slot.data_ptr(),
            block_tile.data_ptr())


def tile_slots(st, order, ids, nblks):
    """Tile slots (kernel C) from each mip's stably sorted tile keys.

    st: (nmips, K) int32 sorted keys (invalid lanes INVALID_TILE, last);
    order: (nmips, K) int64, the lane of each sorted key; ids: (K,)
    int64 survivor ids; nblks: per mip the slot stream's block capacity
    (0: no stream).  Returns (slot (nmips, K) int64 by lane, the group
    offset padded to B plus the rank in the group, SENTINEL on invalid
    lanes; padM (nmips,) int64, the padded slot total; per mip
    (block_tile (nblk,) int32, ids_slot (nblk, B) int32): each valid
    lane's id at its slot (-1 elsewhere) and each block's tile (0 for an
    empty block), slots past nblk * B left out)."""
    dev = st.device
    cpu = _on(dev, "tile_slots")
    _check_slots(st, order, ids, nblks)
    if cpu:
        return tile_slots_torch(st, order, ids, nblks)
    from .build import chain_cuda_library
    nm, K = st.shape
    bsum = torch.empty(nm * chain_cuda_library().omm_tile_slots_chunks(K),
                       dtype=torch.int64, device=dev)
    return _slots_run(_cuda(dev, "omm_tile_slots", "tile_slots", True), st,
                      order, ids, nblks, (bsum.data_ptr(),))


def tile_slots_host(st, order, ids, nblks):
    """tile_slots through the g++ build of the kernel's code."""
    _check_slots(st, order, ids, nblks)
    return _slots_run(_host("omm_tile_slots_host"), st, order, ids, nblks)


def _check_stream(ids, slot, keys, nblk):
    dev = ids.device
    _want("ids", ids, dev, torch.int64, 1)
    _want("slot", slot, dev, torch.int64, 1)
    _want("keys", keys, dev, torch.int32, 1)
    if slot.shape != ids.shape or keys.shape != ids.shape:
        raise ValueError("ids, slot and keys must have one shape")
    if nblk < 0:
        raise ValueError("nblk must be >= 0")


def _stream_run(run, ids, slot, keys, nblk):
    dev = ids.device
    block_tile = torch.empty(nblk, dtype=torch.int32, device=dev)
    ids_slot = torch.empty((nblk, B), dtype=torch.int32, device=dev)
    run((ids.data_ptr(), slot.data_ptr(), keys.data_ptr(), ids.shape[0],
         nblk, ids_slot.data_ptr(), block_tile.data_ptr()))
    return block_tile, ids_slot


def slot_stream(ids, slot, keys, nblk):
    """The exact stage's slot stream of lanes already placed (kernel C's
    discovery form): (block_tile (nblk,) int32, ids_slot (nblk, B)
    int32), ids[k] at slot[k] and, at a block's first slot, keys[k] (the
    lane's tile key of this mip, from `tile_keys`) as the block's tile;
    -1 and 0 elsewhere, slots outside [0, nblk * B) left out."""
    dev = ids.device
    cpu = _on(dev, "slot_stream")
    _check_stream(ids, slot, keys, nblk)
    if cpu:
        return slot_stream_torch(ids, slot, keys, nblk)
    return _stream_run(_cuda(dev, "omm_slot_stream", "tile_slots",
                             nblk > 0 or ids.shape[0] > 0),
                       ids, slot, keys, nblk)


def slot_stream_host(ids, slot, keys, nblk):
    """slot_stream through the g++ build of the kernel's code."""
    _check_stream(ids, slot, keys, nblk)
    return _stream_run(_host("omm_slot_stream_host"), ids, slot, keys, nblk)


# ---------------------------------------------------------------------------
# work and bound
# ---------------------------------------------------------------------------

def descend_work(par, count, out, *, n_out, uv_flat, cls, test=True,
                 act_span=0):
    """Bytes and fp32 operations of one descend_sides call whose result
    is `out`: each input read once (the parents, the count, the UV rows,
    one class-plane byte per lane and mip, the active flags the open
    lanes test), each output written once."""
    side, node, valid, open_ = out
    nm = len(cls) if test else 0
    n_par = 0 if par is None else par.shape[0]
    tested = int((valid & (side == 0)).sum()) if test else int(valid.sum())
    nbytes = (n_par * 8 + (8 if count is not None else 0)
              + uv_flat.numel() * 4 + n_out * nm
              + (tested * act_span if act_span else 0)
              + n_out * (8 + 1 + 1 + (1 if test else 0)))
    ops = n_out * (OPS_CORNERS + OPS_MIP * nm) if test else 0
    return {"lanes": n_out, "bytes": nbytes, "ops": ops}


def tile_keys_work(ids, kvalid, keys, uv_flat):
    """Bytes and fp32 operations of one tile_keys call."""
    nm, n = keys.shape
    nv = n if kvalid is None else int(kvalid.sum())
    nbytes = (nv * 8 + (n if kvalid is not None else 0)
              + uv_flat.numel() * 4 + nm * n * 4)
    return {"lanes": n, "bytes": nbytes,
            "ops": nv * (OPS_CORNERS + OPS_MIP * nm)}


def tile_slots_work(st, order, ids, nblks):
    """Bytes and integer operations of one tile_slots call: the sorted
    keys and the permutation read once, the valid lanes' ids, the slots,
    totals and streams written once; a handful of integer operations per
    position (the binary searches run at group starts only)."""
    nm, K = st.shape
    nv = int((st != INVALID_TILE).sum())
    nb = sum(int(n) for n in nblks)
    nbytes = nm * K * (4 + 8 + 8) + nv * 8 + nm * 8 + nb * (B + 1) * 4
    return {"lanes": nm * K, "bytes": nbytes, "ops": nm * K * 8}


# ---------------------------------------------------------------------------
# holding the kernels against their plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording(calls: list):
    """Within the block, each call of a wrapper from the two-phase stages
    (`twophase`) is appended to `calls` as (kernel, wrapper's name,
    wrapper, plain version, args, kwargs, result): the inputs the stages
    gave each kernel, to hold it against its plain version.  For one
    thread's eager runs (a captured graph's outputs are written at its
    replays)."""
    from .. import twophase
    table = {"descend_sides": ("descend_sides", descend_sides,
                               descend_sides_torch),
             "tile_keys": ("tile_keys", tile_keys, tile_keys_torch),
             "tile_slots": ("tile_slots", tile_slots, tile_slots_torch),
             "chain_slot_stream": ("tile_slots", slot_stream,
                                   slot_stream_torch)}
    saved = {a: getattr(twophase, a) for a in table}

    def rec(attr, kernel, fn, plain):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((kernel, fn.__name__, fn, plain, args, kw, out))
            return out
        return call

    try:
        for attr, (kernel, fn, plain) in table.items():
            setattr(twophase, attr, rec(attr, kernel, fn, plain))
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(twophase, attr, fn)


def result_diff(a, b) -> int:
    """The largest absolute difference between two results of a wrapper
    (tensors, or tuples and lists of them, or None), compared on the
    same device; raises unless their structure, shapes and dtypes
    agree."""
    if isinstance(a, (tuple, list)):
        if not isinstance(b, (tuple, list)) or len(a) != len(b):
            raise ValueError("results differ in structure")
        return max([result_diff(x, y) for x, y in zip(a, b)], default=0)
    if a is None or b is None:
        if a is not b:
            raise ValueError("results differ in structure")
        return 0
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"results differ: {tuple(a.shape)} {a.dtype} "
                         f"against {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
