"""Batched classification of work items through the two-phase engine.

Counterpart of `omm_tpu.kernels.twophase.classify_work_items_batches`,
with its single-sync pipeline and its concurrent drain.  A batch's cap
key is the JAX package's: (subdiv, descent levels, items, all active).
The texture's caps cache (`texture._omm_torch_caps`, the JAX package's
`_omm_caps`) maps a key to the capacities (per-level parents,
survivors, per-mip blocks) that the discovery path saw, with headroom
(`host.caps_entry`).

  - A batch whose key is cached runs its whole stage chain at those
    capacities (`twophase.spec_chain`): on a card as one CUDA graph
    (`graphs`), on the CPU eagerly.  Its payload, [meta int32s | packed
    rows], comes to the host in one copy (pinned memory on a card).
  - The drain reads each payload's meta.  A flagged overflow, or a key
    not in the cache, sends the batch to the discovery path: the
    exact-size stages (`stage_ab`, `stage_c_mip` for every mip,
    `stage_d`), which read each count on the host and record the
    batch's caps entry.

Which path a batch takes depends on the caps cache alone: setting or
emptying `texture._omm_torch_caps` chooses it.  Both give the same
bytes.

The threads of a call are the JAX package's:

  1. With more than one fast-path batch, one enqueue thread (a
     single-worker executor made per call) issues every batch's chain
     in batch order, on the caller's current stream: every copy-in,
     replay, capture and copy-out of the call.  The calling thread
     builds each batch (its host tables and cached planes) and submits
     it at once, so the device starts on batch 0 while later batches
     are built.  A single batch is enqueued inline.
  2. Items off the fast path then take the slow routes on the calling
     thread, before the first drain: their device work queues beside
     the replays, and their host work overlaps the device's.
  3. The calling thread drains the batches in order: it waits for the
     batch's enqueue and its payload's event (label `omm.drain`) and
     reads the meta.  Each clean batch's `_Batch.write_back` (the post
     pass, `PackedStates`, row merges) runs on a pool of POST_WORKERS
     threads while the calling thread waits on the next batch; a batch
     writes only its own results and posts.
  4. After every write-back has finished and the enqueue thread has
     shut down, the batches without a caps entry and those that
     overflowed take the discovery path, in batch order.

The JAX package waits for every enqueue before it drains, since its
chunked fetch concatenates the payloads on the enqueue thread; the port
copies each payload on its own, so batch k drains as soon as its own
enqueue has returned.  An error in an enqueue or a write-back reaches
the caller; queued enqueues are cancelled and no thread is left
running.  The calling thread's spans (`spans.span`) name each step:
`omm.plan` (routing, the fast-path mask, the descent schedule and
window maxima), `omm.class_planes` and `omm.submit` per batch,
`omm.slow`, `omm.drain` per batch (the wait, the meta, the hand-off to
the post pool), `omm.post_wait` (the write-backs and the pool's
shutdown) and `omm.discovery`.  torch.profiler sees the enqueue
thread's `omm.spec` and the pool's `omm.row_post` only with
`profile_all_threads` set in its experimental config.

Items outside the engine's fast path take the JAX package's slow routes
(twophase `_classify_slow`) on the same device through
`engine.resample_fine_item`: a linear-filter level-line item goes to
`classify.classify_work_item`, or to `classify.classify_degenerate` when
it is a line triangle; any other item to the engine's own passes.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from . import engine, geom, graphs, host, native, planes, routes
from .host import TILE
from .planes import check_device
from .spans import span
from .twophase import (PackedStates, spec_chain, stage_ab, stage_c_mip,
                       stage_d)
from .types import OpacityState, get_num_micro_triangles

UO = int(OpacityState.UnknownOpaque)
#: threads that write batches back (twophase.classify_work_items_batches'
#: pool)
POST_WORKERS = 4


def precompute(texture, uvs, subdiv, lg):
    """The call-wide descent schedule and window maxima of one level
    (twophase.classify_work_items_batches' precomp)."""
    levels = host._descend_levels(texture, uvs, subdiv, lg)
    uv_all = np.stack(uvs)
    HW = []
    HWl = [[] for _ in levels]
    for mip in range(texture.mip_count):
        Hbs, Wbs = host._span_windows(texture, uv_all, subdiv, mip)
        HW.append((int(Hbs.max()), int(Wbs.max())))
        for li, lv in enumerate(levels):
            Hls, Wls = host._span_windows(texture, uv_all, lv, mip)
            HWl[li].append((int(Hls.max()), int(Wls.max())))
    return {"lg": lg, "levels": levels, "HW": HW, "HWl": HWl}


def batch_planes(texture, cfg, precomp, device) -> dict:
    """The device state a batch's stages read, per mip: the padded plane,
    its tile columns, the address-mode period, and the class plane of
    every descent level (all cached on the texture)."""
    levels = precomp["levels"]
    cutoff = float(cfg.alpha_cutoff)
    ba = float(getattr(cfg, "border_alpha", 0.0))
    bp = {"levels": levels, "HW": precomp["HW"], "mips": [], "pads": [],
          "ntxs": [], "periods": [], "planes": [], "rcps": [],
          "cls_lv": [[] for _ in levels]}
    for mip in range(texture.mip_count):
        Hb, Wb = precomp["HW"][mip]
        pad = TILE + max(Hb + 2, Wb + 2)
        period = host._period_for(texture, cfg.addr_mode, mip)
        planeP = planes.padded_plane(texture, mip, cfg.addr_mode, pad, ba,
                                     period, device)
        info = texture.info[mip]
        bp["mips"].append(texture.size(mip))
        bp["pads"].append(pad)
        bp["ntxs"].append(-(-planeP.shape[1] // TILE))
        bp["periods"].append(period)
        bp["planes"].append(planeP)
        bp["rcps"].append((float(info.rcp_size[0]), float(info.rcp_size[1])))
        for li in range(len(levels)):
            Hl, Wl = precomp["HWl"][li][mip]
            bp["cls_lv"][li].append(planes.class_plane_cached(
                texture, mip, cfg.addr_mode, pad, Hl, Wl, cutoff, ba,
                period, device))
    return bp


def run_stage_ab(bp, uv_flat, active, subdiv, all_active):
    return stage_ab(bp["cls_lv"], uv_flat, active, subdiv=subdiv,
                    levels=bp["levels"], mips=bp["mips"], pads=bp["pads"],
                    ntxs=bp["ntxs"], periods=bp["periods"],
                    all_active=all_active)


def run_stage_c(bp, res, mip, uv_flat, ccw, subdiv, cfg, exact=None):
    w, h = bp["mips"][mip]
    Hb, Wb = bp["HW"][mip]
    return stage_c_mip(
        bp["planes"][mip], uv_flat, ccw, res["ids"], res["slots"][mip],
        res["padMs"][mip], subdiv=subdiv, w=w, h=h, pad=bp["pads"][mip],
        ntx=bp["ntxs"][mip], H=Hb, W=Wb, rcp=bp["rcps"][mip],
        alpha_cutoff=float(cfg.alpha_cutoff), period=bp["periods"][mip],
        exact=exact)


def item_tables(uv_arr: np.ndarray, device):
    """(T, 6) fp32 UV columns and (T,) int32 0/1 winding on `device`."""
    T = uv_arr.shape[0]
    uv_flat = torch.from_numpy(
        uv_arr.reshape(T, 6).astype(np.float32)).to(device)
    ccw = torch.from_numpy(geom.is_ccw(uv_arr).astype(np.int32)).to(device)
    return uv_flat, ccw


#: the attribute of a texture that holds the port's caps cache
CAPS_ATTR = "_omm_torch_caps"


class _Batch:
    """A fast-path batch: its items, the key of its capacities, and what
    its chain reads (host tables and the cached planes)."""

    def __init__(self, texture, cfg, items, subdiv, fast, out, all_active,
                 precomp, device, exact, post=None):
        self.texture, self.cfg, self.items = texture, cfg, items
        self.subdiv, self.fast, self.out = subdiv, fast, out
        self.post = post  # the dict write_back fills, or None
        self.all_active, self.device, self.exact = all_active, device, exact
        self.T = len(fast)
        self.M = get_num_micro_triangles(subdiv)
        self.uv_arr = np.stack([items[i][0] for i in fast])
        self.active_np = None
        if not all_active:
            self.active_np = np.stack(
                [np.ones(self.M, bool) if items[i][1] is None
                 else items[i][1] == UO for i in fast])
        # spans name the stages in torch.profiler traces
        # (the JAX engine's jax.named_scope labels)
        with span("omm.class_planes"):
            self.bp = batch_planes(texture, cfg, precomp, device)
        self.cap_key = (subdiv, tuple(self.bp["levels"]), self.T,
                        bool(all_active))

    def host_inputs(self):
        """(T, 6) fp32 UVs, (T,) int32 winding and, for a partial batch,
        the (T, M) bool active mask, as CPU tensors."""
        uv_flat, ccw = item_tables(self.uv_arr, "cpu")
        if self.active_np is None:
            return (uv_flat, ccw)
        return (uv_flat, ccw, torch.from_numpy(self.active_np))

    def write_back(self, packed):
        """Put the batch's (T, M/4) packed rows into its items' results:
        PackedStates when all its items are fully active, else states
        with only the active micro-triangles replaced.  Where posts are
        wanted, the fused post pass (`native.row_post_packed`) runs over
        the rows while they are cache-warm: every row of an all-active
        batch, else the rows of fresh items (a row merged into prior
        states changes bytes, so it gets none)."""
        if self.post is not None:
            rows = [t for t, i in enumerate(self.fast)
                    if self.all_active or self.items[i][1] is None]
            if rows:
                with span("omm.row_post"):
                    dig, uni = native.row_post_packed(
                        packed, self.M,
                        row_base=np.asarray(rows, np.int64) * (self.M // 4))
                for k, t in enumerate(rows):
                    self.post[self.fast[t]] = (int(dig[k]), int(uni[k]))
        for t, i in enumerate(self.fast):
            if self.all_active:
                self.out[i] = PackedStates(packed[t], self.M)
                continue
            unp = native.unpack_2bit_seq(packed[t], self.M)
            states = self.items[i][1]
            if states is None:
                self.out[i] = unp
            else:
                act = self.active_np[t]
                st = states.copy()
                st[act] = unp[act]
                self.out[i] = st


def _caps(texture) -> dict:
    """The texture's caps cache (created on first use)."""
    return texture.__dict__.setdefault(CAPS_ATTR, {})


def _run_batch(job):
    """The discovery path: classify the batch at exact sizes, reading
    each count on the host, and record its caps entry."""
    bp, cfg, subdiv = job.bp, job.cfg, job.subdiv
    uv_flat, ccw = item_tables(job.uv_arr, job.device)
    active = None
    if not job.all_active:
        active = torch.from_numpy(job.active_np).to(job.device)
    routes.count("discovery")
    with span("omm.stage_ab"):
        res = run_stage_ab(bp, uv_flat, active, subdiv, job.all_active)
    with span("omm.stage_c"):
        mip_counts = [run_stage_c(bp, res, mi, uv_flat, ccw, subdiv, cfg,
                                  job.exact)
                      for mi in range(len(bp["mips"]))]
    with span("omm.stage_d"):
        packed = stage_d(res["sides"], res["nodes"], res["ids"], mip_counts,
                         T=job.T, subdiv=subdiv, levels=bp["levels"],
                         fmt=cfg.fmt, promotion=cfg.promotion,
                         cutoff_gt=cfg.cutoff_gt, cutoff_le=cfg.cutoff_le)
        packed = packed.cpu().numpy()  # the batch's device-to-host copy
    _caps(job.texture)[job.cap_key] = host.caps_entry(res["Cs"], res["K"],
                                                      res["padMs"])
    job.write_back(packed)


def _graph_key(job):
    """What a batch's graph is built from, but its capacities: the cap
    key, the planes it reads (by identity: the texture's cache holds
    them), their geometry, the configuration's states and the exact
    stage's engine."""
    bp, cfg = job.bp, job.cfg
    planes_read = tuple(id(t) for t in bp["planes"]) + tuple(
        id(t) for lv in bp["cls_lv"] for t in lv)
    return (job.cap_key, planes_read, tuple(bp["mips"]), tuple(bp["pads"]),
            tuple(bp["periods"]), tuple(bp["HW"]), tuple(bp["rcps"]),
            float(cfg.alpha_cutoff), int(cfg.fmt), int(cfg.promotion),
            int(cfg.cutoff_gt), int(cfg.cutoff_le), job.exact)


def spec_fn(job, entry):
    """The batch's capacity chain at the caps entry (Cs, K_cap, nblks):
    a function of the batch's inputs (job.host_inputs(), on its device)
    that returns the payload."""
    Cs, K_cap, nblks = entry
    bp, cfg = job.bp, job.cfg

    def chain(uv_flat, ccw, active=None):
        return spec_chain(
            bp["cls_lv"], bp["planes"], uv_flat, ccw, active,
            subdiv=job.subdiv, levels=tuple(bp["levels"]), caps=tuple(Cs),
            K_cap=K_cap, nblks=tuple(nblks), mips=bp["mips"],
            pads=bp["pads"], ntxs=bp["ntxs"], periods=bp["periods"],
            HWs=bp["HW"], rcps=bp["rcps"], all_active=job.all_active,
            alpha_cutoff=float(cfg.alpha_cutoff), fmt=cfg.fmt,
            promotion=cfg.promotion, cutoff_gt=cfg.cutoff_gt,
            cutoff_le=cfg.cutoff_le, exact=job.exact)

    return chain


def _enqueue_spec(job):
    """Start the batch's capacity chain if its key is cached: returns
    (caps, host payload, CUDA event or None), or None."""
    entry = _caps(job.texture).get(job.cap_key)
    if entry is None:
        return None
    routes.count("spec")
    chain = spec_fn(job, entry)
    if job.device.type == "cuda":
        buf, ev = graphs.run(job.texture, job.device,
                             _graph_key(job), entry,
                             job.host_inputs(), chain)
        return entry, buf, ev
    with span("omm.spec"):
        return entry, chain(*job.host_inputs()), None


def _drain_spec(job, pending):
    """Wait for a batch's payload and read its meta: the batch's (T, M/4)
    packed rows (a view of the payload), or None where the meta flags an
    overflow."""
    _, buf, ev = pending
    if ev is not None:
        ev.synchronize()
    routes.count("count_sync")
    buf = buf.numpy()
    m = len(job.bp["levels"]) - 1
    hdr = 4 * (m + 2 + len(job.bp["mips"]))
    if int(buf[:hdr].view(np.int32)[m + 1]) != 0:
        routes.count("spec_overflow")
        return None
    return buf[hdr:].reshape(job.T, job.M // 4)


def _on_stream(stream, job):
    """_enqueue_spec(job) with `stream` (the caller's, on a card) as this
    thread's current stream."""
    if stream is None:
        return _enqueue_spec(job)
    with torch.cuda.stream(stream):
        return _enqueue_spec(job)


def _run_now(fn, *args) -> Future:
    """fn(*args) on this thread, as a resolved future."""
    f = Future()
    f.set_result(fn(*args))
    return f


def classify_work_items_batches(texture, cfg, batches, subdiv, *,
                                device="cuda", exact=None,
                                post_out: list | None = None):
    """Classify several batches of work items on `device`.

    batches: lists of (uv_tri (3, 2) fp32, states (M,) uint8 or None);
    None declares a fresh item (all UnknownOpaque).  Micro-triangles in
    state UnknownOpaque are classified.  subdiv: one level for every
    batch, or one per batch.  device: "cuda" (the default; raises where
    there is no card) runs the exact stage's CUDA kernel, "cpu" its
    torch twin.  exact: the exact stage's engine, as
    `kernels.exact.exact_counts` takes it: None (the device decides), or
    "torch" for the twin on any device, the GPU baker's ComputeOnly
    engine.

    Returns per batch the list of results: a PackedStates (serialize's
    2-bit rows) for every fast-path item of a batch whose fast-path
    items are all fully active, else (M,) uint8 arrays.  Items with
    nothing left to classify come back unchanged.  Items off the fast
    path go through `engine.resample_fine_item`.  A batch whose cap key
    is in the texture's caps cache runs its chain at the cached
    capacities; the others, and those that overflow them, run the
    discovery path, which records their entries (module docstring).

    post_out: an optional list; receives one dict per batch mapping item
    index -> (states3 digest, uniform value) of the fast-path rows that
    come back whole (every row of an all-active batch, the fresh items'
    rows of a partial one), from the fused post pass that runs as each
    batch's rows reach the host, on either path.  The bake's promotion
    and exact dedup read these instead of unpacking each row.  Without
    it no post pass runs."""
    with span("omm.plan"):
        device = check_device(device)
        subdivs = ([int(subdiv)] * len(batches) if np.isscalar(subdiv)
                   else [int(s) for s in subdiv])
        if len(subdivs) != len(batches):
            raise ValueError("one subdivision level per batch expected")

        # route: fresh items and items with some UnknownOpaque left
        routed = []
        results = []
        for items in batches:
            out = [None] * len(items)
            todo, mins = [], {}
            for i, (uv, st) in enumerate(items):
                if st is None:
                    mins[i] = UO
                    todo.append(i)
                    continue
                mn = int(st.min())
                mins[i] = mn
                if mn == UO or int(st.max()) == UO:
                    todo.append(i)
                else:
                    out[i] = st
            routed.append((items, out, todo, mins))
            results.append(out)

        by_level: dict[int, list[int]] = {}
        for bi, sd in enumerate(subdivs):
            by_level.setdefault(sd, []).append(bi)
        lgs = {}
        for sd, bis in by_level.items():
            uvs = [routed[bi][0][i][0] for bi in bis for i in routed[bi][2]]
            lgs[sd] = host._group_level(texture, uvs, sd) if uvs else 1
        fast_uvs: dict[int, list] = {sd: [] for sd in by_level}
        fast_lists, slow = [], []
        for (items, out, todo, mins), sd in zip(routed, subdivs):
            fast = []
            if todo:
                mask = host._fast_path_mask(
                    texture, cfg, np.stack([items[i][0] for i in todo]), sd,
                    lgs[sd])
                for k, i in enumerate(todo):
                    if mask[k]:
                        fast.append(i)
                    else:
                        slow.append((items, out, i, sd))
            fast_lists.append(fast)
            fast_uvs[sd].extend(items[i][0] for i in fast)
        precomps = {sd: precompute(texture, uvs, sd, lgs[sd])
                    for sd, uvs in fast_uvs.items() if uvs}

    # the threads of the module docstring: enqueue, slow items, drain,
    # discovery
    n_fast = sum(1 for f in fast_lists if f)
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    enq = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="omm-enqueue")
           if n_fast > 1 else None)
    submit = enq.submit if enq is not None else _run_now
    posts = [{} for _ in batches]
    jobs, rerun = [], []
    try:
        for (items, out, todo, mins), fast, sd, post in zip(
                routed, fast_lists, subdivs, posts):
            if fast:
                routes.count("fast_path", len(fast))
                job = _Batch(texture, cfg, items, sd, fast, out,
                             all(mins[i] == UO for i in fast), precomps[sd],
                             device, exact,
                             post=post if post_out is not None else None)
                with span("omm.submit"):
                    jobs.append((job, submit(_on_stream, stream, job)))
        if slow:
            with span("omm.slow"):
                for items, out, i, sd in slow:
                    st = items[i][1]
                    if st is None:
                        st = np.full(get_num_micro_triangles(sd), UO,
                                     np.uint8)
                    out[i] = engine.resample_fine_item(
                        texture, cfg, items[i][0], sd, st, device)
        pool = ThreadPoolExecutor(max_workers=POST_WORKERS,
                                  thread_name_prefix="omm-post")
        try:
            written = []
            for job, fut in jobs:
                with span("omm.drain"):
                    pending = fut.result()
                    rows = (None if pending is None
                            else _drain_spec(job, pending))
                    if rows is None:
                        rerun.append(job)
                    else:
                        written.append(pool.submit(job.write_back, rows))
            with span("omm.post_wait"):
                for w in written:
                    w.result()
                pool.shutdown(wait=True)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    finally:
        if enq is not None:
            enq.shutdown(wait=True, cancel_futures=True)
    if rerun:
        with span("omm.discovery"):
            for job in rerun:
                _run_batch(job)
    if post_out is not None:
        post_out.extend(posts)
    return results
