"""Multi-device bake: an axis of the work split over a device mesh.

Counterpart of `omm_tpu/parallel/shard.py`.  There a jax `Mesh` and
`shard_map` split the work-item, micro-triangle or bird-group axis over
the chips and `psum` merges the histograms.  Here a mesh is a tuple of
torch devices, one per slot; a device may appear more than once (two
slots on one card are two threads on its current stream).  Slot k takes
the k-th contiguous slice of the axis and runs it on its own device in
a worker thread of its own, inside `torch.cuda.device` on a card; the
host concatenates the slices and sums the histograms.  A failure in any
slot raises from the call.

`sharded_classify_batch` runs the full two-phase engine per slot
(`batch.classify_work_items_batches`: descent, exact stage, packing), so
on a card its exact stage is the CUDA kernel.  `classify_item_sharded`,
`sharded_bake_step` and `sharded_group_resolve` are the plain level-line
and window-resolve blocks as torch ops.
"""
from __future__ import annotations

import concurrent.futures as cf
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .. import bird, geom, host
from ..bake import level_chunks
from ..batch import classify_work_items_batches
from ..bird_torch import bary_cols
from ..classify import linear_counts, row_blocks
from ..levelline import get_state_from_coverage
from ..planes import check_device
from ..texture import MipInfo
from ..kernels.chain import window_origin
from ..twophase import PackedStates
from ..types import OpacityState, get_num_micro_triangles

OMM_AXIS = "omm"
UO = int(OpacityState.UnknownOpaque)


@dataclass(frozen=True)
class DeviceMesh:
    """The slots of a mesh: one torch device each, in slot order."""

    devices: tuple
    axis: str = OMM_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = OMM_AXIS) -> DeviceMesh:
    """A mesh of `devices` (torch devices or their names; one slot each,
    repeats allowed), by default every CUDA device; asking for a card
    where there is none raises."""
    if devices is None:
        check_device("cuda")
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devs = tuple(check_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(devs, axis)


def _slices(n: int, mesh: DeviceMesh) -> list:
    """The contiguous (lo, hi) slice of an axis of n for each slot."""
    k = mesh.size
    return [(s * n // k, (s + 1) * n // k) for s in range(k)]


def _map_slots(mesh: DeviceMesh, fn, n: int) -> list:
    """fn(device, lo, hi) for every slot's slice of an axis of n, each in
    a worker thread of its own; the results in slot order.  Every slot
    runs to its end; then the first failure, in slot order, raises."""
    def run(dev, lo, hi):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(dev, lo, hi)
        return fn(dev, lo, hi)

    with cf.ThreadPoolExecutor(max_workers=mesh.size) as pool:
        futs = [pool.submit(run, dev, lo, hi)
                for dev, (lo, hi) in zip(mesh.devices, _slices(n, mesh))]
    for f in futs:
        if f.exception() is not None:
            raise f.exception()
    return [f.result() for f in futs]


def _mip_info(size, size_log2, is_pow2, rcp) -> MipInfo:
    return MipInfo(size=tuple(int(v) for v in size),
                   size_log2=tuple(int(v) for v in size_log2),
                   rcp_size=np.array(rcp, np.float32), is_pow2=bool(is_pow2))


def _level_line_states(plane, muvs, ccw, dev, *, info, W, H, addr_mode,
                       alpha_cutoff, border_alpha, fmt, promotion, cutoff_gt,
                       cutoff_le):
    """States (S,) int32 on `dev` of micro-triangles muvs ((S, 3, 2) fp32)
    of one mip: the level-line block of the JAX function
    (`classify.linear_counts`: bilinear seed at p0, the -0.5 window, the
    conservative mask) in blocks of rows, with winding ccw (S,) bool."""
    cfg = SimpleNamespace(addr_mode=addr_mode, alpha_cutoff=alpha_cutoff,
                          border_alpha=border_alpha)
    plane = torch.as_tensor(plane, dtype=torch.float32).to(dev)
    muv = torch.from_numpy(np.ascontiguousarray(muvs, np.float32)).to(dev)
    ccw = torch.from_numpy(np.asarray(ccw, bool)).to(dev)
    parts = [linear_counts(plane, info, cfg, muv[lo:hi], ccw[lo:hi], W, H)
             for lo, hi in row_blocks(muv.shape[0], W * H)]
    above = torch.cat([p[0] for p in parts])
    below = torch.cat([p[1] for p in parts])
    return get_state_from_coverage(fmt, promotion, cutoff_gt, cutoff_le,
                                   above, below)


def _hist(states) -> np.ndarray:
    return torch.bincount(states.reshape(-1).to(torch.int64),
                          minlength=4)[:4].to(torch.int32).cpu().numpy()


def classify_item_sharded(mesh: DeviceMesh, plane, uv_tri, ccw: bool, *,
                          subdiv, **kw):
    """Classify one work item with the micro-triangle axis split over the
    mesh: `sharded_bake_step` of the one item, with its keywords (size,
    size_log2, is_pow2, rcp, W, H, addr_mode, alpha_cutoff,
    border_alpha, fmt, promotion, cutoff_gt, cutoff_le).  Returns
    (states (M,) int32, histogram (4,) int32), numpy arrays."""
    assert get_num_micro_triangles(subdiv) % mesh.size == 0, \
        "4^N must divide the mesh size"
    states, hist = sharded_bake_step(mesh, plane, np.asarray(uv_tri)[None],
                                     [ccw], subdiv=subdiv, **kw)
    return states[0], hist


def sharded_bake_step(mesh: DeviceMesh, plane, uv_tris, ccws, *, subdiv,
                      size, size_log2, is_pow2, rcp, W, H, addr_mode,
                      alpha_cutoff, border_alpha, fmt, promotion, cutoff_gt,
                      cutoff_le):
    """Several work items (T, 3, 2) with the micro-triangle axis split
    over the mesh: each slot takes the bird-curve corners of its index
    slice of every item and runs the level-line block on its device.
    plane: the mip's fp32 (h, w) texels (array or tensor); ccws: each
    item's winding.  Returns (states (T, M) int32, histogram (4,)
    int32), numpy arrays."""
    M = get_num_micro_triangles(subdiv)
    assert M % mesh.size == 0
    kw = dict(info=_mip_info(size, size_log2, is_pow2, rcp), W=W, H=H,
              addr_mode=addr_mode, alpha_cutoff=alpha_cutoff,
              border_alpha=border_alpha, fmt=fmt, promotion=promotion,
              cutoff_gt=cutoff_gt, cutoff_le=cutoff_le)
    uv_tris = np.asarray(uv_tris, np.float32)
    ccws = np.asarray(ccws, bool)
    T = uv_tris.shape[0]

    def slot(dev, lo, hi):
        muvs = bird.micro_triangle_uvs(
            uv_tris[:, None], np.arange(lo, hi, dtype=np.uint32), subdiv)
        st = _level_line_states(plane, muvs.reshape(-1, 3, 2),
                                np.repeat(ccws, hi - lo), dev, **kw)
        return st.reshape(T, hi - lo).cpu().numpy(), _hist(st)

    outs = _map_slots(mesh, slot, M)
    return (np.concatenate([o[0] for o in outs], axis=1),
            np.sum([o[1] for o in outs], axis=0, dtype=np.int32))


def classify_slices(mesh: DeviceMesh, texture, cfg, uvs, subdiv: int):
    """Fresh fast-path work items of one level (their (3, 2) UVs) with
    the work-item axis split over the mesh: slot k classifies its slice
    through `classify_work_items_batches` on its device, in the bake's
    batches (`bake.level_chunks`).  Returns each item's result as the
    engine gives it (PackedStates)."""
    def slot(dev, lo, hi):
        chunks = level_chunks(list(range(lo, hi)), subdiv)
        outs = classify_work_items_batches(
            texture, cfg, [[(uvs[i], None) for i in c] for c in chunks],
            subdiv, device=dev)
        return [st for out in outs for st in out]

    return [st for out in _map_slots(mesh, slot, len(uvs)) for st in out]


def sharded_classify_batch(mesh: DeviceMesh, texture, cfg, items,
                           subdiv: int):
    """The full two-phase pipeline with the WORK-ITEM axis split over the
    mesh: slot k classifies items[k*T/n:(k+1)*T/n] on its device
    (`classify_slices`).  Every stage is item-local, so each item's
    states equal the single-device engine's.

    items: (uv_tri, states or None) pairs.  Requirements, as in the JAX
    function (ValueError otherwise): len(items) divisible by the mesh
    size; every item fresh (all UnknownOpaque; None counts as fresh),
    fast-path eligible under the whole batch's group level, and
    winding-stable.  Returns (list of per-item (M,) uint8 state arrays,
    histogram (4,) int32).  The fast path needs subdiv >= 2, so 4 divides
    M and the histogram equals the JAX one over the packed 2-bit rows."""
    n_dev = mesh.size
    T = len(items)
    if T % n_dev != 0:
        raise ValueError(f"item count {T} not divisible by mesh {n_dev}")
    lg = host._group_level(texture, [uv for uv, _ in items], subdiv)
    for uv, st in items:
        if st is not None and not (st == UO).all():
            raise ValueError("sharded_classify_batch requires fresh items")
        if not host._fast_path_ok(texture, cfg, uv, subdiv, lg):
            raise ValueError("item not fast-path eligible")
        if not bool(geom.winding_stable(uv, subdiv)):
            # stage C normalizes with the macro winding; slivers take the
            # host path
            raise ValueError("item winding-unstable for the fast path")
    outs = classify_slices(mesh, texture, cfg, [uv for uv, _ in items],
                           subdiv)
    out = [st.unpack() if isinstance(st, PackedStates) else st
           for st in outs]
    hist = np.zeros(4, np.int32)
    for st in out:
        hist += np.bincount(st, minlength=4)[:4].astype(np.int32)
    return out, hist


def _clamped(idx, n: int):
    """Gather indices as jax.numpy takes them: negative ones count from
    the end, then every index clamps into [0, n)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def sharded_group_resolve(mesh: DeviceMesh, cls_plane, uv_tris, *, subdiv,
                          lg, pad, size):
    """Hierarchical phase-1 group resolve with the bird-curve GROUP axis
    split over the mesh: each slot tests its slice of subtriangle windows
    against the class plane (one int8 lookup per group).  Returns (side
    (T, NG) int8, counts (3,) int32: [above, below, mixed]), numpy
    arrays."""
    NG = 4 ** lg
    assert NG % mesh.size == 0, "4^lg must divide the mesh size"
    w, h = size
    uv_flat = np.ascontiguousarray(np.asarray(uv_tris, np.float32)
                                   .reshape(-1, 6))

    def slot(dev, lo, hi):
        cls = torch.as_tensor(np.array(cls_plane, np.int8)).to(dev)
        bu, bv, bd = bary_cols(torch.arange(lo, hi, device=dev), lg)
        uv = torch.from_numpy(uv_flat).to(dev)
        tri6 = tuple(uv[:, k:k + 1] for k in range(6))
        x0, y0 = window_origin(tri6, bu[None, :], bv[None, :], bd[None, :],
                               w, h)
        side = cls[_clamped(y0 - 1 + pad, cls.shape[0]),
                   _clamped(x0 - 1 + pad, cls.shape[1])]
        counts = torch.stack([(side == v).sum() for v in (1, -1, 0)])
        return side.cpu().numpy(), counts.to(torch.int32).cpu().numpy()

    outs = _map_slots(mesh, slot, NG)
    return (np.concatenate([o[0] for o in outs], axis=1),
            np.sum([o[1] for o in outs], axis=0, dtype=np.int32))
