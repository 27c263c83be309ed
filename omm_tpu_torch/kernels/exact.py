"""The exact classification stage: wrapper of the hand-written CUDA
kernel, and its plain torch twin.

Replaces the JAX package's only Pallas kernel (pallas_classify
`_kernel_v3` = `derive_slot_geometry` + `_kernel_body`).  Each block of
B survivor slots shares one texel tile; for each slot the stage decodes
its flat id t*M + m, computes the micro-triangle's corner UVs by the bird
curve, derives its raster window and tile offset, runs the conservative
edge test and the level-line increments over the window's texels, and
adds the bilinear seed at corner p0.  Slots holding -1 count 0.

The TPU kernel gathers texels with one-hot matmuls; here both the kernel
and the twin read the padded plane directly.  A read outside the block's
TSA x TSA region, or past the padded plane's edge, gives 0.0, as the
one-hot select and the halo tiles' zero fill do on the TPU.

`exact_counts` takes the twin for CPU tensors.  For CUDA tensors it
launches the kernel, or raises; `exact="torch"` selects the twin there:
the GPU baker's ComputeOnly engine, and comparisons.  `exact_work` counts what the stage must do for a slot
stream, and `bound` turns that into the least time the card could take.
"""
from __future__ import annotations

import torch

from . import counts
from ..bird_torch import bary_cols, corner_cols, tri6_of
from ..host import B, TILE, wrap_origin
from ..levelline import (f32, level_line_values_kernel, tri_params)

def count_launch(n: int = 1) -> None:
    """Add n launches of the exact kernel (`counts.count`)."""
    counts.count("exact_classify", n)


def __getattr__(name):
    # LAUNCHES: the exact kernel's launches in this process (`counts`)
    if name == "LAUNCHES":
        return counts.COUNTS["exact_classify"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def derive_slot_geometry(ids, uv6, ccw, bt, *, subdiv, pad, ntx, size,
                         period=None):
    """Per-slot geometry from survivor ids and the per-item tables, in
    the fp32 operation order of pallas_classify.derive_slot_geometry.

    ids: (S,) int flat id t*M + m, -1 = empty slot.  uv6: (T, 6) fp32;
    ccw: (T,) int32 0/1 winding; bt: (S,) int tile id of each slot's
    block.  Returns (muv_rows, qn_rows, x0, y0, x1, y1, ox, oy, sdy, sdx,
    val)."""
    val = ids >= 0
    idc = torch.where(val, ids, 0).to(torch.int64)
    sv_t = idc >> (2 * subdiv)
    sv_m = idc & ((1 << (2 * subdiv)) - 1)
    tri6 = tri6_of(uv6, sv_t)
    flip = ccw[sv_t] == 0

    bu, bv, bd = bary_cols(sv_m, subdiv)
    (ax, ay), (bx2, by2), (cx, cy) = corner_cols(tri6, bu, bv, bd)
    wf = f32(float(size[0]))
    hf = f32(float(size[1]))
    qs = [(ax * wf - 0.5, ay * hf - 0.5),
          (bx2 * wf - 0.5, by2 * hf - 0.5),
          (cx * wf - 0.5, cy * hf - 0.5)]

    def fl(v):
        return torch.floor(v).to(torch.int32)

    def ce(v):
        return torch.ceil(v).to(torch.int32)

    mn, mx = torch.minimum, torch.maximum
    x0 = fl(mn(mn(qs[0][0], qs[1][0]), qs[2][0]))
    y0 = fl(mn(mn(qs[0][1], qs[1][1]), qs[2][1]))
    x1 = ce(mx(mx(qs[0][0], qs[1][0]), qs[2][0]))
    y1 = ce(mx(mx(qs[0][1], qs[1][1]), qs[2][1]))
    sx = fl(qs[0][0])
    sy = fl(qs[0][1])

    qn_rows = []
    for k in range(3):
        src = [qs[k], qs[2 - k]]
        qn_rows.append(torch.where(flip, src[1][0], src[0][0]))
        qn_rows.append(torch.where(flip, src[1][1], src[0][1]))
    muv_rows = [ax, ay, bx2, by2, cx, cy]

    btx = bt % ntx
    bty = bt // ntx
    # memory offsets only: periodic modes wrap the window origin into
    # the canonical period, the geometry keeps absolute coordinates
    x0m, y0m = wrap_origin(x0, y0, period)
    ox = (x0m + pad - btx * TILE).to(torch.int32)
    oy = (y0m + pad - bty * TILE).to(torch.int32)
    return (muv_rows, qn_rows, x0, y0, x1, y1, ox, oy, sy - y0, sx - x0,
            val)


def _chunk_state(planeP, bt, ids, uv6, ccw, *, subdiv, pad, ntx, size,
                 period, H, W):
    """Geometry, window texels and conservative mask of S slots (one
    chunk of blocks): a dict the count and work functions read."""
    (muv, qn, x0, y0, x1, y1, ox, oy, sdy, sdx, val) = derive_slot_geometry(
        ids, uv6, ccw, bt, subdiv=subdiv, pad=pad, ntx=ntx, size=size,
        period=period)
    device = planeP.device
    S = ids.shape[0]
    He, We = H + 2, W + 2
    HW = H * W
    TSA = TILE + max(He, We)
    Hp, Wp = planeP.shape

    # the slot's (He, We) window of its block's region, read directly
    ry = oy[:, None].to(torch.int64) + torch.arange(He, device=device)
    rx = ox[:, None].to(torch.int64) + torch.arange(We, device=device)
    gy = (bt // ntx)[:, None].to(torch.int64) * TILE + ry
    gx = (bt % ntx)[:, None].to(torch.int64) * TILE + rx
    ok_y = (ry >= 0) & (ry < TSA) & (gy < Hp)
    ok_x = (rx >= 0) & (rx < TSA) & (gx < Wp)
    ext = planeP[gy.clamp(0, Hp - 1)[:, :, None],
                 gx.clamp(0, Wp - 1)[:, None, :]]
    ext = torch.where(ok_y[:, :, None] & ok_x[:, None, :], ext, 0.0)

    k = torch.arange(HW, dtype=torch.int32, device=device)
    px = x0[:, None] + k % W
    py = y0[:, None] + k // W
    sxf = px.to(torch.float32)
    syf = py.to(torch.float32)
    qnx = [qn[2 * e][:, None] for e in range(3)]
    qny = [qn[2 * e + 1][:, None] for e in range(3)]
    mask = (px < x1[:, None]) & (py < y1[:, None])
    mask_edges = torch.zeros_like(px)  # edge functions the kernel evaluates
    for e in range(3):
        nx = qny[(e + 1) % 3] - qny[e]
        ny = qnx[e] - qnx[(e + 1) % 3]
        cc = -(nx * qnx[e] + ny * qny[e])
        ev = (nx * sxf + ny * syf) + cc
        bx = torch.where(nx > 0.0, 0.0, nx)
        by = torch.where(ny > 0.0, 0.0, ny)
        mask_edges = mask_edges + mask.to(torch.int32)
        mask = mask & ((ev + bx + by) < 0.0)
    return {"muv": muv, "val": val, "sdy": sdy, "sdx": sdx, "ext": ext,
            "px": px, "py": py, "mask": mask, "mask_edges": mask_edges,
            "gy": gy, "gx": gx, "ok_y": ok_y, "ok_x": ok_x}


def _quads(st, H, W):
    """The 2x2 quads (c00, c01, c11, c10) of every window texel."""
    S, HW = st["px"].shape
    ext = st["ext"]
    return (ext[:, 0:H, 0:W].reshape(S, HW),
            ext[:, 1:H + 1, 0:W].reshape(S, HW),
            ext[:, 1:H + 1, 1:W + 1].reshape(S, HW),
            ext[:, 0:H, 1:W + 1].reshape(S, HW))


def _counts_chunk(planeP, bt, ids, uv6, ccw, *, subdiv, pad, ntx, size,
                  period, H, W, rcp, alpha_cutoff):
    """(above, below) int32 (S,) for S slots (one chunk of blocks)."""
    st = _chunk_state(planeP, bt, ids, uv6, ccw, subdiv=subdiv, pad=pad,
                      ntx=ntx, size=size, period=period, H=H, W=W)
    muv, mask, val = st["muv"], st["mask"], st["val"]
    S = ids.shape[0]
    We, Ke = W + 2, (H + 2) * (W + 2)

    tp = tri_params(*[r[:, None] for r in muv])
    a_inc, b_inc = level_line_values_kernel(tp, st["px"], st["py"],
                                            *_quads(st, H, W), size, rcp,
                                            alpha_cutoff)
    above = torch.where(mask, a_inc, 0).sum(dim=1, dtype=torch.int32)
    below = torch.where(mask, b_inc, 0).sum(dim=1, dtype=torch.int32)

    # bilinear seed at corner p0
    ext_flat = st["ext"].reshape(S, Ke)
    soff = (st["sdy"] * We + st["sdx"]).to(torch.int64)

    def pick(shift):
        kk = soff + shift
        v = ext_flat.gather(1, kk.clamp(0, Ke - 1)[:, None])[:, 0]
        return torch.where((kk >= 0) & (kk < Ke), v, 0.0)

    a, b, c, d = pick(0), pick(We), pick(1), pick(We + 1)
    p0px = muv[0] * f32(float(size[0])) - 0.5
    p0py = muv[1] * f32(float(size[1])) - 0.5
    wxf = p0px - torch.floor(p0px)
    wyf = p0py - torch.floor(p0py)
    ac = a * (1.0 - wxf) + c * wxf
    bdv = b * (1.0 - wxf) + d * wxf
    seed = ac * (1.0 - wyf) + bdv * wyf
    seed_above = f32(alpha_cutoff) < seed
    above = above + seed_above.to(torch.int32)
    below = below + (~seed_above).to(torch.int32)
    return torch.where(val, above, 0), torch.where(val, below, 0)


def _chunks(nblk, H, W):
    """Block ranges that bound the plain versions' temporaries."""
    step = max(1, (1 << 22) // (B * (H + 2) * (W + 2)))
    return [(c0, min(nblk, c0 + step)) for c0 in range(0, nblk, step)]


def exact_counts_torch(planeP, block_tile, ids_slot, uv6, ccw, *, subdiv,
                       pad, ntx, size, period, H, W, rcp, alpha_cutoff):
    """Plain torch version of the exact stage: (above, below) int32
    (nblk, B), vectorized over slots and window texels, in chunks of
    blocks that bound the temporaries."""
    nblk = ids_slot.shape[0]
    above = torch.empty((nblk, B), dtype=torch.int32, device=ids_slot.device)
    below = torch.empty_like(above)
    for c0, c1 in _chunks(nblk, H, W):
        a, b = _counts_chunk(
            planeP, block_tile[c0:c1, None].expand(c1 - c0, B).reshape(-1),
            ids_slot[c0:c1].reshape(-1), uv6, ccw, subdiv=subdiv, pad=pad,
            ntx=ntx, size=size, period=period, H=H, W=W, rcp=rcp,
            alpha_cutoff=alpha_cutoff)
        above[c0:c1] = a.reshape(-1, B)
        below[c0:c1] = b.reshape(-1, B)
    return above, below


#: operations charged per unit of work, read off the kernel's source
#: (csrc/exact_math.cuh): fp32 and integer operations alike, an IEEE
#: division or square root as one operation
OPS = {
    "slots": 170,         # id decode, bird curve, corners, window, edges, seed
    "window_texels": 8,   # pair index, texel position, window bounds
    "mask_edges": 7,      # one conservative edge function and its test
    "covered": 100,       # 4 point-in-triangle tests, 4 opacity compares
    "level_line": 12,     # quad terms and the flat-quad test
    "edge_tests": 60,     # endpoints, edge length, slope, a point test
    "roots": 50,          # the hyperbola's sqrt, two roots, a point test
}
#: NVIDIA H100 SXM peaks (data sheet): fp32 outside the tensor cores,
#: and HBM3 bandwidth
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12


def exact_work(planeP, block_tile, ids_slot, uv6, ccw, *, subdiv, pad,
               ntx, size, period, H, W, rcp, alpha_cutoff):
    """What the exact stage must do for this slot stream, counted by a
    plain torch pass beside the twin.

    Returns a dict: slots (non-empty), window_texels (H*W per slot),
    mask_edges (conservative edge functions evaluated, each test
    stopping at the first failed edge), covered (texels in the mask),
    level_line (covered texels past the extremum and flat-quad tests),
    edge_tests (edge tests they run up to the first hit), hyperbola
    (of those, tests taking the hyperbola branch), roots (hyperbola
    tests with real roots), texels_read (distinct plane texels in the
    slots' windows); ops (the counts weighted by OPS) and bytes (each
    input read once: ids, tiles, item tables and texels_read plane
    values; each output written once)."""
    keys = ("slots", "window_texels", "mask_edges", "covered", "level_line",
            "edge_tests", "hyperbola", "roots")
    out = dict.fromkeys(keys, 0)
    nblk = ids_slot.shape[0]
    need = torch.zeros(planeP.shape, dtype=torch.bool, device=planeP.device)
    for c0, c1 in _chunks(nblk, H, W):
        bt = block_tile[c0:c1, None].expand(c1 - c0, B).reshape(-1)
        st = _chunk_state(planeP, bt, ids_slot[c0:c1].reshape(-1), uv6, ccw,
                          subdiv=subdiv, pad=pad, ntx=ntx, size=size,
                          period=period, H=H, W=W)
        val, mask = st["val"], st["mask"]
        mask = mask & val[:, None]
        work = {}
        level_line_values_kernel(tri_params(*[r[:, None] for r in st["muv"]]),
                                 st["px"], st["py"], *_quads(st, H, W), size,
                                 rcp, alpha_cutoff, work=work)
        nval = int(val.sum())
        out["slots"] += nval
        out["window_texels"] += nval * H * W
        out["mask_edges"] += int(st["mask_edges"][val].sum())
        out["covered"] += int(mask.sum())
        out["level_line"] += int((work["level_line"] & mask).sum())
        for k in ("edge_tests", "hyperbola", "roots"):
            w = work["edges" if k == "edge_tests" else k]
            out[k] += int(torch.where(mask, w, 0).sum())
        sel = (val[:, None, None] & st["ok_y"][:, :, None]
               & st["ok_x"][:, None, :])
        yy = st["gy"][:, :, None].expand(sel.shape)[sel]
        xx = st["gx"][:, None, :].expand(sel.shape)[sel]
        need[yy, xx] = True
    out["texels_read"] = int(need.sum())
    out["ops"] = sum(OPS[k] * out[k] for k in OPS)
    out["bytes"] = (ids_slot.numel() * 4 + block_tile.numel() * 4
                    + uv6.numel() * 4 + ccw.numel() * 4
                    + out["texels_read"] * 4 + 2 * ids_slot.numel() * 4)
    return out


def bound(work: dict):
    """(ms, "operations" or "bytes"): the least time the card could take
    for `work` (exact_work's dict) at its peak rates, and what binds."""
    t_ops = work["ops"] / PEAK_OPS
    t_bytes = work["bytes"] / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check(planeP, block_tile, ids_slot, uv6, ccw, H, W):
    dev = planeP.device
    want = [(planeP, torch.float32, 2), (block_tile, torch.int32, 1),
            (ids_slot, torch.int32, 2), (uv6, torch.float32, 2),
            (ccw, torch.int32, 1)]
    for name, (t, dt, nd) in zip(
            ("planeP", "block_tile", "ids_slot", "uv6", "ccw"), want):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, planeP on {dev}")
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d {dt} tensor, got "
                             f"{t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nblk = ids_slot.shape[0]
    if ids_slot.shape[1] != B or block_tile.shape[0] != nblk:
        raise ValueError(f"ids_slot must be (nblk, {B}) and block_tile "
                         "(nblk,)")
    if uv6.shape[1] != 6 or ccw.shape[0] != uv6.shape[0]:
        raise ValueError("uv6 must be (T, 6) and ccw (T,)")
    if TILE + max(H, W) + 2 > 2 * TILE:
        raise ValueError(f"window {H}x{W} exceeds the exact stage's tile")


def exact_counts(planeP, block_tile, ids_slot, uv6, ccw, *, subdiv, pad,
                 ntx, size, period, H, W, rcp, alpha_cutoff, exact=None):
    """Exact-stage (above, below) int32 (nblk, B) counts.

    planeP: padded plane (Hp, Wp) fp32; block_tile: (nblk,) int32 tile id
    of each block; ids_slot: (nblk, B) int32 survivor ids (-1 = empty);
    uv6: (T, 6) fp32 item UVs; ccw: (T,) int32 0/1 winding.
    CPU tensors run the plain twin.  CUDA tensors launch the kernel, or
    the twin when exact="torch"."""
    if exact not in (None, "torch"):
        raise ValueError(f"exact must be None or 'torch', got {exact!r}")
    _check(planeP, block_tile, ids_slot, uv6, ccw, H, W)
    kw = dict(subdiv=subdiv, pad=pad, ntx=ntx, size=size, period=period,
              H=H, W=W, rcp=rcp, alpha_cutoff=alpha_cutoff)
    args = (planeP, block_tile, ids_slot, uv6, ccw)
    dev = planeP.device
    if dev.type == "cpu" or exact == "torch":
        return exact_counts_torch(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no exact stage for device {dev}")

    from .build import cuda_library
    nblk = ids_slot.shape[0]
    above = torch.empty((nblk, B), dtype=torch.int32, device=dev)
    below = torch.empty_like(above)
    if nblk == 0:
        return above, below
    launch(cuda_library(), planeP, block_tile, ids_slot, uv6, ccw, above,
           below, **kw)
    count_launch()
    return above, below


def launch(lib, planeP, block_tile, ids_slot, uv6, ccw, above, below, *,
           subdiv, pad, ntx, size, period, H, W, rcp, alpha_cutoff):
    """Launch `lib`'s omm_exact_classify on checked CUDA tensors (the
    wrapper's launch, also used to time another build of the kernel
    with the same interface); raises if the launch fails."""
    Pw, Ph = period if period is not None else (0, 0)
    Hp, Wp = planeP.shape
    dev = planeP.device
    with torch.cuda.device(dev):
        rc = lib.omm_exact_classify(
            planeP.data_ptr(), Hp, Wp, block_tile.data_ptr(),
            ids_slot.data_ptr(), ids_slot.shape[0], uv6.data_ptr(),
            ccw.data_ptr(), subdiv, pad, ntx, size[0], size[1], Pw, Ph, H, W,
            f32(rcp[0]), f32(rcp[1]), f32(alpha_cutoff), above.data_ptr(),
            below.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.omm_exact_error_string(rc).decode()
        raise RuntimeError(f"exact_classify launch failed: {msg} ({rc})")


def shape(H: int, W: int) -> dict:
    """The kernel's launch shape at window H x W on the current card:
    threads and resident blocks per SM, dynamic shared memory bytes."""
    import ctypes
    from .build import cuda_library
    vals = [ctypes.c_int() for _ in range(3)]
    rc = cuda_library().omm_exact_shape(H, W, *[ctypes.byref(v)
                                                for v in vals])
    if rc != 0:
        raise RuntimeError(f"omm_exact_shape failed ({rc})")
    return dict(zip(("threads", "blocks_per_sm", "smem_bytes"),
                    (v.value for v in vals)))
