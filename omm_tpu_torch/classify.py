"""Fine classification off the two-phase engine's fast path, in torch.

Counterpart of `omm_tpu.kernels.jax_classify`: the dense level-line
pass over all 4^N micro-triangles of an item (`classify_item`), its
sliver hand-off to the survivors pass (`classify_work_item`), the
level-line pass over the micro-triangles still UnknownOpaque
(`classify_linear_survivors_batch`), the nearest-filter pass
(`classify_nearest_survivors_batch`) and the line-triangle pass with its
host DDA schedule (`classify_degenerate`).  Every function takes the
torch device it runs on.

The host does what the JAX package's host does: survivor compaction,
the bird-curve corners (`bird.micro_triangle_uvs`), the float64 winding
per micro-triangle (`geom.is_ccw`), the window bounds and the DDA cell
walks.  The device evaluates each micro-triangle's (H, W) texel window
densely, in the fp32 operation order of the JAX programs; the texels
outside a triangle's own window are masked out of its counts, so any H
and W at least as large give the same counts.  The JAX package buckets
H, W and the row count to powers of two to bound its jit signatures;
here they are exact, and rows go in blocks of at most BLOCK_TEXELS
(micro-triangle, texel) pairs, which bounds the eager temporaries and
never changes a count.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bird, geom, routes
from .levelline import (conservative_raster_mask, f32,
                        get_state_from_coverage, level_line_texel_kernel,
                        make_tri_params)
from .planes import check_device, tex_cache
from .raster import conservative_line_cells_batch
from .spans import span
from .texture_torch import bilinear, get_tex_coord, load
from .types import OpacityState, TextureAddressMode, get_num_micro_triangles

UO = int(OpacityState.UnknownOpaque)
UT = int(OpacityState.UnknownTransparent)

#: (micro-triangle, window texel) pairs per block of rows
BLOCK_TEXELS = 1 << 21


def tex_planes(texture, device) -> tuple:
    """The texture's fp32 mip planes on `device`, cached in
    `planes.tex_cache` (jax_classify._dev_planes)."""
    c = tex_cache(texture, device)
    t = c.get("raw_planes")
    if t is None:
        t = c["raw_planes"] = tuple(
            torch.from_numpy(texture.load_plane(m)).to(device)
            for m in range(texture.mip_count))
    return t


def border_alpha_of(cfg):
    """border_alpha where the address mode reads it, else None."""
    return (cfg.border_alpha if cfg.addr_mode == TextureAddressMode.Border
            else None)


def window_hw(texture, muvs: np.ndarray, offset: float) -> list:
    """Per mip, the (W, H) texel window that holds every micro-triangle
    of muvs ((S, 3, 2) fp32): max of ceil(max q) - floor(min q) with
    q = muv * size + offset, on the host."""
    out = []
    for mip in range(texture.mip_count):
        rf = np.array(texture.size(mip), dtype=np.float32)
        q = muvs * rf + np.float32(offset) if offset else muvs * rf
        amin = q.min(axis=-2)
        amax = q.max(axis=-2)
        W = int(np.max(np.ceil(amax[:, 0]).astype(np.int64)
                       - np.floor(amin[:, 0]).astype(np.int64)))
        H = int(np.max(np.ceil(amax[:, 1]).astype(np.int64)
                       - np.floor(amin[:, 1]).astype(np.int64)))
        out.append((max(W, 1), max(H, 1)))
    return out


def window_bounds(texture, uv_tri: np.ndarray, subdiv: int) -> tuple:
    """Per-mip (W, H) texel window bounds of an item's micro-triangles
    (jax_classify._window_bounds, unbucketed)."""
    muvs = bird.micro_triangle_uvs(
        uv_tri, np.arange(get_num_micro_triangles(subdiv), dtype=np.uint32),
        subdiv)
    return tuple(window_hw(texture, muvs, -0.5))


def row_blocks(S: int, texels: int):
    step = max(1, BLOCK_TEXELS // max(1, texels))
    return [(lo, min(S, lo + step)) for lo in range(0, S, step)]


def raster_window(muv, ccw, info, offset, W, H):
    """Texel window of each micro-triangle: x (S, 1, W) and y (S, H, 1)
    int32 texel coordinates from floor(min q), and the (S, H, W) mask of
    in-bounds texels that pass the conservative raster test; q = muv *
    size + offset, CCW-normalized by the host winding ccw (S,) bool."""
    w, h = info.size
    rf = torch.tensor([float(w), float(h)], dtype=torch.float32,
                      device=muv.device)
    q = muv * rf
    if offset:
        q = q + f32(offset)
    qn = torch.where(ccw[:, None, None], q, q.flip(1))
    amin = qn.amin(dim=1)
    amax = qn.amax(dim=1)
    ix0 = torch.floor(amin[:, 0]).to(torch.int32)
    iy0 = torch.floor(amin[:, 1]).to(torch.int32)
    ix1 = torch.ceil(amax[:, 0]).to(torch.int32)
    iy1 = torch.ceil(amax[:, 1]).to(torch.int32)
    dev = muv.device
    x = ix0[:, None, None] + torch.arange(W, dtype=torch.int32,
                                          device=dev)[None, None, :]
    y = iy0[:, None, None] + torch.arange(H, dtype=torch.int32,
                                          device=dev)[None, :, None]
    inb = (x < ix1[:, None, None]) & (y < iy1[:, None, None])
    return x, y, inb & conservative_raster_mask(qn, x, y)


def sum_hw(v):
    return v.sum(dim=(-1, -2), dtype=torch.int32)


def linear_counts(plane, info, cfg, muv, ccw, W, H):
    """One mip of the level-line pass: (above, below) int32 (S,) with the
    bilinear seed at corner p0 (_classify_item's block, _classify_linear,
    engine._linear_mip_pass)."""
    seed = bilinear(plane, cfg.addr_mode, muv[:, 0, 0], muv[:, 0, 1], info)
    seed_above = (f32(cfg.alpha_cutoff) < seed).to(torch.int32)
    x, y, mask = raster_window(muv, ccw, info, -0.5, W, H)
    a_inc, b_inc = level_line_texel_kernel(
        make_tri_params(muv), x, y, plane, info, cfg.addr_mode,
        cfg.alpha_cutoff, cfg.border_alpha)
    return (sum_hw(torch.where(mask, a_inc, 0)) + seed_above,
            sum_hw(torch.where(mask, b_inc, 0)) + (1 - seed_above))


def nearest_counts(plane, info, cfg, muv, ccw, W, H):
    """One mip of the nearest-filter pass (bake_cpu_impl.cpp:969-1022):
    the zero-offset window, one texel per covered cell, no seed
    (_classify_nearest, engine._nearest_mip_pass)."""
    x, y, mask = raster_window(muv, ccw, info, 0.0, W, H)
    cx, cy = get_tex_coord(cfg.addr_mode, x, y, info)
    alpha = load(plane, cx, cy, border_alpha_of(cfg))
    above_t = f32(cfg.alpha_cutoff) < alpha
    return sum_hw(mask & above_t), sum_hw(mask & ~above_t)


def accumulate(texture, cfg, S: int, device, counts):
    """(above, below) int32 (S,) over all mips, with the reference's
    early-unknown exit: a micro-triangle whose state turns unknown stops
    counting (bake_cpu_impl.cpp per-mip loop).  counts(mip) gives one
    mip's counts."""
    above = torch.zeros(S, dtype=torch.int32, device=device)
    below = torch.zeros(S, dtype=torch.int32, device=device)
    alive = torch.ones(S, dtype=torch.bool, device=device)
    for mip in range(texture.mip_count):
        a, b = counts(mip)
        above = above + torch.where(alive, a, 0)
        below = below + torch.where(alive, b, 0)
        if texture.mip_count > 1:
            st = states_of(cfg, above, below)
            alive = alive & ~((st == UO) | (st == UT))
    return above, below


def states_of(cfg, above, below):
    return get_state_from_coverage(cfg.fmt, cfg.promotion, cfg.cutoff_gt,
                                   cfg.cutoff_le, above, below)


def micro_pass(texture, cfg, muvs: np.ndarray, ccw: np.ndarray, device,
               counts_fn, offset):
    """(above, below) of micro-triangles muvs ((S, 3, 2) fp32, host
    winding ccw) over all mips, through counts_fn (linear_counts or
    nearest_counts) in blocks of rows."""
    S = muvs.shape[0]
    planes = tex_planes(texture, device)
    win = window_hw(texture, muvs, offset)
    muv_t = torch.from_numpy(np.ascontiguousarray(muvs, np.float32)).to(
        device)
    ccw_t = torch.from_numpy(np.asarray(ccw, bool)).to(device)

    def counts(mip):
        W, H = win[mip]
        parts = [counts_fn(planes[mip], texture.info[mip], cfg,
                           muv_t[lo:hi], ccw_t[lo:hi], W, H)
                 for lo, hi in row_blocks(S, W * H)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    return accumulate(texture, cfg, S, device, counts)


def final_states(cfg, above, below) -> np.ndarray:
    return states_of(cfg, above, below).to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------------------
# linear filter: dense pass, work item, survivors
# ---------------------------------------------------------------------------

def classify_item(texture, cfg, uv_tri: np.ndarray, subdiv: int,
                  device="cuda"):
    """Level-line pass over all 4^subdiv micro-triangles of one item, all
    mips (jax_classify._classify_item): (above, below) int32 (M,) on
    `device`.  Uses the item's winding for every micro-triangle, which
    `classify_work_item` only does for winding-stable items."""
    device = check_device(device)
    M = get_num_micro_triangles(subdiv)
    muvs = bird.micro_triangle_uvs(uv_tri, np.arange(M, dtype=np.uint32),
                                   subdiv)
    ccw = np.full(M, bool(geom.is_ccw(uv_tri)))
    return micro_pass(texture, cfg, muvs, ccw, device, linear_counts, -0.5)


def classify_work_item(texture, cfg, uv_tri: np.ndarray, subdiv: int,
                       states: np.ndarray, device="cuda") -> np.ndarray:
    """Fine pass of one linear-filter, non-degenerate item
    (classify_work_item_jax): updated states.  Winding-unstable slivers
    go to the survivors pass, whose winding is per micro-triangle."""
    device = check_device(device)
    active = states == UO
    if not active.any():
        return states
    if not bool(geom.winding_stable(uv_tri, subdiv)):
        return classify_linear_survivors(texture, cfg, uv_tri, subdiv,
                                         states, device)
    routes.count("dense")
    with span("omm.dense"):
        above, below = classify_item(texture, cfg, uv_tri, subdiv, device)
        final = final_states(cfg, above, below)
    out = states.copy()
    out[active] = final[active]
    return out


def classify_linear_survivors_batch(texture, cfg, work, subdiv: int,
                                    device="cuda") -> list:
    """Level-line pass over the micro-triangles still UnknownOpaque of
    every item of `work` ((uv_tri, states) pairs), as one stream
    (classify_linear_survivors_batch): the new state list.  An item with
    nothing resolved yet goes to the dense pass when its winding is
    stable (the JAX package's bounce); a sliver never does.  Profiler
    label omm.linear_survivors (a bounced item's omm.dense inside it)."""
    device = check_device(device)
    with span("omm.linear_survivors"):
        return _linear_survivors(texture, cfg, work, subdiv, device)


def _linear_survivors(texture, cfg, work, subdiv, device):
    outs, seg_muvs, owners = [], [], []
    for i, (uv_tri, states) in enumerate(work):
        sel = np.flatnonzero(states == UO)
        if sel.size == 0:
            outs.append(states)
            continue
        if sel.size >= states.shape[0] \
                and bool(geom.winding_stable(uv_tri, subdiv)):
            outs.append(classify_work_item(texture, cfg, uv_tri, subdiv,
                                           states, device))
            continue
        routes.count("linear_survivors")
        outs.append(states.copy())
        seg_muvs.append(bird.micro_triangle_uvs(
            uv_tri, sel.astype(np.uint32), subdiv))
        owners.append((i, sel))
    if not seg_muvs:
        return outs
    muvs = np.concatenate(seg_muvs)
    # float64 winding per micro-triangle, the oracle's (the macro
    # triangle's can disagree on fp32-thin slivers)
    above, below = micro_pass(texture, cfg, muvs, geom.is_ccw(muvs), device,
                              linear_counts, -0.5)
    flat = final_states(cfg, above, below)
    o = 0
    for i, sel in owners:
        outs[i][sel] = flat[o:o + sel.size]
        o += sel.size
    return outs


def classify_linear_survivors(texture, cfg, uv_tri, subdiv, states,
                              device="cuda") -> np.ndarray:
    """Single-item form of classify_linear_survivors_batch."""
    return classify_linear_survivors_batch(
        texture, cfg, [(uv_tri, states)], subdiv, device)[0]


# ---------------------------------------------------------------------------
# nearest filter
# ---------------------------------------------------------------------------

def nearest_states(texture, cfg, muvs: np.ndarray, device) -> np.ndarray:
    """Final uint8 states of micro-triangles muvs ((S, 3, 2) fp32) under
    the nearest filter, all mips."""
    above, below = micro_pass(texture, cfg, muvs, geom.is_ccw(muvs), device,
                              nearest_counts, 0.0)
    return final_states(cfg, above, below)


def classify_nearest_survivors_batch(texture, cfg, work, subdiv: int,
                                     device="cuda") -> list:
    """Nearest-filter pass over the micro-triangles still UnknownOpaque
    (the contour left by twophase.resolve_nearest_phase1) of every item
    of `work`, as one stream: the new state list
    (jax_classify.classify_nearest_survivors, item by item there).
    Profiler label omm.nearest_survivors."""
    device = check_device(device)
    with span("omm.nearest_survivors"):
        return _nearest_survivors(texture, cfg, work, subdiv, device)


def _nearest_survivors(texture, cfg, work, subdiv, device):
    outs, seg_muvs, owners = [], [], []
    for i, (uv_tri, states) in enumerate(work):
        sel = np.flatnonzero(states == UO)
        if sel.size == 0:
            outs.append(states)
            continue
        outs.append(states.copy())
        routes.count("nearest_survivors")
        routes.count("nearest_survivors_utri", sel.size)
        seg_muvs.append(bird.micro_triangle_uvs(
            uv_tri, sel.astype(np.uint32), subdiv))
        owners.append((i, sel))
    if not seg_muvs:
        return outs
    flat = nearest_states(texture, cfg, np.concatenate(seg_muvs), device)
    o = 0
    for i, sel in owners:
        outs[i][sel] = flat[o:o + sel.size]
        o += sel.size
    return outs


def classify_nearest_survivors(texture, cfg, uv_tri, subdiv, states,
                               device="cuda") -> np.ndarray:
    """Single-item form of classify_nearest_survivors_batch."""
    return classify_nearest_survivors_batch(
        texture, cfg, [(uv_tri, states)], subdiv, device)[0]


# ---------------------------------------------------------------------------
# degenerate (line) triangles
# ---------------------------------------------------------------------------

def degenerate_counts(plane, info, cfg, muv, aabb_s, aabb_e, x, y, m):
    """One mip of the line-triangle pass over (S, K) DDA cells x, y with
    mask m: (above, below) int32 (S,) with the bilinear seed
    (_classify_degenerate, engine._degenerate_mip_pass)."""
    seed = bilinear(plane, cfg.addr_mode, muv[:, 0, 0], muv[:, 0, 1], info)
    sa = (f32(cfg.alpha_cutoff) < seed).to(torch.int32)
    a_inc, b_inc = level_line_texel_kernel(
        None, x[:, :, None], y[:, :, None], plane, info, cfg.addr_mode,
        cfg.alpha_cutoff, cfg.border_alpha, degenerate=True, aabb_s=aabb_s,
        aabb_e=aabb_e)
    m3 = m[:, :, None]
    return (sum_hw(torch.where(m3, a_inc, 0)) + sa,
            sum_hw(torch.where(m3, b_inc, 0)) + (1 - sa))


def classify_degenerate(texture, cfg, uv_tri: np.ndarray, subdiv: int,
                        states: np.ndarray, device="cuda") -> np.ndarray:
    """Fine pass of a degenerate (line) item (classify_degenerate_device):
    the conservative DDA walk of each micro-triangle's AABB diagonal runs
    on the host (raster.py), the level-line kernel's degenerate branch
    and the seed on `device`."""
    device = check_device(device)
    sel = np.flatnonzero(states == UO)
    if sel.size == 0:
        return states
    routes.count("degenerate")
    with span("omm.degenerate"):
        return _degenerate_pass(texture, cfg, uv_tri, subdiv, states, sel,
                                device)


def _degenerate_pass(texture, cfg, uv_tri, subdiv, states, sel, device):
    muvs = bird.micro_triangle_uvs(uv_tri, sel.astype(np.uint32), subdiv)
    aabb_s, aabb_e = geom.tri_aabb(muvs)
    S = sel.size
    # the host's DDA schedule per mip: (S, K) cells, zero-padded, masked
    cells = [conservative_line_cells_batch(aabb_s, aabb_e, texture.size(m),
                                           (-0.5, -0.5))
             for m in range(texture.mip_count)]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    planes = tex_planes(texture, device)
    muv_t, s_t, e_t = up(muvs), up(aabb_s), up(aabb_e)

    def counts(mip):
        x, y, m = (up(a) for a in cells[mip])
        parts = [degenerate_counts(planes[mip], texture.info[mip], cfg,
                                   muv_t[lo:hi], s_t[lo:hi], e_t[lo:hi],
                                   x[lo:hi], y[lo:hi], m[lo:hi])
                 for lo, hi in row_blocks(S, x.shape[1])]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    above, below = accumulate(texture, cfg, S, device, counts)
    out = states.copy()
    out[sel] = final_states(cfg, above, below)
    return out
