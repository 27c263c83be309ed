"""Resample engine: the coarse SAT pass, the configuration it reads, and
the fine pass of the routes no device program of the JAX package takes.

`ResampleConfig` and `resample_coarse_item` are the port's copies from
`omm_tpu/engine.py` (ResampleCoarse, bake_cpu_impl.cpp:715-808).
`resample_fine_item` is the counterpart of that module's fine pass
(ResampleFine, bake_cpu_impl.cpp:816-1029), with its nearest-filter and
AABB-kernel passes as torch ops on the bake's device; the JAX package's
pallas route reaches it for nearest-filter line triangles and for bakes
without level-line intersection.  Its level-line passes are the
`classify` module's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import bird, classify, geom, routes
from .classify import (border_alpha_of, final_states, raster_window,
                       row_blocks, sum_hw, tex_planes, window_hw)
from .levelline import f32
from .planes import check_device
from .spans import span
from .texture import Texture, gather_tex_coord4
from .texture_torch import gather_tex_coord4 as gather4, load
from .types import (Format, OpacityState, TextureAddressMode,
                    TextureFilterMode, UnknownStatePromotion,
                    get_num_micro_triangles)

UO = int(OpacityState.UnknownOpaque)


@dataclass
class ResampleConfig:
    addr_mode: TextureAddressMode
    filter: TextureFilterMode
    alpha_cutoff: float
    border_alpha: float
    fmt: Format                        # desc.format (global, used for state)
    promotion: UnknownStatePromotion
    cutoff_gt: OpacityState
    cutoff_le: OpacityState
    disable_level_line: bool = False
    enable_aabb_testing: bool = False
    disable_fine: bool = False


# ---------------------------------------------------------------------------
# Coarse SAT pass (bake_cpu_impl.cpp:715-808)
# ---------------------------------------------------------------------------

def resample_coarse_item(texture: Texture, cfg: ResampleConfig,
                         uv_tri: np.ndarray, subdiv: int,
                         states: np.ndarray) -> np.ndarray:
    """SAT-based box classification of micro-triangles fully above/below the
    cutoff.  Runs only with an embedded alpha cutoff, single mip, linear
    filter; mutates nothing, returns updated states."""
    if not texture.has_sat() or texture.mip_count != 1:
        return states
    if cfg.filter != TextureFilterMode.Linear:
        return states

    mip = 0
    w, h = texture.size(mip)
    M = get_num_micro_triangles(subdiv)
    idx = np.arange(M, dtype=np.uint32)
    uvs = bird.micro_triangle_uvs(uv_tri, idx, subdiv)  # (M, 3, 2) fp32
    aabb_s, aabb_e = geom.tri_aabb(uvs)

    # Require the whole micro-tri inside one integer UV cell (no wrap).
    sx = aabb_s[:, 0].astype(np.int32)
    sy = aabb_s[:, 1].astype(np.int32)
    ex = aabb_e[:, 0].astype(np.int32)
    ey = aabb_e[:, 1].astype(np.int32)
    ok = (sx == ex) & (sy == ey)

    sizef = np.array([w, h], dtype=np.float32)
    f_s = np.floor(aabb_s * sizef - np.float32(0.5))
    f_e = np.floor(aabb_e * sizef - np.float32(0.5))
    size_i = np.array([w, h], np.int32)
    log2_i = np.array(texture.info[mip].size_log2, np.int32)
    pow2 = texture.info[mip].is_pow2
    c00s, _, _, _ = gather_tex_coord4(cfg.addr_mode, f_s.astype(np.int32),
                                      size_i, log2_i, pow2)
    _, _, _, c11e = gather_tex_coord4(cfg.addr_mode, f_e.astype(np.int32),
                                      size_i, log2_i, pow2)
    s_c = c00s
    e_c = c11e
    ok &= ~((e_c[:, 0] < s_c[:, 0]) | (e_c[:, 1] < s_c[:, 1]))
    ok &= texture.in_texture(s_c, mip) & texture.in_texture(e_c, mip)

    sel = np.nonzero(ok)[0]
    if len(sel) == 0:
        return states
    s_sel = s_c[sel]
    e_sel = e_c[sel]
    area = ((e_sel[:, 0] - s_sel[:, 0] + 1)
            * (e_sel[:, 1] - s_sel[:, 1] + 1)).astype(np.uint32)
    sa = texture.sat_query(s_sel, e_sel, mip)

    out = states.copy()
    out[sel[sa == 0]] = int(cfg.cutoff_le)
    out[sel[sa == area]] = int(cfg.cutoff_gt)
    return out


# ---------------------------------------------------------------------------
# Fine pass (bake_cpu_impl.cpp:816-1029)
# ---------------------------------------------------------------------------

def _aabb_counts(plane, info, cfg, tri, ccw, W, H):
    """One triangle set of the ConservativeBilinearKernel pass
    (engine._aabb_kernel_mip_pass): per covered texel of the -0.5 offset
    window, the 2x2 quad's max above the cutoff counts above and its min
    below counts below."""
    x, y, mask = raster_window(tri, ccw, info, -0.5, W, H)
    pix_x = (x.to(torch.float32) + 0.5).to(torch.int32)
    pix_y = (y.to(torch.float32) + 0.5).to(torch.int32)
    ba = border_alpha_of(cfg)
    vals = [load(plane, cx, cy, ba)
            for cx, cy in gather4(cfg.addr_mode, pix_x, pix_y, info)]
    vmin = torch.minimum(torch.minimum(vals[0], vals[1]),
                         torch.minimum(vals[2], vals[3]))
    vmax = torch.maximum(torch.maximum(vals[0], vals[1]),
                         torch.maximum(vals[2], vals[3]))
    cut = f32(cfg.alpha_cutoff)
    return sum_hw(mask & (cut < vmax)), sum_hw(mask & (vmin < cut))


def _aabb_states(texture, cfg, muvs: np.ndarray, device) -> np.ndarray:
    """Final states of micro-triangles muvs under the AABB debug kernels
    (bake_cpu_impl.cpp:915-966), mip 0 only: the micro-triangle itself,
    or with EnableAABBTesting its AABB split into two triangles."""
    aabb_s, aabb_e = geom.tri_aabb(muvs)
    if cfg.enable_aabb_testing:
        c1 = np.stack([aabb_e[:, 0], aabb_s[:, 1]], -1)
        c2 = np.stack([aabb_s[:, 0], aabb_e[:, 1]], -1)
        tris = [np.stack([aabb_s, c1, c2], axis=1),
                np.stack([aabb_e, c1, c2], axis=1)]
    else:
        tris = [muvs]
    S = muvs.shape[0]
    plane = tex_planes(texture, device)[0]
    info = texture.info[0]
    above = torch.zeros(S, dtype=torch.int32, device=device)
    below = torch.zeros(S, dtype=torch.int32, device=device)
    for tri in tris:
        tri = np.ascontiguousarray(tri, np.float32)
        W, H = window_hw(texture, tri, -0.5)[0]
        tri_t = torch.from_numpy(tri).to(device)
        ccw_t = torch.from_numpy(geom.is_ccw(tri)).to(device)
        parts = [_aabb_counts(plane, info, cfg, tri_t[lo:hi], ccw_t[lo:hi],
                              W, H) for lo, hi in row_blocks(S, W * H)]
        above = above + torch.cat([p[0] for p in parts])
        below = below + torch.cat([p[1] for p in parts])
    return final_states(cfg, above, below)


def resample_fine_item(texture: Texture, cfg: ResampleConfig,
                       uv_tri: np.ndarray, subdiv: int, states: np.ndarray,
                       device="cuda") -> np.ndarray:
    """Fine classification of one work item on `device`
    (engine.resample_fine_item): the micro-triangles still UnknownOpaque
    get their final states.  Nearest filter: the zero-offset window over
    every mip, with the early-unknown exit.  Without level-line
    intersection: the AABB debug kernels on mip 0.  Linear filter with
    level lines: the `classify` module's passes (the dense pass, or the
    line-triangle pass for degenerate items), which give the same
    states.  DisableFineClassification returns `states` as they are."""
    device = check_device(device)
    if cfg.disable_fine:
        return states
    if (cfg.filter == TextureFilterMode.Linear
            and not cfg.disable_level_line):
        if bool(geom.is_degenerate(uv_tri)):
            return classify.classify_degenerate(texture, cfg, uv_tri, subdiv,
                                                states, device)
        return classify.classify_work_item(texture, cfg, uv_tri, subdiv,
                                           states, device)
    sel = np.flatnonzero(states == UO)
    if sel.size == 0:
        return states
    routes.count("host_engine")
    with span("omm.host_engine"):
        muvs = bird.micro_triangle_uvs(uv_tri, sel.astype(np.uint32),
                                       subdiv)
        if cfg.filter == TextureFilterMode.Nearest:
            final = classify.nearest_states(texture, cfg, muvs, device)
        else:
            final = _aabb_states(texture, cfg, muvs, device)
    out = states.copy()
    out[sel] = final
    return out
