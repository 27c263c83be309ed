"""Resample engine: the coarse SAT pass and the configuration it reads.

The port's copy of `ResampleConfig` and `resample_coarse_item` from
`omm_tpu/engine.py` (ResampleCoarse, bake_cpu_impl.cpp:715-808).  The
fine passes of that module (`resample_fine_item` and its level-line,
nearest and AABB passes) are not copied: the port's fine classification
is `batch.classify_work_items_batches`, and the fine routes off its fast
path are not ported yet (ROADMAP A8).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import bird, geom
from .texture import Texture, gather_tex_coord4
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
