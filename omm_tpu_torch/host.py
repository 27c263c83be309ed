"""Host-side numpy helpers of the two-phase engine.

These functions live in `omm_tpu.kernels.twophase` and
`omm_tpu.kernels.mxu_classify`, which load jax when imported; the port
keeps its own copies here.  Each copy is pinned equal to its original by
tests/test_torch_host.py.  The environment switches of the originals are
not carried over: every function follows its original's default.
"""
from __future__ import annotations

import numpy as np

from . import bird, geom
from .texture import Texture, get_tex_coord
from .types import (TextureAddressMode, TextureFilterMode,
                    get_num_micro_triangles)

#: texel tile edge of the exact stage (pallas_classify.TILE default)
TILE = 64
#: survivor slots per exact-stage block (pallas_classify.B default)
B = 128


def padded_plane(texture: Texture, mip: int, pad: int,
                 addr_mode: TextureAddressMode,
                 border_alpha: float = 0.0,
                 period: tuple | None = None) -> np.ndarray:
    """Plane extended by `pad` texels on each side with the address
    mode's wrapped texels (mxu_classify.padded_plane).  Border mode fills
    the pad with border_alpha; period=(Pw, Ph) builds one address-mode
    period plus the apron, extended by the periodic continuation."""
    plane = texture.load_plane(mip)
    w, h = texture.size(mip)
    info = texture.info[mip]
    if addr_mode == TextureAddressMode.Border:
        out = np.full((h + 2 * pad, w + 2 * pad), np.float32(border_alpha),
                      dtype=np.float32)
        out[pad:pad + h, pad:pad + w] = plane
        return out
    if period is not None:
        Pw, Ph = period
        cx = np.mod(np.arange(-pad, Pw + pad, dtype=np.int64),
                    Pw).astype(np.int32)
        cy = np.mod(np.arange(-pad, Ph + pad, dtype=np.int64),
                    Ph).astype(np.int32)
    else:
        cx = np.arange(-pad, w + pad, dtype=np.int32)
        cy = np.arange(-pad, h + pad, dtype=np.int32)
    wx = get_tex_coord(addr_mode, np.stack([cx, np.zeros_like(cx)], -1),
                       np.array([w, h], np.int32),
                       np.array(info.size_log2, np.int32), info.is_pow2)[:, 0]
    wy = get_tex_coord(addr_mode, np.stack([np.zeros_like(cy), cy], -1),
                       np.array([w, h], np.int32),
                       np.array(info.size_log2, np.int32), info.is_pow2)[:, 1]
    return plane[np.ix_(wy, wx)]


def _period_for(texture: Texture, addr_mode, mip: int):
    """Address-mode period (Pw, Ph) in texels, or None for aperiodic
    modes: Wrap repeats every w texels, Mirror every 2w."""
    w, h = texture.size(mip)
    if addr_mode == TextureAddressMode.Wrap:
        return (w, h)
    if addr_mode == TextureAddressMode.Mirror:
        return (2 * w, 2 * h)
    return None


def wrap_origin(x0, y0, period):
    """Wrap a window origin into the canonical period (floor mod: `%` on
    numpy arrays and torch integer tensors takes the divisor's sign);
    no-op for aperiodic modes (period None)."""
    if period is None:
        return x0, y0
    return x0 % period[0], y0 % period[1]


def _span_window(texture: Texture, uv_tri: np.ndarray, level: int, mip: int):
    """Conservative (H, W) texel window class of one item's subtriangles
    at `level`."""
    Hb, Wb = _span_windows(texture, uv_tri[None], level, mip)
    return int(Hb[0]), int(Wb[0])


def _span_windows(texture: Texture, uv_arr: np.ndarray, level: int,
                  mip: int):
    """uv_arr (N, 3, 2) -> (Hb, Wb) int64 (N,): an upper bound on the
    clipped AABB extent of a subtriangle at `level` (the macro triangle
    scaled by 2^-level), in fp64."""
    w, h = texture.size(mip)
    q = np.asarray(uv_arr, np.float64) * np.array([w, h], np.float64)
    span = (q.max(axis=1) - q.min(axis=1)) * 2.0 ** -level
    Wb = np.ceil(span[:, 0] * (1.0 + 1e-5)).astype(np.int64) + 2
    Hb = np.ceil(span[:, 1] * (1.0 + 1e-5)).astype(np.int64) + 2
    return Hb, Wb


def _fast_path_mask(texture: Texture, cfg, uv_arr: np.ndarray,
                    subdiv: int, lg: int) -> np.ndarray:
    """Per item of uv_arr (N, 3, 2): True when the two-phase engine's
    preconditions hold (linear filter with level lines, non-degenerate,
    winding-stable, windows that fit the tile padding)."""
    N = uv_arr.shape[0]
    if (cfg.filter != TextureFilterMode.Linear
            or getattr(cfg, "disable_level_line", False)
            or subdiv < 2):
        return np.zeros(N, bool)
    ok = ~geom.is_degenerate(uv_arr)
    ok &= geom.winding_stable(uv_arr, subdiv)
    if cfg.addr_mode == TextureAddressMode.Border:
        for k in np.flatnonzero(ok):
            ok[k] = _fast_path_ok(texture, cfg, uv_arr[k], subdiv, lg)
        return ok
    for mip in range(texture.mip_count):
        Hbs, Wbs = _span_windows(texture, uv_arr, subdiv, mip)
        Hgs, Wgs = _span_windows(texture, uv_arr, lg, mip)
        He, We = Hbs + 2, Wbs + 2
        win_mx = np.maximum(He, We)
        pad = TILE + win_mx  # per-item TSA
        ok &= win_mx <= TILE
        ok &= np.maximum(Hgs, Wgs) + 6 < pad
        w, h = texture.size(mip)
        q = uv_arr.astype(np.float64) * np.array([w, h], np.float64)
        tmin = np.floor(q.min(axis=1)) - 2
        tmax = np.ceil(q.max(axis=1)) + 2
        if _period_for(texture, cfg.addr_mode, mip) is not None:
            # periodic modes need no containment; non-pow2 Wrap's
            # negative-coordinate quirk is aperiodic, so negative
            # footprints stay off the fast path there
            ok &= (np.abs(q) < 2.0 ** 30).all(axis=(1, 2))
            if (cfg.addr_mode == TextureAddressMode.Wrap
                    and not texture.info[mip].is_pow2):
                ok &= (tmin[:, 0] >= 1) & (tmin[:, 1] >= 1)
        else:
            ok &= (tmin[:, 0] >= 1 - pad) & (tmin[:, 1] >= 1 - pad)
            ok &= tmax[:, 0] + np.maximum(We + 2, Wgs + 6) <= w + pad
            ok &= tmax[:, 1] + np.maximum(He + 2, Hgs + 6) <= h + pad
    return ok


def _fast_path_ok(texture: Texture, cfg, uv_tri: np.ndarray,
                  subdiv: int, lg: int) -> bool:
    """Scalar form of _fast_path_mask; Border mode also requires every
    micro-triangle's seed footprint in bounds (the oracle's seed sample
    clamps where the padded plane substitutes borderAlpha)."""
    if (cfg.filter != TextureFilterMode.Linear
            or getattr(cfg, "disable_level_line", False)
            or subdiv < 2
            or bool(geom.is_degenerate(uv_tri))):
        return False
    if cfg.addr_mode == TextureAddressMode.Border:
        M = get_num_micro_triangles(subdiv)
        p0 = bird.micro_triangle_uvs(
            uv_tri, np.arange(M, dtype=np.uint32), subdiv)[:, 0, :]
        for mip in range(texture.mip_count):
            w, h = texture.size(mip)
            s = np.floor(p0 * np.array([w, h], np.float32)
                         - np.float32(0.5))
            if (s < 0).any() or (s[:, 0] > w - 2).any() \
                    or (s[:, 1] > h - 2).any():
                return False
    for mip in range(texture.mip_count):
        Hb, Wb = _span_window(texture, uv_tri, subdiv, mip)
        Hg, Wg = _span_window(texture, uv_tri, lg, mip)
        He, We = Hb + 2, Wb + 2
        if max(He, We) > TILE:
            return False
        TSA = TILE + max(He, We)
        pad = TSA
        if max(Hg, Wg) + 6 >= pad:
            return False
        w, h = texture.size(mip)
        q = uv_tri.astype(np.float64) * np.array([w, h], np.float64)
        tmin = np.floor(q.min(axis=0)) - 2
        tmax = np.ceil(q.max(axis=0)) + 2
        if _period_for(texture, cfg.addr_mode, mip) is not None:
            if (np.abs(q) >= 2.0 ** 30).any():
                return False
            if (cfg.addr_mode == TextureAddressMode.Wrap
                    and not texture.info[mip].is_pow2
                    and (tmin[0] < 1 or tmin[1] < 1)):
                return False
        elif (tmin[0] < 1 - pad or tmin[1] < 1 - pad
                or tmax[0] + max(We + 2, Wg + 6) > w + pad
                or tmax[1] + max(He + 2, Hg + 6) > h + pad):
            return False
    return True


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _bucket(n: int) -> int:
    """Smallest capacity in {2^k, 1.5*2^k} >= n: tight enough to bound
    the padded work, coarse enough to bound the captured graphs."""
    p = _next_pow2(max(n, 1))
    if (p // 4) * 3 >= n:
        return (p // 4) * 3
    return p


def caps_entry(Cs, K: int, padMs) -> tuple:
    """The caps-cache entry (Cs caps, K cap, per-mip block caps) for a
    batch whose true counts were Cs (per level), K (survivors) and padMs
    (per-mip padded slot totals): the discovery path's headroom of
    twophase._run_batch_sync, applied once to the true counts."""
    nblks = [(p + B - 1) // B for p in padMs]
    return (tuple(max(_bucket(c + c // 16 + 64), 512) for c in Cs),
            max(_bucket(K + K // 16 + 64), 4 * B),
            tuple(max(_bucket(n + n // 8 + 8), 8) for n in nblks))


def _skip_final_p(levels, all_active: bool) -> bool:
    """True when the final level's window test is skipped: all-active
    batches whose last descent step is one level (its children go
    straight to the exact stage)."""
    return (bool(all_active) and len(levels) >= 2
            and levels[-1] - levels[-2] == 1)


def _group_level(texture: Texture, uv_tris, subdiv: int) -> int:
    """Subdivision level of the resolve groups: subtriangle texel span
    ~8-16 at mip 0."""
    w, h = texture.size(0)
    span = 1.0
    if uv_tris:
        q = np.stack(uv_tris).astype(np.float64) \
            * np.array([w, h], np.float64)
        span = max(span, float((q.max(axis=1) - q.min(axis=1)).max()))
    lg = int(np.ceil(np.log2(max(span / 8.0, 1.0))))
    return max(1, min(subdiv - 1, lg))


def _descend_levels(texture: Texture, uv_tris, subdiv: int,
                    lg: int) -> tuple:
    """Descent schedule (l0, ..., subdiv): start at the coarsest level
    whose window class plane still fits the tile padding, then step down
    by 2."""
    l0 = lg
    uv_arr = np.stack(uv_tris) if uv_tris else np.zeros((0, 3, 2))
    pads_sub = []
    for mip in range(texture.mip_count):
        Hb, Wb = _span_windows(texture, uv_arr, subdiv, mip)
        pads_sub.append(TILE + np.maximum(Hb + 2, Wb + 2))
    for lv in range(1, lg):
        ok = True
        for mip in range(texture.mip_count):
            Hg, Wg = _span_windows(texture, uv_arr, lv, mip)
            if (np.maximum(Hg, Wg) + 6 >= pads_sub[mip]).any():
                ok = False
                break
        if ok:
            l0 = lv
            break
    levels = list(range(l0, subdiv, 2))
    levels.append(subdiv)
    return tuple(levels)


def _nearest_phase1_windows(texture: Texture, cfg, uv_tris,
                            subdiv: int) -> list | None:
    """The preconditions of the nearest-filter phase-1 resolve
    (twophase.resolve_nearest_phase1): nearest filter, subdivision 2 or
    more, no degenerate item, micro-triangles far above fp32 edge-test
    noise (the span gate), and windows the padded plane holds, with the
    periodic modes' guards.  Returns None when one fails, else the
    largest (Hb, Wb) window over the items at each mip."""
    if cfg.filter != TextureFilterMode.Nearest or subdiv < 2:
        return None
    windows = [(0, 0)] * texture.mip_count
    for uv_tri in uv_tris:
        if bool(geom.is_degenerate(uv_tri)):
            return None
        for mip in range(texture.mip_count):
            w, h = texture.size(mip)
            q = uv_tri.astype(np.float64) * np.array([w, h], np.float64)
            span = (q.max(axis=0) - q.min(axis=0)) * 2.0 ** -subdiv
            if span.min() < 0.25:
                return None
            Hb, Wb = _span_window(texture, uv_tri, subdiv, mip)
            windows[mip] = (max(windows[mip][0], Hb),
                            max(windows[mip][1], Wb))
            pad = TILE + max(Hb + 2, Wb + 2)
            tmin = np.floor(q.min(axis=0)) - 2
            tmax = np.ceil(q.max(axis=0)) + 2
            if _period_for(texture, cfg.addr_mode, mip) is not None:
                if (np.abs(q) >= 2.0 ** 30).any():
                    return None
                if (cfg.addr_mode == TextureAddressMode.Wrap
                        and not texture.info[mip].is_pow2
                        and (tmin[0] < 1 or tmin[1] < 1)):
                    return None
            elif (tmin[0] < 1 - pad or tmin[1] < 1 - pad
                    or tmax[0] + Wb + 6 > w + pad
                    or tmax[1] + Hb + 6 > h + pad):
                return None
    return windows
