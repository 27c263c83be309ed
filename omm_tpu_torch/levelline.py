"""Level-line classification math in torch.

Counterparts of `omm_tpu.kernels.levelline` (the conservative raster
mask, the level-line kernel's non-degenerate and degenerate branches,
the coverage-to-state map), in the same fp32 operation order.  Eager
torch runs
each operation as its own kernel, so `a*b + c` is never contracted into
an FMA, and `/` rounds to nearest: the JAX module's contraction fence
(`guard`) has no counterpart here, and its correctly rounded software
sqrt (`exact_sqrt`) becomes `sqrt_rn`.  Do not run these functions
under `torch.compile`, whose code generator may fuse them.

Every fp32 constant is a float32 value before it meets a tensor, as
`jnp.float32(...)` makes it in the JAX code.
"""
from __future__ import annotations

import numpy as np
import torch

from .texture_torch import gather_tex_coord4, load
from .types import (Format, OpacityState, TextureAddressMode,
                    UnknownStatePromotion)


def f32(v) -> float:
    """The float32 value nearest v, as a Python float (exact in fp32)."""
    return float(np.float32(v))


_EPS5 = f32(1e-5)


def is_zero(v, eps=1e-6):
    """IsZero (bake_kernels_cpu.h:135-137): |v| < eps via two compares."""
    e = f32(eps)
    return (v < e) & (v > -e)


def sqrt_rn(x):
    """Correctly rounded fp32 sqrt.  torch's fp32 `sqrt` on the CPU is
    not: it is one ulp off on ~0.6% of inputs (measured against numpy
    over 5M random floats).  The float64 sqrt rounded once to fp32 is
    correctly rounded (float64 carries more than 2*24+2 bits), on every
    device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _length(dx, dy):
    """glm::length of a float2 in fp32."""
    return sqrt_rn(dx * dx + dy * dy)


def edge_hyperbola_hit(p0x, p0y, p1x, p1y, ha, hb, hc, hd, branches=False):
    """TestEdgeHyperbolaIntersection (bake_kernels_cpu.h:144-238).

    Edge endpoints (p0, p1) in texel-local coordinates; hyperbola
    f(x,y) = ha + hb*x + hc*y + hd*x*y = 0.  Returns a bool tensor, or
    with branches=True (hit, hyperbola, roots): whether the test takes
    the hyperbola branch, and whether that branch has real roots."""
    swap = p0x > p1x
    q0x = torch.where(swap, p1x, p0x)
    q0y = torch.where(swap, p1y, p0y)
    q1x = torch.where(swap, p0x, p1x)
    q1y = torch.where(swap, p0y, p1y)

    edge_len = _length(q1x - q0x, q1y - q0y)

    def on_edge(px, py):
        l = _length(px - q0x, py - q0y) + _length(px - q1x, py - q1y) \
            - edge_len
        return is_zero(l, _EPS5)

    def in_unit_square(px, py):
        return (px >= 0.0) & (px <= 1.0) & (py >= 0.0) & (py <= 1.0)

    def point_hit(px, py):
        return in_unit_square(px, py) & on_edge(px, py)

    k_denum = q1x - q0x
    vertical = is_zero(k_denum)

    # vertical edge branch (bake_kernels_cpu.h:161-180)
    vx = q0x
    v_c0 = hd * vx + hc
    v_c1 = ha + hb * vx
    v_c0_safe = torch.where(is_zero(v_c0), 1.0, v_c0)
    vy = -v_c1 / v_c0_safe

    # general branch (bake_kernels_cpu.h:181-234)
    k_den_safe = torch.where(vertical, 1.0, k_denum)
    k = (q1y - q0y) / k_den_safe
    m = q1y - q1x * k
    c0 = hd * k
    c1 = hc * k + hd * m + hb
    c2 = ha + hc * m
    c0_zero = is_zero(c0)

    c1_safe = torch.where(is_zero(c1), 1.0, c1)
    lx = -c2 / c1_safe
    ly = k * lx + m

    inner = c1 * c1 - (4.0 * c0) * c2
    real = inner > 0.0
    root = sqrt_rn(torch.where(real, inner, 0.0))
    c0_safe = torch.where(c0_zero, 1.0, c0)
    hx0 = 0.5 * (-c1 + root) / c0_safe
    hx1 = 0.5 * (-c1 - root) / c0_safe
    hy0 = k * hx0 + m
    hy1 = k * hx1 + m

    # the branches are exclusive per element: select the branch's
    # candidate points, then run the point test twice
    pax = torch.where(vertical, vx, torch.where(c0_zero, lx, hx0))
    pay = torch.where(vertical, vy, torch.where(c0_zero, ly, hy0))
    pbx = torch.where(vertical | c0_zero, 2.0, hx1)
    pby = torch.where(vertical | c0_zero, 2.0, hy1)
    gate = ((vertical & ~is_zero(v_c0))
            | (~vertical & c0_zero & ~is_zero(c1))
            | (~vertical & ~c0_zero & real))
    hit = gate & (point_hit(pax, pay) | point_hit(pbx, pby))
    if not branches:
        return hit
    hyper = ~vertical & ~c0_zero
    return hit, hyper, hyper & real


def point_in_tri_cached(tp, px, py):
    """Triangle::PointInTriangle (geometry.h:101-114).  tp: dict with
    p0x..p2y and the cached edge diffs p0p2/p1p0/p2p1."""
    s = tp["p0p2x"] * (py - tp["p2y"]) - tp["p0p2y"] * (px - tp["p2x"])
    t = tp["p1p0x"] * (py - tp["p0y"]) - tp["p1p0y"] * (px - tp["p0x"])
    early_false = ((s < 0.0) != (t < 0.0)) & (s != 0.0) & (t != 0.0)
    d = tp["p2p1x"] * (py - tp["p1y"]) - tp["p2p1y"] * (px - tp["p1x"])
    ok = (d == 0.0) | ((d < 0.0) == ((s + t) <= 0.0))
    return (~early_false) & ok


def tri_params(p0x, p0y, p1x, p1y, p2x, p2y):
    """Cached point-in-triangle diffs (levelline.make_tri_params)."""
    return {"p0x": p0x, "p0y": p0y, "p1x": p1x, "p1y": p1y,
            "p2x": p2x, "p2y": p2y,
            "p0p2x": p0x - p2x, "p0p2y": p0y - p2y,
            "p1p0x": p1x - p0x, "p1p0y": p1y - p0y,
            "p2p1x": p2x - p1x, "p2p1y": p2y - p1y}


def make_tri_params(tri):
    """tri_params of (..., 3, 2) fp32 triangles with two trailing
    broadcast axes (levelline.make_tri_params)."""
    def g(i, j):
        return tri[..., i, j][..., None, None]
    return tri_params(g(0, 0), g(0, 1), g(1, 0), g(1, 1), g(2, 0), g(2, 1))


def conservative_raster_mask(q, x, y):
    """Over-conservative Pineda edge-test accept mask
    (cpu_raster.h:102-124 via :304-333).  q: (..., 3, 2) fp32
    CCW-normalized raster-space triangles; x, y: int texel coordinates
    broadcastable to (..., H, W)."""
    sx = x.to(torch.float32)
    sy = y.to(torch.float32)
    acc = None
    for e in range(3):
        px = q[..., e, 0][..., None, None]
        py = q[..., e, 1][..., None, None]
        qx = q[..., (e + 1) % 3, 0][..., None, None]
        qy = q[..., (e + 1) % 3, 1][..., None, None]
        nx = qy - py
        ny = px - qx
        c = -(nx * px + ny * py)
        ev = (nx * sx + ny * sy) + c
        bx = torch.where(nx > 0.0, 0.0, nx)
        by = torch.where(ny > 0.0, 0.0, ny)
        ok = (ev + bx + by) < 0.0
        acc = ok if acc is None else (acc & ok)
    return acc


def level_line_texel_kernel(tp, px_i, py_i, plane, info, addr_mode,
                            alpha_cutoff, border_alpha, degenerate=False,
                            aabb_s=None, aabb_e=None):
    """Per-(micro-triangle, texel) increments of the level-line kernel
    (bake_kernels_cpu.h:241-399) with the 2x2 quad gathered from `plane`
    (fp32 (h, w) tensor of the mip `info` describes) through the address
    mode.  degenerate=True takes the line-triangle branch, whose level
    line is tested against the segment aabb_s -> aabb_e ((..., 2) fp32,
    one per triangle) instead of the three edges."""
    c00, c10, c01, c11 = gather_tex_coord4(addr_mode, px_i, py_i, info)
    ba = border_alpha if addr_mode == TextureAddressMode.Border else None
    # quad order of the kernel: x=c00, y=c01, z=c11, w=c10
    # (bake_kernels_cpu.h:259-273)
    g = [load(plane, cx, cy, ba) for cx, cy in (c00, c01, c11, c10)]
    rcp = (float(info.rcp_size[0]), float(info.rcp_size[1]))
    if degenerate:
        return level_line_values_degenerate(px_i, py_i, *g, info.size,
                                            alpha_cutoff, aabb_s, aabb_e)
    return level_line_values_kernel(tp, px_i, py_i, *g, info.size, rcp,
                                    alpha_cutoff)


def level_line_values_degenerate(px_i, py_i, gx, gy, gz, gw, tex_size,
                                 alpha_cutoff, aabb_s, aabb_e):
    """The degenerate branch of the level-line kernel
    (bake_kernels_cpu.h:358-374): no corner-in-triangle search, and one
    edge test against the AABB diagonal aabb_s -> aabb_e ((..., 2) fp32
    per triangle, broadcast over two trailing texel axes)."""
    cutoff = f32(alpha_cutoff)
    sizef_x = f32(float(tex_size[0]))
    sizef_y = f32(float(tex_size[1]))
    pixelf_x = px_i.to(torch.float32) + 0.5
    pixelf_y = py_i.to(torch.float32) + 0.5

    a = gx
    b = gw - gx
    c = gy - gx
    d = gx + gz - gy - gw
    uniform = is_zero(b) & is_zero(c) & is_zero(d)
    uni_above = uniform & (cutoff < a)
    uni_below = uniform & ~(cutoff < a)

    def end(p, k, size, pix):
        return size * p[..., k][..., None, None] - pix

    hit = edge_hyperbola_hit(end(aabb_s, 0, sizef_x, pixelf_x),
                             end(aabb_s, 1, sizef_y, pixelf_y),
                             end(aabb_e, 0, sizef_x, pixelf_x),
                             end(aabb_e, 1, sizef_y, pixelf_y),
                             a - cutoff, b, c, d)
    above = uni_above | (~uniform & hit)
    below = uni_below | (~uniform & hit)
    return above.to(torch.int32), below.to(torch.int32)


def level_line_values_kernel(tp, px_i, py_i, gx, gy, gz, gw, tex_size,
                             rcp_size, alpha_cutoff, work=None):
    """Per-(micro-triangle, texel) increments of the level-line kernel
    (bake_kernels_cpu.h:241-399), non-degenerate branch, with the 2x2
    quad values already fetched (x=c00, y=c01, z=c11, w=c10).
    Returns (above_inc, below_inc) int32 tensors (values 0..2).

    work: a dict that, when given, receives per texel what a kernel that
    stops at the first decision does: "level_line" (the texel passes the
    extremum and flat-quad tests), and among those "edges" (edge tests
    run up to the first hit), "hyperbola" (of them, tests that take the
    hyperbola branch) and "roots" (hyperbola tests with real roots)."""
    cutoff = f32(alpha_cutoff)
    sizef_x = f32(float(tex_size[0]))
    sizef_y = f32(float(tex_size[1]))
    inv_x = f32(float(rcp_size[0]))
    inv_y = f32(float(rcp_size[1]))

    pixelf_x = px_i.to(torch.float32) + 0.5
    pixelf_y = py_i.to(torch.float32) + 0.5
    invpix_x = pixelf_x * inv_x
    invpix_y = pixelf_y * inv_y

    # corner-in-triangle extremum search (bake_kernels_cpu.h:276-331)
    op0 = cutoff < gx
    op1 = cutoff < gy
    op2 = cutoff < gz
    op3 = cutoff < gw
    in0 = point_in_tri_cached(tp, invpix_x, invpix_y)
    in1 = point_in_tri_cached(tp, invpix_x, invpix_y + inv_y)
    in2 = point_in_tri_cached(tp, invpix_x + inv_x, invpix_y + inv_y)
    in3 = point_in_tri_cached(tp, invpix_x + inv_x, invpix_y)
    is_op = (in0 & op0) | (in1 & op1) | (in2 & op2) | (in3 & op3)
    is_tr = (in0 & ~op0) | (in1 & ~op1) | (in2 & ~op2) | (in3 & ~op3)
    above = is_op.to(torch.int32)
    below = is_tr.to(torch.int32)
    early_done = is_op & is_tr

    # level-line section (bake_kernels_cpu.h:333-398)
    a = gx
    b = gw - gx
    c = gy - gx
    d = gx + gz - gy - gw
    uniform = is_zero(b) & is_zero(c) & is_zero(d)
    uni_above = uniform & (cutoff < a)
    uni_below = uniform & ~(cutoff < a)

    ha = a - cutoff
    corner = [(tp["p0x"], tp["p0y"]), (tp["p1x"], tp["p1y"]),
              (tp["p2x"], tp["p2y"])]
    hit = None
    if work is not None:
        todo = ~early_done & ~uniform
        work.update(level_line=todo, edges=0, hyperbola=0, roots=0)
    for e in range(3):
        p0x = sizef_x * corner[e][0] - pixelf_x
        p0y = sizef_y * corner[e][1] - pixelf_y
        p1x = sizef_x * corner[(e + 1) % 3][0] - pixelf_x
        p1y = sizef_y * corner[(e + 1) % 3][1] - pixelf_y
        if work is None:
            h = edge_hyperbola_hit(p0x, p0y, p1x, p1y, ha, b, c, d)
        else:
            h, hyp, roots = edge_hyperbola_hit(p0x, p0y, p1x, p1y, ha, b, c,
                                               d, branches=True)
            for key, v in (("edges", todo), ("hyperbola", todo & hyp),
                           ("roots", todo & roots)):
                work[key] = work[key] + v.to(torch.int32)
            todo = todo & ~h
        hit = h if hit is None else (hit | h)

    ll_above = uni_above | (~uniform & hit)
    ll_below = uni_below | (~uniform & hit)
    above = above + (~early_done & ll_above).to(torch.int32)
    below = below + (~early_done & ll_below).to(torch.int32)
    return above, below


def get_state_from_coverage(fmt: Format, mode: UnknownStatePromotion,
                            cutoff_gt: OpacityState, cutoff_le: OpacityState,
                            above, below):
    """GetStateFromCoverage (bake_kernels_cpu.h:25-61) over (above,
    below) integer tensors; returns an int32 state tensor."""
    def unknown_of(s: OpacityState) -> int:
        if s == OpacityState.Transparent:
            return int(OpacityState.UnknownTransparent)
        if s == OpacityState.Opaque:
            return int(OpacityState.UnknownOpaque)
        return int(s)

    def full(v):
        return torch.full_like(above, int(v), dtype=torch.int32)

    is_unknown = (above != 0) & (below != 0)
    if fmt == Format.OC1_4_State:
        if mode == UnknownStatePromotion.ForceOpaque:
            unk = full(OpacityState.UnknownOpaque)
        elif mode == UnknownStatePromotion.ForceTransparent:
            unk = full(OpacityState.UnknownTransparent)
        else:  # Nearest
            unk = torch.where(above >= below, full(unknown_of(cutoff_gt)),
                              full(unknown_of(cutoff_le)))
    else:
        if mode == UnknownStatePromotion.ForceOpaque:
            unk = full(OpacityState.Opaque)
        elif mode == UnknownStatePromotion.ForceTransparent:
            unk = full(OpacityState.Transparent)
        else:
            unk = torch.where(above >= below, full(cutoff_gt),
                              full(cutoff_le))
    known = torch.where(above == 0, full(cutoff_le), full(cutoff_gt))
    return torch.where(is_unknown, unk, known)
