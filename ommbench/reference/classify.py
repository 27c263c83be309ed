"""Plain reference of the fine classification: the micro-triangle states
of a triangle, as the reference SDK's CPU baker works them out.

Plain PyTorch, on whatever device its tensors are on, written from the
reference's per-texel kernels with every fp32 operation in the
reference's order:

  - micro-triangle corners on the bird curve (bird.h:57-182);
  - the seed bilinear sample at corner 0 (texture_impl.cpp:261-278);
  - the over-conservative raster of each micro-triangle in texel space,
    offset by -0.5 (cpu_raster.h:102-124, 277-383);
  - for each covered texel, LevelLineIntersectionKernel
    (bake_kernels_cpu.h:241-399): the texel's corners inside the
    micro-triangle, then the bilinear level line against its edges;
  - GetStateFromCoverage (bake_kernels_cpu.h:25-61).

It covers what the benchmark's configurations state: one FP32 mip, the
linear filter with level lines, Clamp addressing, non-degenerate
triangles, OC1_4_State, and any promotion and cutoff states.  Every
texel of every micro-triangle is evaluated: nothing is pruned.  Square
roots are taken in float64 and rounded once to fp32, which is the
correctly rounded fp32 root; no division is by a scalar (a kernel may
multiply by its reciprocal instead).
"""
from __future__ import annotations

import torch

F32 = torch.float32
M32 = 0xFFFFFFFF

TRANSPARENT, OPAQUE, UNKNOWN_TRANSPARENT, UNKNOWN_OPAQUE = 0, 1, 2, 3


def _even_bits(x):
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def _prefix_eor(x):
    x = x ^ (x >> 1)
    x = x ^ (x >> 2)
    x = x ^ (x >> 4)
    return x ^ (x >> 8)


def bary_corners(level: int, device) -> torch.Tensor:
    """(4^level, 3, 2) fp32 barycentric (u, v) corners of each
    micro-triangle in bird-curve order (bird.h:57-118); uint32 math in
    int64 lanes masked to 32 bits."""
    n = 1 << (2 * level)
    if level == 0:
        return torch.tensor([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]],
                            dtype=F32, device=device)
    index = torch.arange(n, dtype=torch.int64, device=device)
    b0 = _even_bits(index)
    b1 = _even_bits(index >> 1)
    fx = _prefix_eor(b0)
    fy = _prefix_eor(b0 & (~b1 & M32))
    t = fy ^ b1
    nt, nb0, nfx = ~t & M32, ~b0 & M32, ~fx & M32
    u = (fx & nt) | (b0 & nt) | (nb0 & nfx & t)
    v = fy ^ b0
    w = (nfx & nt) | (b0 & nt) | (nb0 & fx & t)
    mask = (1 << level) - 1
    iu, iv, iw = u & mask, v & mask, w & mask
    upright = ((iu & 1) ^ (iv & 1) ^ (iw & 1)) == 1
    iu = torch.where(upright, iu, iu + 1)
    iv = torch.where(upright, iv, iv + 1)
    scale = torch.tensor(2.0 ** -level, dtype=F32, device=device)
    d = torch.where(upright, scale, -scale)
    fu = iu.to(F32) * scale
    fv = iv.to(F32) * scale
    c0 = torch.stack([fu, fv], -1)
    c1 = torch.stack([fu + d, fv], -1)
    c2 = torch.stack([fu, fv + d], -1)
    return torch.stack([c0, c1, c2], 1)


def micro_uvs(tris: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """(T, 3, 2) fp32 triangles and (M, 3, 2) barycentric corners ->
    (T, M, 3, 2) micro-triangle UVs, p0*(1-u-v) + p1*u + p2*v with every
    product rounded (geometry.h:241-248)."""
    p0 = tris[:, None, None, 0, :]
    p1 = tris[:, None, None, 1, :]
    p2 = tris[:, None, None, 2, :]
    u = bary[None, :, :, 0:1]
    v = bary[None, :, :, 1:2]
    w = (1.0 - u) - v
    return ((p0 * w) + (p1 * u)) + (p2 * v)


def _is_zero(v, eps):
    e = torch.tensor(eps, dtype=F32, device=v.device)
    return (v < e) & (v > -e)


def _length(dx, dy):
    """glm::length in fp32, the root correctly rounded."""
    return torch.sqrt(((dx * dx) + (dy * dy)).double()).to(F32)


def _edge_hyperbola_hit(p0x, p0y, p1x, p1y, ha, hb, hc, hd):
    """TestEdgeHyperbolaIntersection (bake_kernels_cpu.h:144-238)."""
    one = torch.ones((), dtype=F32, device=ha.device)
    half = torch.tensor(0.5, dtype=F32, device=ha.device)
    two = torch.tensor(2.0, dtype=F32, device=ha.device)
    four = torch.tensor(4.0, dtype=F32, device=ha.device)
    zero = torch.zeros((), dtype=F32, device=ha.device)

    swap = p0x > p1x
    q0x = torch.where(swap, p1x, p0x)
    q0y = torch.where(swap, p1y, p0y)
    q1x = torch.where(swap, p0x, p1x)
    q1y = torch.where(swap, p0y, p1y)
    edge_len = _length(q1x - q0x, q1y - q0y)

    def point_hit(px, py):
        inside = (px >= zero) & (px <= one) & (py >= zero) & (py <= one)
        l = (_length(px - q0x, py - q0y) + _length(px - q1x, py - q1y)) \
            - edge_len
        return inside & _is_zero(l, 1e-5)

    k_denum = q1x - q0x
    vertical = _is_zero(k_denum, 1e-6)
    # a vertical edge
    vx = q0x
    v_c0 = (hd * vx) + hc
    v_c1 = ha + (hb * vx)
    v_c0_zero = _is_zero(v_c0, 1e-6)
    vy = (-v_c1) / torch.where(v_c0_zero, one, v_c0)
    # y = k x + m
    k = (q1y - q0y) / torch.where(vertical, one, k_denum)
    m = q1y - (q1x * k)
    c0 = hd * k
    c1 = ((hc * k) + (hd * m)) + hb
    c2 = ha + (hc * m)
    c0_zero = _is_zero(c0, 1e-6)
    c1_zero = _is_zero(c1, 1e-6)
    # a straight level line
    lx = (-c2) / torch.where(c1_zero, one, c1)
    ly = (k * lx) + m
    # a hyperbola
    inner = (c1 * c1) - ((four * c0) * c2)
    real = inner > zero
    root = torch.sqrt(torch.where(real, inner, zero).double()).to(F32)
    c0_safe = torch.where(c0_zero, one, c0)
    hx0 = (half * ((-c1) + root)) / c0_safe
    hx1 = (half * ((-c1) - root)) / c0_safe
    hy0 = (k * hx0) + m
    hy1 = (k * hx1) + m

    pax = torch.where(vertical, vx, torch.where(c0_zero, lx, hx0))
    pay = torch.where(vertical, vy, torch.where(c0_zero, ly, hy0))
    pbx = torch.where(vertical | c0_zero, two, hx1)
    pby = torch.where(vertical | c0_zero, two, hy1)
    gate = ((vertical & ~v_c0_zero) | (~vertical & c0_zero & ~c1_zero)
            | (~vertical & ~c0_zero & real))
    return gate & (point_hit(pax, pay) | point_hit(pbx, pby))


def _point_in_tri(t, px, py):
    """Triangle::PointInTriangle (geometry.h:101-114); t: (N, 3, 2)."""
    zero = torch.zeros((), dtype=F32, device=px.device)
    p0x, p0y = t[:, 0, 0], t[:, 0, 1]
    p1x, p1y = t[:, 1, 0], t[:, 1, 1]
    p2x, p2y = t[:, 2, 0], t[:, 2, 1]
    s = ((p0x - p2x) * (py - p2y)) - ((p0y - p2y) * (px - p2x))
    tt = ((p1x - p0x) * (py - p0y)) - ((p1y - p0y) * (px - p0x))
    early_false = ((s < zero) != (tt < zero)) & (s != zero) & (tt != zero)
    d = ((p2x - p1x) * (py - p1y)) - ((p2y - p1y) * (px - p1x))
    ok = (d == zero) | ((d < zero) == ((s + tt) <= zero))
    return ~early_false & ok


def _fetch(plane, x, y):
    """Clamp-addressed texel of an (h, w) plane."""
    h, w = plane.shape
    return plane[y.clamp(0, h - 1), x.clamp(0, w - 1)]


def _level_line(plane, muv, px, py, cutoff):
    """LevelLineIntersectionKernel, one (micro-triangle, texel) pair
    per lane: (above, below) increments, 0 or 1 each, plus the corner
    test's (bake_kernels_cpu.h:241-399)."""
    h, w = plane.shape
    dev = plane.device
    half = torch.tensor(0.5, dtype=F32, device=dev)
    size_x = torch.tensor(float(w), dtype=F32, device=dev)
    size_y = torch.tensor(float(h), dtype=F32, device=dev)
    inv_x = torch.tensor(1.0, dtype=F32, device=dev) / size_x
    inv_y = torch.tensor(1.0, dtype=F32, device=dev) / size_y
    gx = _fetch(plane, px, py)          # c00
    gy = _fetch(plane, px, py + 1)      # c01
    gz = _fetch(plane, px + 1, py + 1)  # c11
    gw = _fetch(plane, px + 1, py)      # c10

    pfx = px.to(F32) + half
    pfy = py.to(F32) + half
    ipx = pfx * inv_x
    ipy = pfy * inv_y
    op = [cutoff < g for g in (gx, gy, gz, gw)]
    ins = [_point_in_tri(muv, ipx, ipy),
           _point_in_tri(muv, ipx, ipy + inv_y),
           _point_in_tri(muv, ipx + inv_x, ipy + inv_y),
           _point_in_tri(muv, ipx + inv_x, ipy)]
    is_op = (ins[0] & op[0]) | (ins[1] & op[1]) | (ins[2] & op[2]) \
        | (ins[3] & op[3])
    is_tr = (ins[0] & ~op[0]) | (ins[1] & ~op[1]) | (ins[2] & ~op[2]) \
        | (ins[3] & ~op[3])
    early_done = is_op & is_tr

    a = gx
    b = gw - gx
    c = gy - gx
    d = ((gx + gz) - gy) - gw
    uniform = _is_zero(b, 1e-6) & _is_zero(c, 1e-6) & _is_zero(d, 1e-6)
    uni_above = uniform & (cutoff < a)
    uni_below = uniform & ~(cutoff < a)
    ha = a - cutoff
    hit = torch.zeros_like(uniform)
    for e in range(3):
        f = (e + 1) % 3
        p0x = (size_x * muv[:, e, 0]) - pfx
        p0y = (size_y * muv[:, e, 1]) - pfy
        p1x = (size_x * muv[:, f, 0]) - pfx
        p1y = (size_y * muv[:, f, 1]) - pfy
        hit = hit | _edge_hyperbola_hit(p0x, p0y, p1x, p1y, ha, b, c, d)
    ll_above = uni_above | (~uniform & hit)
    ll_below = uni_below | (~uniform & hit)
    above = is_op.to(torch.int32) + (~early_done & ll_above).to(torch.int32)
    below = is_tr.to(torch.int32) + (~early_done & ll_below).to(torch.int32)
    return above, below


def _seed_above(plane, p, cutoff):
    """The runtime bilinear sample at p (N, 2) against the cutoff
    (texture_impl.cpp:261-278), Clamp addressing."""
    h, w = plane.shape
    dev = plane.device
    size = torch.tensor([float(w), float(h)], dtype=F32, device=dev)
    one = torch.ones((), dtype=F32, device=dev)
    pixel = (p * size) - torch.tensor(0.5, dtype=F32, device=dev)
    fl = torch.floor(pixel)
    ix = fl[:, 0].to(torch.int64)
    iy = fl[:, 1].to(torch.int64)
    a = _fetch(plane, ix, iy)
    b = _fetch(plane, ix, iy + 1)
    c = _fetch(plane, ix + 1, iy)
    d = _fetch(plane, ix + 1, iy + 1)
    wt = pixel - fl
    wx, wy = wt[:, 0], wt[:, 1]
    ac = (a * (one - wx)) + (c * wx)
    bd = (b * (one - wx)) + (d * wx)
    return cutoff < ((ac * (one - wy)) + (bd * wy))


def _ccw(muv):
    """IsCCW in float64 (geometry.h:49-55)."""
    t = muv.double()
    ax = t[:, 2, 0] - t[:, 0, 0]
    ay = t[:, 2, 1] - t[:, 0, 1]
    bx = t[:, 1, 0] - t[:, 0, 0]
    by = t[:, 1, 1] - t[:, 0, 1]
    return ((ax * by) - (ay * bx)) < 0


def coverage(plane: torch.Tensor, muv: torch.Tensor, cutoff: float,
             pairs_per_step: int = 1 << 24):
    """(above, below) int32 coverage counts of micro-triangles muv
    (N, 3, 2) over one fp32 plane, the seed sample included."""
    dev = plane.device
    h, w = plane.shape
    n = muv.shape[0]
    cut = torch.tensor(cutoff, dtype=F32, device=dev)
    size = torch.tensor([float(w), float(h)], dtype=F32, device=dev)
    q = (muv * size) + torch.tensor(-0.5, dtype=F32, device=dev)
    q = torch.where(_ccw(muv)[:, None, None], q, q[:, [2, 1, 0], :])
    lo = q.min(dim=1).values
    hi = q.max(dim=1).values
    x0 = torch.floor(lo[:, 0]).to(torch.int64)
    y0 = torch.floor(lo[:, 1]).to(torch.int64)
    x1 = torch.ceil(hi[:, 0]).to(torch.int64)
    y1 = torch.ceil(hi[:, 1]).to(torch.int64)
    W = int((x1 - x0).max()) if n else 0
    H = int((y1 - y0).max()) if n else 0

    seed = _seed_above(plane, muv[:, 0, :], cut)
    above = seed.to(torch.int32)
    below = (~seed).to(torch.int32)
    zero = torch.zeros((), dtype=F32, device=dev)
    # the edge functions of the over-conservative raster
    edges = []
    for e in range(3):
        f = (e + 1) % 3
        nx = q[:, f, 1] - q[:, e, 1]
        ny = q[:, e, 0] - q[:, f, 0]
        c = -((nx * q[:, e, 0]) + (ny * q[:, e, 1]))
        edges.append((nx, ny, c, torch.where(nx > zero, zero, nx),
                      torch.where(ny > zero, zero, ny)))
    ids, xs, ys = [], [], []
    for dy in range(H):
        for dx in range(W):
            x = x0 + dx
            y = y0 + dy
            ok = (x < x1) & (y < y1)
            sx = x.to(F32)
            sy = y.to(F32)
            for nx, ny, c, bx, by in edges:
                ev = ((nx * sx) + (ny * sy)) + c
                ok = ok & (((ev + bx) + by) < zero)
            sel = torch.nonzero(ok).flatten()
            ids.append(sel)
            xs.append(x[sel])
            ys.append(y[sel])
    if not ids:
        return above, below
    ids = torch.cat(ids)
    xs = torch.cat(xs)
    ys = torch.cat(ys)
    for s in range(0, ids.numel(), pairs_per_step):
        i = ids[s:s + pairs_per_step]
        a, b = _level_line(plane, muv[i], xs[s:s + pairs_per_step],
                           ys[s:s + pairs_per_step], cut)
        above.index_add_(0, i, a)
        below.index_add_(0, i, b)
    return above, below


def states_from_coverage(above, below, promotion: int = 1,
                         cutoff_gt: int = OPAQUE,
                         cutoff_le: int = TRANSPARENT) -> torch.Tensor:
    """GetStateFromCoverage (bake_kernels_cpu.h:25-61) for OC1_4_State:
    uint8 states.  promotion: 0 Nearest, 1 ForceOpaque, 2
    ForceTransparent."""
    def unknown_of(s):
        return {TRANSPARENT: UNKNOWN_TRANSPARENT,
                OPAQUE: UNKNOWN_OPAQUE}.get(s, s)

    if promotion == 1:
        unk = torch.full_like(above, UNKNOWN_OPAQUE)
    elif promotion == 2:
        unk = torch.full_like(above, UNKNOWN_TRANSPARENT)
    else:
        unk = torch.where(above >= below, unknown_of(cutoff_gt),
                          unknown_of(cutoff_le)).to(above.dtype)
    known = torch.where(above == 0, cutoff_le, cutoff_gt).to(above.dtype)
    unknown = (above != 0) & (below != 0)
    return torch.where(unknown, unk, known).to(torch.uint8)


def classify(plane: torch.Tensor, tris: torch.Tensor, level: int,
             cutoff: float, utri_per_step: int = 1 << 21,
             **state_kw) -> torch.Tensor:
    """(T, 4^level) uint8 states of triangles tris (T, 3, 2) fp32, all at
    `level`, over the fp32 plane (h, w)."""
    dev = plane.device
    bary = bary_corners(level, dev)
    m = bary.shape[0]
    out = torch.empty((tris.shape[0], m), dtype=torch.uint8, device=dev)
    per = max(1, utri_per_step // m)
    for s in range(0, tris.shape[0], per):
        t = tris[s:s + per]
        muv = micro_uvs(t, bary).reshape(-1, 3, 2)
        above, below = coverage(plane, muv, cutoff)
        out[s:s + per] = states_from_coverage(above, below,
                                              **state_kw).reshape(-1, m)
    return out
