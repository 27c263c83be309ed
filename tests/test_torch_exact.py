"""The exact classification stage: omm_tpu_torch's stage_c_mip (plain
twin) against the JAX package's _stageC_mip (Pallas kernel, interpret
mode on the CPU), the twin's slot geometry against
pallas_classify.derive_slot_geometry, and the g++ build of the CUDA
kernel's per-slot math (csrc/exact_math.cuh) against the twin.  All
comparisons are exact.  The kernel itself is tested on the card by
tests/test_torch_cuda.py."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import omm_tpu as omm  # noqa: E402
from omm_tpu.kernels import pallas_classify as pk  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
from omm_tpu_torch import batch, host  # noqa: E402
from omm_tpu_torch.kernels import exact  # noqa: E402

from fixtures import sine_fp32, sine_unorm8, standard_circle  # noqa: E402
from test_torch_twophase import _cfg, _tris, port_inputs  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

B = host.B


_PERIODIC_TRI = np.array([[0.1, -0.2], [0.2, 1.1], [1.3, 0.7]], np.float32)

CASES = {
    "clamp": (lambda: omm.Texture([standard_circle(64, 64)],
                                  omm.TextureFormat.FP32),
              _cfg(), lambda: _tris(2), 5),
    "wrap": (lambda: omm.Texture([sine_fp32(64, 64)],
                                 omm.TextureFormat.FP32),
             _cfg(addr_mode=omm.TextureAddressMode.Wrap),
             lambda: [_PERIODIC_TRI], 5),
    "mirror": (lambda: omm.Texture([sine_fp32(64, 64)],
                                   omm.TextureFormat.FP32),
               _cfg(addr_mode=omm.TextureAddressMode.Mirror),
               lambda: [_PERIODIC_TRI[::-1].copy()], 5),
}


def _jax_slot_stream(tex, cfg, tris, subdiv):
    """JAX _stageAB at capacities no batch can overflow, then every
    mip's _stageC_mip; returns the ctx, K and per mip (ids, slot, padM,
    above, below), cut to the K survivors."""
    T = len(tris)
    M = omm.get_num_micro_triangles(subdiv)
    ctx = tp._BatchCtx(tex, cfg, [(t, None) for t in tris], subdiv,
                       list(range(T)), [None] * T, all_active=True)
    m = len(ctx.levels) - 1
    K_cap = T * M
    res = ctx.stage_ab([T * 4 ** ctx.levels[i] for i in range(m)], K_cap)
    meta = np.asarray(res[4])
    K = int(meta[m])
    assert K > 0 and int(meta[m + 1]) == 0
    ids = np.asarray(res[2])[:K]
    out = []
    for mi in range(tex.mip_count):
        padM = int(meta[m + 2 + mi])
        a, b = ctx.stage_c(mi, res, K_cap, padM // B)
        out.append((ids, np.asarray(res[5][mi][0])[:K], padM,
                    np.asarray(a)[:K], np.asarray(b)[:K]))
    return ctx, K, out


def _port_state(tex, cfg, tris, subdiv, device="cpu"):
    tex, cfg = port_inputs(tex, cfg)
    lg = host._group_level(tex, tris, subdiv)
    pre = batch.precompute(tex, tris, subdiv, lg)
    bp = batch.batch_planes(tex, cfg, pre, device)
    uv_flat, ccw = batch.item_tables(np.stack(tris), device)
    return bp, uv_flat, ccw


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_c_mip_matches_jax(case):
    mk_tex, cfg, mk_tris, subdiv = CASES[case]
    tex, tris = mk_tex(), mk_tris()
    ctx, K, jx = _jax_slot_stream(tex, cfg, tris, subdiv)
    bp, uv_flat, ccw = _port_state(tex, cfg, tris, subdiv)
    assert list(bp["levels"]) == list(ctx.levels)
    for mi, (ids, slot, padM, a, b) in enumerate(jx):
        w, h = bp["mips"][mi]
        Hb, Wb = bp["HW"][mi]
        assert (bp["pads"][mi], bp["ntxs"][mi]) == (ctx.pads[mi],
                                                    ctx.ntxs[mi])
        ga, gb = exact_stage(bp, mi, uv_flat, ccw, ids, slot, padM, subdiv,
                             cfg)
        assert np.array_equal(ga.numpy(), a)
        assert np.array_equal(gb.numpy(), b)
        assert (a + b > 1).any()  # some survivors straddle the cutoff


def exact_stage(bp, mi, uv_flat, ccw, ids, slot, padM, subdiv, cfg):
    from omm_tpu_torch.twophase import stage_c_mip
    w, h = bp["mips"][mi]
    Hb, Wb = bp["HW"][mi]
    return stage_c_mip(
        bp["planes"][mi], uv_flat, ccw,
        torch.from_numpy(ids.astype(np.int64)),
        torch.from_numpy(slot.astype(np.int64)), padM, subdiv=subdiv, w=w,
        h=h, pad=bp["pads"][mi], ntx=bp["ntxs"][mi], H=Hb, W=Wb,
        rcp=bp["rcps"][mi], alpha_cutoff=float(cfg.alpha_cutoff),
        period=bp["periods"][mi])


def _slot_stream(bp, uv_flat, ccw, subdiv, mi, cfg):
    """The port's own (block_tile, ids_slot) for mip mi, captured at
    the exact stage's entry."""
    res = batch.run_stage_ab(bp, uv_flat, None, subdiv, True)
    seen = {}
    orig = exact.exact_counts

    def spy(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return orig(*args, **kw)

    import omm_tpu_torch.twophase as ttp
    ttp.exact_counts = spy
    try:
        batch.run_stage_c(bp, res, mi, uv_flat, ccw, subdiv, cfg)
    finally:
        ttp.exact_counts = orig
    kw = {k: v for k, v in seen["kw"].items() if k != "exact"}
    return seen["args"], kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_slot_geometry_matches_jax(case):
    mk_tex, cfg, mk_tris, subdiv = CASES[case]
    tex, tris = mk_tex(), mk_tris()
    bp, uv_flat, ccw = _port_state(tex, cfg, tris, subdiv)
    (planeP, bt, ids_slot, uv6, ccw_t), kw = _slot_stream(
        bp, uv_flat, ccw, subdiv, 0, cfg)
    ids = ids_slot.reshape(-1)
    bts = bt.repeat_interleave(B)
    got = exact.derive_slot_geometry(
        ids, uv6, ccw_t, bts, subdiv=subdiv, pad=kw["pad"], ntx=kw["ntx"],
        size=kw["size"], period=kw["period"])
    want = pk.derive_slot_geometry(
        jnp.asarray(ids.numpy())[None], jnp.asarray(uv6.numpy().T),
        jnp.asarray(ccw_t.numpy().astype(np.float32))[None],
        jnp.asarray(bts.numpy())[None], jnp.zeros((), jnp.int32),
        subdiv=subdiv, pad=kw["pad"], ntx=kw["ntx"], size=kw["size"],
        period=kw["period"])
    valid = ids.numpy() >= 0
    for rows_g, rows_w in ((got[0], want[0]), (got[1], want[1])):
        for g, w in zip(rows_g, rows_w):
            gv = g.numpy()[valid].view(np.int32)
            wv = np.asarray(w)[0][valid].view(np.int32)
            assert np.array_equal(gv, wv)
    for g, w in zip(got[2:], want[2:]):
        assert np.array_equal(g.numpy()[valid],
                              np.asarray(w)[0][valid].astype(g.numpy().dtype))


HOST_CASES = dict(CASES, unorm8_2mip=(
    lambda: omm.Texture([sine_unorm8(64, 64), sine_unorm8(64, 64)[::2, ::2]],
                        omm.TextureFormat.UNORM8),
    _cfg(promotion=omm.UnknownStatePromotion.ForceOpaque),
    lambda: _tris(2, seed=3), 5), wide_window=(
    lambda: omm.Texture([standard_circle(256, 256)], omm.TextureFormat.FP32),
    _cfg(), lambda: _tris(2, seed=4), 4))


def _host_counts(lib, args, kw):
    """The g++ build's (above, below) for one slot stream."""
    planeP, bt, ids_slot, uv6, ccw_t = args
    ha = torch.empty(ids_slot.shape, dtype=torch.int32)
    hb = torch.empty_like(ha)
    Pw, Ph = kw["period"] or (0, 0)
    rc = lib.omm_exact_host(
        planeP.data_ptr(), planeP.shape[0], planeP.shape[1],
        bt.data_ptr(), ids_slot.data_ptr(), ids_slot.shape[0],
        uv6.data_ptr(), ccw_t.data_ptr(), kw["subdiv"], kw["pad"], kw["ntx"],
        kw["size"][0], kw["size"][1], Pw, Ph, kw["H"], kw["W"],
        float(np.float32(kw["rcp"][0])), float(np.float32(kw["rcp"][1])),
        float(np.float32(kw["alpha_cutoff"])), ha.data_ptr(),
        hb.data_ptr())
    assert rc == 0
    return ha, hb


def _host_library():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from omm_tpu_torch.kernels.build import host_library
    return host_library()


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_build_of_kernel_math_matches_twin(case):
    """csrc/exact_math.cuh compiled by g++, walking each block in the
    CUDA kernel's order (geometry, mask compaction, corner tests, edge
    tests, seeds), equals the torch twin bit for bit."""
    lib = _host_library()
    mk_tex, cfg, mk_tris, subdiv = HOST_CASES[case]
    tex, tris = mk_tex(), mk_tris()
    bp, uv_flat, ccw = _port_state(tex, cfg, tris, subdiv)
    for mi in range(tex.mip_count):
        args, kw = _slot_stream(bp, uv_flat, ccw, subdiv, mi, cfg)
        if case == "wide_window":  # more pairs per slot than a chunk
            assert kw["H"] * kw["W"] > 32
        ta, tb = exact.exact_counts_torch(*args, **kw)
        ha, hb = _host_counts(lib, args, kw)
        assert torch.equal(ha, ta) and torch.equal(hb, tb)
        assert ((ta + tb) > 1).any()


def test_host_build_empty_blocks_and_tile_runs():
    """Blocks of empty slots (first, middle, last) and runs of blocks
    that share a tile and switch tiles: the g++ build equals the twin,
    and empty slots count 0."""
    lib = _host_library()
    tex = omm.Texture([standard_circle(128, 128)], omm.TextureFormat.FP32)
    cfg, subdiv = _cfg(), 6
    bp, uv_flat, ccw = _port_state(tex, cfg, _tris(3, seed=5), subdiv)
    (planeP, bt, ids_slot, uv6, ccw_t), kw = _slot_stream(
        bp, uv_flat, ccw, subdiv, 0, cfg)
    btn = bt.numpy()
    assert (btn[1:] == btn[:-1]).any() and (btn[1:] != btn[:-1]).any()
    empty = torch.full((1, B), -1, dtype=torch.int32)
    h = ids_slot.shape[0] // 2
    ids2 = torch.cat([empty, ids_slot[:h], empty, ids_slot[h:], empty])
    bt2 = torch.cat([torch.tensor([0], dtype=torch.int32), bt[:h],
                     bt[h - 1:h], bt[h:], torch.tensor([5],
                                                       dtype=torch.int32)])
    args = (planeP, bt2.contiguous(), ids2.contiguous(), uv6, ccw_t)
    ta, tb = exact.exact_counts_torch(*args, **kw)
    ha, hb = _host_counts(lib, args, kw)
    assert torch.equal(ha, ta) and torch.equal(hb, tb)
    for r in (0, h + 1, ids2.shape[0] - 1):
        assert not ta[r].any() and not tb[r].any()
    assert ((ta + tb) > 1).any()


def _brute_work(args, kw):
    """exact_work's counts by a scalar walk over every slot and window
    texel in np.float32, stopping where the kernel's loops stop."""
    planeP, bt, ids_slot, uv6, ccw = args
    f = np.float32
    H, W = kw["H"], kw["W"]
    TSA = exact.TILE + max(H, W) + 2
    plane = planeP.numpy()
    Hp, Wp = plane.shape
    ids = ids_slot.reshape(-1)
    bts = bt.repeat_interleave(B)
    g = exact.derive_slot_geometry(ids, uv6, ccw, bts, subdiv=kw["subdiv"],
                                   pad=kw["pad"], ntx=kw["ntx"],
                                   size=kw["size"], period=kw["period"])
    muv = [r.numpy() for r in g[0]]
    qn = [r.numpy() for r in g[1]]
    x0, y0, x1, y1, ox, oy = (t.numpy() for t in g[2:8])
    val = g[10].numpy()
    sizef = (f(kw["size"][0]), f(kw["size"][1]))
    inv = (f(kw["rcp"][0]), f(kw["rcp"][1]))
    cut = f(kw["alpha_cutoff"])
    out = dict.fromkeys(("slots", "window_texels", "mask_edges", "covered",
                         "level_line", "edge_tests", "hyperbola", "roots"), 0)
    read = set()

    def zero(v, e):
        return v < f(e) and v > -f(e)

    def length(dx, dy):
        return np.sqrt(f(dx * dx + dy * dy))

    def point_in(t, px, py):
        p0x, p0y, p1x, p1y, p2x, p2y = t
        s_ = (p0x - p2x) * (py - p2y) - (p0y - p2y) * (px - p2x)
        u_ = (p1x - p0x) * (py - p0y) - (p1y - p0y) * (px - p0x)
        if (s_ < 0) != (u_ < 0) and s_ != 0 and u_ != 0:
            return False
        d_ = (p2x - p1x) * (py - p1y) - (p2y - p1y) * (px - p1x)
        return d_ == 0 or (d_ < 0) == (s_ + u_ <= 0)

    def edge(p0x, p0y, p1x, p1y, ha, hb, hc, hd):
        """(hit, hyperbola branch, real roots)."""
        if p0x > p1x:
            p0x, p0y, p1x, p1y = p1x, p1y, p0x, p0y
        elen = length(p1x - p0x, p1y - p0y)

        def on(px, py):
            if not (px >= 0 and px <= 1 and py >= 0 and py <= 1):
                return False
            return zero(length(px - p0x, py - p0y)
                        + length(px - p1x, py - p1y) - elen, 1e-5)
        kd = p1x - p0x
        if zero(kd, 1e-6):
            c0v = hd * p0x + hc
            if zero(c0v, 1e-6):
                return False, False, False
            return on(p0x, -(ha + hb * p0x) / c0v), False, False
        k = (p1y - p0y) / kd
        m = p1y - p1x * k
        c0, c1, c2 = hd * k, hc * k + hd * m + hb, ha + hc * m
        if zero(c0, 1e-6):
            if zero(c1, 1e-6):
                return False, False, False
            lx = -c2 / c1
            return on(lx, k * lx + m), False, False
        inner = c1 * c1 - (f(4) * c0) * c2
        if not inner > 0:
            return False, True, False
        root = np.sqrt(inner)
        ax = f(0.5) * (-c1 + root) / c0
        bx = f(0.5) * (-c1 - root) / c0
        return on(ax, k * ax + m) or on(bx, k * bx + m), True, True

    for i in np.flatnonzero(val):
        out["slots"] += 1
        yb = int(bts[i]) // kw["ntx"] * exact.TILE
        xb = int(bts[i]) % kw["ntx"] * exact.TILE

        def fetch(ry, rx):
            gy, gx = yb + ry, xb + rx
            if 0 <= ry < TSA and 0 <= rx < TSA and gy < Hp and gx < Wp:
                read.add((gy, gx))
                return plane[gy, gx]
            return f(0)
        for r in range(H + 2):  # the window the slot reads
            for c in range(W + 2):
                fetch(oy[i] + r, ox[i] + c)
        tri = [m[i] for m in muv]
        for dy in range(H):
            for dx in range(W):
                out["window_texels"] += 1
                px, py = x0[i] + dx, y0[i] + dy
                inn = px < x1[i] and py < y1[i]
                for e in range(3):
                    if not inn:
                        break
                    out["mask_edges"] += 1
                    n_ = (e + 1) % 3
                    nx = qn[2 * n_ + 1][i] - qn[2 * e + 1][i]
                    ny = qn[2 * e][i] - qn[2 * n_][i]
                    cc = -(nx * qn[2 * e][i] + ny * qn[2 * e + 1][i])
                    ev = (nx * f(px) + ny * f(py)) + cc
                    inn = (ev + min(nx, f(0)) + min(ny, f(0))) < 0
                if not inn:
                    continue
                out["covered"] += 1
                q = [fetch(oy[i] + dy + a, ox[i] + dx + b)
                     for a, b in ((0, 0), (1, 0), (1, 1), (0, 1))]
                pfx, pfy = f(px) + f(0.5), f(py) + f(0.5)
                ix, iy = pfx * inv[0], pfy * inv[1]
                ins = [point_in(tri, ix, iy), point_in(tri, ix, iy + inv[1]),
                       point_in(tri, ix + inv[0], iy + inv[1]),
                       point_in(tri, ix + inv[0], iy)]
                op = [cut < v for v in q]
                if any(a and o for a, o in zip(ins, op)) and \
                        any(a and not o for a, o in zip(ins, op)):
                    continue
                b_, c_ = q[3] - q[0], q[1] - q[0]
                d_ = q[0] + q[2] - q[1] - q[3]
                if zero(b_, 1e-6) and zero(c_, 1e-6) and zero(d_, 1e-6):
                    continue
                out["level_line"] += 1
                for e in range(3):
                    n_ = (e + 1) % 3
                    hit, hyp, roots = edge(
                        sizef[0] * tri[2 * e] - pfx,
                        sizef[1] * tri[2 * e + 1] - pfy,
                        sizef[0] * tri[2 * n_] - pfx,
                        sizef[1] * tri[2 * n_ + 1] - pfy,
                        q[0] - cut, b_, c_, d_)
                    out["edge_tests"] += 1
                    out["hyperbola"] += hyp
                    out["roots"] += roots
                    if hit:
                        break
    out["texels_read"] = len(read)
    return out


@pytest.mark.parametrize("case", ["clamp", "wide_window", "wrap"])
def test_exact_work_matches_brute_force(case):
    """exact_work's counts on a small stream equal a scalar walk of the
    kernel's loops; its ops and bytes follow from them."""
    mk_tex, cfg, mk_tris, subdiv = HOST_CASES[case]
    tex, tris = mk_tex(), mk_tris()
    bp, uv_flat, ccw = _port_state(tex, cfg, tris[:1], subdiv)
    args, kw = _slot_stream(bp, uv_flat, ccw, subdiv, 0, cfg)
    args = (args[0], args[1][:3].contiguous(), args[2][:3].contiguous(),
            *args[3:])
    with np.errstate(all="ignore"):
        want = _brute_work(args, kw)
    got = exact.exact_work(*args, **kw)
    assert {k: got[k] for k in want} == want
    assert want["edge_tests"] > 0 and want["covered"] > want["level_line"]
    assert got["ops"] == sum(exact.OPS[k] * got[k] for k in exact.OPS)
    nblk = args[2].shape[0]
    assert got["bytes"] == (3 * nblk * B + nblk + 7 * args[3].shape[0]
                            + got["texels_read"]) * 4
    ms, by = exact.bound(got)
    assert ms > 0 and by in ("operations", "bytes")


def test_wrapper_checks_and_cpu_route():
    """CPU tensors take the twin; a wrong engine name or a malformed
    argument raises instead of falling back."""
    plane = torch.zeros((200, 200))
    bt = torch.zeros(1, dtype=torch.int32)
    ids = torch.full((1, B), -1, dtype=torch.int32)
    uv6 = torch.zeros((1, 6))
    ccw = torch.zeros(1, dtype=torch.int32)
    kw = dict(subdiv=3, pad=70, ntx=4, size=(64, 64), period=None, H=4,
              W=4, rcp=(1 / 64, 1 / 64), alpha_cutoff=0.5)
    before = exact.LAUNCHES
    a, b = exact.exact_counts(plane, bt, ids, uv6, ccw, **kw)
    assert a.shape == (1, B) and not a.any() and not b.any()
    assert exact.LAUNCHES == before
    with pytest.raises(ValueError):
        exact.exact_counts(plane, bt, ids, uv6, ccw, exact="cuda", **kw)
    with pytest.raises(ValueError):
        exact.exact_counts(plane, bt, ids.to(torch.int64), uv6, ccw, **kw)
    with pytest.raises(ValueError):
        exact.exact_counts(plane, bt, ids, uv6, ccw,
                           **dict(kw, H=70, W=4))


def test_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch):
    """Where <package parent>/build/omm_tpu_torch/ cannot be made (an
    installed package's site-packages; here a path under a plain file),
    the host build goes into ~/.cache/omm_tpu_torch/ and loads from
    there; a writable BUILD_DIR is used as it is."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from omm_tpu_torch.kernels import build
    blocker = tmp_path / "site-packages"
    blocker.write_text("a file, not a directory")
    monkeypatch.setattr(build, "BUILD_DIR", blocker / "build" / "omm")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(build, "_LIBS", {})
    cache = tmp_path / "home" / ".cache" / "omm_tpu_torch"
    assert build.build_dir() == cache
    lib = build.host_library()
    built = list(cache.glob("libomm_exact_host_*.so"))
    assert len(built) == 1 and lib._name == str(built[0])
    writable = tmp_path / "checkout" / "build" / "omm_tpu_torch"
    monkeypatch.setattr(build, "BUILD_DIR", writable)
    assert build.build_dir() == writable and writable.is_dir()
