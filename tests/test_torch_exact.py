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
from test_torch_twophase import _cfg, _tris  # noqa: E402

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
    lambda: _tris(2, seed=3), 5))


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_build_of_kernel_math_matches_twin(case):
    """csrc/exact_math.cuh compiled by g++, looping over blocks and
    slots as the CUDA kernel does, equals the torch twin bit for bit."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from omm_tpu_torch.kernels.build import host_library
    lib = host_library()
    mk_tex, cfg, mk_tris, subdiv = HOST_CASES[case]
    tex, tris = mk_tex(), mk_tris()
    bp, uv_flat, ccw = _port_state(tex, cfg, tris, subdiv)
    for mi in range(tex.mip_count):
        (planeP, bt, ids_slot, uv6, ccw_t), kw = _slot_stream(
            bp, uv_flat, ccw, subdiv, mi, cfg)
        ta, tb = exact.exact_counts_torch(planeP, bt, ids_slot, uv6, ccw_t,
                                          **kw)
        ha = torch.empty_like(ta)
        hb = torch.empty_like(tb)
        Pw, Ph = kw["period"] or (0, 0)
        rc = lib.omm_exact_host(
            planeP.data_ptr(), planeP.shape[0], planeP.shape[1],
            bt.data_ptr(), ids_slot.data_ptr(), ids_slot.shape[0],
            uv6.data_ptr(), ccw_t.data_ptr(), subdiv, kw["pad"], kw["ntx"],
            kw["size"][0], kw["size"][1], Pw, Ph, kw["H"], kw["W"],
            float(np.float32(kw["rcp"][0])), float(np.float32(kw["rcp"][1])),
            float(np.float32(kw["alpha_cutoff"])), ha.data_ptr(),
            hb.data_ptr())
        assert rc == 0
        assert torch.equal(ha, ta) and torch.equal(hb, tb)
        assert ((ta + tb) > 1).any()


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
