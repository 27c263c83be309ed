"""omm_tpu_torch's stage programs against the JAX package's
kernels/twophase.py, stage by stage, on one batch per case.  All
comparisons are exact; the JAX exact stage runs the Pallas kernel in
interpret mode.  The port gets its own texture and configuration,
built from the same numpy planes and enum values (`port_inputs`)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import omm_tpu as omm  # noqa: E402
from omm_tpu import engine, native  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
from omm_tpu_torch import batch, convert, host, planes  # noqa: E402
from omm_tpu_torch import engine as tengine  # noqa: E402
from omm_tpu_torch import types as ttypes  # noqa: E402
from omm_tpu_torch.twophase import stage_d  # noqa: E402

from fixtures import sine_unorm8, standard_circle  # noqa: E402

B = host.B
UO = 3


def _cfg(**over):
    base = dict(addr_mode=omm.TextureAddressMode.Clamp,
                filter=omm.TextureFilterMode.Linear, alpha_cutoff=0.5,
                border_alpha=0.0, fmt=omm.Format.OC1_4_State,
                promotion=omm.UnknownStatePromotion.Nearest,
                cutoff_gt=omm.OpacityState.Opaque,
                cutoff_le=omm.OpacityState.Transparent)
    base.update(over)
    return engine.ResampleConfig(**base)


_ENUMS = dict(addr_mode=ttypes.TextureAddressMode,
              filter=ttypes.TextureFilterMode, fmt=ttypes.Format,
              promotion=ttypes.UnknownStatePromotion,
              cutoff_gt=ttypes.OpacityState, cutoff_le=ttypes.OpacityState)


def port_inputs(tex, cfg):
    """The port's Texture and ResampleConfig for the JAX package's: the
    same numpy planes and the same enum values."""
    ptex = convert.texture(tex.mips, int(tex.format), int(tex.flags),
                           tex.alpha_cutoff)
    vals = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ptex, tengine.ResampleConfig(**{
        k: _ENUMS[k](int(v)) if k in _ENUMS else v for k, v in vals.items()})


def _tris(n, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = rng.rand(2).astype(np.float32) * 0.25
        out.append(np.array([b + [0.05, 0.08], b + [0.12, 0.7],
                             b + [0.72, 0.6]], np.float32))
    return out


def _circle():
    return omm.Texture([standard_circle(128, 128)], omm.TextureFormat.FP32)


def _unorm8_mips():
    m0 = sine_unorm8(64, 64)
    return omm.Texture([m0, m0[::2, ::2].copy()], omm.TextureFormat.UNORM8)


def _partial_items(subdiv):
    M = omm.get_num_micro_triangles(subdiv)
    pre = np.full(M, UO, np.uint8)
    pre[: M // 2] = 0  # resolved by an earlier pass: must be kept
    return [(_tris(1)[0], pre)]


CASES = {
    "circle4": (_circle, _cfg(), lambda sd: [(t, None) for t in _tris(4)],
                5),
    "unorm8_mips": (_unorm8_mips,
                    _cfg(promotion=omm.UnknownStatePromotion.ForceOpaque),
                    lambda sd: [(t, None) for t in _tris(2, seed=3)], 4),
    "partial": (lambda: omm.Texture([standard_circle(64, 64)],
                                    omm.TextureFormat.FP32),
                _cfg(), _partial_items, 5),
}


def _all_active(items):
    return all(st is None or int(st.min()) == UO for _, st in items)


@pytest.fixture(scope="module", params=sorted(CASES))
def staged(request):
    """One batch through the JAX stages and through the port's."""
    mk_tex, cfg, mk_items, subdiv = CASES[request.param]
    tex, items = mk_tex(), mk_items(subdiv)
    T = len(items)
    M = omm.get_num_micro_triangles(subdiv)
    all_active = _all_active(items)

    ctx = tp._BatchCtx(tex, cfg, items, subdiv, list(range(T)), [None] * T,
                       all_active=all_active)
    m = len(ctx.levels) - 1
    K_cap = T * M
    jres = ctx.stage_ab([T * 4 ** ctx.levels[i] for i in range(m)], K_cap)
    meta = np.asarray(jres[4])
    K = int(meta[m])
    counts = []
    for mi in range(tex.mip_count):
        a, b = ctx.stage_c(mi, jres, K_cap, int(meta[m + 2 + mi]) // B)
        counts.append((a, b))
    jpacked = np.asarray(tp._stageD(
        jres[0], jres[1], jres[2], jres[3], tuple(counts), subdiv=subdiv,
        levels=ctx.levels, fmt=cfg.fmt, promotion=cfg.promotion,
        cutoff_gt=cfg.cutoff_gt, cutoff_le=cfg.cutoff_le))

    uvs = [t for t, _ in items]
    ptex, pcfg = port_inputs(tex, cfg)
    pre = batch.precompute(ptex, uvs, subdiv,
                           host._group_level(ptex, uvs, subdiv))
    bp = batch.batch_planes(ptex, pcfg, pre, "cpu")
    uv_flat, ccw = batch.item_tables(np.stack(uvs), "cpu")
    active = None
    if not all_active:
        active = torch.from_numpy(np.stack(
            [np.ones(M, bool) if st is None else st == UO
             for _, st in items]))
    pres = batch.run_stage_ab(bp, uv_flat, active, subdiv, all_active)
    pcounts = [batch.run_stage_c(bp, pres, mi, uv_flat, ccw, subdiv, pcfg)
               for mi in range(ptex.mip_count)]
    ppacked = stage_d(pres["sides"], pres["nodes"], pres["ids"], pcounts,
                      T=T, subdiv=subdiv, levels=bp["levels"], fmt=pcfg.fmt,
                      promotion=pcfg.promotion, cutoff_gt=pcfg.cutoff_gt,
                      cutoff_le=pcfg.cutoff_le).numpy()
    return dict(tex=tex, cfg=cfg, items=items, subdiv=subdiv, M=M, T=T,
                ctx=ctx, jres=jres, meta=meta, m=m, K=K, counts=counts,
                jpacked=jpacked, bp=bp, pres=pres, pcounts=pcounts,
                ppacked=ppacked)


def test_class_planes_match(staged):
    ctx, bp = staged["ctx"], staged["bp"]
    assert tuple(bp["levels"]) == tuple(ctx.levels)
    for li in range(len(ctx.levels)):
        for mi in range(staged["tex"].mip_count):
            want = np.asarray(ctx.cls_lv[li][mi])
            got = bp["cls_lv"][li][mi].numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_stage_ab_matches(staged):
    jres, pres, m = staged["jres"], staged["pres"], staged["m"]
    sides, nodes, ids, kvalid, meta, slots = jres
    assert pres["Cs"] == [int(c) for c in staged["meta"][:m]]
    assert pres["K"] == staged["K"] > 0
    assert pres["padMs"] == [int(x) for x in staged["meta"][m + 2:]]
    assert len(pres["sides"]) == len(sides)
    for g, w in zip(pres["sides"], sides):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w[:g.shape[0]])
    for g, (w, _) in zip(pres["nodes"], nodes):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w[:g.shape[0]])
    K = staged["K"]
    assert np.array_equal(pres["ids"].numpy(), np.asarray(ids)[:K])
    for g, (w, _) in zip(pres["slots"], slots):
        assert np.array_equal(g.numpy(), np.asarray(w)[:K])


def test_stage_c_matches(staged):
    K = staged["K"]
    for (ga, gb), (wa, wb) in zip(staged["pcounts"], staged["counts"]):
        assert np.array_equal(ga.numpy(), np.asarray(wa)[:K])
        assert np.array_equal(gb.numpy(), np.asarray(wb)[:K])


def test_stage_d_matches(staged):
    M = staged["M"]
    for t in range(staged["T"]):
        want = tp._unpack_states(staged["jpacked"][t], M)
        got = native.unpack_2bit_seq(staged["ppacked"][t], M)
        assert np.array_equal(got, want)


def test_class_plane_direct():
    """class_plane against _class_plane on odd window sizes, values at
    the cutoff's margin and a cutoff that is not a float32 value."""
    rng = np.random.RandomState(11)
    plane = (np.float32(0.3)
             + (rng.rand(90, 77).astype(np.float32) - np.float32(0.5))
             * np.float32(1e-3))
    plane[::7] = np.float32(5.0)
    for Hb, Wb in ((1, 1), (3, 8), (12, 5)):
        for cutoff in (0.3, 0.5):
            want = np.asarray(tp._class_plane(
                jnp.asarray(plane), Hb, Wb, cutoff, tp.PHASE1_MARGIN))
            got = planes.class_plane(torch.from_numpy(plane), Hb, Wb,
                                     cutoff, planes.PHASE1_MARGIN).numpy()
            assert np.array_equal(got, want)
    assert planes.PHASE1_MARGIN == tp.PHASE1_MARGIN
