"""omm_tpu_torch.host: each numpy copy equals its original in the JAX
package (kernels/twophase.py, kernels/mxu_classify.py), exactly.  The
port's copies get the port's own textures and configurations, built from
the same numpy planes and enum values."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
from omm_tpu import engine  # noqa: E402
from omm_tpu.kernels import mxu_classify as mx  # noqa: E402
from omm_tpu.kernels import twophase as tp  # noqa: E402
from omm_tpu_torch import host  # noqa: E402

from test_torch_twophase import port_inputs  # noqa: E402

MODES = [omm.TextureAddressMode.Wrap, omm.TextureAddressMode.Mirror,
         omm.TextureAddressMode.Clamp, omm.TextureAddressMode.Border,
         omm.TextureAddressMode.MirrorOnce]


def _tex(w, h, seed=0, mips=1):
    rng = np.random.RandomState(seed)
    planes = [rng.rand(h >> k, w >> k).astype(np.float32)
              for k in range(mips)]
    return omm.Texture(planes, omm.TextureFormat.FP32)


def _cfg(mode, **over):
    base = dict(addr_mode=mode, filter=omm.TextureFilterMode.Linear,
                alpha_cutoff=0.5, border_alpha=0.25,
                fmt=omm.Format.OC1_4_State,
                promotion=omm.UnknownStatePromotion.Nearest,
                cutoff_gt=omm.OpacityState.Opaque,
                cutoff_le=omm.OpacityState.Transparent)
    base.update(over)
    return engine.ResampleConfig(**base)


def _tris(n, seed, lo=-0.3, hi=1.3, scale=1.0):
    rng = np.random.RandomState(seed)
    base = rng.uniform(lo, hi, size=(n, 1, 2))
    d = rng.uniform(-0.4, 0.4, size=(n, 3, 2)) * scale
    return (base + d).astype(np.float32)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("wh", [(32, 32), (24, 40)])
def test_padded_plane(mode, wh):
    tex = _tex(*wh, seed=1)
    for pad in (3, 70):
        for period in (None, tp._period_for(tex, mode, 0)):
            want = mx.padded_plane(tex, 0, pad, mode, 0.25, period=period)
            got = host.padded_plane(port_inputs(tex, _cfg(mode))[0], 0, pad,
                                    mode, 0.25, period=period)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_period_for(mode):
    tex = _tex(24, 40, mips=2)
    ptex, pcfg = port_inputs(tex, _cfg(mode))
    for mip in range(2):
        assert host._period_for(ptex, pcfg.addr_mode, mip) == \
            tp._period_for(tex, mode, mip)


def test_span_windows_and_levels():
    tex = _tex(64, 48, mips=2)
    ptex = port_inputs(tex, _cfg(omm.TextureAddressMode.Clamp))[0]
    uv = _tris(40, 3, scale=2.0)
    for level in range(0, 9):
        for mip in range(2):
            g = host._span_windows(ptex, uv, level, mip)
            w = tp._span_windows(tex, uv, level, mip)
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
            assert host._span_window(ptex, uv[0], level, mip) == \
                tp._span_window(tex, uv[0], level, mip)
    for subdiv in range(2, 10):
        for k in (1, 5, 40):
            tris = list(uv[:k])
            lg = host._group_level(ptex, tris, subdiv)
            assert lg == tp._group_level(tex, tris, subdiv)
            assert host._descend_levels(ptex, tris, subdiv, lg) == \
                tp._descend_levels(tex, tris, subdiv, lg)
    assert host._group_level(ptex, [], 5) == tp._group_level(tex, [], 5)


def test_skip_final_p():
    for levels in [(2, 4, 6), (3, 5, 6), (4, 5), (5,), (1, 3, 5, 7, 8)]:
        for all_active in (False, True):
            assert host._skip_final_p(levels, all_active) == \
                tp._skip_final_p(levels, all_active)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("wh", [(64, 64), (48, 80)])
def test_fast_path_mask_and_ok(mode, wh):
    """Covers negative coordinates under non-pow2 Wrap, Border's seed
    footprint check, slivers and degenerate triangles."""
    tex = _tex(*wh, seed=2, mips=2)
    uv = np.concatenate([
        _tris(24, 5),                                   # straddling edges
        _tris(8, 6, lo=0.2, hi=0.8, scale=0.1),         # small, inside
        np.array([[[0.1, 0.1], [0.4, 0.4], [0.7, 0.7]],  # degenerate
                  [[0.1, 0.1], [0.9, 0.1000001], [0.5, 0.1]],  # sliver
                  [[-0.2, -0.3], [-0.1, 0.2], [0.3, -0.1]]],   # negative
                 np.float32)])
    for subdiv in (1, 3, 5):
        for cfg in (_cfg(mode),
                    _cfg(mode, filter=omm.TextureFilterMode.Nearest),
                    _cfg(mode, disable_level_line=True)):
            lg = tp._group_level(tex, list(uv), subdiv)
            ptex, pcfg = port_inputs(tex, cfg)
            got = host._fast_path_mask(ptex, pcfg, uv, subdiv, lg)
            want = tp._fast_path_mask(tex, cfg, uv, subdiv, lg)
            assert np.array_equal(got, want)
            for k in range(0, len(uv), 5):
                assert host._fast_path_ok(ptex, pcfg, uv[k], subdiv, lg) == \
                    tp._fast_path_ok(tex, cfg, uv[k], subdiv, lg)
