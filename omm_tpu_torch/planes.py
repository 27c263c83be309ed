"""Texture state on the device: padded planes and class planes.

The padded plane is `host.padded_plane` as an fp32 tensor; the exact
stage reads it directly (a read past its edge reads 0.0).  A class plane
classifies the texel window anchored at each texel of the padded plane
(+1 strictly above the cutoff, -1 strictly below, 0 mixed); it is the
counterpart of `twophase._class_plane`.

Both are cached per texture and device under `texture._omm_torch_cache`,
keyed like the JAX package's `_omm_dev_cache` entries, so that
`convert.cache_from_numpy` can install the JAX package's planes.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from . import host
from .levelline import f32
from .texture import Texture

#: Relative margin below which the window test refuses to resolve
#: (twophase.PHASE1_MARGIN).
PHASE1_MARGIN = f32(2.0 ** -14)

_CACHE_ATTR = "_omm_torch_cache"
#: makes the creation of a texture's cache one step for threads (mesh
#: slots share the texture)
_CACHE_LOCK = threading.Lock()


def check_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a CUDA device raises
    (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("omm_tpu_torch: no CUDA device for device="
                           f"{str(device)!r}; pass device='cpu' to run the "
                           "plain torch path on the CPU")
    return device


def tex_cache(texture: Texture, device) -> dict:
    """The port's per-texture cache for one device (one dict per texture
    and device, whichever thread asks first)."""
    with _CACHE_LOCK:
        c = texture.__dict__.get(_CACHE_ATTR)
        if c is None:
            c = {}
            setattr(texture, _CACHE_ATTR, c)
        return c.setdefault(str(torch.device(device)), {})


def drop_cache(texture: Texture) -> None:
    """Drop every device's cached planes of `texture` (under the lock
    that creates the cache: mesh slots share a texture)."""
    with _CACHE_LOCK:
        c = texture.__dict__.get(_CACHE_ATTR)
        if c is not None:
            c.clear()


def plane_key(mip, addr_mode, pad, border_alpha, period):
    return ("tiles", mip, int(addr_mode), pad, pad, float(border_alpha),
            period)


def cls_key(mip, addr_mode, pad, Hb, Wb, cutoff, margin, border_alpha,
            period):
    return ("cls", mip, int(addr_mode), pad, pad, Hb, Wb, cutoff, margin,
            float(border_alpha), period)


def padded_plane(texture: Texture, mip: int, addr_mode, pad: int,
                 border_alpha: float, period, device) -> torch.Tensor:
    """Cached (h+2*pad, w+2*pad) fp32 padded plane on `device` (one
    address-mode period plus the apron in periodic modes)."""
    c = tex_cache(texture, device)
    key = plane_key(mip, addr_mode, pad, border_alpha, period)
    t = c.get(key)
    if t is None:
        planeH = host.padded_plane(texture, mip, pad, addr_mode,
                                   border_alpha, period=period)
        # threads that raced here all get the first one stored
        t = c.setdefault(key, torch.from_numpy(planeH).to(device))
    return t


def class_plane(planeP: torch.Tensor, Hb: int, Wb: int, cutoff: float,
                margin: float) -> torch.Tensor:
    """int8 plane: the value at (y, x) classifies the (Hb+2, Wb+2) window
    anchored there.  Separable max pools are exact on fp32, and the min
    is taken as -max(-x), which is exact too."""
    x = planeP[None, None]
    wmax = F.max_pool2d(x, (Hb + 2, 1), stride=1)
    wmax = F.max_pool2d(wmax, (1, Wb + 2), stride=1)[0, 0]
    wmin = F.max_pool2d(-x, (Hb + 2, 1), stride=1)
    wmin = -F.max_pool2d(wmin, (1, Wb + 2), stride=1)[0, 0]
    cut = f32(cutoff)
    mrg = f32(margin)
    scale = torch.clamp_min(torch.maximum(wmin.abs(), wmax.abs()), 1.0)
    delta = scale * mrg
    one = torch.ones_like(wmin, dtype=torch.int8)
    return torch.where(wmin > cut + delta, one,
                       torch.where(wmax < cut - delta, -one,
                                   torch.zeros_like(one)))


def class_plane_cached(texture: Texture, mip: int, addr_mode, pad: int,
                       Hb: int, Wb: int, cutoff: float, border_alpha: float,
                       period, device) -> torch.Tensor:
    """Cached class plane for one window class (textures are reused
    across batches; the window filters run once per class)."""
    c = tex_cache(texture, device)
    key = cls_key(mip, addr_mode, pad, Hb, Wb, cutoff, PHASE1_MARGIN,
                  border_alpha, period)
    t = c.get(key)
    if t is None:
        planeP = padded_plane(texture, mip, addr_mode, pad, border_alpha,
                              period, device)
        t = c.setdefault(key, class_plane(planeP, Hb, Wb, cutoff,
                                          PHASE1_MARGIN))
    return t
