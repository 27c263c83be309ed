"""State carried across from the JAX package.

The JAX package caches each texture's device planes in
`texture._omm_dev_cache`: the padded plane under a ("tiles", ...) key and
the class planes under ("cls", ...) keys.  The port keys its own cache
(`planes.tex_cache`) the same way, so those planes, taken to numpy with
`np.asarray`, install as the port's tensors and both packages then
compute on identical state.
"""
from __future__ import annotations

import numpy as np
import torch

from omm_tpu.texture import Texture

from .planes import tex_cache

_DTYPES = {"tiles": np.float32, "cls": np.int8}


def cache_from_numpy(texture: Texture, entries: dict, device) -> int:
    """Install `entries` ({JAX cache key: numpy plane}) as the port's
    planes of `texture` on `device`.  A "tiles" entry is the padded
    plane (the first element of the JAX cache value), a "cls" entry a
    class plane.  Returns the number of planes installed."""
    c = tex_cache(texture, device)
    for key, arr in entries.items():
        kind = key[0]
        if kind not in _DTYPES:
            raise ValueError(f"unknown cache entry kind {kind!r}")
        arr = np.asarray(arr)
        if arr.dtype != _DTYPES[kind] or arr.ndim != 2:
            raise ValueError(f"{kind} plane must be 2-d {_DTYPES[kind]}, "
                             f"got {arr.ndim}-d {arr.dtype}")
        c[key] = torch.from_numpy(arr.copy()).to(device)
    return len(entries)
