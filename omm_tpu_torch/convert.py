"""State carried across from the JAX package.

The port shares no type with the JAX package.  A JAX-package descriptor
holds numpy arrays and enum values; `bake_input` builds the port's
`BakeInputDesc` from those arrays and the enums' integer values, and
`result_to_numpy` turns a `BakeResult` of either package into a plain
dict of numpy arrays and ints, so that results compare across packages.

The JAX package caches each texture's device planes in
`texture._omm_dev_cache`: the padded plane under a ("tiles", ...) key and
the class planes under ("cls", ...) keys.  The port keys its own cache
(`planes.tex_cache`) the same way, so those planes, taken to numpy with
`np.asarray`, install as the port's tensors (`cache_from_numpy`) and
both packages then compute on identical state.
"""
from __future__ import annotations

import numpy as np
import torch

from .planes import tex_cache
from .texture import Texture
from .types import (AlphaMode, BakeFlags, BakeInputDesc, Format, IndexFormat,
                    OpacityState, SamplerDesc, SpecialIndex, TexCoordFormat,
                    TextureAddressMode, TextureFilterMode, TextureFlags,
                    TextureFormat, UnknownStatePromotion)

_DTYPES = {"tiles": np.float32, "cls": np.int8}

#: BakeInputDesc fields that hold an enum value, with the port's enum
_ENUM_FIELDS = {
    "bake_flags": BakeFlags,
    "alpha_mode": AlphaMode,
    "tex_coord_format": TexCoordFormat,
    "index_format": IndexFormat,
    "alpha_cutoff_less_equal": OpacityState,
    "alpha_cutoff_greater": OpacityState,
    "format": Format,
    "unknown_state_promotion": UnknownStatePromotion,
    "unresolved_tri_state": SpecialIndex,
}


def texture(planes, texture_format, flags=0, alpha_cutoff=-1.0) -> Texture:
    """The port's Texture from numpy mip planes and integer enum values
    (the JAX package's Texture holds them as `mips`, `format`, `flags`
    and `alpha_cutoff`)."""
    return Texture([np.asarray(p) for p in planes],
                   TextureFormat(int(texture_format)),
                   TextureFlags(int(flags)), float(alpha_cutoff))


def bake_input(planes, texture_format, *, texture_flags=0,
               texture_alpha_cutoff=-1.0, addressing_mode=None, filter=None,
               border_alpha=0.0, **fields) -> BakeInputDesc:
    """The port's BakeInputDesc from numpy arrays and integer enum values.

    planes: the texture's mip planes (numpy arrays); texture_format,
    texture_flags and texture_alpha_cutoff: the Texture's arguments;
    addressing_mode, filter and border_alpha: the runtime sampler
    (None keeps SamplerDesc's default); fields: any other BakeInputDesc
    field by name, enums as ints (or either package's enum members)."""
    tex = texture(planes, texture_format, texture_flags, texture_alpha_cutoff)
    sampler = SamplerDesc()
    if addressing_mode is not None:
        sampler.addressing_mode = TextureAddressMode(int(addressing_mode))
    if filter is not None:
        sampler.filter = TextureFilterMode(int(filter))
    sampler.border_alpha = float(border_alpha)
    for name, enum in _ENUM_FIELDS.items():
        if name in fields:
            fields[name] = enum(int(fields[name]))
    return BakeInputDesc(texture=tex, runtime_sampler=sampler, **fields)


def result_to_numpy(res) -> dict:
    """A BakeResult of either package as numpy arrays and ints: the
    descriptors and histograms become (n, 3) int64 arrays of
    (offset | count, subdivision_level, format)."""
    def rows(entries, first):
        return np.array([(getattr(e, first), e.subdivision_level,
                          int(e.format)) for e in entries],
                        np.int64).reshape(-1, 3)

    return {"array_data": np.asarray(res.array_data, np.uint8),
            "desc_array": rows(res.desc_array, "offset"),
            "desc_array_histogram": rows(res.desc_array_histogram, "count"),
            "index_buffer": np.asarray(res.index_buffer),
            "index_format": int(res.index_format),
            "index_histogram": rows(res.index_histogram, "count"),
            "triangle_area": np.asarray(res.triangle_area, np.float32)}


def cache_from_numpy(texture, entries: dict, device) -> int:
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
