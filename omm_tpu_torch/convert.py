"""State carried across from the JAX package.

The port shares no type with the JAX package.  A JAX-package descriptor
holds numpy arrays and enum values; `bake_input` builds the port's
`BakeInputDesc` and `dispatch_config` its GPU baker's
`DispatchConfigDesc` from those arrays and the enums' integer values.
`result_to_numpy` turns a `BakeResult` of either package into a plain
dict of numpy arrays and ints, and `post_to_dict` a `PostDispatchInfo`
into a dict of ints, so that results compare across packages.

The JAX package caches each texture's device planes in
`texture._omm_dev_cache`: the padded plane under a ("tiles", ...) key and
the class planes under ("cls", ...) keys.  The port keys its own cache
(`planes.tex_cache`) the same way, so those planes, taken to numpy with
`np.asarray`, install as the port's tensors (`cache_from_numpy`) and
both packages then compute on identical state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gpu.baker import DispatchConfigDesc, GpuBakeFlags
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


#: DispatchConfigDesc fields that hold an enum value, with the port's enum
_GPU_ENUM_FIELDS = {
    "bake_flags": GpuBakeFlags,
    "alpha_cutoff_less_equal": OpacityState,
    "alpha_cutoff_greater": OpacityState,
    "global_format": Format,
    "unknown_state_promotion": UnknownStatePromotion,
}


def texture(planes, texture_format, flags=0, alpha_cutoff=-1.0) -> Texture:
    """The port's Texture from numpy mip planes and integer enum values
    (the JAX package's Texture holds them as `mips`, `format`, `flags`
    and `alpha_cutoff`)."""
    return Texture([np.asarray(p) for p in planes],
                   TextureFormat(int(texture_format)),
                   TextureFlags(int(flags)), float(alpha_cutoff))


def _sampler(addressing_mode, filter, border_alpha) -> SamplerDesc:
    sampler = SamplerDesc()
    if addressing_mode is not None:
        sampler.addressing_mode = TextureAddressMode(int(addressing_mode))
    if filter is not None:
        sampler.filter = TextureFilterMode(int(filter))
    sampler.border_alpha = float(border_alpha)
    return sampler


def _enums(fields: dict, enums: dict) -> dict:
    return {k: enums[k](int(v)) if k in enums else v
            for k, v in fields.items()}


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
    return BakeInputDesc(texture=tex, runtime_sampler=_sampler(
        addressing_mode, filter, border_alpha), **_enums(fields, _ENUM_FIELDS))


def dispatch_config(planes, texture_format, *, texture_flags=0,
                    texture_alpha_cutoff=-1.0, addressing_mode=None,
                    filter=None, border_alpha=0.0,
                    **fields) -> DispatchConfigDesc:
    """The port's gpu.DispatchConfigDesc from numpy arrays and integer
    enum values, as `bake_input` builds a BakeInputDesc: planes (mips of
    (h, w) or (h, w, channels) arrays) and the texture's arguments
    become `alpha_texture`; the sampler is given as ints; fields: any
    other DispatchConfigDesc field by name, `bake_flags` as an int of
    GpuBakeFlags and the other enums as ints."""
    tex = texture(planes, texture_format, texture_flags, texture_alpha_cutoff)
    return DispatchConfigDesc(alpha_texture=tex, runtime_sampler=_sampler(
        addressing_mode, filter, border_alpha),
        **_enums(fields, _GPU_ENUM_FIELDS))


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


def post_to_dict(post) -> dict:
    """A PostDispatchInfo of either package as a dict of ints."""
    return {f.name: int(getattr(post, f.name))
            for f in dataclasses.fields(post)}


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
