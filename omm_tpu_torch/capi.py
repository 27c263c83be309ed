"""Flat C-ABI-style facade mirroring `omm.h` entry points.

The reference exposes a flat C API (`ommCreateBaker`, `ommCpuBake`,
`ommGpuDispatch`, `ommDebugGetStats`, ... — omm.h:276-280,568-594,
1127-1141,1199-1204) under the type-safe `omm.hpp` wrapper.  This is the
port's copy of `omm_tpu/capi.py`: the pythonic surface
(`omm_tpu_torch.bake`, `Baker`, `gpu.Pipeline`) is the primary API; this
module provides the flat names so code structured around the
reference's call shapes ports mechanically.  The calls that bake or
dispatch run on the CUDA card unless given device="cpu".  All functions
raise `BakeError` on failure (the `ommResult` analog travels on the
exception).
"""
from __future__ import annotations

from typing import NamedTuple

from . import planes
from . import serialize as _ser
from .baker import Baker
from .debug import save_as_images as _save_images
from .stats import get_stats as _get_stats
from .texture import Texture
from .types import BakeInputDesc, BakeResult, TextureFormat, TextureFlags

__all__ = [
    "omm_get_library_desc",
    "omm_create_baker", "omm_destroy_baker",
    "omm_cpu_create_texture", "omm_cpu_get_texture_desc",
    "omm_cpu_destroy_texture",
    "omm_cpu_bake", "omm_cpu_destroy_bake_result",
    "omm_cpu_get_bake_result_desc",
    "omm_cpu_serialize", "omm_cpu_deserialize",
    "omm_gpu_create_pipeline", "omm_gpu_get_pipeline_desc",
    "omm_gpu_get_pre_dispatch_info", "omm_gpu_dispatch",
    "omm_gpu_get_static_resource_data",
    "omm_debug_get_stats", "omm_debug_get_stats2",
    "omm_debug_save_as_images", "omm_debug_save_binary_to_disk",
]


# -- library info (ommGetLibraryDesc, omm.h:191-196,276) ---------------------

class LibraryDesc(NamedTuple):
    """ommLibraryDesc analog (omm.h:191-196)."""
    version_major: int
    version_minor: int
    version_build: int


def omm_get_library_desc() -> LibraryDesc:
    from . import LIBRARY_VERSION
    return LibraryDesc(*LIBRARY_VERSION)


# -- baker lifecycle (ommCreateBaker / ommDestroyBaker) ----------------------

def omm_create_baker(message_callback=None, allocator=None) -> Baker:
    return Baker(message_callback, allocator=allocator)


def omm_destroy_baker(baker: Baker) -> None:
    """Handles are garbage-collected; provided for call-shape parity."""


# -- textures (ommCpuCreateTexture / ommCpuDestroyTexture) -------------------

def omm_cpu_create_texture(baker: Baker, mips, fmt: TextureFormat,
                           flags: TextureFlags = TextureFlags.NONE,
                           alpha_cutoff: float = -1.0) -> Texture:
    return baker.create_texture(mips, fmt, flags, alpha_cutoff)


class TextureDesc(NamedTuple):
    """ommCpuTextureDesc read-back analog (omm.h:358-367).  `mips` holds
    (width, height, row_pitch) per level, the shape triple the reference
    fills when the caller passes a mip array (texture_impl.cpp:280-300);
    texel data is read back per level via `texture.load_plane(mip)`."""
    format: TextureFormat
    flags: TextureFlags
    mip_count: int
    alpha_cutoff: float
    mips: tuple


def omm_cpu_get_texture_desc(texture: Texture) -> TextureDesc:
    mips = tuple((texture.size(m)[0], texture.size(m)[1],
                  texture.size(m)[0]) for m in range(texture.mip_count))
    return TextureDesc(texture.format, texture.flags, texture.mip_count,
                       texture.alpha_cutoff, mips)


def omm_cpu_destroy_texture(baker: Baker, texture: Texture) -> None:
    """Drop the texture's device planes; a later bake builds them again."""
    planes.drop_cache(texture)


# -- CPU bake (ommCpuBake / ommCpuGetBakeResultDesc) --------------------------

def omm_cpu_bake(baker: Baker, desc: BakeInputDesc,
                 device="cuda") -> BakeResult:
    return baker.bake(desc, device=device)


def omm_cpu_destroy_bake_result(result: BakeResult) -> None:
    """Results are plain data; provided for call-shape parity."""


def omm_cpu_get_bake_result_desc(result: BakeResult) -> BakeResult:
    """The result object IS the ommCpuBakeResultDesc analog."""
    return result


# -- serialization (ommCpuSerialize / ommCpuDeserialize) ----------------------

def omm_cpu_serialize(baker: Baker, input_descs=(), result_descs=(),
                      compress: bool = False) -> bytes:
    return baker.serialize(input_descs=input_descs,
                           result_descs=result_descs, compress=compress)


def omm_cpu_deserialize(baker: Baker, blob: bytes) -> _ser.DeserializedDesc:
    return baker.deserialize(blob)


# -- GPU-style deferred pipeline (ommGpu*) ------------------------------------

def omm_gpu_create_pipeline(baker: Baker, render_api: str = "cuda"):
    return baker.create_gpu_pipeline(render_api)


def omm_gpu_get_pipeline_desc(pipeline):
    return pipeline.get_pipeline_desc()


def omm_gpu_get_pre_dispatch_info(pipeline, cfg):
    return pipeline.get_pre_dispatch_info(cfg)


def omm_gpu_dispatch(pipeline, cfg, device="cuda"):
    return pipeline.dispatch(cfg, device=device)


def omm_gpu_get_static_resource_data(resource: str):
    from .gpu import static_data
    return static_data.get_static_resource_data(resource)


# -- debug (ommDebug*) ---------------------------------------------------------

def omm_debug_get_stats(result: BakeResult):
    return _get_stats(result)


def omm_debug_get_stats2(result: BakeResult):
    return _get_stats(result, use_area=True)


def omm_debug_save_as_images(desc: BakeInputDesc, result: BakeResult,
                             path: str, **kw):
    return _save_images(desc, result, path, **kw)


def omm_debug_save_binary_to_disk(blob: bytes, path: str):
    with open(path, "wb") as f:
        f.write(blob)
    return path
