"""User-facing Baker handle: the ommCreateBaker/ommCpu*/ommDebug* surface.

The port's copy of `omm_tpu/baker.py`.  Bundles the message interface,
texture creation, CPU/GPU bakes, stats, serialization and image dumps
behind one object (the reference routes all of these through
baker/tagged handles — bake.cpp:410-457, omm_handle.h).  Python object
lifetime replaces the handle/allocator machinery.  Bakes run on the
CUDA card unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Optional


from . import debug as debug_mod
from . import serialize as serialize_mod
from .bake import bake as _bake
from .log import Logger, MessageCallback
from .stats import get_stats
from .texture import Texture
from .types import (BakeInputDesc, BakeResult, DebugStats, TextureFlags,
                    TextureFormat)


class Baker:
    """Analog of ommBaker (CPU+GPU in one: both bakers share the
    classification engine)."""

    def __init__(self, message_callback: Optional[MessageCallback] = None,
                 allocator=None):
        from .allocator import check_and_set_default
        self.log = Logger(message_callback)
        self.allocator = check_and_set_default(allocator)

    # -- textures (ommCpuCreateTexture) --------------------------------------
    def create_texture(self, mips, fmt: TextureFormat,
                       flags: TextureFlags = TextureFlags.NONE,
                       alpha_cutoff: float = -1.0) -> Texture:
        return Texture(mips, fmt, flags, alpha_cutoff)

    # -- CPU bake (ommCpuBake) ------------------------------------------------
    def bake(self, desc: BakeInputDesc, device="cuda",
             mesh=None) -> BakeResult:
        """`omm_tpu_torch.bake` with this baker's logger and allocator:
        on the card unless device="cpu"."""
        return _bake(desc, device=device, logger=self.log,
                     allocator=self.allocator, mesh=mesh)

    # -- GPU-style deferred bake (ommGpuCreatePipeline/Dispatch) --------------
    def create_gpu_pipeline(self, render_api: str = "cuda"):
        from .gpu import Pipeline
        return Pipeline(render_api)

    # -- serialization (ommCpuSerialize/Deserialize) ---------------------------
    def serialize(self, input_descs=(), result_descs=(),
                  compress: bool = False) -> bytes:
        d = serialize_mod.DeserializedDesc(
            flags=(serialize_mod.SerializeFlags.COMPRESS if compress
                   else serialize_mod.SerializeFlags.NONE),
            input_descs=list(input_descs), result_descs=list(result_descs))
        return serialize_mod.serialize(d)

    def deserialize(self, blob: bytes) -> serialize_mod.DeserializedDesc:
        return serialize_mod.deserialize(blob)

    def save_binary_to_disk(self, blob: bytes, path: str):
        """ommDebugSaveBinaryToDisk (debug_impl.cpp:655-670)."""
        with open(path, "wb") as f:
            f.write(blob)

    # -- debug (ommDebugGetStats / SaveAsImages) -------------------------------
    def get_stats(self, result: BakeResult) -> DebugStats:
        return get_stats(result)

    def get_stats2(self, result: BakeResult) -> DebugStats:
        """ommDebugGetStats2: area-weighted variant using per-triangle UV
        areas (fills knownAreaMetric)."""
        return get_stats(result, use_area=True)

    def save_as_images(self, desc: BakeInputDesc, result: BakeResult,
                       path: str, **kw) -> list[str]:
        return debug_mod.save_as_images(desc, result, path, **kw)
