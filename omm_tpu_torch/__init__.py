"""omm_tpu_torch: the opacity micro-map baker's device path in PyTorch.

A port of `omm_tpu`'s `bake(desc, backend="pallas")` to torch: the
linear-filter, level-line two-phase engine, with the exact
classification stage as a hand-written CUDA kernel for Hopper, and the
routes off its fast path (nearest filter, line triangles, slivers, wide
windows, low subdivision levels, the AABB debug kernels) as torch ops;
and of its GPU-baker dispatch chain (`gpu.Pipeline`), whose default
engine runs the same kernel and whose ComputeOnly engine its twin.  The
JAX package `omm_tpu` stays the reference; this package imports nothing
of it and never imports jax: it keeps its own copies of the host code it
needs, under the JAX package's module names (`types`, `texture`,
`geom`, `bird`, `engine`, `bake`, `native`, ...).

    import omm_tpu_torch as ot
    res = ot.bake(desc)                # on the CUDA card
    # byte-equal to omm_tpu.bake(desc, backend="pallas")
    res, post = ot.gpu.Pipeline().dispatch(cfg).execute()
    # byte-equal to omm_tpu.gpu.Pipeline().dispatch(cfg, backend=...)
    res = ot.bake(desc, mesh=ot.parallel.make_mesh())  # every card
    # byte-equal to omm_tpu.bake(desc, backend="pallas", mesh=...)

The library surface above them is the JAX package's, copied: `Baker`
(the ommCpu*/ommDebug* handle), `capi` (the flat omm.h names), `debug`
(state overlays and PNG dumps), `integration` (D3D12/Vulkan build
inputs), and the tools `viewer`, `tui` and the CLI
(`python -m omm_tpu_torch.cli`, not imported here so that `-m` runs it
fresh).

    bk = ot.Baker()
    res = bk.bake(desc)                # on the CUDA card
    bk.save_as_images(desc, res, "out/")

`bake`, `Baker.bake`, `gpu.Pipeline.dispatch`, the viewer and the CLI
run on "cuda" unless the caller passes device="cpu" (`--device cpu`),
where the exact stage runs its plain torch twin; asking for "cuda"
without a card raises.  `convert` builds the port's
input from the numpy arrays and enum values a JAX-package descriptor
holds, and turns a result into plain numpy arrays and ints.  `parallel`
splits a bake over a mesh of devices (`shard`) and over processes
joined by torch.distributed (`multihost`, the bake farm); `serialize`
writes and reads the JAX package's blobs, byte for byte.
"""
from .types import (AlphaMode, BakeError, BakeFlags, BakeInputDesc,
                    BakeResult, DebugStats, Format, IndexFormat, MicromapDesc,
                    OpacityState, Result, SamplerDesc, SpecialIndex,
                    TexCoordFormat, TextureAddressMode, TextureFilterMode,
                    TextureFlags, TextureFormat, UnknownStatePromotion,
                    UsageCount, get_bit_count, get_num_micro_triangles,
                    MAX_SUBDIV_LEVEL)
from .texture import Texture

from . import gpu, parallel, routes, serialize
from .bake import bake
from .batch import classify_work_items_batches
from .kernels import counts as kernel_counts
from .stats import collect_stats, decode_states, get_stats
from .baker import Baker
from .log import Logger, MessageSeverity
from . import capi, debug, integration, tui, viewer

LIBRARY_VERSION = (1, 9, 0)  # capability parity target (omm.h:17-19)


def launches() -> dict:
    """Kernel launches made in this process, by kernel name, and the work
    items each classification route took ("route.<name>", see
    `routes`)."""
    with routes.LOCK:
        out = dict(kernel_counts.COUNTS)
        out.update({f"route.{k}": routes.COUNTS[k] for k in routes.NAMES})
    return out


def pipeline_counts() -> dict:
    """The two-phase engine's batches per path, CUDA graphs captured and
    replayed, host count-syncs, pinned host tensors made and the GPU
    baker's scratch batches in this process, by name (see
    `routes.PIPELINE`)."""
    with routes.LOCK:
        return {k: routes.COUNTS[k] for k in routes.PIPELINE}


def reset_launches() -> None:
    """Set every kernel's launch count, every route's count and every
    pipeline count to 0."""
    with routes.LOCK:
        kernel_counts.reset()
        routes.reset()


__all__ = [
    "AlphaMode", "BakeError", "BakeFlags", "BakeInputDesc", "BakeResult",
    "DebugStats", "Format", "IndexFormat", "MicromapDesc", "OpacityState",
    "Result", "SamplerDesc", "SpecialIndex", "TexCoordFormat",
    "TextureAddressMode", "TextureFilterMode", "TextureFlags",
    "TextureFormat", "UnknownStatePromotion", "UsageCount", "Texture",
    "bake", "get_stats", "collect_stats", "decode_states", "get_bit_count",
    "get_num_micro_triangles", "MAX_SUBDIV_LEVEL", "LIBRARY_VERSION",
    "Baker", "Logger", "MessageSeverity",
    "capi", "classify_work_items_batches", "debug", "gpu", "integration",
    "launches", "parallel", "pipeline_counts", "reset_launches",
    "serialize", "tui", "viewer"]
