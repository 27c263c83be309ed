"""omm_tpu_torch: the opacity micro-map baker's device path in PyTorch.

A port of `omm_tpu`'s `bake(desc, backend="pallas")` main path (the
linear-filter, level-line two-phase engine) to torch, with the exact
classification stage as a hand-written CUDA kernel for Hopper.  The
JAX package `omm_tpu` stays the reference: this package reuses its
jax-free host modules and never imports jax.

    import omm_tpu_torch
    res = omm_tpu_torch.bake(desc, device="cuda")
    # byte-equal to omm_tpu.bake(desc, backend="pallas")

On CPU tensors the exact stage runs its plain torch twin.  The input
and result types are the JAX package's jax-free ones, re-exported here.
"""
from omm_tpu.texture import Texture
from omm_tpu.types import BakeInputDesc, BakeResult, TextureFormat

from .bake import bake
from .batch import classify_work_items_batches
from .kernels import exact as exact_kernel


def launches() -> dict:
    """Kernel launches made in this process, by kernel name."""
    return {"exact_classify": exact_kernel.LAUNCHES}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    exact_kernel.LAUNCHES = 0


__all__ = ["BakeInputDesc", "BakeResult", "Texture", "TextureFormat", "bake",
           "classify_work_items_batches", "launches", "reset_launches"]
