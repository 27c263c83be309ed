"""bake(): the JAX package's `bake(desc, backend="pallas")` with the
classification on a torch device.

Validation, work-item setup, the coarse SAT pass and the whole host tail
(promotion, dedup, compression, histograms, spatial sort, serialization)
are the JAX package's own jax-free host code; the fine classification
runs through `batch.classify_work_items_batches`, batched per
subdivision level as bake.py batches it for the two-phase engine.
"""
from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from omm_tpu import engine, geom
from omm_tpu.bake import (Options, finalize_items, setup_work_items,
                          split_tail_light, validate_desc,
                          validate_workload_size)
from omm_tpu.log import Logger
from omm_tpu.types import (BakeError, BakeInputDesc, BakeResult, Result,
                           TextureFilterMode, get_num_micro_triangles)

from .batch import classify_work_items_batches, unsupported_reason
from .twophase import PackedStates

#: micro-triangles per batch (bake.py's bound on device scratch)
MAX_UTRI_PER_BATCH = 3 << 22


def _config(desc: BakeInputDesc, opts: Options) -> engine.ResampleConfig:
    return engine.ResampleConfig(
        addr_mode=desc.runtime_sampler.addressing_mode,
        filter=desc.runtime_sampler.filter,
        alpha_cutoff=desc.alpha_cutoff,
        border_alpha=desc.runtime_sampler.border_alpha,
        fmt=desc.format,
        promotion=desc.unknown_state_promotion,
        cutoff_gt=desc.alpha_cutoff_greater,
        cutoff_le=desc.alpha_cutoff_less_equal,
        disable_level_line=opts.disable_level_line_intersection,
        enable_aabb_testing=opts.enable_aabb_testing,
        disable_fine=opts.disable_fine_classification,
    )


def classify_items(desc: BakeInputDesc, opts: Options, items: list,
                   device) -> None:
    """The classification half of bake(): the coarse pass, then the fine
    pass of every item on `device`, mutating `items` in place."""
    tex = desc.texture
    cfg = _config(desc, opts)
    if opts.enable_aabb_testing and not opts.disable_level_line_intersection:
        raise BakeError(
            Result.INVALID_ARGUMENT,
            "EnableAABBTesting requires DisableLevelLineIntersection")
    for it in items:
        st = engine.resample_coarse_item(tex, cfg, it.uv_tri,
                                         it.subdivision_level, it.states)
        if st is not it.states:  # identity (no SAT): keep _fresh valid
            it.states = st
    if cfg.disable_fine or not items:
        return

    degen = np.asarray(geom.is_degenerate(
        np.stack([it.uv_tri for it in items]))).reshape(len(items))
    for it, dg in zip(items, degen):
        if (cfg.filter != TextureFilterMode.Linear or cfg.disable_level_line
                or dg):
            raise NotImplementedError(
                unsupported_reason(cfg, it.uv_tri, it.subdivision_level))

    by_level: dict[int, list[int]] = {}
    for i, it in enumerate(items):
        by_level.setdefault(it.subdivision_level, []).append(i)
    chunks, levels = [], []
    for level in sorted(by_level, reverse=True):
        per_item = get_num_micro_triangles(level)
        cs = split_tail_light(by_level[level],
                              [max(1, MAX_UTRI_PER_BATCH // per_item)])
        chunks.extend(cs)
        levels.extend([level] * len(cs))
    batches = [[(items[i].uv_tri,
                 None if getattr(items[i], "_fresh", False)
                 else items[i].states) for i in c] for c in chunks]
    outs = classify_work_items_batches(tex, cfg, batches, levels,
                                       device=device)
    for c, res in zip(chunks, outs):
        for i, st in zip(c, res):
            if isinstance(st, PackedStates):
                items[i].set_packed_states(st)
            else:
                items[i].states = st


def bake(desc: BakeInputDesc, device, logger=None,
         allocator=None) -> BakeResult:
    """Bake `desc` with the fine classification on `device` (a torch
    device: "cuda" runs the hand-written exact kernel, "cpu" its plain
    twin).  The result is byte-equal to
    `omm_tpu.bake(desc, backend="pallas")`.  Nearest filter, degenerate
    triangles and the other routes off the two-phase engine's fast path
    raise NotImplementedError."""
    log = logger or Logger()
    opts = Options.from_flags(desc.bake_flags)
    if desc.texture is None:
        log.invalid_arg("[Invalid Argument] - ommCpuBakeInputDesc has no "
                        "texture set")
    with record_function("omm.setup"):
        validate_desc(desc, opts, log)
        items = setup_work_items(desc, opts, log)
        validate_workload_size(desc, opts, items, log)
    with record_function("omm.classify"):
        classify_items(desc, opts, items, device)
    with record_function("omm.finalize"):
        return finalize_items(desc, opts, items, allocator=allocator,
                              spec_blob=None)
