"""Deferred "GPU baker" pipeline: the dispatch-chain API on a torch device.

The port's counterpart of `omm_tpu/gpu/baker.py`, with the same names.
The reference GPU baker (bake_gpu_impl.{h,cpp} + 24 HLSL shaders) never
touches the device itself: it emits a labeled command chain (clears,
init, work-setup, per-level indirect rasterize, desc-patch, index-write)
that the client's renderer executes, with scratch sub-allocated from
transient pools and the workload split into batches bounded by
maxScratchMemorySize (bake_gpu_impl.cpp:434-679, 788-1272).

Here the chain is a plan of labeled passes that this module executes on
a torch device: indirect dispatch becomes per-level batches of the
two-phase engine (the bake's fine pass, `bake.classify_fine`), the CAS
hash-table dedup of work-setup (omm_work_setup_cs.cs.hlsl) a sort over
UV keys.  The plan is still introspectable (pass labels mirror the
reference's debug markers, `rhi.record_chain` walks it) and the setup
and bake phases can run separately (PerformSetup / PerformBake,
omm.h:696-710).

`Pipeline().dispatch(cfg)` runs on "cuda" unless given device="cpu";
asking for "cuda" without a card raises at `dispatch`.  On the card the
default engine's exact stage is the hand-written CUDA kernel; with
GpuBakeFlags.ComputeOnly the same two-phase pipeline runs the kernel's
plain torch twin.  Results are byte-equal to the JAX package's
`Pipeline().dispatch(cfg, backend=...).execute()`.

GPU-baker semantic differences from the CPU baker are preserved: no
coarse pass, no post-bake dedup or near-duplicate merging
(integration_guide.md:129-131), special-index promotion from the
micro-triangle tally, conservative output-size estimates in the
pre-dispatch info.
"""
from __future__ import annotations

import copy
import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import engine, native, routes
from ..bake import (area_levels, classify_fine, degenerate_mask,
                    write_result, WorkItem)
from ..planes import check_device
from ..spans import span, spanned
from ..stats import collect_stats
from ..texture import Texture
from ..types import (BakeError, BakeFlags, BakeInputDesc, Format,
                     IndexFormat, OpacityState, Result, SamplerDesc,
                     SpecialIndex, UnknownStatePromotion,
                     get_bit_count, get_num_micro_triangles,
                     MAX_NUM_SUBDIV_LEVELS)
from .rhi import ResourceRange as RR


class GpuBakeFlags(enum.IntFlag):
    """ommGpuBakeFlags (omm.h:694-744)."""

    Invalid = 0
    PerformSetup = 1 << 0
    PerformBake = 1 << 1
    PerformSetupAndBake = 3
    ComputeOnly = 1 << 2
    EnablePostDispatchInfoStats = 1 << 3
    DisableSpecialIndices = 1 << 4
    DisableTexCoordDeduplication = 1 << 5
    Force32BitIndices = 1 << 6
    DisableLevelLineIntersection = 1 << 7
    EnableNsightDebugMode = 1 << 8
    Allow8BitIndices = 1 << 9


class ScratchMemoryBudget(enum.IntEnum):
    """ommGpuScratchMemoryBudget (omm.h:681-692)."""

    MB_4 = 4 << 20
    MB_32 = 32 << 20
    MB_64 = 64 << 20
    MB_128 = 128 << 20
    MB_256 = 256 << 20
    MB_512 = 512 << 20
    MB_1024 = 1024 << 20
    Default = 256 << 20


@dataclass
class DispatchConfigDesc:
    """ommGpuDispatchConfigDesc (omm.h:997-1083), array-ified."""

    bake_flags: GpuBakeFlags = GpuBakeFlags.PerformSetupAndBake
    runtime_sampler: SamplerDesc = field(default_factory=SamplerDesc)
    alpha_texture: Optional[Texture] = None
    alpha_texture_channel: int = 3  # channel sampled from alpha_texture
    tex_coords: Optional[np.ndarray] = None
    index_buffer: Optional[np.ndarray] = None
    index_count: int = 0
    alpha_cutoff: float = 0.5
    alpha_cutoff_less_equal: OpacityState = OpacityState.Transparent
    alpha_cutoff_greater: OpacityState = OpacityState.Opaque
    dynamic_subdivision_scale: float = 2.0
    global_format: Format = Format.OC1_4_State
    max_subdivision_level: int = 8
    enable_subdivision_level_buffer: bool = False
    subdivision_levels: Optional[np.ndarray] = None
    max_out_omm_array_size: int = 0xFFFFFFFF
    max_scratch_memory_size: ScratchMemoryBudget = ScratchMemoryBudget.Default
    unknown_state_promotion: UnknownStatePromotion = UnknownStatePromotion.ForceOpaque


@dataclass
class PreDispatchInfo:
    """ommGpuPreDispatchInfo (omm.h:958-995): conservative output sizes and
    scratch plan."""

    out_omm_index_buffer_format: IndexFormat = IndexFormat.UINT_32
    out_omm_index_count: int = 0
    out_omm_array_size_in_bytes: int = 0
    out_omm_desc_size_in_bytes: int = 0
    out_omm_index_buffer_size_in_bytes: int = 0
    out_omm_array_histogram_size_in_bytes: int = 0
    out_omm_index_histogram_size_in_bytes: int = 0
    transient_pool_buffer_sizes: tuple = ()
    max_batch_count: int = 1


@dataclass
class PostDispatchInfo:
    """ommGpuPostDispatchInfo (omm.h:1098-1114)."""

    out_omm_array_size_in_bytes: int = 0
    out_omm_desc_size_in_bytes: int = 0
    out_stats_total_opaque_count: int = 0
    out_stats_total_transparent_count: int = 0
    out_stats_total_unknown_count: int = 0
    out_stats_total_fully_opaque_count: int = 0
    out_stats_total_fully_transparent_count: int = 0
    out_stats_total_fully_unknown_count: int = 0


@dataclass
class Pass:
    """One labeled step of the dispatch chain (analog of
    ommGpuDispatchDesc + Begin/EndLabel markers)."""

    label: str
    kind: str  # 'clear' | 'setup' | 'classify' | 'desc_patch' | 'index_write'
    detail: dict = field(default_factory=dict)


@dataclass
class DispatchChain:
    passes: list[Pass]
    execute: callable  # () -> (BakeResult, PostDispatchInfo)


# Pass registry names mirror the reference pipeline's shader inventory
# (bake_gpu_impl.cpp:313-419) for tooling/marker parity.
PIPELINE_PASS_NAMES = (
    "omm_clear_buffer",
    "omm_init_buffers_cs",
    "omm_work_setup_cs",
    "omm_work_setup_bake_only_cs",
    "omm_post_build_info",
    "omm_rasterize_cs",
    "omm_desc_patch",
    "omm_index_write",
)


class Pipeline:
    """Analog of ommGpuPipeline: holds the pass registry and planner, and
    the schedules of earlier PerformSetup dispatches."""

    def __init__(self, render_api: str = "cuda"):
        self.render_api = render_api
        self._setup_store: dict = {}   # schedule key -> setup's items

    def get_pipeline_desc(self):
        return {"passes": PIPELINE_PASS_NAMES,
                "static_samplers": 8,  # 4 address modes x 2 filters
                "render_api": self.render_api}

    # -- Phase B: resource planning (bake_gpu_impl.cpp:434-679) -------------
    def get_pre_dispatch_info(self, cfg: DispatchConfigDesc) -> PreDispatchInfo:
        return self._pre_dispatch_info(
            cfg, self._subdiv_levels(cfg, self._triangles(cfg)))

    def _pre_dispatch_info(self, cfg: DispatchConfigDesc,
                           levels: np.ndarray) -> PreDispatchInfo:
        """The pre-dispatch info of `cfg`, whose levels are `levels`."""
        tri_count = cfg.index_count // 3
        max_level = int(levels.max()) if len(levels) else 0

        bit_count = get_bit_count(cfg.global_format)
        # Conservative: every primitive unique at its own level.
        counts = np.bincount(levels, minlength=MAX_NUM_SUBDIV_LEVELS)
        array_size = sum(int(cnt) * max((get_num_micro_triangles(lvl)
                                         * bit_count) >> 3, 1)
                         for lvl, cnt in enumerate(counts))
        array_size = min(array_size, cfg.max_out_omm_array_size)

        force32 = bool(cfg.bake_flags & GpuBakeFlags.Force32BitIndices)
        allow8 = bool(cfg.bake_flags & GpuBakeFlags.Allow8BitIndices)
        if allow8 and tri_count <= 127 and not force32:
            fmt = IndexFormat.UINT_8
            idx_size = tri_count
        elif tri_count <= 32767 and not force32:
            fmt = IndexFormat.UINT_16
            idx_size = tri_count * 2
        else:
            fmt = IndexFormat.UINT_32
            idx_size = tri_count * 4

        # Scratch: per-batch micro-tri state buffer; batch count bounds it
        # under the budget (bake_gpu_impl.cpp:517-584).  A budget below
        # even ONE primitive's worth of micro-tri scratch cannot be split
        # further (bake_gpu_impl.cpp:540-542).
        per_tri_scratch = get_num_micro_triangles(max_level) * 8
        budget = int(cfg.max_scratch_memory_size)
        if budget < per_tri_scratch:
            raise BakeError(Result.INSUFFICIENT_SCRATCH_MEMORY,
                            "maxScratchMemorySize below the single-"
                            "primitive minimum")
        tris_per_batch = max(1, budget // max(per_tri_scratch, 1))
        max_batch_count = (tri_count + tris_per_batch - 1) // max(tris_per_batch, 1)
        if cfg.bake_flags & GpuBakeFlags.EnableNsightDebugMode:
            # frame-capture debugging: one primitive per batch
            # (bake_gpu_impl.cpp:555-559)
            max_batch_count = tri_count
            tris_per_batch = 1
        # an executed batch packs by ACTUAL per-primitive levels, so it
        # can fill up to the full budget with mixed levels; the pool must
        # cover that (while never exceeding the whole-mesh worst case)
        scratch = max(per_tri_scratch,
                      min(budget, tri_count * per_tri_scratch))

        # <=4 transient pools with bump-allocated sub-ranges, mirroring
        # the reference's pool layout (bake_gpu_impl.cpp:434-516):
        #   pool 0: per-batch micro-tri bake-result scratch
        #   pool 1: dedup hash table (16x load factor, :463-466)
        #   pool 2: work items + histograms + per-level indirect args
        #           (args bump-reset per batch) + temp index buffer
        #   pool 3: assert/debug buffer (1024 dwords, :496-499)
        pools = (scratch,
                 16 * max(tri_count, 1) * 8,
                 max(tri_count, 1) * 16 + 2 * MAX_NUM_SUBDIV_LEVELS * 12
                 + MAX_NUM_SUBDIV_LEVELS * 12 + max(tri_count, 1) * 4,
                 4096)

        return PreDispatchInfo(
            out_omm_index_buffer_format=fmt,
            out_omm_index_count=tri_count,
            out_omm_array_size_in_bytes=array_size,
            out_omm_desc_size_in_bytes=tri_count * 8,
            out_omm_index_buffer_size_in_bytes=idx_size,
            out_omm_array_histogram_size_in_bytes=8 * 2 * MAX_NUM_SUBDIV_LEVELS,
            out_omm_index_histogram_size_in_bytes=8 * 2 * MAX_NUM_SUBDIV_LEVELS,
            transient_pool_buffer_sizes=pools,
            max_batch_count=max_batch_count,
        )

    def _batch_ranges(self, cfg: DispatchConfigDesc,
                      levels: np.ndarray) -> list:
        """Primitive ranges whose live micro-tri scratch fits the budget
        (the reference's maxScratchMemorySize batching,
        bake_gpu_impl.cpp:517-584, executed rather than merely planned);
        Nsight debug mode forces one primitive per batch (:555-559)."""
        n = len(levels)
        if n == 0:
            return [(0, 0)]
        if cfg.bake_flags & GpuBakeFlags.EnableNsightDebugMode:
            return [(i, i + 1) for i in range(n)]
        budget = int(cfg.max_scratch_memory_size)
        ranges, start, cur = [], 0, 0
        for i, lvl in enumerate(levels):
            s = get_num_micro_triangles(int(lvl)) * 8
            if cur and cur + s > budget:
                ranges.append((start, i))
                start, cur = i, 0
            cur += s
        ranges.append((start, n))
        return ranges

    # -- Phase C+D: dispatch-chain build + execution -------------------------
    @spanned("omm.gpu.dispatch")
    def dispatch(self, cfg: DispatchConfigDesc,
                 device="cuda") -> DispatchChain:
        """The dispatch chain of `cfg`, executed by its `execute()` on
        `device`: "cuda" (the default; raises here where there is no
        card) or "cpu"."""
        device = check_device(device)
        self._validate(cfg)
        tris = self._triangles(cfg)
        levels = self._subdiv_levels(cfg, tris)
        do_setup = bool(cfg.bake_flags & GpuBakeFlags.PerformSetup)
        do_bake = bool(cfg.bake_flags & GpuBakeFlags.PerformBake)
        pre = self._pre_dispatch_info(cfg, levels)
        pools = pre.transient_pool_buffer_sizes
        tri_count = cfg.index_count // 3
        ranges = self._batch_ranges(cfg, levels) if do_bake else None

        # fixed pool-2 layout (bump order mirrors _pre_dispatch_info)
        wi_size = max(tri_count, 1) * 16
        hist_size = 2 * MAX_NUM_SUBDIV_LEVELS * 12
        hist_off = wi_size
        args_off = hist_off + hist_size          # per-batch bump region
        tmpidx_off = args_off + MAX_NUM_SUBDIV_LEVELS * 12
        assert_rr = RR(3, 0, pools[3], "assert_buffer")
        hash_rr = RR(1, 0, 16 * max(tri_count, 1) * 8, "hash_table")
        wi_rr = RR(2, 0, wi_size, "work_items", "r")

        passes = []
        if do_setup:
            passes += [
                Pass("Clear", "clear",
                     {"resources": [RR(2, 0, pools[2], "zero_fill", "w"),
                                    RR(1, 0, hash_rr.size, "zero_fill",
                                       "w")]}),
                Pass("Init", "setup",
                     {"resources": [RR(2, hist_off, hist_size,
                                       "histograms", "w"), assert_rr]}),
                Pass("WorkSetup", "setup",
                     {"dedup": not (cfg.bake_flags
                                    & GpuBakeFlags.DisableTexCoordDeduplication),
                      "resources": [hash_rr,
                                    RR(2, 0, wi_size, "work_items", "w"),
                                    assert_rr]})]
        if do_bake:
            # per-batch, per-level passes like the reference's labeled
            # dispatch chain ("Batch %d" / "Level %d" markers,
            # bake_gpu_impl.cpp:1112,1133-1135), each with the concrete
            # bump-allocated pool sub-ranges it touches; pool 0 and the
            # pool-2 args region reset at every batch boundary (the
            # reference's per-batch transient reuse, :517-584)
            multi = len(ranges) > 1
            for b, (s, e) in enumerate(ranges):
                bump0 = 0   # pool-0 bump pointer, reset per batch
                bump_args = args_off
                counts = np.bincount(levels[s:e],
                                     minlength=MAX_NUM_SUBDIV_LEVELS)
                for lvl in np.flatnonzero(counts).tolist():
                    cnt = int(counts[lvl])
                    label = (f"Batch {b} Level {lvl}" if multi
                             else f"Level {lvl}")
                    res_size = cnt * get_num_micro_triangles(lvl) * 8
                    rr0 = RR(0, bump0, res_size, "bake_result")
                    bump0 += res_size
                    rr_args = RR(2, bump_args, 12, "dispatch_args", "r")
                    bump_args += 12
                    passes.append(Pass(
                        label, "classify",
                        {"level": lvl, "batch": b, "count": cnt,
                         "resources": [rr0, rr_args, wi_rr, assert_rr]}))
            passes.append(Pass("DescPatch", "desc_patch",
                               {"resources": [
                                   RR(1, 0, hash_rr.size, "hash_table",
                                      "r"),
                                   RR(2, hist_off, hist_size,
                                      "histograms"), assert_rr]}))
            passes.append(Pass("IndexWrite", "index_write",
                               {"resources": [
                                   RR(2, tmpidx_off,
                                      max(tri_count, 1) * 4,
                                      "temp_indices"), assert_rr]}))

        def execute():
            return self._execute(cfg, tris, levels, ranges, pre, device)

        return DispatchChain(passes=passes, execute=execute)

    # -- internals -----------------------------------------------------------
    def _validate(self, cfg: DispatchConfigDesc):
        if cfg.alpha_texture is None:
            raise BakeError(Result.INVALID_ARGUMENT, "alpha texture not set")
        if (cfg.alpha_texture.channels > 1
                and not 0 <= cfg.alpha_texture_channel
                < cfg.alpha_texture.channels):
            raise BakeError(Result.INVALID_ARGUMENT,
                            "alphaTextureChannel out of range")
        if cfg.tex_coords is None or cfg.index_buffer is None:
            raise BakeError(Result.INVALID_ARGUMENT, "geometry not set")
        if not (cfg.bake_flags & GpuBakeFlags.PerformSetupAndBake):
            raise BakeError(Result.INVALID_ARGUMENT,
                            "PerformSetup and/or PerformBake must be set")

    @staticmethod
    def _triangles(cfg: DispatchConfigDesc) -> np.ndarray:
        """The (T, 3, 2) fp32 UV triangles of `cfg`, gathered once a
        dispatch for its levels and its WorkSetup."""
        return np.asarray(cfg.tex_coords, np.float32)[
            np.asarray(cfg.index_buffer, np.int64)[:cfg.index_count]
        ].reshape(-1, 3, 2)

    @spanned("omm.gpu.levels")
    def _subdiv_levels(self, cfg: DispatchConfigDesc,
                       tris: np.ndarray) -> np.ndarray:
        """Per-primitive levels of the triangles `tris` of `cfg`, int32,
        in one array pass: the subdivision-level buffer's override or the
        UV-area heuristic (omm_common.hlsli:180-195,228-240 — the CPU
        baker's formula, on every row: no edge heuristic for degenerate
        ones).  A buffer value v >= 0 is min(v, 12), -1 the maximum, -2
        and below the heuristic."""
        n = len(tris)
        if cfg.dynamic_subdivision_scale > 0:
            sizef = np.array(cfg.alpha_texture.size(0), dtype=np.float32)
            with np.errstate(all="ignore"):
                out = area_levels(tris, sizef, cfg.dynamic_subdivision_scale,
                                  cfg.max_subdivision_level)
        else:
            out = np.full(n, cfg.max_subdivision_level, np.int64)
        if (cfg.enable_subdivision_level_buffer
                and cfg.subdivision_levels is not None):
            # indexed, not sliced: a short buffer raises
            v = np.asarray(cfg.subdivision_levels)[np.arange(n)].astype(
                np.int8).astype(np.int64)
            out = np.where(v >= 0, np.minimum(v, 12),
                           np.where(v == -1, cfg.max_subdivision_level,
                                    out))
        return out.astype(np.int32)

    @spanned("omm.gpu.work_setup")
    def _schedule_key(self, cfg: DispatchConfigDesc,
                      levels: np.ndarray) -> int:
        """Identity of a setup's inputs: the bake-only path (the
        reference's SetupBeforeBuild resume,
        omm_work_setup_bake_only_cs.cs.hlsl) must see the same geometry
        the setup scheduled."""
        return native.xxh64(
            np.ascontiguousarray(cfg.tex_coords, np.float32).tobytes()
            + np.ascontiguousarray(cfg.index_buffer, np.uint32).tobytes()
            + levels.tobytes()
            + bytes([int(cfg.global_format),
                     1 if (cfg.bake_flags
                           & GpuBakeFlags.DisableTexCoordDeduplication)
                     else 0]))

    @spanned("omm.gpu.work_setup")
    def _work_setup(self, cfg: DispatchConfigDesc, tris: np.ndarray,
                    levels: np.ndarray):
        """WorkSetup of the triangles `tris` of `cfg`: first-occurrence
        dedup on (UVs, level) like the CAS hash table
        (omm_work_setup_cs.cs.hlsl:26-153), in array passes.  Triangles
        with a non-finite UV are skipped; the key is the row's 24 UV
        bytes and its level, so -0.0 and +0.0, or rotated vertices, are
        different keys.  Items follow their first triangle's index, each
        listing its triangles in ascending order; under
        DisableTexCoordDeduplication every finite triangle is an item."""
        keep = np.flatnonzero(np.isfinite(tris).all(axis=(1, 2)))
        # `order`: the finite triangles, each group's ascending and
        # together; `new` marks the first of each group in `order`
        order, new = keep, np.ones(len(keep), bool)
        if not cfg.bake_flags & GpuBakeFlags.DisableTexCoordDeduplication:
            key = np.concatenate(
                [tris[keep].reshape(-1, 6).view(np.uint64),
                 np.asarray(levels, np.int64)[keep, None].view(np.uint64)],
                axis=1)
            rows = np.lexsort(key.T)   # stable: equal keys by index
            key = key[rows]
            new[1:] = (key[1:] != key[:-1]).any(axis=1)
            order = keep[rows]
        starts = np.flatnonzero(new)
        ends = np.append(starts[1:], len(order))
        by_first = np.argsort(order[starts])
        starts, ends = starts[by_first], ends[by_first]
        heads = order[starts]
        prims = order.tolist()
        return [WorkItem(subdivision_level=level,
                         vm_format=cfg.global_format,
                         uv_tri=tris[h],
                         primitive_indices=prims[a:b])
                for h, level, a, b in zip(heads.tolist(),
                                          levels[heads].tolist(),
                                          starts.tolist(), ends.tolist())]

    @spanned("omm.gpu.execute")
    def _execute(self, cfg: DispatchConfigDesc, tris: np.ndarray,
                 levels: np.ndarray, ranges: list, pre: PreDispatchInfo,
                 device):
        # Channel selection: the analog of the reference's per-channel
        # Gather PSOs (bake_gpu_impl.cpp:313-419); every engine below
        # samples the selected plane.  The view is cached on the texture,
        # and with it the device planes of earlier dispatches.
        tex = cfg.alpha_texture.channel_view(cfg.alpha_texture_channel)
        disable_special = bool(cfg.bake_flags & GpuBakeFlags.DisableSpecialIndices)
        do_setup = bool(cfg.bake_flags & GpuBakeFlags.PerformSetup)
        do_bake = bool(cfg.bake_flags & GpuBakeFlags.PerformBake)
        skey = self._schedule_key(cfg, levels)

        if do_setup:
            items = self._work_setup(cfg, tris, levels)
            self._setup_store[skey] = items
            if not do_bake:
                # setup-only: persist the schedule, report planned sizes
                # (the reference's PerformSetup leaves the scheduling
                # buffers for a later bake-only dispatch)
                post = PostDispatchInfo(
                    out_omm_array_size_in_bytes=sum(
                        max(get_num_micro_triangles(it.subdivision_level)
                            * get_bit_count(cfg.global_format) >> 3, 1)
                        for it in items),
                    out_omm_desc_size_in_bytes=8 * len(items))
                return None, post
        else:
            if skey not in self._setup_store:
                raise BakeError(
                    Result.INVALID_ARGUMENT,
                    "PerformBake without a prior PerformSetup for these "
                    "inputs (SetupBeforeBuild requires the setup phase)")
            items = self._setup_store[skey]

        rcfg = engine.ResampleConfig(
            addr_mode=cfg.runtime_sampler.addressing_mode,
            filter=cfg.runtime_sampler.filter,
            alpha_cutoff=cfg.alpha_cutoff,
            border_alpha=cfg.runtime_sampler.border_alpha,
            fmt=cfg.global_format,
            promotion=cfg.unknown_state_promotion,
            cutoff_gt=cfg.alpha_cutoff_greater,
            cutoff_le=cfg.alpha_cutoff_less_equal,
            # The reference GPU's DisableLevelLineIntersection runs the
            # conservative-bilinear min/max test over the RASTERIZED
            # TRIANGLE footprint (omm_resample_common.hlsli:355-372, gated
            # at bake_gpu_impl.cpp:714) — i.e. two_tris=False semantics.
            # The AABB-split two-triangle variant is the CPU baker's
            # internal EnableAABBTesting debug mode, which has no GPU flag.
            disable_level_line=bool(cfg.bake_flags
                                    & GpuBakeFlags.DisableLevelLineIntersection),
            enable_aabb_testing=False,
        )
        # bake on copies so a stored setup can be re-baked (the
        # reference's bake-only dispatch is repeatable): a copy's states
        # are only ever reassigned, never written in place, and a fresh
        # item's shared all-UnknownOpaque template is read-only
        items = [copy.copy(it) for it in items]

        # ComputeOnly: the same two-phase pipeline with the exact stage's
        # plain torch twin in place of the CUDA kernel (the JAX package's
        # exact_engine="xla")
        exact = ("torch" if cfg.bake_flags & GpuBakeFlags.ComputeOnly
                 else None)

        # Batched execution bounding live micro-tri scratch under
        # maxScratchMemorySize — the reference's batching EXECUTED
        # (bake_gpu_impl.cpp:517-584), not just planned; Nsight debug
        # mode runs one primitive per batch (:555-559).  A work item is
        # processed in the batch that owns its first source primitive,
        # by the CPU bake's fine pass (no coarse pass before it).
        pools = pre.transient_pool_buffer_sizes
        with span("omm.gpu.batches"):
            stats = {"batch_count": 0, "max_live_scratch_bytes": 0,
                     "transient_pool_sizes": pools}
            with span("omm.chunk"):
                degen = degenerate_mask(items)
                first = np.array([it.primitive_indices[0] for it in items],
                                 np.int64)
            for (s, e) in ranges:
                sel = (first >= s) & (first < e)
                if not sel.any():
                    continue
                live = sum(get_num_micro_triangles(items[i].subdivision_level)
                           * 8 for i in np.flatnonzero(sel))
                assert live <= pools[0], \
                    f"batch scratch {live} exceeds pool 0 ({pools[0]})"
                stats["batch_count"] += 1
                routes.count("gpu_batch")
                stats["max_live_scratch_bytes"] = max(
                    stats["max_live_scratch_bytes"], live)
                classify_fine(tex, rcfg, items, sel, degen, device,
                              exact=exact)
            self.last_dispatch_stats = stats

        # DescPatch: promote uniform primitives to special indices
        # (omm_desc_patch.cs.hlsl:23-200).  Reading `states` unpacks an
        # engine item's packed rows.
        with span("omm.desc_patch"):
            for it in items:
                st = it.states
                if not disable_special and bool((st == st[0]).all()):
                    it.special_index = -int(st[0]) - 1

        # the GPU layout's tail: the CPU bake's result writer
        # (bake.write_result) under a serialize descriptor of `cfg`
        with span("omm.gpu.tail"):
            sdesc = BakeInputDesc(
                texture=tex, tex_coords=cfg.tex_coords,
                index_buffer=cfg.index_buffer,
                index_count=cfg.index_count, format=cfg.global_format,
                unresolved_tri_state=SpecialIndex.FullyUnknownOpaque,
                bake_flags=BakeFlags.NONE)
            if cfg.bake_flags & GpuBakeFlags.Force32BitIndices:
                sdesc.bake_flags = BakeFlags.Force32BitIndices
            elif cfg.bake_flags & GpuBakeFlags.Allow8BitIndices:
                sdesc.bake_flags = BakeFlags.Allow8BitIndices
            result = write_result(sdesc, items)

        post = PostDispatchInfo(
            out_omm_array_size_in_bytes=len(result.array_data),
            out_omm_desc_size_in_bytes=8 * len(result.desc_array))
        if cfg.bake_flags & GpuBakeFlags.EnablePostDispatchInfoStats:
            s = collect_stats(result)
            post.out_stats_total_opaque_count = s.total_opaque
            post.out_stats_total_transparent_count = s.total_transparent
            post.out_stats_total_unknown_count = (
                s.total_unknown_opaque + s.total_unknown_transparent)
            post.out_stats_total_fully_opaque_count = s.total_fully_opaque
            post.out_stats_total_fully_transparent_count = s.total_fully_transparent
            post.out_stats_total_fully_unknown_count = (
                s.total_fully_unknown_opaque + s.total_fully_unknown_transparent)
        return result, post
