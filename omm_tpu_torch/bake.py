"""bake(): the JAX package's `bake(desc, backend="pallas")` with the
classification on a torch device.

The host half is the port's copy of `omm_tpu/bake.py`: work items
(`WorkItem`), the subdivision heuristics, `Options`, validation,
`setup_work_items`, `validate_workload_size` and `finalize_items` with
every stage it runs (promotion, exact and near-duplicate dedup,
compression, histograms, spatial sort, serialization).  Not carried
over: the speculative serialize blob, the `OMM_BAKE_TRACE` marks and
the backend switch.  The fine classification follows the
pallas backend's routes (`classify_items`): the two-phase engine
(`batch.classify_work_items_batches`, batched per subdivision level as
bake.py batches it), and the `classify` and `engine` passes for the
items off its fast path.  The GPU baker (`gpu/baker.py`) runs the same
fine pass (`classify_fine`) and result writer (`write_result`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import classify, engine, geom, host, native
from .batch import classify_work_items_batches
from .bit_tricks import xy_to_morton
from .log import Logger
from .mt19937 import MT19937
from .planes import check_device
from .spans import span
from .texture import Texture, get_tex_coord
from .types import (BakeError, BakeFlags, BakeInputDesc, BakeResult, Format,
                    IndexFormat, MicromapDesc, OpacityState, Result,
                    TextureAddressMode, TextureFilterMode,
                    UsageCount, get_bit_count, get_num_micro_triangles,
                    is_compatible, MAX_NUM_SUBDIV_LEVELS,
                    MAX_SUBDIV_LEVEL)
from .twophase import PackedStates, resolve_nearest_phase1

UO = int(OpacityState.UnknownOpaque)
UT = int(OpacityState.UnknownTransparent)

#: micro-triangles per batch (bake.py's bound on device scratch)
MAX_UTRI_PER_BATCH = 3 << 22

NO_SPECIAL_INDEX = 0  # OmmWorkItem::kNoSpecialIndex (bake_cpu_impl.cpp:456)

#: shared frozen all-UnknownOpaque state arrays, one per subdivision level
#: (see WorkItem.__post_init__)
_FRESH_TEMPLATES: dict[int, np.ndarray] = {}


def _fresh_template(level: int) -> np.ndarray:
    t = _FRESH_TEMPLATES.get(level)
    if t is None:
        t = np.full(get_num_micro_triangles(level), UO, dtype=np.uint8)
        t.flags.writeable = False
        _FRESH_TEMPLATES[level] = t
    return t


@dataclass
class WorkItem:
    """OmmWorkItem (bake_cpu_impl.cpp:436-462).

    `states` is a property (attached below the class): the device engine
    can hand back a serialize-ready PackedStates (sequential 2-bit rows,
    twophase.PackedStates) via set_packed_states(); the (4^N,)
    uint8 array then materializes lazily on first read, so the packed
    fast path (dedup by post digest, promotion by post uniform, blob
    memcpy in serialize_result) never touches the unpacked bytes."""

    subdivision_level: int
    vm_format: Format
    uv_tri: np.ndarray              # (3, 2) fp32
    primitive_indices: list[int]
    states: np.ndarray = None       # (4^N,) uint8; init UnknownOpaque
    special_index: int = NO_SPECIAL_INDEX
    desc_offset: int = 0xFFFFFFFF
    #: cached (states3 digest, uniform value) from the batch pipeline's
    #: fused post pass (native.row_post_packed); auto-cleared whenever
    #: `states` is reassigned (merges/downsampling build NEW arrays, so
    #: attribute assignment is the invalidation point)
    post: tuple | None = None

    def __setattr__(self, name, value):
        if name == "states":
            object.__setattr__(self, "post", None)
            object.__setattr__(self, "_fresh", False)
        elif name == "post" and value is not None:
            # The cache is only valid while `states` stays byte-identical;
            # reassignment invalidates it above, and in-place writes must
            # fail loudly rather than leave a stale digest live.
            s = self.__dict__.get("_states")
            if s is not None:
                s.flags.writeable = False
        object.__setattr__(self, name, value)

    def __post_init__(self):
        if self.__dict__.get("_states") is None \
                and self.__dict__.get("_packed2") is None:
            # provably all-UnknownOpaque and untouched: lets the bake
            # pass `states=None` to the classify engine (its declared
            # fresh-item form — no per-item min() scan); any later
            # `states` assignment clears the flag via __setattr__.
            # The template is frozen (writeable=False) so an in-place
            # write can't silently break the invariant, which also makes
            # it safe to SHARE one array across all fresh items of a
            # level — setup_work_items was spending ~35 ms/bake on
            # per-item np.full memsets the classify engine immediately
            # replaces (reassignment installs a fresh writable array).
            self.states = _fresh_template(self.subdivision_level)
            object.__setattr__(self, "_fresh", True)

    def set_packed_states(self, packed, post: tuple | None = None):
        """Install a PackedStates result (+ its fused post cache): the
        canonical bytes are the packed rows until someone reads .states,
        which materializes (and freezes) the unpacked array."""
        self.states = None            # clears post/_fresh via the hook
        self.__dict__["_packed2"] = packed
        if post is not None:
            self.post = post

    def packed2(self):
        """The serialize-ready sequential 2-bit rows, or None.  Valid
        whenever present: any states reassignment clears it, and the
        lazily-materialized array is frozen, so the packed bytes always
        mirror the logical states."""
        return self.__dict__.get("_packed2")

    def has_special_index(self) -> bool:
        return self.special_index != NO_SPECIAL_INDEX

    def states3(self) -> np.ndarray:
        """3-state view: UT==UO (OmmArrayDataView, bake_cpu_impl.cpp:374-377)."""
        return np.where(self.states == UT, np.uint8(UO), self.states)


def _workitem_states_get(self):
    d = self.__dict__
    s = d.get("_states")
    if s is None:
        pk = d.get("_packed2")
        if pk is not None:
            s = pk.unpack()
            # frozen like the post-cache contract: consumers copy before
            # mutating, and the packed rows stay authoritative
            s.flags.writeable = False
            d["_states"] = s
    return s


def _workitem_states_set(self, value):
    d = self.__dict__
    d["_states"] = value
    d["_packed2"] = None


WorkItem.states = property(_workitem_states_get, _workitem_states_set)


def split_tail_light(seq, schedule):
    """Split seq into batches by a descending size schedule: the head
    size repeats while enough items remain, then the tail sizes apply
    in order.  [128, 96, 32] over 256 items -> [128, 96, 32]; over 512
    -> [128, 128, 128, 96, 32].  The pipelined engine's LAST batch sets
    its non-overlapped fetch+reconstruct tail, so a small final batch
    raises end-to-end throughput (a plain fixed size is schedule=[n])."""
    head, tail = schedule[0], schedule[1:]
    tail_sum = sum(tail)
    out = []
    o = 0
    while len(seq) - o - tail_sum >= head:
        out.append(seq[o:o + head])
        o += head
    for s in tail:
        if o >= len(seq):
            break
        out.append(seq[o:o + s])
        o += s
    if o < len(seq):
        out.append(seq[o:])
    return out


# ---------------------------------------------------------------------------
# Subdivision-level heuristics (bake_cpu_impl.cpp:470-560)
# ---------------------------------------------------------------------------

def area_levels(tris: np.ndarray, sizef: np.ndarray, scale: float,
                max_level: int) -> np.ndarray:
    """ComputeAreaHeuristic (bake_cpu_impl.cpp:470-509), one level a row
    of the (T, 3, 2) fp32 UV triangles on a texture of `sizef` texels,
    under the dynamic subdivision scale `scale`, capped at `max_level`.
    The GPU baker's level rule runs it too."""
    scale = np.float32(scale)
    ratio_f = geom.uv_area(tris * sizef) / (scale * scale)
    # the uint32 cast of the ratio: an fp32's floor, and its remainder by
    # 2^32, are exact in float64; NaN, Inf and negative ratios give 0
    ok = np.isfinite(ratio_f) & (ratio_f >= 0)
    ratio = np.fmod(np.floor(np.where(ok, ratio_f, 0).astype(np.float64)),
                    2.0 ** 32)
    # log2(NextPow2(ratio)) with uint32 wrap: ceil(log2(ratio)), exact
    # from the float64 exponent (ratio = m * 2^e, a power of two where
    # m is 1/2); 0 for 0 and 1, and above 2^31, where NextPow2 wraps to 0
    m, e = np.frexp(ratio)
    log2 = np.where(ratio > 2.0 ** 31, 0, e - (m == 0.5))
    return np.minimum(log2 >> 1, max_level).astype(np.int64)


def _edge_levels(desc: BakeInputDesc, tris: np.ndarray,
                 sizef: np.ndarray) -> np.ndarray:
    """ComputeEdgeHeuristic (bake_cpu_impl.cpp:511-528), one level a row.
    A row whose level is NaN or Inf gets 0: one with a NaN or Inf vertex
    (skipped as invalid in any case), or whose scaled edges overflow."""
    ve = sizef * (tris[:, [1, 2, 2]] - tris[:, [0, 0, 1]])
    e_max = (ve[..., 0] * ve[..., 0] + ve[..., 1] * ve[..., 1]).max(axis=1)
    n = np.ceil(np.log2(e_max) / np.float32(2.0)
                - np.log2(np.float32(desc.dynamic_subdivision_scale)))
    n[~np.isfinite(n) | (e_max.astype(np.float64) < 1e-6)] = 0
    return np.clip(n.astype(np.int64), 0, desc.max_subdivision_level)


def _levels(desc: BakeInputDesc, opts, tris: np.ndarray, tex_size,
            overrides) -> np.ndarray:
    """GetSubdivisionLevel (bake_cpu_impl.cpp:542-560) of every row of
    `tris`; `overrides[k]`, where given and at most 12, is row k's."""
    tris = np.asarray(tris, dtype=np.float32)
    if desc.dynamic_subdivision_scale > 0:
        sizef = np.array(tex_size, dtype=np.float32)
        with np.errstate(all="ignore"):
            if opts.enable_edge_heuristic:
                levels = _edge_levels(desc, tris, sizef)
            else:
                levels = area_levels(tris, sizef,
                                     desc.dynamic_subdivision_scale,
                                     desc.max_subdivision_level)
                rows = np.flatnonzero(geom.is_degenerate(tris))
                if rows.size:
                    levels[rows] = _edge_levels(desc, tris[rows], sizef)
    else:
        levels = np.full(len(tris), desc.max_subdivision_level, np.int64)
    if overrides is not None:
        # indexed, not sliced: a short list raises, as it did per triangle
        ov = np.asarray(overrides)[np.arange(len(tris))].astype(np.int64)
        levels = np.where(ov <= MAX_SUBDIV_LEVEL, ov, levels)
    return levels


def subdivision_levels(desc: BakeInputDesc, opts, tris: np.ndarray,
                       tex_size) -> np.ndarray:
    """Every triangle's subdivision level in one array pass: int64, one a
    row of the (T, 3, 2) UV triangles, element for element the SDK's
    fp32 arithmetic."""
    return _levels(desc, opts, tris, tex_size, desc.subdivision_levels)


def get_subdivision_level(desc: BakeInputDesc, opts, i: int,
                          uv_tri: np.ndarray, tex_size) -> int:
    """bake_cpu_impl.cpp:542-560, triangle `i`."""
    ov = None if desc.subdivision_levels is None \
        else [desc.subdivision_levels[i]]
    return int(_levels(desc, opts, np.asarray(uv_tri)[None], tex_size,
                       ov)[0])


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------

@dataclass
class Options:
    """Decoded bake flags (bake_cpu_impl.cpp:61-85)."""

    enable_internal_threads: bool = False
    disable_special_indices: bool = False
    disable_duplicate_detection: bool = False
    enable_near_duplicate_detection: bool = False
    enable_near_duplicate_detection_brute_force: bool = False
    enable_validation: bool = False
    enable_aabb_testing: bool = False
    disable_level_line_intersection: bool = False
    disable_fine_classification: bool = False
    enable_edge_heuristic: bool = False

    @staticmethod
    def from_flags(flags: BakeFlags) -> "Options":
        f = BakeFlags(flags)
        return Options(
            enable_internal_threads=bool(f & BakeFlags.EnableInternalThreads),
            disable_special_indices=bool(f & BakeFlags.DisableSpecialIndices),
            disable_duplicate_detection=bool(f & BakeFlags.DisableDuplicateDetection),
            enable_near_duplicate_detection=bool(f & BakeFlags.EnableNearDuplicateDetection),
            enable_near_duplicate_detection_brute_force=bool(
                f & BakeFlags.EnableNearDuplicateDetectionBruteForce),
            enable_validation=bool(f & BakeFlags.EnableValidation),
            enable_aabb_testing=bool(f & BakeFlags.EnableAABBTesting),
            disable_level_line_intersection=bool(
                f & BakeFlags.DisableLevelLineIntersection),
            disable_fine_classification=bool(
                f & BakeFlags.DisableFineClassification),
            enable_edge_heuristic=bool(f & BakeFlags.EnableEdgeHeuristic),
        )


# ---------------------------------------------------------------------------
# Validation (bake_cpu_impl.cpp:235-290)
# ---------------------------------------------------------------------------

def validate_desc(desc: BakeInputDesc, opts: Options, log=None):
    """ValidateDesc (bake_cpu_impl.cpp:235-290); message strings match the
    reference exactly (they are contract-tested by test_omm_log.cpp)."""
    from .log import Logger, format_name, opacity_state_name
    log = log or Logger()
    if desc.texture is None:
        log.invalid_arg("[Invalid Argument] - texture is not set")
    elif desc.texture.channels != 1:
        # the reference CPU texture object is strictly single-channel
        # (ommCpuTextureFormat = FP32/UNORM8, texture_impl.cpp:40-66);
        # RGBA channel selection is a GPU-dispatch concept
        log.invalid_arg("[Invalid Argument] - texture must be "
                        "single-channel (use Texture.channel_view or the "
                        "GPU baker's alphaTextureChannel)")
    if desc.alpha_mode is None:
        log.invalid_arg("[Invalid Argument] - alphaMode is not set")
    if desc.runtime_sampler.addressing_mode is None:
        log.invalid_arg("[Invalid Argument] - "
                        "runtimeSamplerDesc.addressingMode is not set")
    if desc.runtime_sampler.filter is None:
        log.invalid_arg("[Invalid Argument] - runtimeSamplerDesc.filter "
                        "is not set")
    if desc.tex_coord_format is None:
        log.invalid_arg("[Invalid Argument] - texCoordFormat is not set")
    if desc.tex_coords is None:
        log.invalid_arg("[Invalid Argument] - texCoords is not set")
    if desc.index_format is None:
        log.invalid_arg("[Invalid Argument] - indexFormat is not set")
    if desc.index_buffer is None:
        log.invalid_arg("[Invalid Argument] - indexBuffer is not set")
    if desc.index_count == 0:
        log.invalid_arg("[Invalid Argument] - indexCount is not set")
    if desc.max_subdivision_level > MAX_SUBDIV_LEVEL:
        log.invalid_arg(f"[Invalid Argument] - maxSubdivisionLevel "
                        f"({desc.max_subdivision_level}) is greater than "
                        f"maximum supported ({MAX_SUBDIV_LEVEL})")
    if ((opts.enable_near_duplicate_detection
         or opts.enable_near_duplicate_detection_brute_force)
            and opts.disable_duplicate_detection):
        log.invalid_arg("[Invalid Argument] - EnableNearDuplicateDetection "
                        "or EnableNearDuplicateDetectionBruteForce is used "
                        "together with DisableDuplicateDetection")
    if opts.enable_validation and not log.has_logger():
        log.invalid_arg("[Invalid Argument] - EnableValidation is set but "
                        "no message callback was provided")
    tex: Texture = desc.texture
    if tex.has_alpha_cutoff() and tex.alpha_cutoff != desc.alpha_cutoff:
        log.invalid_arg(f"[Invalid Argument] - Texture object alpha cutoff "
                        f"threshold ({tex.alpha_cutoff:.6f}) is different "
                        f"from alpha cutoff threshold in bake input "
                        f"({desc.alpha_cutoff:.6f})")
    if not is_compatible(desc.alpha_cutoff_greater, desc.format):
        log.invalid_arg(f"[Invalid Argument] - alphaCutoffGreater="
                        f"{opacity_state_name(desc.alpha_cutoff_greater)} is "
                        f"not compatible with {format_name(desc.format)}")
    if not is_compatible(desc.alpha_cutoff_less_equal, desc.format):
        log.invalid_arg(f"[Invalid Argument] - alphaCutoffLessEqual="
                        f"{opacity_state_name(desc.alpha_cutoff_less_equal)} "
                        f"is not compatible with {format_name(desc.format)}")


# ---------------------------------------------------------------------------
# Stage 1: SetupWorkItems (bake_cpu_impl.cpp:589-660)
# ---------------------------------------------------------------------------

DISABLED_PRIMITIVE = 0xE


def setup_work_items(desc: BakeInputDesc, opts: Options,
                     log=None) -> list[WorkItem]:
    tex: Texture = desc.texture
    tri_count = desc.index_count // 3
    with span("omm.setup.triangles"):
        tris = geom.triangles_from_indices(
            np.asarray(desc.index_buffer)[:desc.index_count],
            desc.tex_coords, desc.tex_coord_format,
            desc.tex_coord_stride_in_bytes)
        tris = tris[:tri_count]
        # batched validity scan (identical per-element decisions to the
        # scalar geom calls; the per-tri python loop profiled at ~55 us/tri)
        if tri_count:
            inv_arr = np.asarray(geom.is_invalid(tris)).reshape(tri_count)
            if opts.disable_level_line_intersection:
                inv_arr = inv_arr | np.asarray(
                    geom.is_degenerate(tris)).reshape(tri_count)

    items: list[WorkItem] = []
    key_to_item: dict = {}
    tex_size = tex.size(0)
    num_disabled = 0

    # every triangle's level in one array pass over `tris`, then the
    # skips, formats and keys per triangle; the levels as Python ints,
    # the type of WorkItem.subdivision_level and of the dedup keys
    with span("omm.setup.levels"):
        # constant subdivision level unless per-tri levels / dynamic scale
        if (desc.subdivision_levels is None
                and not desc.dynamic_subdivision_scale > 0):
            subdivs = [desc.max_subdivision_level] * tri_count
        else:
            subdivs = subdivision_levels(desc, opts, tris, tex_size).tolist()

    with span("omm.setup.dedup"):
        for i, subdiv in enumerate(subdivs):
            disabled = subdiv == DISABLED_PRIMITIVE
            invalid = bool(inv_arr[i])
            if disabled or invalid:
                num_disabled += 1
                continue  # resolved to unresolvedTriState at serialize time
            uv_tri = tris[i]
            fmt = desc.format
            if desc.formats is not None \
                    and int(desc.formats[i]) != int(Format.INVALID):
                fmt = Format(int(desc.formats[i]))
            key = (uv_tri.tobytes(), subdiv, int(fmt))
            hit = key_to_item.get(key)
            if hit is None or opts.disable_duplicate_detection:
                if subdiv > MAX_SUBDIV_LEVEL:
                    raise BakeError(Result.INVALID_ARGUMENT,
                                    "subdivisionLevel exceeds kMaxSubdivLevel")
                key_to_item[key] = len(items)
                items.append(WorkItem(subdivision_level=subdiv, vm_format=fmt,
                                      uv_tri=uv_tri, primitive_indices=[i]))
            else:
                items[hit].primitive_indices.append(i)

    if opts.enable_validation and num_disabled != 0 and log is not None:
        from .log import special_index_name
        log.info(f"[Info] - The workload consists of {num_disabled} "
                 f"unclassifiable triangles, these will be classified as "
                 f"unresolvedTriState = "
                 f"{special_index_name(desc.unresolved_tri_state)}.")
    return items


def validate_workload_size(desc: BakeInputDesc, opts: Options,
                           items: list[WorkItem], log=None):
    """bake_cpu_impl.cpp:662-713."""
    limit = desc.max_workload_size != 0xFFFFFFFFFFFFFFFF
    if not opts.enable_validation and not limit:
        return
    tex: Texture = desc.texture
    sizef = np.array(tex.size(0), dtype=np.float32)
    workload = 0
    for it in items:
        s, e = geom.tri_aabb(it.uv_tri)
        aabb = ((e - s) * sizef).astype(np.int32)
        # uint64_t(int32 * int32): int32 wrap then sign-extend to uint64.
        with np.errstate(over="ignore"):
            v = int(np.int32(aabb[0] * aabb[1]))
        workload += v % (1 << 64)
    if limit and workload > desc.max_workload_size:
        raise BakeError(Result.WORKLOAD_TOO_BIG, "workload too big")

    if opts.enable_validation and workload > (1 << 27) and log is not None:
        num_1k = workload >> 20
        log.perf_warn(
            f"[Perf Warning] - The workload consists of {workload} work "
            f"items (number of texels to classify), which corresponds to "
            f"roughly {num_1k} 1024x1024 textures. This is unusually large "
            f"and may result in long bake times.")


# ---------------------------------------------------------------------------
# Stage: special-index promotion (bake_cpu_impl.cpp:1432-1472)
# ---------------------------------------------------------------------------

def promote_special_indices(desc: BakeInputDesc, opts: Options,
                            items: list[WorkItem]):
    for it in items:
        if it.has_special_index():
            continue
        # decide from the fused post cache when present so packed device
        # results never materialize their (4^N,) arrays on this pass
        u = it.post[1] if it.post is not None \
            else native.all_uniform_u8(it.states)
        all_equal = u >= 0
        common = int(u) if all_equal else UO
        if not all_equal and desc.rejection_threshold > 0.0:
            st = it.states
            known = int(np.count_nonzero((st == 0) | (st == 1)))
            if known / float(len(st)) < desc.rejection_threshold:
                all_equal = True
                common = UT
        if all_equal and not opts.disable_special_indices:
            it.special_index = -common - 1


# ---------------------------------------------------------------------------
# Stage: exact dedup (bake_cpu_impl.cpp:1031-1066)
# ---------------------------------------------------------------------------

def deduplicate_exact(opts: Options, items: list[WorkItem]):
    """Merge byte-identical state arrays.  Keyed by the XXH64 digest of
    the 3-state view, exactly like the reference (which dedups on the
    hash alone, bake_cpu_impl.cpp:1031-1066); the native digest fuses
    the UT->UO remap into the hash pass so no 4^N-byte copy is made."""
    if opts.disable_duplicate_detection:
        return
    def _digest(it):
        # the classify engine's fused post pass already hashed fresh
        # rows cache-warm; only mutated/slow-path items re-hash here
        return it.post[0] if it.post is not None \
            else native.states3_digest(it.states)

    ncpu = os.cpu_count() or 1
    todo = sum(1 for it in items if it.post is None)
    if todo > 8 and ncpu > 1:
        # the native digest releases the GIL: hash items in parallel
        # (single-core hosts skip the pool — it is pure overhead there)
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(max_workers=min(ncpu, 8)) as pool:
            digests = list(pool.map(_digest, items))
    else:
        digests = [_digest(it) for it in items]
    digest_to_idx: dict = {}
    for i, it in enumerate(items):
        digest = digests[i]
        j = digest_to_idx.get(digest)
        if j is None:
            digest_to_idx[digest] = i
        else:
            items[j].primitive_indices.extend(it.primitive_indices)
            it.primitive_indices = []
            it.special_index = -1


# ---------------------------------------------------------------------------
# Stage: near-duplicate merges (bake_cpu_impl.cpp:1093-1430)
# ---------------------------------------------------------------------------

def _merge_work_items(to: WorkItem, frm: WorkItem):
    """MergeWorkItems (bake_cpu_impl.cpp:1093-1132)."""
    to.primitive_indices.extend(frm.primitive_indices)
    frm.primitive_indices = []
    frm.special_index = -1
    ts = to.states
    fs = frm.states
    diff = ts != fs
    t_known = ts <= 1
    f_known = fs <= 1
    both_known = diff & t_known & f_known
    to_known_from_unknown = diff & t_known & ~f_known
    new = ts.copy()
    new[both_known] = UO
    new[to_known_from_unknown] = fs[to_known_from_unknown]
    to.states = new


def deduplicate_similar_lsh(desc: BakeInputDesc, opts: Options,
                            items: list[WorkItem],
                            iterations: int) -> bool:
    """LSH hamming bit-sampling merge (bake_cpu_impl.cpp:1134-1352);
    reproduces the reference's std::mt19937(42) draw sequence exactly.
    Returns True when any merge mutated states."""
    if opts.disable_duplicate_detection:
        return False
    if (not opts.enable_near_duplicate_detection
            or opts.enable_near_duplicate_detection_brute_force):
        return False
    any_merge = False

    mt = MT19937(42)

    for _attempt in range(iterations):
        for subdiv in range(1, MAX_SUBDIV_LEVEL + 1):
            batch = [i for i, it in enumerate(items)
                     if it.special_index == NO_SPECIAL_INDEX
                     and it.vm_format == Format.OC1_4_State
                     and it.subdivision_level == subdiv]
            if not batch:
                continue

            M = get_num_micro_triangles(subdiv)
            n = len(batch)
            d = M
            r = np.float32(desc.near_duplicate_deduplication_factor) * np.float32(d)
            c = 4.0
            L = int(np.ceil(np.float32(n) ** np.float32(1.0 / c)))
            if L == 0:
                continue
            k = int(np.ceil((np.float32(np.log(np.float32(n))) * np.float32(d))
                            / (np.float32(c) * r)))
            if k == 0:
                continue

            tables = []
            for _t in range(L):
                bit_indices = [mt() & (M - 1) for _ in range(k)]
                tables.append({"bits": bit_indices, "hashes": {},
                               "buckets": {}})

            for wi in batch:
                s3 = items[wi].states3()
                for tab in tables:
                    samples = np.array([s3[b] for b in tab["bits"]],
                                       dtype=np.uint32)
                    h = native.xxh64(samples.tobytes(), seed=42)
                    tab["hashes"][wi] = h
                    tab["buckets"].setdefault(h, []).append(wi)

            for wi in batch:
                it = items[wi]
                if it.has_special_index():
                    continue
                potential: set[int] = set()
                for tab in tables:
                    h = tab["hashes"][wi]
                    for cand in tab["buckets"][h]:
                        if cand == wi:
                            continue
                        if items[cand].has_special_index():
                            continue
                        if len(potential) > 3 * L:
                            break
                        potential.add(cand)
                min_dist = np.inf
                nearest = -1
                from . import native as _native
                s3w = it.states3()
                for cand in sorted(potential):
                    dist = float(_native.hamming_u8(
                        s3w, items[cand].states3()))
                    if dist < float(r) and dist < min_dist:
                        min_dist = dist
                        nearest = cand
                if nearest >= 0:
                    _merge_work_items(it, items[nearest])
                    any_merge = True
    return any_merge


def deduplicate_similar_brute_force(opts: Options,
                                    items: list[WorkItem]) -> bool:
    """bake_cpu_impl.cpp:1354-1430.  Returns True on any merge."""
    if opts.disable_duplicate_detection:
        return False
    if (not opts.enable_near_duplicate_detection
            or not opts.enable_near_duplicate_detection_brute_force):
        return False
    if not items:
        return False

    MERGE_THRESHOLD = 0.1
    MAX_COMPARISONS = 2048
    merged: set[int] = set()
    for a in range(len(items) - 1):
        ia = items[a]
        if ia.special_index != NO_SPECIAL_INDEX:
            continue
        if ia.vm_format != Format.OC1_4_State:
            continue
        start = a + 1
        end = min(MAX_COMPARISONS + start, len(items))
        min_dist = np.inf
        nearest = -1
        for b in range(start, end):
            ib = items[b]
            if ib.special_index != NO_SPECIAL_INDEX:
                continue
            if ib.vm_format != Format.OC1_4_State:
                continue
            if not ib.primitive_indices:
                continue
            if ia.subdivision_level != ib.subdivision_level:
                continue
            if b in merged:
                continue
            from . import native as _native
            M = get_num_micro_triangles(ia.subdivision_level)
            dist = float(_native.hamming_u8(ia.states3(), ib.states3())) / M
            if dist < MERGE_THRESHOLD and dist < min_dist:
                min_dist = dist
                nearest = b
        if nearest >= 0:
            merged.add(a)
            merged.add(nearest)
            _merge_work_items(ia, items[nearest])
    return bool(merged)


# ---------------------------------------------------------------------------
# Stage: memory-budget downsampling (bake_cpu_impl.cpp:1557-1688)
# ---------------------------------------------------------------------------

def _known_ratio(it: WorkItem) -> float:
    s3 = it.states3()
    known = int(np.count_nonzero(s3 <= 1))
    return known / float(len(s3))


def _downsample_known_ratio(it: WorkItem) -> float:
    """DownsampleOneLevel const-variant (bake_cpu_impl.cpp:1531-1555)."""
    s3 = it.states3().reshape(-1, 4)
    ok = (s3[:, 0] <= 1) & (s3[:, 0] == s3[:, 1]) & (s3[:, 0] == s3[:, 2]) \
        & (s3[:, 0] == s3[:, 3])
    return int(np.count_nonzero(ok)) / float(s3.shape[0])


def _downsample_one_level(it: WorkItem):
    """bake_cpu_impl.cpp:1499-1529."""
    if it.subdivision_level == 0:
        raise BakeError(Result.FAILURE, "cannot downsample level 0")
    it.subdivision_level -= 1
    s3 = it.states3().reshape(-1, 4)
    ok = (s3[:, 0] <= 1) & (s3[:, 0] == s3[:, 1]) & (s3[:, 0] == s3[:, 2]) \
        & (s3[:, 0] == s3[:, 3])
    new = np.where(ok, s3[:, 0], np.uint8(UO)).astype(np.uint8)
    it.states = new


def _item_info(desc: BakeInputDesc, it: WorkItem) -> dict:
    """ComputeWorkItemInfo (bake_cpu_impl.cpp:1572-1595)."""
    known = np.float32(_known_ratio(it))
    known_ds = np.float32(_downsample_known_ratio(it))
    area = np.float32(geom.uv_area(it.uv_tri))
    total_area = np.float32(0.0)
    for _ in it.primitive_indices:
        total_area = np.float32(total_area + area)
    mem = max(1, (get_num_micro_triangles(it.subdivision_level) * 2) // 8)
    mem_ds = max(1, (get_num_micro_triangles(it.subdivision_level - 1) * 2) // 8)
    delta = mem - mem_ds
    cov_delta = np.float32(known - known_ds)
    # delta==0 at level 1 (both byte sizes clamp to 1); the reference's C++
    # float division yields inf/nan silently — keep IEEE semantics, no warn.
    with np.errstate(divide="ignore", invalid="ignore"):
        cpb = float(np.float32(total_area * cov_delta) / np.float32(delta))
    return {"mem": mem, "mem_ds": mem_ds, "cpb": cpb}


def compress(desc: BakeInputDesc, opts: Options,
             items: list[WorkItem]) -> bool:
    """Returns True when any item was downsampled (states mutated)."""
    if desc.max_array_data_size == 0xFFFFFFFF:
        return False
    active = []
    for i, it in enumerate(items):
        if it.subdivision_level == 0 or not it.primitive_indices \
                or it.has_special_index():
            continue
        active.append([i, _item_info(desc, it)])

    total = sum(a[1]["mem"] for a in active)
    if total < desc.max_array_data_size:
        return False

    active.sort(key=lambda a: a[1]["cpb"])
    while total >= desc.max_array_data_size and active:
        n = len(active)
        i = 0
        while i < n:
            idx = active[i][0]
            it = items[idx]
            total -= active[i][1]["mem"]
            _downsample_one_level(it)
            total += active[i][1]["mem_ds"]
            if it.subdivision_level == 0:
                active[i][0] = -1
                i += 1
                continue
            active[i][1] = _item_info(desc, it)
            if total < desc.max_array_data_size:
                break
            if i + 1 != n and active[i][1]["cpb"] < active[i + 1][1]["cpb"]:
                continue  # redo same item (i-- then i++ in the reference)
            i += 1
        # swap-remove dead entries then resort (bake_cpu_impl.cpp:1668-1684)
        j = 0
        while j < len(active):
            if active[j][0] == -1:
                active[j], active[-1] = active[-1], active[j]
                active.pop()
            else:
                j += 1
        active.sort(key=lambda a: a[1]["cpb"])
    return True


# ---------------------------------------------------------------------------
# Stages: histograms, spatial sort, serialize (bake_cpu_impl.cpp:1690-1920)
# ---------------------------------------------------------------------------

def create_usage_histograms(items: list[WorkItem]):
    arr = np.zeros((3, MAX_NUM_SUBDIV_LEVELS), dtype=np.uint64)
    idxh = np.zeros((3, MAX_NUM_SUBDIV_LEVELS), dtype=np.uint64)
    for it in items:
        if it.special_index == NO_SPECIAL_INDEX:
            arr[int(it.vm_format) - 1, it.subdivision_level] += 1
            idxh[int(it.vm_format) - 1, it.subdivision_level] += len(
                it.primitive_indices)
    return arr, idxh


def micromap_spatial_sort(items: list[WorkItem]) -> list[int]:
    """bake_cpu_impl.cpp:1707-1754: descending (key, index) order;
    special-index items first, regular items by (subdiv, morton) desc.
    One batched centroid->morton pass (same fp32 op order per element
    as the scalar form) instead of a per-item python loop."""
    n = len(items)
    if n == 0:
        return []
    keys = np.empty(n, np.uint64)
    spec = np.fromiter((it.special_index != NO_SPECIAL_INDEX
                        for it in items), bool, n)
    sidx = np.flatnonzero(spec)
    keys[sidx] = (np.uint64(1) << np.uint64(63)) | sidx.astype(np.uint64)
    reg = np.flatnonzero(~spec)
    if reg.size:
        K = 13
        q_size = np.array([1 << K, 1 << K], dtype=np.int32)
        t = np.stack([items[i].uv_tri for i in reg]).astype(np.float32)
        centroid = (t[:, 0] + t[:, 1] + t[:, 2]) / np.float32(3.0)
        q_uv = (q_size.astype(np.float32) * centroid).astype(np.int32)
        q_pos = get_tex_coord(TextureAddressMode.MirrorOnce, q_uv,
                              q_size, np.array([0, 0], np.int32), False)
        mcode = xy_to_morton(q_pos[:, 0].astype(np.uint32),
                             q_pos[:, 1].astype(np.uint32))
        lev = np.fromiter((items[i].subdivision_level for i in reg),
                          np.uint64, reg.size)
        keys[reg] = (lev << np.uint64(60)) | mcode.astype(np.uint64)
    # ascending lexsort by (key, index), reversed == the reference's
    # descending (key, index) tuple sort
    order = np.lexsort((np.arange(n), keys))[::-1]
    return [int(i) for i in order]


def serialize_result(desc: BakeInputDesc, items: list[WorkItem],
                     arr_hist: np.ndarray, idx_hist: np.ndarray,
                     order: list[int], allocator=None) -> BakeResult:
    """bake_cpu_impl.cpp:1756-1920.  Output buffers go through the
    user allocator when one is supplied (std_allocator.h analog).  The
    original's speculative result blob is not carried over: the port
    copies every packed row once."""
    from .allocator import check_and_set_default
    allocator = check_and_set_default(allocator)
    bit_count = get_bit_count(desc.format)

    desc_count = 0
    array_size = 0
    for lvl in range(MAX_NUM_SUBDIV_LEVELS):
        cnt = int(arr_hist[int(desc.format) - 1, lvl])
        desc_count += cnt
        nbits = get_num_micro_triangles(lvl) * bit_count
        array_size += cnt * max(nbits >> 3, 1)
    if array_size > 0xFFFFFFFF:
        raise BakeError(Result.FAILURE, "array data > 4GB")

    array_data = allocator.array(array_size, np.uint8)
    desc_array: list[MicromapDesc] = []
    if desc_count != 0:
        offset = 0
        pack_plan: list = []
        for vm_index in order:
            it = items[vm_index]
            if it.special_index != NO_SPECIAL_INDEX:
                continue
            if offset >= array_size:
                raise BakeError(Result.FAILURE, "array data overflow")
            desc_array.append(MicromapDesc(offset=offset,
                                           subdivision_level=it.subdivision_level,
                                           format=int(it.vm_format)))
            it.desc_offset = len(desc_array) - 1
            M = get_num_micro_triangles(it.subdivision_level)
            stride = max((M * bit_count) >> 3, 1)
            bits = 1 if it.vm_format == Format.OC1_2_State else 2
            pk = it.packed2()
            if pk is not None and bits == 2 and len(pk.packed) == stride:
                # device engine already produced the blob bytes
                # (PackedStates rows ARE the OC1_4_State layout)
                array_data[offset:offset + stride] = pk.packed
                offset += stride
                continue
            # collect, then pack the whole blob in ONE native call;
            # packed length always equals the stride (M is a power of 4)
            st = np.ascontiguousarray(it.states, dtype=np.uint8)
            pack_plan.append((st, bits, offset, stride))
            offset += stride
        if not native.pack_states_batch(
                [p[0] for p in pack_plan], [p[1] for p in pack_plan],
                [p[2] for p in pack_plan], array_data):
            for st, bits, off, stride in pack_plan:
                if not native.pack_states_into(
                        st, bits, array_data[off:off + stride]):
                    packed = native.pack_states(st, bits)
                    array_data[off:off + len(packed)] |= packed

    def hist_list(h):
        out = []
        for fmt in (Format.OC1_2_State, Format.OC1_4_State):
            for lvl in range(MAX_NUM_SUBDIV_LEVELS):
                cnt = int(h[int(fmt) - 1, lvl])
                if cnt:
                    out.append(UsageCount(count=cnt, subdivision_level=lvl,
                                          format=int(fmt)))
        return out

    tri_count = desc.index_count // 3
    index_buffer = np.full(tri_count, int(desc.unresolved_tri_state),
                           dtype=np.int32)
    for it in items:
        for prim in it.primitive_indices:
            if it.special_index != NO_SPECIAL_INDEX:
                index_buffer[prim] = it.special_index
            else:
                # desc_offset is uint32 (0xFFFFFFFF when never assigned,
                # possible with mixed per-triangle formats — the reference
                # stores it into the int32 buffer with wraparound).
                v = it.desc_offset
                index_buffer[prim] = v - (1 << 32) if v >= (1 << 31) else v

    flags = BakeFlags(desc.bake_flags)
    allow8 = bool(flags & BakeFlags.Allow8BitIndices)
    force32 = bool(flags & BakeFlags.Force32BitIndices)
    if allow8 and tri_count <= 127 and not force32:
        fmt = IndexFormat.UINT_8
    elif tri_count <= 32767 and not force32:
        fmt = IndexFormat.UINT_16
    else:
        fmt = IndexFormat.UINT_32

    tri_area = np.zeros(tri_count, dtype=np.float32)
    tris = geom.triangles_from_indices(
        np.asarray(desc.index_buffer)[:desc.index_count], desc.tex_coords,
        desc.tex_coord_format, desc.tex_coord_stride_in_bytes)
    areas = np.asarray(geom.uv_area(tris), np.float32).reshape(-1) \
        if tri_count else np.zeros(0, np.float32)  # one batched pass
    for it in items:
        for prim in it.primitive_indices:
            tri_area[prim] = areas[prim]

    return BakeResult(array_data=array_data, desc_array=desc_array,
                      desc_array_histogram=hist_list(arr_hist),
                      index_buffer=index_buffer, index_format=fmt,
                      index_histogram=hist_list(idx_hist),
                      triangle_area=tri_area)


def finalize_items(desc: BakeInputDesc, opts: Options,
                   items: list[WorkItem], allocator=None) -> BakeResult:
    """The global tail of bake() — promotion, dedup (exact + near-dup),
    compression, histograms, spatial sort, serialization.  These stages
    couple across ALL work items (dedup maps, the compress budget sort),
    so the exact bake farm replays this tail once over the gathered
    global item list (parallel/multihost.merge_exact)."""
    # spans split omm.finalize in torch.profiler traces
    with span("omm.promote"):
        promote_special_indices(desc, opts, items)
    with span("omm.dedup_exact"):
        deduplicate_exact(opts, items)
    with span("omm.dedup_near"):
        changed = deduplicate_similar_lsh(desc, opts, items, iterations=3)
        changed |= deduplicate_similar_brute_force(opts, items)
    with span("omm.promote"):
        promote_special_indices(desc, opts, items)
    with span("omm.compress"):
        changed |= compress(desc, opts, items)
    if changed:
        # only near-duplicate merges or downsampling can mint new exact
        # duplicates / uniform items; when none ran, the second dedup +
        # promotion passes are identities (the reference runs them
        # unconditionally, but they observably do nothing then)
        with span("omm.dedup_exact"):
            deduplicate_exact(opts, items)
        with span("omm.promote"):
            promote_special_indices(desc, opts, items)
    return write_result(desc, items, allocator=allocator)


def write_result(desc: BakeInputDesc, items: list[WorkItem],
                 allocator=None) -> BakeResult:
    """The result of the classified, promoted `items`: usage histograms,
    spatial sort and serialization under `desc`.  The end of
    `finalize_items`, and the GPU baker's whole tail."""
    with span("omm.histograms"):
        arr_hist, idx_hist = create_usage_histograms(items)
    with span("omm.sort"):
        order = micromap_spatial_sort(items)
    with span("omm.serialize"):
        return serialize_result(desc, items, arr_hist, idx_hist, order,
                                allocator=allocator)


# ---------------------------------------------------------------------------
# Classification on a torch device, and the top-level bake
# ---------------------------------------------------------------------------

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
                   device, mesh=None, sel=None) -> None:
    """The classification half of bake(), mutating `items` in place, in
    the order of the JAX package's pallas route (bake.py:1130-1326): with
    a mesh, the fresh fast-path items over the mesh (`_classify_on_mesh`);
    the coarse pass; for the nearest filter, the phase-1 window resolve of
    each subdivision level, then its survivors through
    `classify.classify_nearest_survivors_batch` (one stream per level);
    then `classify_fine`: the two-phase engine's batches for the
    linear-filter, level-line, non-degenerate items, and every other
    item through `engine.resample_fine_item`: line triangles (the linear
    filter's degenerate pass, or the nearest filter's), and without
    level lines the AABB debug kernels.  sel: a bool mask over `items`
    (default all) that restricts every pass to the selected items; the
    exact farm classifies only the items its process owns
    (parallel/multihost.py)."""
    tex = desc.texture
    cfg = _config(desc, opts)
    if opts.enable_aabb_testing and not opts.disable_level_line_intersection:
        raise BakeError(
            Result.INVALID_ARGUMENT,
            "EnableAABBTesting requires DisableLevelLineIntersection")
    sel = (np.ones(len(items), bool) if sel is None
           else np.asarray(sel, bool).copy())
    with span("omm.chunk"):
        degen = degenerate_mask(items)
    linear_ll = (cfg.filter == TextureFilterMode.Linear
                 and not cfg.disable_level_line)
    nearest = cfg.filter == TextureFilterMode.Nearest

    if mesh is not None and linear_ll and not cfg.disable_fine:
        # sharded items skip every later pass: the engine's descent
        # resolves what the coarse pass would, and the exact stage the rest
        sel &= ~_classify_on_mesh(tex, cfg, items, sel & ~degen, mesh)
    with span("omm.coarse"):
        for i in np.flatnonzero(sel):
            it = items[i]
            st = engine.resample_coarse_item(tex, cfg, it.uv_tri,
                                             it.subdivision_level, it.states)
            if st is not it.states:  # identity (no SAT): keep _fresh valid
                it.states = st
    if cfg.disable_fine or not items:
        return

    if nearest:
        for level, idxs in _by_level(items, sel & ~degen).items():
            res = resolve_nearest_phase1(
                tex, cfg, [(items[i].uv_tri, items[i].states) for i in idxs],
                level, device)
            if res is not None:
                for i, st in zip(idxs, res):
                    items[i].states = st
        for level, idxs in _by_level(items, sel & ~degen).items():
            res = classify.classify_nearest_survivors_batch(
                tex, cfg, [(items[i].uv_tri, items[i].states) for i in idxs],
                level, device)
            for i, st in zip(idxs, res):
                set_states(items[i], st)
        sel &= degen  # the line triangles are left
    classify_fine(tex, cfg, items, sel, degen, device, posts=True)


def degenerate_mask(items) -> np.ndarray:
    """Which of `items` are line triangles (geom.is_degenerate), one
    batched pass."""
    if not items:
        return np.zeros(0, bool)
    return np.asarray(geom.is_degenerate(
        np.stack([it.uv_tri for it in items]))).reshape(len(items))


def level_chunks(idxs: list, level: int) -> list:
    """`idxs`, items of one subdivision level, cut into the two-phase
    engine's batches: at most MAX_UTRI_PER_BATCH micro-triangles each
    (bake.py's bound on device scratch), by `split_tail_light`."""
    return split_tail_light(
        idxs, [max(1, MAX_UTRI_PER_BATCH // get_num_micro_triangles(level))])


def classify_fine(tex, cfg, items, sel, degen, device, *, exact=None,
                  posts=False) -> None:
    """The fine pass over the items that the bool mask `sel` selects,
    mutating them in place; `degen` is `degenerate_mask(items)`.  Under
    the linear filter with level lines, the non-degenerate ones go
    through the two-phase engine (`classify_work_items_batches`, its
    exact stage's engine `exact`) in one call: largest level first, each
    level in `level_chunks`; with `posts`, each result's fused post pass
    is installed with it.  Every other selected item goes through
    `engine.resample_fine_item`, which routes it by the configuration.
    Both bakers run it: `classify_items` after its coarse and nearest
    passes, the GPU baker once per scratch batch."""
    if cfg.filter == TextureFilterMode.Linear and not cfg.disable_level_line:
        with span("omm.chunk"):
            chunks, levels = [], []
            for level, idxs in sorted(_by_level(items, sel & ~degen).items(),
                                      reverse=True):
                cs = level_chunks(idxs, level)
                chunks.extend(cs)
                levels.extend([level] * len(cs))
            batches = [[(items[i].uv_tri,
                         None if getattr(items[i], "_fresh", False)
                         else items[i].states) for i in c] for c in chunks]
        post_out = [] if posts else None
        outs = classify_work_items_batches(tex, cfg, batches, levels,
                                           device=device, exact=exact,
                                           post_out=post_out)
        with span("omm.set_states"):
            for k, (c, res) in enumerate(zip(chunks, outs)):
                pd = post_out[k] if posts else {}
                for bi, (i, st) in enumerate(zip(c, res)):
                    set_states(items[i], st, pd.get(bi))
        sel = sel & degen
    for i in np.flatnonzero(sel):
        it = items[i]
        set_states(it, engine.resample_fine_item(
            tex, cfg, it.uv_tri, it.subdivision_level, it.states, device))


def _classify_on_mesh(tex, cfg, items, cand, mesh) -> np.ndarray:
    """Classify the fresh, fast-path eligible, winding-stable items among
    `cand` (a bool mask) over the mesh, level by level, each level padded
    to a multiple of the mesh size with copies of its first item
    (omm_tpu/bake.py:1136-1164).  Returns the mask of the items it
    classified."""
    from .parallel.shard import classify_slices

    fresh = np.array([getattr(it, "_fresh", False)
                      or int(it.states.min()) == UO for it in items], bool)
    done = np.zeros(len(items), bool)
    for level, idxs in _by_level(items, cand & fresh).items():
        uvs = [items[i].uv_tri for i in idxs]
        lg = host._group_level(tex, uvs, level)
        # the batched form of the JAX bake's per-item test
        # (_fast_path_ok and winding_stable)
        mask = host._fast_path_mask(tex, cfg, np.stack(uvs), level, lg)
        ok = [i for i, m in zip(idxs, mask) if m]
        if not ok:
            continue
        padded = ok + ok[:1] * ((-len(ok)) % mesh.size)
        outs = classify_slices(mesh, tex, cfg,
                               [items[i].uv_tri for i in padded], level)
        for i, st in zip(ok, outs):
            set_states(items[i], st)
            done[i] = True
    return done


def set_states(it, st, post=None):
    """Install a classification result on a work item: a PackedStates as
    its packed rows, an array as its states (unless it is the item's
    own: an identity keeps the item's caches); then `post`, the batch
    pipeline's (states3 digest, uniform value) of the result, where
    there is one."""
    if isinstance(st, PackedStates):
        it.set_packed_states(st, post)
        return
    if st is not it.states:
        it.states = st
    if post is not None:
        it.post = post


def _by_level(items, sel) -> dict:
    """Indices of the selected items, by subdivision level."""
    by_level: dict[int, list[int]] = {}
    for i in np.flatnonzero(sel):
        by_level.setdefault(items[i].subdivision_level, []).append(int(i))
    return by_level


def bake(desc: BakeInputDesc, device="cuda", logger=None,
         allocator=None, mesh=None) -> BakeResult:
    """Bake `desc` with the fine classification on `device`, a torch
    device: "cuda" (the default) runs the hand-written exact kernel and
    raises where there is no CUDA device; "cpu" runs its plain twin.
    The result is byte-equal to `omm_tpu.bake(desc, backend="pallas")`
    for every descriptor, whichever routes its items take
    (`classify_items`): the two-phase engine, the dense and survivors
    level-line passes, line triangles, the nearest filter, and the AABB
    debug kernels.  mesh: a `parallel.make_mesh` mesh; with the linear
    filter and level lines, its slots classify the fresh fast-path items
    (byte-equal to `omm_tpu.bake(desc, backend="pallas", mesh=...)`),
    and every other item runs on `device`."""
    device = check_device(device)
    log = logger or Logger()
    opts = Options.from_flags(desc.bake_flags)
    if desc.texture is None:
        log.invalid_arg("[Invalid Argument] - ommCpuBakeInputDesc has no "
                        "texture set")
    with span("omm.setup"):
        with span("omm.setup.validate"):
            validate_desc(desc, opts, log)
        items = setup_work_items(desc, opts, log)
        with span("omm.setup.validate"):
            validate_workload_size(desc, opts, items, log)
    with span("omm.classify"):
        classify_items(desc, opts, items, device, mesh=mesh)
    with span("omm.finalize"):
        return finalize_items(desc, opts, items, allocator=allocator)
