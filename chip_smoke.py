#!/usr/bin/env python3
"""Smoke test of omm_tpu_torch on one CUDA card: the quickest proof that
the port builds, runs its main path through its kernels, and is right.

    python3 chip_smoke.py [--parent DIR]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

  1. device  card name and power limit (nvidia-smi), torch and CUDA
             versions; no CUDA device is an error, never a CPU fallback
  2. build   the exact-classification kernel and the capacity chain's
             kernels, two libraries compiled at once by nvcc for sm_90a
             from omm_tpu_torch/csrc/, with ptxas's register and spill
             report and the exact kernel's launch shape
  3. kernel  two slot streams from the port's stage_ab on the card: the
             first 48-triangle batch of the benchmark workload (1024^2
             FP32 clamp texture, 256 triangles from RandomState(42),
             subdivision 9; window 4x4) and the same triangles at
             subdivision 6 (a window of more than 32 texels); on each
             the hand kernel and its plain torch twin must give exactly
             equal counts.  On the bench stream: the work the stage must
             do (exact_work) and its bound, and both versions' time by
             CUDA events (median of 21 bursts of 5 calls after 3
             warm-ups)
  4. slice   omm_tpu_torch.bake(desc), on the card by default, on the
             whole workload: 2 warm-ups, 5 timed bakes, each ending with
             the result on the host; the kernel's launch count must grow
  5. correct the five timed bakes are byte-equal; the result has the
             expected shape (one index per triangle, every descriptor
             at subdivision 9 with its 2-bit states in array_data); the
             BakeResult of the first 16 triangles baked on the card is
             byte-equal to the port's bake of them on the CPU, where the
             exact stage runs its plain torch twin
  6. nearest the benchmark workload with the nearest filter: 2 warm-ups,
             5 timed bakes, byte-equal to one another, the first 16
             triangles on the card byte-equal to the CPU bake; the
             micro-triangles phase-1 resolved and those left to the
             survivors pass
  7. mixed   one descriptor of 312 triangles over every linear route:
             the 256 benchmark triangles at subdivision 9 (fast path,
             exact kernel), 16 line triangles (collinear UVs from
             RandomState(43)) and 16 fp32-thin slivers at 9, 8 triangles
             at level 0 and 8 at level 1, 8 texture-spanning triangles
             at level 3 (windows of ~128 texels); timed like phase 6,
             every route must take items, and a subset with items of
             every route is byte-equal on the card and on the CPU
  8. aabb    16 triangles with DisableLevelLineIntersection |
             EnableAABBTesting, byte-equal on the card and on the CPU
  9. timing  the kernel's device time on the bench stream (torch.profiler
             over 50 launches) and its share of the bound; last, so that
             the profiler's tracing does not reach the timed bakes
 10. gpu     (runs before phase 9) the GPU baker's dispatch chain,
             omm_tpu_torch.gpu.Pipeline().dispatch(cfg) on the card by
             default, of the benchmark workload in channel 3 of a 1024^2
             RGBA FP32 texture (channels 0-2: the plane transposed,
             shifted and inverted), default flags and scratch budget: 2
             warm-ups, 5 timed execute() calls, byte-equal, with 6 exact
             launches per dispatch (2 scratch batches of 128 triangles,
             chunks of 48, 48 and 32); the same with ComputeOnly (the
             kernel's torch twin), byte-equal to the default engine with
             no launch; byte-equal to a dispatch of the single-channel
             plane and to PerformSetup then PerformBake twice on one
             Pipeline; the chain recorded clean by RecordingRHI; 16
             triangles on the card byte-equal, PostDispatchInfo with
             stats included, to the dispatch on the CPU
 11. farm    (runs before phase 9) the multi-device bake of the
             benchmark workload: (a) ot.bake(desc, mesh=make_mesh()), a
             slot per card, and (b) a mesh of two slots on cuda:0 (two
             threads on one card), each 2 warm-ups and 5 timed bakes in
             turns with the plain bake, byte-equal to it, with 6 exact
             launches per bake (slices of 256, or 128 + 128, in batches of
             48/48/.../16 or 48/48/32); (c) the exact farm: two worker
             processes (this script with --farm-worker) joined by
             torch.distributed over gloo on a localhost port, both on the
             card, each timing classify_partition and bake_partition of
             its half (3 exact launches each) and all_gather_object-ing
             its blobs, times and launches; merge_exact of the gathered
             blobs must be byte-equal to the plain bake, and the partition
             blobs' dedup_loss within its bound; the classify wall time of
             the farm beside one process classifying every item
 12. surface (runs before phase 9) the library surface and the tools,
             all on the card by default: (a) the benchmark workload
             through ot.Baker().bake(desc) and ot.capi.omm_cpu_bake(bk,
             desc) in turns with ot.bake(desc), 2 warm-ups and 5 timed
             calls each, byte-equal to ot.bake's with 6 exact launches per
             bake; (b) the vegetation scene (BASELINE.json config 5 at
             examples/vegetation_scene.py's defaults: a 512^2 foliage
             atlas, FP32 with the cutoff 0.5 embedded, 200 quads = 400
             triangles over 6 UV variants, EnableNearDuplicateDetection)
             through one Baker at subdivision 7 (the example's dynamic
             subdivision scale, 2.0: levels 5-6) and at 9 with the scale
             at 0 (every triangle at 9), 2 warm-ups and 5 timed bakes
             each, byte-equal, round-tripped through
             Baker.serialize(compress=True); the level-9 bakes must launch
             the exact kernel; at each level the card's BakeResult is
             byte-equal to Baker.bake(desc, device="cpu"); at level 7
             integration.dump_debug_compare reports equal stats, and the
             D3D12 and Vulkan build inputs agree; (c) the tools on the
             level-7 scene's blob: cli bake on the card and with --device
             cpu (the same JSON, byte-equal blobs), cli viewer with a
             tweak, a ViewerSession re-baked on the card against one on
             the CPU (equal stats, np.array_equal overlays from
             debug.render_overlay, string-equal tui.render_ansi frames);
             the exact launch count must grow across (c)
 13. spots   (runs before phase 9) bench.py's spot configurations at full
             size, each through omm_tpu_torch.bake on the card (2 warm-ups,
             5 timed bakes, byte-equal; peak device memory beside what
             was held before them; items per route; the exact kernel must
             be launched and the fast path take every work item):
             (a) subdivision 11, bench.py _spot_highsubdiv's 4 triangles
             (16,777,216 utri); (b) subdivision 12, _spot_subdiv12's 2
             triangles (33,554,432 utri, one item per batch); (c) the
             bench triangles 0-15 at subdivision 10; (d) the 256 bench
             triangles as t*3+1 under Wrap, and the same under Mirror;
             (e) _spot_multimip's 3-mip chain (128/64/32 crops of a
             RandomState(5) plane, 2 triangles at 6), and the benchmark
             circle drawn at 1024/512/256 under the 256 bench triangles
             at 9; (f) _spot_unorm8's 1024^2 UNORM8 soft contour under
             the 256 bench triangles at 9; (g) 1024 triangles (bench
             triangle k % 256) at 9, 268,435,456 utri, with
             DisableDuplicateDetection so that all 1024 are classified;
             (h) 384 triangles at levels 7/8/9 x 128 through
             subdivision_levels; (i) the GPU baker's dispatch of the
             bench triangles on the 1024/512/256 chain in channel 3 of an
             RGBA texture under Wrap, byte-equal to the same dispatch
             with ComputeOnly (no launch).  Card against CPU, byte-equal:
             the whole of (a), (b), (c) and of the small 3-mip chain, the
             first 16 triangles of the others (the last 16 of (g)), with
             PostDispatchInfo for (i).  Then the exact stage on the first
             batch's slot stream of (a), (b), (d) and (f): kernel equal
             to its twin, exact_work, bound and both versions' event time

 14. spec    (runs before phase 9, after 13) the single-sync batch
             pipeline on a fresh bench texture: (a) the first bake runs
             every batch on the discovery path (exact sizes, host count
             reads; it records the caps entries), the second on the
             capacity chain, capturing one CUDA graph per batch shape;
             then 5 bakes on the chain (graph replays) in turns with 5
             whose caps cache is emptied before each (the discovery
             path): best and median of each, batches per path, captures,
             replays, exact launches and count syncs per bake (the chain:
             6 of 6 batches, no overflow, at most one count sync per
             batch), all byte-equal; 16 triangles through the discovery,
             capturing and replaying bakes on the card byte-equal to the
             CPU's discovery and capacity-chain bakes; (b) the caps cache
             seeded at an eighth of each capacity: every batch flags its
             overflow, is rerun on the discovery path, stays byte-equal,
             and its entry grows to the discovery path's; (c) the GPU
             baker's dispatch, default engine and ComputeOnly, on the
             chain after warm-up, byte-equal to each other and to its
             discovery dispatch; (d) one profiled bench bake
             (tools/profile_torch_bake.py --workload bench: kernel and
             graph launch calls, omm.* labels, device idle share); and
             torch.cuda.memory_reserved() after phases 13 and 14
 15. post    (runs before phase 9, after 14) the fused post pass on a
             fresh bench texture: after 2 warm-up bakes (discovery,
             capture), bake.classify_items with its counts set to 0 just
             before and read just after: every batch on the capacity
             chain, and every one of the 256 fast-path items must carry
             a post, (states3 digest, uniform value), equal to
             native.states3_digest and native.all_uniform_u8 of its
             unpacked row; finalize_items over those items byte-equal to
             the discovery bake; 16 triangles classified with their
             posts on the card and on the CPU, finalized byte-equal to
             each other and to ot.bake on the CPU; then one bake under
             torch.profiler (host labels): omm.classify, omm.row_post,
             omm.finalize and its stages (omm.promote, omm.dedup_exact,
             omm.dedup_near, omm.compress, omm.histograms, omm.sort,
             omm.serialize), byte-equal to the discovery bake
 16. drain   (runs before phase 9, after 15) the concurrent drain of the
             batch pipeline on a fresh bench texture, after 2 warm-ups:
             (a) 5 bakes, each with its counts set to 0 just before
             it, whose chains must all be issued from one enqueue thread
             and whose post passes must run on pool threads, never the
             calling thread, on 2 or more threads in at least one bake
             (the post threads and the most post passes at once of each
             bake are printed), each byte-equal to the discovery bake
             with 6 spec batches, 6 graph replays, 6 count syncs and 6
             exact launches; (b) the first 16
             triangles in 4 batches of 4 through classify_work_items_
             batches with posts, the card's discovery, capturing and
             drained calls equal, rows and posts, to the CPU's; (c) the
             bench bake and the GPU baker's dispatch, 5 each on the
             drained chain in turns with 5 on the discovery path (a
             second texture of the same data, its caps emptied before
             each; the GPU baker's second call per dispatch finds the
             first's entries), byte-equal to the discovery bake, best
             and median; (d) whether CUDAGraph.replay() lets another
             thread run Python (a Python loop's rate beside a thread
             that replays a bench graph); (e) one bench bake profiled
             on every thread (profile_all_threads): omm.classify and
             omm.drain (the calling thread), omm.spec (on one thread),
             omm.row_post with the threads it ran on, device busy and
             idle share
 17. chain   (runs before phase 9, after 16) the capacity chain's
             descent and tile-slot kernels (kernels.chain: descend_sides,
             tile_keys, tile_slots with its discovery form slot_stream):
             (a) every call of each on the first batch's discovery path
             and capacity chain of six streams, held against its plain
             version on the same inputs, every lane equal: the bench
             batch, _spot_multimip's 3-mip chain, the wrapped spot,
             subdiv12, a partial bench batch, and the bench batch at an
             eighth of its caps (the flag must be set); (b) each
             kernel's device time (torch.profiler) and event time summed
             over the bench batch's calls, its bound and share, the
             plain version's time; (c) launches per bench bake on the
             chain, counted just around it; (d) one profiled bench bake
             with the kernels and one with their plain versions in their
             place (the device program before the kernels), in turns
             after warm-ups on textures of their own: device kernels,
             device busy ms and idle share, and 5 unprofiled bakes each;
             (e) with --parent DIR (another checkout, such as the parent
             commit unpacked into the gitignored build/), one profiled
             bench bake of each tree (tools/profile_torch_bake.py
             --package-root: device kernels and busy ms), then the bench
             bake and the GPU dispatch timed by tools/time_torch_bake.py
             in turns, one process each: parent, this, this, parent

Every timed bake of phases 4-17 comes after 2 warm-ups, the first of
which discovers the capacities and the second captures the graphs; every
two-phase batch of the timed bakes must start on the capacity chain
(overflows and reruns are counted and printed), and the timed bakes must
equal the first warm-up.  Each path's counts
(`omm_tpu_torch.launches()`: kernel launches and work items per route;
`omm_tpu_torch.pipeline_counts()`: batches per path) are set to 0 just
before its timed bakes and read just after (the mesh and surface paths:
around each timed bake; the tools: around the whole of phase 12 c).  launches_by_path has a key for
each path: surface.baker, surface.capi and surface.tools for phase 12
(a) and (c), scene.level7 and scene.level9 for (b), spots.<name> for
each bake of phase 13 (around its 5 timed bakes), spec.<path> for phase
14 (spec and discovery: 5 bakes each; overflow: the flagged bake and
the one after it; gpu: one default-engine dispatch), post.classify for
phase 15's classify_items, drain.<path> for phase 16 (threads: the 5
bakes of (a); batches16: the drained call of (b); bench, bench_discovery, gpu,
gpu_discovery: the 5 bakes of each path in (c)).
jax and the JAX package omm_tpu are blocked from import for the whole
run, the farm's worker processes included: the port must not need
them.  Everything is reached through
omm_tpu_torch.  The checks against the JAX package's numpy oracle run
on the card as tests/test_torch_cuda.py.
The second-to-last line is the kernels' JSON record (the exact kernel
and the three chain kernels), the last line the result: {"ok": true,
"device": {...}}.
"""
import importlib.abc
import sys


_BLOCKED = ("jax", "jaxlib", "omm_tpu")


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ModuleNotFoundError(f"import of {name} blocked: the port "
                                      "runs without jax and the JAX package")
        return None


sys.meta_path.insert(0, _NoJax())

import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_TRIS = 256
SUBDIV = 9
BATCH = 48  # items per batch at subdiv 9 (bake's MAX_UTRI_PER_BATCH)


def _circle(w):
    """The benchmark plane at w x w: 0 inside a circle of radius 0.4
    about the centre, 1 outside, 0.6 at texel (0, 0)."""
    j, i = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    u = i / np.float32(w)
    v = j / np.float32(w)
    r = np.sqrt((u - 0.5) ** 2 + (v - 0.5) ** 2)
    plane = np.where(r < np.float32(0.4), np.float32(0.0),
                     np.float32(1.0)).astype(np.float32)
    plane[0, 0] = np.float32(0.6)
    return plane


def _workload():
    """The benchmark workload (bench.py's _workload): a 1024^2 FP32 clamp
    texture with a circle of radius 0.4 and 256 triangles."""
    import omm_tpu_torch as ot
    tex = ot.Texture([_circle(1024)], ot.TextureFormat.FP32)
    rng = np.random.RandomState(42)
    uv_tris = []
    for _ in range(N_TRIS):
        base = rng.rand(2).astype(np.float32) * 0.2
        uv_tris.append(np.array([base + [0.05, 0.1], base + [0.1, 0.7],
                                 base + [0.7, 0.65]], dtype=np.float32))
    return tex, uv_tris


def _desc(tex, uv_tris):
    import omm_tpu_torch as ot
    n = len(uv_tris)
    return ot.BakeInputDesc(
        texture=tex, tex_coords=np.concatenate(uv_tris).astype(np.float32),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        alpha_cutoff=0.5, max_subdivision_level=SUBDIV,
        dynamic_subdivision_scale=0.0)


def _nearest_desc(tex, uv_tris):
    """The benchmark descriptor with the nearest filter."""
    import omm_tpu_torch as ot
    desc = _desc(tex, uv_tris)
    desc.runtime_sampler.filter = ot.types.TextureFilterMode.Nearest
    return desc


def _mixed_tris(uv_tris):
    """The mixed mesh: (triangles, subdivision level of each, route
    group of each) for the benchmark triangles at SUBDIV, 16 line
    triangles and 16 fp32-thin slivers at SUBDIV, 8 triangles at level
    0, 8 at level 1 and 8 texture-spanning ones at level 3."""
    from omm_tpu_torch import geom
    rng = np.random.RandomState(43)
    lines, slivers = [], []
    for _ in range(16):
        # on a 1/1024 grid, so that the fp32 area is exactly 0
        p = rng.randint(100, 900, 2).astype(np.float32) / np.float32(1024)
        d = rng.randint(-60, 61, 2).astype(np.float32) / np.float32(1024)
        lines.append(np.array([p, p + 2 * d, p + d], np.float32))
    for _ in range(16):
        b = rng.rand(2).astype(np.float32) * np.float32(0.35)
        slivers.append(np.array([b, b + [0.6, 1e-7], b + [0.3, 0.0]],
                                np.float32))
    low = []
    for _ in range(16):
        b = rng.rand(2).astype(np.float32) * np.float32(0.2)
        low.append(np.array([b + [0.05, 0.1], b + [0.1, 0.7],
                             b + [0.7, 0.65]], np.float32))
    wide = []
    for _ in range(8):
        j = rng.rand(3, 2).astype(np.float32) * np.float32(0.02)
        wide.append((np.array([[0.02, 0.03], [0.97, 0.1], [0.4, 0.95]],
                              np.float32) + j).astype(np.float32))
    if not all(geom.is_degenerate(t) for t in lines):
        raise SystemExit("a mixed-mesh line triangle is not degenerate")
    if any(geom.is_degenerate(t) or geom.winding_stable(t, SUBDIV)
           for t in slivers):
        raise SystemExit("a mixed-mesh sliver is winding-stable")
    tris = list(uv_tris) + lines + slivers + low + wide
    levels = [SUBDIV] * (len(uv_tris) + 32) + [0] * 8 + [1] * 8 + [3] * 8
    groups = (["bench"] * len(uv_tris) + ["line"] * 16 + ["sliver"] * 16
              + ["level0"] * 8 + ["level1"] * 8 + ["wide"] * 8)
    return tris, levels, groups


def _mixed_desc(tex, tris, levels):
    desc = _desc(tex, tris)
    desc.subdivision_levels = np.array(levels, np.uint8)
    return desc


# the vegetation scene at examples/vegetation_scene.py's defaults
SCENE_ATLAS = 512
SCENE_QUADS = 200
SCENE_CUTOFF = 0.5


def foliage_atlas(size: int = 512, seed: int = 7) -> np.ndarray:
    """examples/vegetation_scene.py's foliage_atlas (that module imports
    the JAX package, which this script blocks): leaf-cluster alpha, soft
    elliptic leaves with serrated edges on a transparent background."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    alpha = np.zeros((size, size), np.float32)
    for _ in range(140):
        cx, cy = rng.rand(2) * size
        ang = rng.rand() * np.pi
        la, lb = 8 + rng.rand() * 40, 4 + rng.rand() * 14
        dx = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        dy = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        r = (dx / la) ** 2 + (dy / lb) ** 2
        serration = 0.12 * np.sin(np.arctan2(dy, dx) * 9.0)
        leaf = np.clip(1.2 - r + serration, 0.0, 1.0)
        alpha = np.maximum(alpha, leaf.astype(np.float32))
    return np.clip(alpha, 0.0, 1.0).astype(np.float32)


def quad_mesh(n_quads: int, n_uv_variants: int = 6, seed: int = 3):
    """examples/vegetation_scene.py's quad_mesh: n_quads quads whose UV
    rectangles come from a pool of n_uv_variants."""
    rng = np.random.RandomState(seed)
    variants = []
    for _ in range(n_uv_variants):
        u0, v0 = rng.rand(2) * 0.5
        du, dv = 0.2 + rng.rand(2) * 0.3
        variants.append(np.array([[u0, v0], [u0, v0 + dv],
                                  [u0 + du, v0], [u0 + du, v0 + dv]],
                                 np.float32))
    uvs = []
    indices = []
    for q in range(n_quads):
        base = len(uvs)
        uvs.extend(variants[rng.randint(n_uv_variants)])
        indices.extend([base, base + 1, base + 2,
                        base + 3, base + 1, base + 2])
    return (np.asarray(uvs, np.float32),
            np.asarray(indices, np.uint32))


def _scene_desc(level, atlas=None, fixed=False):
    """The vegetation scene's BakeInputDesc at subdivision `level`, as
    examples/vegetation_scene.py builds it (atlas: its 512^2 plane, made
    here unless given).  The example keeps the default dynamic
    subdivision scale, 2.0, which puts this scene's triangles at levels
    5-6 whatever the maximum above 6; fixed=True sets the scale to 0, so
    that every triangle is baked at `level`."""
    import omm_tpu_torch as ot
    if atlas is None:
        atlas = foliage_atlas(SCENE_ATLAS)
    uvs, indices = quad_mesh(SCENE_QUADS)
    tex = ot.Texture([atlas], ot.TextureFormat.FP32,
                     alpha_cutoff=SCENE_CUTOFF)
    desc = ot.BakeInputDesc(
        texture=tex, tex_coords=uvs, index_buffer=indices,
        index_count=len(indices), alpha_cutoff=SCENE_CUTOFF,
        max_subdivision_level=level,
        bake_flags=ot.BakeFlags.EnableNearDuplicateDetection)
    if fixed:
        desc.dynamic_subdivision_scale = 0.0
    return desc


def _per_bake(counts, prefix):
    """The nonzero counts whose names start with `prefix`, summed over 5
    bakes, per bake."""
    return {k: v // 5 for k, v in counts.items()
            if k.startswith(prefix) and v}


def _result_utri(res) -> int:
    """Micro-triangles of a result: 4^level of each triangle's OMM, 0
    for a triangle with a special index."""
    return sum(4 ** res.desc_array[int(i)].subdivision_level
               for i in res.index_buffer if i >= 0)


WORKLOADS = ("bench", "nearest", "mixed", "gpu", "scene")


def _rgba(tex):
    """The GPU workload's RGBA FP32 texture of `tex`'s mips: each plane
    in channel 3; the plane transposed, shifted and inverted in
    channels 0-2."""
    import omm_tpu_torch as ot
    return ot.Texture([np.stack([p.T, np.roll(p, 17, axis=1),
                                 np.float32(1.0) - p, p], axis=-1)
                       for p in tex.mips], ot.TextureFormat.FP32)


def _gpu_cfg(tex, uv_tris, flags=None):
    """The GPU baker's DispatchConfigDesc of the benchmark triangles on
    `tex` (alphaTextureChannel 3), default flags unless given."""
    from omm_tpu_torch import gpu
    n = len(uv_tris)
    cfg = gpu.DispatchConfigDesc(
        alpha_texture=tex, alpha_texture_channel=3,
        tex_coords=np.concatenate(uv_tris).astype(np.float32),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        alpha_cutoff=0.5, max_subdivision_level=SUBDIV,
        dynamic_subdivision_scale=0.0)
    if flags is not None:
        cfg.bake_flags = flags
    return cfg


def _bake(desc, device="cuda"):
    """desc's BakeResult on `device`: omm_tpu_torch.bake for a
    BakeInputDesc, the GPU baker's dispatch chain for a
    DispatchConfigDesc."""
    import omm_tpu_torch as ot
    if isinstance(desc, ot.gpu.DispatchConfigDesc):
        return ot.gpu.Pipeline().dispatch(desc, device).execute()[0]
    return ot.bake(desc, device)


def _workload_desc(name, tex, uv_tris):
    """(descriptor, micro-triangles) of a workload on the benchmark
    texture and triangles: "bench", "nearest" (the nearest filter),
    "mixed" (the 312-triangle mesh over every linear route) or "gpu"
    (the GPU baker's DispatchConfigDesc of the bench triangles on the
    RGBA texture); or "scene", the vegetation scene with every triangle
    at SUBDIV (its own texture and triangles)."""
    if name == "scene":
        desc = _scene_desc(SUBDIV, fixed=True)
        return desc, desc.index_count // 3 * 4 ** SUBDIV
    if name == "gpu":
        return _gpu_cfg(_rgba(tex), uv_tris), len(uv_tris) * 4 ** SUBDIV
    if name == "mixed":
        tris, levels, _ = _mixed_tris(uv_tris)
        return _mixed_desc(tex, tris, levels), sum(4 ** lv for lv in levels)
    utri = len(uv_tris) * 4 ** SUBDIV
    if name == "nearest":
        return _nearest_desc(tex, uv_tris), utri
    return _desc(tex, uv_tris), utri


def _mixed_subset(tris, levels, groups):
    """Items of every route: the first few of each group."""
    take = {"bench": 4, "line": 2, "sliver": 2, "level0": 1, "level1": 1,
            "wide": 1}
    seen: dict = {}
    keep = []
    for k, g in enumerate(groups):
        seen[g] = seen.get(g, 0) + 1
        if seen[g] <= take[g]:
            keep.append(k)
    return [tris[k] for k in keep], [levels[k] for k in keep]


def _cuda_ms(fn, reps=21, burst=5, warm=3):
    """Median milliseconds per call of fn(), over `reps` CUDA-event-timed
    bursts of `burst` back-to-back calls (a burst hides the launch
    latency of one call; a host-bound fn is timed by its host cost)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return statistics.median(times)


def device_ms(fn, kernel, n=50):
    """Mean device milliseconds of the CUDA kernel named `kernel` per call
    of fn(), from torch.profiler over n calls (device time alone, without
    the host's launch cost); None if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    return us / 1e3 / n if us > 0 else None


def slot_streams(tex, uvs, cfg, subdiv, n, dev):
    """The exact stage's inputs for the first n items at `subdiv`:
    ((planeP, block_tile, ids_slot, uv6, ccw), keyword arguments,
    description) of mip 0, from the port's stage_ab on `dev`."""
    from omm_tpu_torch import batch, host
    from omm_tpu_torch.twophase import slot_stream
    lg = host._group_level(tex, uvs, subdiv)
    pre = batch.precompute(tex, uvs, subdiv, lg)
    bp = batch.batch_planes(tex, cfg, pre, dev)
    uv_flat, ccw = batch.item_tables(np.stack(uvs[:n]), dev)
    res = batch.run_stage_ab(bp, uv_flat, None, subdiv, True)
    w, h = bp["mips"][0]
    H, W = bp["HW"][0]
    kw = dict(subdiv=subdiv, pad=bp["pads"][0], ntx=bp["ntxs"][0],
              size=(w, h), period=bp["periods"][0], H=H, W=W,
              rcp=bp["rcps"][0], alpha_cutoff=float(cfg.alpha_cutoff))
    block_tile, ids_slot = slot_stream(
        uv_flat, res["ids"], res["slots"][0], res["padMs"][0],
        subdiv=subdiv, w=w, h=h, pad=kw["pad"], ntx=kw["ntx"],
        period=kw["period"])
    what = (f"subdiv {subdiv}: levels {pre['levels']} window {H}x{W} "
            f"TSA {kw['pad']} Cs {res['Cs']} K {res['K']} "
            f"blocks {ids_slot.shape[0]}")
    return (bp["planes"][0], block_tile, ids_slot, uv_flat, ccw), kw, what


def _kernel_equals_twin(args, kw, what):
    """Run the exact stage's kernel and its plain twin on one slot stream
    (slot_streams' args and kw); fail unless their counts are equal and
    some survivor straddles the cutoff.  Returns the largest count
    difference."""
    from omm_tpu_torch.kernels import exact
    ka, kb = exact.exact_counts(*args, **kw)
    ta, tb = exact.exact_counts(*args, exact="torch", **kw)
    torch.cuda.synchronize()
    err = max(int((ka - ta).abs().max()), int((kb - tb).abs().max()))
    if err:
        raise SystemExit(f"{what}: kernel counts differ from the torch twin "
                         f"by up to {err}")
    if int(((ka + kb) > 1).sum()) == 0:
        raise SystemExit(f"{what}: no survivor straddles the cutoff: "
                         "vacuous check")
    return err


def _summary(utri, times):
    """Best and median seconds and micro-triangles per second."""
    best, med = min(times), statistics.median(times)
    return {"utri": utri, "best_s": best, "median_s": med,
            "best_mutri_s": utri / best / 1e6,
            "median_mutri_s": utri / med / 1e6}


def _counts():
    """ot.launches() with the pipeline's counts as "pipeline.<name>" (0
    for a package without them: an earlier checkout timed by
    tools/time_torch_bake.py --package-root)."""
    import omm_tpu_torch as ot
    pc = getattr(ot, "pipeline_counts", dict)()
    return {**ot.launches(), **{f"pipeline.{k}": pc.get(k, 0) for k in (
        "spec", "spec_overflow", "discovery", "graph_capture",
        "graph_replay", "count_sync")}}


def _timed_bakes(desc, utri, what, card):
    """2 warm-up bakes (`_bake`), then 5 timed ones (each ending with the
    result on the host) with every count set to 0 just before them:
    (counts after the 5, times, results, summary).  Every two-phase
    batch of the timed bakes must start on the capacity chain (the
    warm-ups discover the capacities and capture the graphs; a batch
    that overflows its entry, which the last discovered batch of its
    shape recorded, is rerun on the discovery path, as in the JAX
    package), and the timed bakes must equal the first warm-up (on a
    fresh texture, the discovery path)."""
    import omm_tpu_torch as ot
    first = _bake(desc)
    _bake(desc)
    torch.cuda.synchronize()
    ot.reset_launches()
    times, results = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        results.append(_bake(desc))  # numpy arrays: on the host
        times.append(time.perf_counter() - t0)
    counts = _counts()
    pipe = _per_bake(counts, "pipeline.")
    print(f"{what}: pipeline per bake {json.dumps(pipe)}", flush=True)
    if counts["pipeline.discovery"] != counts["pipeline.spec_overflow"]:
        raise SystemExit(f"a timed {what} batch had no caps entry: "
                         f"{json.dumps(pipe)}")
    if not _results_equal(results[0], first):
        raise SystemExit(f"the timed {what} bakes differ from the first "
                         "warm-up (the discovery path)")
    summary = _summary(utri, times)
    best, med = summary["best_s"], summary["median_s"]
    print(f"{what}: {desc.index_count // 3} tris ({utri} utri): best "
          f"{best:.4f} s median {med:.4f} s -> {utri / best / 1e6:.2f} "
          f"M utri/s best, {utri / med / 1e6:.2f} M utri/s median; exact "
          f"launches {counts['exact_classify']} in 5 bakes ({card})",
          flush=True)
    print(f"{what} times s: {json.dumps([round(t, 6) for t in times])}")
    if not all(_results_equal(r, results[0]) for r in results):
        raise SystemExit(f"the timed {what} bakes differ from one another")
    return counts, times, results, summary


def _card_equals_cpu(desc_fn, what):
    """Bake desc_fn() on the card and on the CPU (the port's plain
    path); fail unless the BakeResults are byte-equal.  Returns (the
    card's result, the CPU bake's seconds)."""
    r_card = _bake(desc_fn())
    t0 = time.perf_counter()
    r_cpu = _bake(desc_fn(), device="cpu")
    cpu_s = time.perf_counter() - t0
    if not _results_equal(r_card, r_cpu):
        raise SystemExit(f"{what}: the BakeResult on the card differs from "
                         "the CPU bake")
    print(f"{what}: BakeResult on the card byte-equal to the CPU bake "
          f"({cpu_s:.1f} s on the CPU)", flush=True)
    return r_card, cpu_s


def _results_equal(a, b) -> bool:
    return (np.array_equal(a.array_data, b.array_data)
            and a.desc_array == b.desc_array
            and a.index_format == b.index_format
            and a.desc_array_histogram == b.desc_array_histogram
            and a.index_histogram == b.index_histogram
            and np.array_equal(a.index_buffer, b.index_buffer))


def _check_shape(res, n_tris, levels=(SUBDIV,)):
    """One index per triangle, each a descriptor or a special index
    (-1..-4); every descriptor at one of `levels` with its 4**level 2-bit
    states laid end to end in array_data.  Returns the descriptors'
    count."""
    idx = np.asarray(res.index_buffer).astype(np.int64)
    if idx.shape != (n_tris,):
        raise SystemExit(f"index buffer shape {idx.shape}, want ({n_tris},)")
    nd = len(res.desc_array)
    if not np.all(((idx >= 0) & (idx < nd)) | ((idx >= -4) & (idx < 0))):
        raise SystemExit("index buffer holds an index out of range")
    end = 0
    for d in sorted(res.desc_array, key=lambda d: d.offset):
        if d.subdivision_level not in levels or d.offset != end:
            raise SystemExit("descriptors have the wrong level or offset")
        end += 4 ** d.subdivision_level // 4
    if len(res.array_data) != end:
        raise SystemExit("array_data has the wrong size")
    return nd


def gpu_phase(tex, uv_tris, card):
    """Phase 10: the GPU baker's dispatch chain at full width.  Returns
    (the default engine's counts after its 5 timed dispatches, its
    summary, ComputeOnly's summary)."""
    import dataclasses

    from omm_tpu_torch import gpu
    F = gpu.GpuBakeFlags
    cfg, utri = _workload_desc("gpu", tex, uv_tris)
    counts, _, res, summary = _timed_bakes(cfg, utri, "gpu dispatch", card)
    _check_shape(res[-1], N_TRIS)
    if counts["exact_classify"] != 6 * 5:
        raise SystemExit(f"{counts['exact_classify']} exact launches in 5 "
                         "dispatches: want 6 per dispatch")
    co_cfg = dataclasses.replace(cfg, bake_flags=F.PerformSetupAndBake
                                 | F.ComputeOnly)
    co_counts, _, co_res, co_summary = _timed_bakes(
        co_cfg, utri, "gpu ComputeOnly dispatch", card)
    if co_counts["exact_classify"] != 0:
        raise SystemExit("the ComputeOnly dispatches launched the exact "
                         "kernel")
    if not _results_equal(co_res[0], res[0]):
        raise SystemExit("the ComputeOnly dispatch differs from the "
                         "default engine's")
    if not _results_equal(_bake(dataclasses.replace(cfg, alpha_texture=tex)),
                          res[0]):
        raise SystemExit("the channel-3 dispatch differs from a dispatch "
                         "of the single-channel plane")
    pipe = gpu.Pipeline()
    none, _ = pipe.dispatch(dataclasses.replace(
        cfg, bake_flags=F.PerformSetup)).execute()
    if none is not None:
        raise SystemExit("a setup-only dispatch returned a result")
    for k in range(2):
        r, _ = pipe.dispatch(dataclasses.replace(
            cfg, bake_flags=F.PerformBake)).execute()
        if not _results_equal(r, res[0]):
            raise SystemExit(f"bake-only dispatch {k} after PerformSetup "
                             "differs from PerformSetupAndBake")
    chain = pipe.dispatch(cfg)
    rec = gpu.RecordingRHI(
        pipe.get_pre_dispatch_info(cfg).transient_pool_buffer_sizes)
    gpu.record_chain(chain, rec)
    level9 = [lb for lb in rec.labels
              if lb.startswith("Batch ") and lb.endswith(f" Level {SUBDIV}")]
    if rec.labels != [p.label for p in chain.passes] or len(level9) != 2:
        raise SystemExit(f"recorded labels {rec.labels}: want the passes' "
                         f"labels with two 'Batch b Level {SUBDIV}' passes")
    print(f"gpu chain recorded clean: {rec.dispatch_count} dispatches "
          f"{json.dumps(rec.labels)}, high water {rec.high_water}")
    sub = _gpu_cfg(cfg.alpha_texture, uv_tris[:16],
                   F.PerformSetupAndBake | F.EnablePostDispatchInfoStats)
    r_card, p_card = pipe.dispatch(sub).execute()
    t0 = time.perf_counter()
    r_cpu, p_cpu = pipe.dispatch(sub, "cpu").execute()
    if not _results_equal(r_card, r_cpu) or p_card != p_cpu:
        raise SystemExit("16-triangle gpu dispatch: the card differs from "
                         "the CPU")
    _check_shape(r_card, 16)
    print(f"16-triangle gpu dispatch: BakeResult and PostDispatchInfo on "
          f"the card byte-equal to the CPU's ({time.perf_counter() - t0:.1f}"
          f" s on the CPU); {p_card}", flush=True)
    print(f"gpu dispatch: default engine best {summary['best_mutri_s']:.2f}"
          f" median {summary['median_mutri_s']:.2f} M utri/s, ComputeOnly "
          f"best {co_summary['best_mutri_s']:.2f} median "
          f"{co_summary['median_mutri_s']:.2f} M utri/s ({card})",
          flush=True)
    return counts, summary, co_summary


def _slot_batches(n_items, mesh):
    """Exact launches of a mesh bake of n_items fresh fast-path items at
    SUBDIV: each slot's contiguous slice in batches of BATCH
    (parallel.shard.classify_slices)."""
    from omm_tpu_torch.bake import split_tail_light
    k = mesh.size
    return sum(len(split_tail_light(list(range(s * n_items // k,
                                               (s + 1) * n_items // k)),
                                    [BATCH])) for s in range(k))


def _in_turns(paths, rounds=5, warm=2):
    """Call each of `paths` ({name: fn returning a BakeResult}) `warm`
    times, then `rounds` rounds in turns, each call with the counts set
    to 0 just before it and read just after: ({name: results}, {name:
    times}, {name: each count of `_counts` summed over the
    rounds})."""
    import omm_tpu_torch as ot
    for _ in range(warm):
        for fn in paths.values():
            fn()
    torch.cuda.synchronize()
    results = {k: [] for k in paths}
    times = {k: [] for k in paths}
    counts = {k: {} for k in paths}
    for _ in range(rounds):
        for name, fn in paths.items():
            ot.reset_launches()
            t0 = time.perf_counter()
            results[name].append(fn())
            times[name].append(time.perf_counter() - t0)
            for k, v in _counts().items():
                counts[name][k] = counts[name].get(k, 0) + v
    return results, times, counts


def mesh_phase(desc, utri, card):
    """Phase 11 (a), (b): the plain bake, the mesh of every card and two
    slots on cuda:0, 2 warm-ups each, then 5 rounds in turns, each bake
    with the counts set to 0 just before it and read just after.
    Returns (exact launches of each mesh path's 5 bakes, summaries, the
    plain bake's result)."""
    import omm_tpu_torch as ot
    paths = {"plain": None, "mesh": ot.parallel.make_mesh(),
             "mesh2": ot.parallel.make_mesh(["cuda:0", "cuda:0"])}
    results, times, counts = _in_turns(
        {name: (lambda mesh=mesh: ot.bake(desc, mesh=mesh))
         for name, mesh in paths.items()})
    launches = {k: c["exact_classify"] for k, c in counts.items()}
    ref = results["plain"][0]
    summaries = {}
    for name, mesh in paths.items():
        if not all(_results_equal(r, ref) for r in results[name]):
            raise SystemExit(f"a timed {name} bake differs from the plain "
                             "bake")
        want = 5 * _slot_batches(N_TRIS, mesh or ot.parallel.make_mesh(
            ["cuda:0"]))
        if launches[name] != want:
            raise SystemExit(f"{launches[name]} exact launches in 5 {name} "
                             f"bakes: want {want}")
        summaries[name] = _summary(utri, times[name])
        print(f"{name} bake ({mesh.size if mesh else 0} slots): best "
              f"{summaries[name]['best_s']:.4f} s median "
              f"{summaries[name]['median_s']:.4f} s, "
              f"{summaries[name]['best_mutri_s']:.2f} M utri/s best; exact "
              f"launches {launches[name]} in 5 bakes, byte-equal to the "
              f"plain bake ({card})", flush=True)
        print(f"{name} times s: {json.dumps([round(t, 6) for t in times[name]])}")
    return ({k: launches[k] for k in ("mesh", "mesh2")},
            {k: summaries[k] for k in ("mesh", "mesh2")}, ref)


FARM_PROCS = 2
FARM_ROUNDS = 5
FARM_TIMEOUT_S = 300


def farm_worker(rank, n, coord, outdir):
    """One process of phase 11 (c) (run as this script with --farm-worker
    RANK N HOST:PORT DIR): join the farm over gloo, classify this rank's
    half of the benchmark items on the card (2 warm-ups, then FARM_ROUNDS
    rounds that start at a barrier, each with the counts set to 0 just
    before it and read just after), bake its half of the triangles, and
    all_gather_object the blobs, times and launches; rank 0 writes them
    to DIR."""
    import torch.distributed as dist

    import omm_tpu_torch as ot
    from omm_tpu_torch.parallel import multihost as mh
    if not torch.cuda.is_available():
        raise SystemExit("farm worker: no CUDA device")
    # the host's cores shared between the workers' torch CPU ops
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if mh.init_distributed(coord, n, rank) != (rank, n):
        raise SystemExit("farm worker: wrong rank or world size")
    tex, uv_tris = _workload()
    desc = _desc(tex, uv_tris)
    part = mh.partition_items(mh.item_costs(desc).tolist(), n)[rank]
    for _ in range(2):  # discovers the capacities, captures the graphs
        mh.classify_partition(desc, part)
    rounds = []
    for _ in range(FARM_ROUNDS):
        dist.barrier()
        ot.reset_launches()
        t0 = time.perf_counter()
        xblob = mh.classify_partition(desc, part)
        t1 = time.perf_counter()
        rounds.append((t0, t1, ot.launches()["exact_classify"]))
    t0 = time.perf_counter()
    blob = mh.bake_partition(
        desc, mh.partition_items([4 ** SUBDIV] * N_TRIS, n)[rank])
    bake_s = time.perf_counter() - t0
    got = [None] * n
    dist.all_gather_object(got, {"rank": rank, "rounds": rounds,
                                 "bake_s": bake_s, "xblob": xblob,
                                 "blob": blob})
    if rank == 0:
        for g in got:
            for key in ("xblob", "blob"):
                with open(os.path.join(outdir, f"{key}{g['rank']}.bin"),
                          "wb") as f:
                    f.write(g.pop(key))
        with open(os.path.join(outdir, "farm.json"), "w") as f:
            json.dump(got, f)
    dist.destroy_process_group()
    if [m for m in sys.modules if m.split(".")[0] in _BLOCKED]:
        raise SystemExit("farm worker: jax or the JAX package was imported")
    print(f"farm worker {rank}: classify rounds "
          f"{[round(b - a, 6) for a, b, _ in rounds]} s, launches "
          f"{[k for _, _, k in rounds]}, bake_partition {bake_s:.4f} s",
          flush=True)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def farm_phase(desc, ref, card):
    """Phase 11 (c): one process classifying every item (the baseline),
    then FARM_PROCS worker processes on the card; their merged blobs must
    equal the plain bake `ref`.  Returns (exact launches of the workers'
    timed rounds, summary)."""
    import tempfile

    import omm_tpu_torch as ot
    from omm_tpu_torch.parallel import multihost as mh
    everything = mh.Partition(0, np.arange(len(mh.item_costs(desc))))
    mh.classify_partition(desc, everything)
    single = []
    for _ in range(FARM_ROUNDS):
        t0 = time.perf_counter()
        mh.classify_partition(desc, everything)
        single.append(time.perf_counter() - t0)

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    coord = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--farm-worker",
             str(r), str(FARM_PROCS), coord, outdir], cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(FARM_PROCS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=FARM_TIMEOUT_S)[0]
                            .decode(errors="replace"))
        except subprocess.TimeoutExpired:
            raise SystemExit(f"a farm worker ran past {FARM_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            print("\n".join(out.strip().splitlines()[-3:]))
            if p.returncode != 0:
                raise SystemExit(f"farm worker {r} exited {p.returncode}:\n"
                                 f"{out[-3000:]}")
        with open(os.path.join(outdir, "farm.json")) as f:
            got = json.load(f)
        xblobs, blobs = [], []
        for r in range(FARM_PROCS):
            for key, dst in (("xblob", xblobs), ("blob", blobs)):
                with open(os.path.join(outdir, f"{key}{r}.bin"), "rb") as f:
                    dst.append(f.read())

    per_round = [[k for _, _, k in g["rounds"]] for g in got]
    want = [_slot_batches(len(p.item_indices), ot.parallel.make_mesh(
        ["cuda:0"])) for p in mh.partition_items(
        mh.item_costs(desc).tolist(), FARM_PROCS)]
    if any(ks != [w] * FARM_ROUNDS for ks, w in zip(per_round, want)):
        raise SystemExit(f"farm exact launches per round {per_round}: want "
                         f"{want} per process")
    walls = [max(g["rounds"][i][1] for g in got)
             - min(g["rounds"][i][0] for g in got)
             for i in range(FARM_ROUNDS)]
    t0 = time.perf_counter()
    merged = mh.merge_exact(desc, xblobs)
    merge_s = time.perf_counter() - t0
    if not _results_equal(merged, ref):
        raise SystemExit("merge_exact of the farm's blobs differs from the "
                         "plain bake")
    rep = mh.dedup_loss(mh.gather_results(blobs))
    if not 0 <= rep.loss <= rep.bound:
        raise SystemExit(f"dedup loss {rep.loss} outside [0, {rep.bound}]")
    summary = {"procs": FARM_PROCS,
               "classify_wall_best_s": min(walls),
               "classify_wall_median_s": statistics.median(walls),
               "single_classify_best_s": min(single),
               "single_classify_median_s": statistics.median(single),
               "merge_s": merge_s,
               "bake_partition_s": [g["bake_s"] for g in got],
               "dedup": {"per_partition": rep.per_partition,
                         "global_distinct": rep.global_distinct,
                         "loss": rep.loss, "bound": rep.bound}}
    print(f"farm: {FARM_PROCS} processes on the card, classify wall best "
          f"{min(walls):.4f} s median {statistics.median(walls):.4f} s "
          f"against one process's best {min(single):.4f} s median "
          f"{statistics.median(single):.4f} s; exact launches per round "
          f"{per_round[0][0]} + {per_round[1][0]}; merge_exact "
          f"{merge_s:.4f} s, byte-equal to the plain bake; bake_partition "
          f"{[round(t, 4) for t in summary['bake_partition_s']]} s; dedup "
          f"loss {rep.loss} <= bound {rep.bound} ({card})", flush=True)
    print(f"farm classify walls s: {json.dumps([round(t, 6) for t in walls])}"
          f", one process s: {json.dumps([round(t, 6) for t in single])}")
    return sum(sum(ks) for ks in per_round), summary


def surface_phase(desc, utri, card):
    """Phase 12 (a): the benchmark workload through ot.Baker and
    ot.capi in turns with ot.bake, every result byte-equal to ot.bake's
    with 6 exact launches per bake.  Returns (exact launches of the
    Baker's and of capi's timed bakes by name, summaries)."""
    import omm_tpu_torch as ot
    bk = ot.Baker()
    cbk = ot.capi.omm_create_baker()
    results, times, counts = _in_turns({
        "plain": lambda: ot.bake(desc),
        "baker": lambda: bk.bake(desc),
        "capi": lambda: ot.capi.omm_cpu_bake(cbk, desc)})
    launches = {k: c["exact_classify"] for k, c in counts.items()}
    ref = results["plain"][0]
    summaries = {}
    for name in results:
        if not all(_results_equal(r, ref) for r in results[name]):
            raise SystemExit(f"a timed {name} bake differs from ot.bake's")
        if launches[name] != 6 * 5:
            raise SystemExit(f"{launches[name]} exact launches in 5 {name} "
                             "bakes: want 6 per bake")
        summaries[name] = _summary(utri, times[name])
        print(f"surface {name} bake: best {summaries[name]['best_s']:.4f} s "
              f"median {summaries[name]['median_s']:.4f} s, "
              f"{summaries[name]['best_mutri_s']:.2f} M utri/s best; exact "
              f"launches {launches[name]} in 5 bakes, byte-equal to ot.bake "
              f"({card})", flush=True)
        print(f"surface {name} times s: "
              f"{json.dumps([round(t, 6) for t in times[name]])}")
    return {k: launches[k] for k in ("baker", "capi")}, summaries


#: (maximum level, every triangle at it): level 7 at the example's
#: defaults, level 9 with the dynamic subdivision scale at 0
SCENE_LEVELS = ((7, False), (9, True))


def scene_phase(card):
    """Phase 12 (b): the vegetation scene through one Baker at each of
    SCENE_LEVELS, each level's card result byte-equal to the CPU bake.
    Returns (exact launches of each level's timed bakes, summaries by
    level, the level-7 descriptor and card result)."""
    import omm_tpu_torch as ot
    from omm_tpu_torch import integration
    atlas = foliage_atlas(SCENE_ATLAS)
    bk = ot.Baker()
    launches, summaries = {}, {}
    for level, fixed in SCENE_LEVELS:
        desc = _scene_desc(level, atlas, fixed)
        results, times, counts = _in_turns({"scene": lambda: bk.bake(desc)})
        res = results["scene"][0]
        utri = _result_utri(res)
        levels = sorted({d.subdivision_level for d in res.desc_array})
        if fixed and levels != [level]:
            raise SystemExit(f"the scene baked at levels {levels}, not "
                             f"{level}")
        if not all(_results_equal(r, res) for r in results["scene"]):
            raise SystemExit(f"the timed level-{level} scene bakes differ")
        launched = counts["scene"]["exact_classify"]
        routes = _per_bake(counts["scene"], "route.")
        blob = bk.serialize(input_descs=[desc], result_descs=[res],
                            compress=True)
        back = bk.deserialize(blob)
        if not (_results_equal(back.result_descs[0], res)
                and bk.serialize(input_descs=back.input_descs,
                                 result_descs=back.result_descs,
                                 compress=True) == blob):
            raise SystemExit(f"the level-{level} scene's blob does not "
                             "round-trip")
        summaries[level] = _summary(utri, times["scene"])
        summaries[level].update(descs=len(res.desc_array), blob=len(blob),
                                levels=levels, exact_launches=launched,
                                routes=routes)
        launches[level] = launched
        print(f"scene level {level} (dynamic scale "
              f"{desc.dynamic_subdivision_scale}): {desc.index_count // 3} "
              f"tris ({utri} utri), {len(res.desc_array)} OMMs at levels "
              f"{levels}, blob {len(blob)} B: best "
              f"{summaries[level]['best_s']:.4f} s median "
              f"{summaries[level]['median_s']:.4f} s; exact launches "
              f"{launched} in 5 bakes; items per route per bake "
              f"{json.dumps(routes)} ({card})", flush=True)
        print(f"scene level {level} times s: "
              f"{json.dumps([round(t, 6) for t in times['scene']])}")
        if level == 9 and launched == 0:
            raise SystemExit("the level-9 scene bakes never launched the "
                             "exact kernel")
        t0 = time.perf_counter()
        if not _results_equal(res, bk.bake(desc, device="cpu")):
            raise SystemExit(f"level-{level} scene: the card's BakeResult "
                             "differs from the CPU bake")
        print(f"level-{level} scene: byte-equal to the CPU bake "
              f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
        if level == 7:
            desc7, res7 = desc, res
            t0 = time.perf_counter()
            s1, s2, equal = integration.dump_debug_compare(desc, res)
            if not equal:
                raise SystemExit(f"dump_debug_compare: {s1} != {s2}")
            d3d = integration.to_d3d12_build_inputs(res)
            vk = integration.to_vulkan_build_inputs(res)
            if not (d3d.input_buffer == vk["data"]
                    and d3d.omm_index_buffer == vk["indexBuffer"]
                    and d3d.per_omm_counts == [
                        (u["count"], u["subdivisionLevel"], u["format"])
                        for u in vk["usageCounts"]]
                    and d3d.omm_index_counts == [
                        (u["count"], u["subdivisionLevel"], u["format"])
                        for u in vk["indexUsageCounts"]]):
                raise SystemExit("the D3D12 and Vulkan build inputs "
                                 "disagree")
            print(f"level-7 scene: dump_debug_compare equal, D3D12 and "
                  f"Vulkan inputs agree ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    return launches, summaries, desc7, res7


def _cli(argv):
    """(exit code, standard output) of omm_tpu_torch.cli.main(argv)."""
    import contextlib
    import io

    from omm_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def tools_phase(desc7, res7, card):
    """Phase 12 (c): the CLI, the viewer session, the overlay and the
    terminal frame on the card against the CPU, on the level-7 scene's
    blob.  Returns the exact launches of the whole phase."""
    import tempfile

    import omm_tpu_torch as ot
    from omm_tpu_torch import debug, tui
    from omm_tpu_torch.viewer import ViewerSession
    ot.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "scene.bin")
        ot.Baker().save_binary_to_disk(ot.Baker().serialize(
            input_descs=[desc7], result_descs=[res7], compress=True), p)
        # the card without --device (the default), then the CPU
        runs = {"cuda": [], "cpu": ["--device", "cpu"]}
        outs = {}
        for dev, extra in runs.items():
            q = os.path.join(d, f"out_{dev}.bin")
            rc, out = _cli(["bake", "--input-blob", p, "--out", q] + extra)
            with open(q, "rb") as f:
                outs[dev] = (rc, out.replace(q, "OUT"), f.read())
        if outs["cuda"] != outs["cpu"] or outs["cuda"][0] != 0:
            raise SystemExit("cli bake: the card's output differs from the "
                             "CPU's")
        frames = {}
        for dev, extra in runs.items():
            rc, frames[dev] = _cli(
                ["viewer", p, "--set", "max_subdivision_level=6", "--stats",
                 "--frame"] + extra)
            if rc != 0:
                raise SystemExit(f"cli viewer on {dev} exited {rc}")
        if frames["cuda"] != frames["cpu"]:
            raise SystemExit("cli viewer: the card's frame differs from the "
                             "CPU's")
        card_vs, cpu_vs = ViewerSession(p), ViewerSession(p, device="cpu")
        r_card, r_cpu = card_vs.rebake(), cpu_vs.rebake()
        if card_vs.stats() != cpu_vs.stats() or not _results_equal(r_card,
                                                                    r_cpu):
            raise SystemExit("viewer: the card's re-bake differs from the "
                             "CPU's")
        if not np.array_equal(debug.render_overlay(desc7, r_card, scale=1),
                              debug.render_overlay(desc7, r_cpu, scale=1)):
            raise SystemExit("render_overlay: the card's result renders "
                             "differently from the CPU's")
        if tui.render_ansi(tui.TuiViewer(card_vs)) \
                != tui.render_ansi(tui.TuiViewer(cpu_vs)):
            raise SystemExit("render_ansi: the card's frame differs from "
                             "the CPU's")
    launched = ot.launches()["exact_classify"]
    if launched == 0:
        raise SystemExit("the tools never launched the exact kernel")
    print(f"tools on the card: cli bake (JSON and blob equal to --device "
          f"cpu), cli viewer --set max_subdivision_level=6 --frame (frame "
          f"equal to the CPU's), ViewerSession re-bake (stats and result "
          f"equal to the CPU's), render_overlay and render_ansi equal; "
          f"exact launches {launched} ({time.perf_counter() - t0:.1f} s, "
          f"{card})", flush=True)
    return launched


# ---- phase 13: bench.py's spot configurations ----

#: the base triangle of bench.py's _spot_highsubdiv and _spot_subdiv12
SPOT_BASE = np.array([[0.05, 0.1], [0.1, 0.8], [0.75, 0.7]], np.float32)
#: triangles of a spot held against the CPU bake where not all of them
SPOT_SUBSET = 16
#: the spots whose first batch's slot stream phase 13 times and bounds
SPOT_STREAMS = ("subdiv11", "subdiv12", "wrapped", "unorm8")


def _chain():
    """The benchmark plane as a 3-mip chain: the circle drawn at 1024^2,
    512^2 and 256^2."""
    import omm_tpu_torch as ot
    return ot.Texture([_circle(w) for w in (1024, 512, 256)],
                      ot.TextureFormat.FP32)


def _soft_contour():
    """bench.py _spot_unorm8's texture: a 1024^2 UNORM8 soft radial edge,
    quantized, with a wide band of texels near the cutoff."""
    import omm_tpu_torch as ot
    w = h = 1024
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    r = np.hypot(i / w - 0.5, j / h - 0.5)
    a = np.clip((np.float32(0.45) - r) / np.float32(0.08), 0.0, 1.0)
    return ot.Texture([np.round(a * 255).astype(np.uint8)],
                      ot.TextureFormat.UNORM8)


def _multimip_small():
    """bench.py _spot_multimip's 3-mip chain (128/64/32 crops of one
    RandomState(5) plane) and its two triangles."""
    import omm_tpu_torch as ot
    rng = np.random.RandomState(5)
    mips = []
    w = 128
    base = rng.rand(w, w).astype(np.float32)
    while w >= 32:
        mips.append(base[:w, :w].copy())
        w //= 2
    tris = [np.array([[0.1, 0.12], [0.2, 0.8], [0.82, 0.7]], np.float32),
            np.array([[0.3, 0.05], [0.35, 0.6], [0.9, 0.5]], np.float32)]
    return ot.Texture(mips, ot.TextureFormat.FP32), tris


def _spot_desc(tex, tris, level, mode=None, levels=None, flags=0):
    """A spot's BakeInputDesc with bench.py's engine configuration (cutoff
    0.5, OC1_4_State, Nearest promotion, the linear filter): every
    triangle at `level`, or at its entry of `levels`; address mode
    `mode` (Clamp); bake flags `flags`."""
    import omm_tpu_torch as ot
    n = len(tris)
    desc = ot.BakeInputDesc(
        texture=tex, tex_coords=np.concatenate(tris).astype(np.float32),
        index_buffer=np.arange(3 * n, dtype=np.uint32), index_count=3 * n,
        alpha_cutoff=0.5, max_subdivision_level=level,
        dynamic_subdivision_scale=0.0, bake_flags=ot.BakeFlags(flags),
        unknown_state_promotion=ot.UnknownStatePromotion.Nearest)
    if mode is not None:
        desc.runtime_sampler.addressing_mode = mode
    if levels is not None:
        desc.subdivision_levels = np.asarray(levels, np.uint8)
    return desc


def spot_workloads(tex, uv_tris):
    """Phase 13's bakes, (a)-(h), in order: (name, descriptor,
    micro-triangles, a function making the descriptor held against the
    CPU bake).  That descriptor is the whole spot for (a)-(c) and the
    small 3-mip chain, else SPOT_SUBSET of its triangles.  The large mesh
    repeats each bench triangle four times, as bench.py's does; the bake
    would classify each UV triangle once (duplicate detection), so it
    runs with DisableDuplicateDetection and classifies all 1024, as
    bench.py's spot does."""
    import omm_tpu_torch as ot
    A = ot.TextureAddressMode
    no_dups = int(ot.BakeFlags.DisableDuplicateDetection)
    wrapped = [t * np.float32(3.0) + np.float32(1.0) for t in uv_tris]
    chain = _chain()
    small_tex, small_tris = _multimip_small()
    unorm8 = _soft_contour()
    large = [uv_tris[k % len(uv_tris)] for k in range(1024)]
    mixed = [uv_tris[k % len(uv_tris)] for k in range(384)]
    mixed_levels = [7, 8, 9] * 128
    first = slice(0, SPOT_SUBSET)
    # (name, texture, triangles, level, mode, levels, flags, subset)
    rows = [
        ("subdiv11", tex, [SPOT_BASE + np.float32(0.02) * k
                           for k in range(4)], 11, None, None, 0, None),
        ("subdiv12", tex, [SPOT_BASE, SPOT_BASE + np.float32(0.02)], 12,
         None, None, 0, None),
        ("subdiv10", tex, uv_tris[:16], 10, None, None, 0, None),
        ("wrapped", tex, wrapped, SUBDIV, A.Wrap, None, 0, first),
        ("mirror", tex, wrapped, SUBDIV, A.Mirror, None, 0, first),
        ("multimip_small", small_tex, small_tris, 6, None, None, 0, None),
        ("multimip", chain, uv_tris, SUBDIV, None, None, 0, first),
        ("unorm8", unorm8, uv_tris, SUBDIV, None, None, 0, first),
        ("large_mesh", tex, large, SUBDIV, None, None, no_dups,
         slice(len(large) - SPOT_SUBSET, len(large))),
        ("mixed_levels", tex, mixed, SUBDIV, None, mixed_levels, 0, first),
    ]
    out = []
    for name, t, tris, level, mode, levels, flags, sub in rows:
        desc = _spot_desc(t, tris, level, mode, levels, flags)
        utri = sum(4 ** lv for lv in (levels or [level] * len(tris)))
        sub = sub or slice(0, len(tris))

        def cpu_desc(t=t, tris=tris[sub], level=level, mode=mode,
                     levels=None if levels is None else levels[sub],
                     flags=flags):
            return _spot_desc(t, tris, level, mode, levels, flags)
        out.append((name, desc, utri, cpu_desc))
    return out


def _gpu_spot_cfg(uv_tris, flags=None):
    """(i): the GPU baker's DispatchConfigDesc of the benchmark triangles
    on the 1024/512/256 chain in channel 3 of an RGBA texture, under
    Wrap."""
    import omm_tpu_torch as ot
    cfg = _gpu_cfg(_rgba(_chain()), uv_tris, flags)
    cfg.runtime_sampler.addressing_mode = ot.TextureAddressMode.Wrap
    return cfg


def spots_phase(tex, uv_tris, card):
    """Phase 13: (a)-(h) through ot.bake on the card, (i) through the GPU
    baker; each 2 warm-ups and 5 timed bakes, byte-equal, the exact kernel
    launched on the fast path, the card's result byte-equal to the CPU
    bake (`spot_workloads`' descriptors).  Returns ({name: exact launches
    of the 5 timed bakes}, {name: summary})."""
    import dataclasses

    import omm_tpu_torch as ot
    from omm_tpu_torch import gpu
    from omm_tpu_torch.bake import Options, setup_work_items
    launches, summaries = {}, {}
    for name, desc, utri, cpu_desc in spot_workloads(tex, uv_tris):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        counts, _, res, summary = _timed_bakes(desc, utri, f"spot {name}",
                                               card)
        peak = torch.cuda.max_memory_allocated()
        routes = _per_bake(counts, "route.")
        launches[name] = counts["exact_classify"]
        levels = ({int(lv) for lv in desc.subdivision_levels}
                  if desc.subdivision_levels is not None
                  else {desc.max_subdivision_level})
        nd = _check_shape(res[0], desc.index_count // 3, levels)
        n_items = len(setup_work_items(desc, Options.from_flags(
            desc.bake_flags)))
        if launches[name] == 0 or routes.get("route.fast_path", 0) != n_items:
            raise SystemExit(f"spot {name}: the bakes took {routes} items, "
                             f"not all {n_items} work items to the fast "
                             "path, or never launched the exact kernel")
        sub = cpu_desc()
        _, cpu_s = _card_equals_cpu(cpu_desc, f"spot {name}, "
                                    f"{sub.index_count // 3} triangles")
        summary.update(exact_launches=launches[name], routes=routes,
                       items=n_items, peak_bytes=peak, held_bytes=held,
                       descs=nd, cpu_s=cpu_s, cpu_tris=sub.index_count // 3)
        summaries[name] = summary
        print(f"spot {name}: {n_items} work items, {nd} OMMs at levels "
              f"{sorted(levels)}; items per route per bake "
              f"{json.dumps(routes)}; exact launches "
              f"{launches[name] // 5} per bake; peak device memory "
              f"{peak / 2 ** 20:.1f} MiB, {held / 2 ** 20:.1f} MiB of it "
              f"held before the bakes ({card})", flush=True)

    F = gpu.GpuBakeFlags
    cfg = _gpu_spot_cfg(uv_tris)
    utri = len(uv_tris) * 4 ** SUBDIV
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    counts, _, res, summary = _timed_bakes(cfg, utri, "spot gpu_chain_wrap",
                                           card)
    peak = torch.cuda.max_memory_allocated()
    launches["gpu_chain_wrap"] = counts["exact_classify"]
    _check_shape(res[0], len(uv_tris))
    if launches["gpu_chain_wrap"] == 0:
        raise SystemExit("spot gpu_chain_wrap never launched the exact "
                         "kernel")
    ot.reset_launches()
    co = _bake(dataclasses.replace(cfg, bake_flags=F.PerformSetupAndBake
                                   | F.ComputeOnly))
    if ot.launches()["exact_classify"] != 0 or not _results_equal(co,
                                                                   res[0]):
        raise SystemExit("spot gpu_chain_wrap: the ComputeOnly dispatch "
                         "launched the kernel or differs from the default "
                         "engine's")
    sub = _gpu_spot_cfg(uv_tris[:SPOT_SUBSET], F.PerformSetupAndBake
                        | F.EnablePostDispatchInfoStats)
    pipe = gpu.Pipeline()
    r_card, p_card = pipe.dispatch(sub).execute()
    t0 = time.perf_counter()
    r_cpu, p_cpu = pipe.dispatch(sub, "cpu").execute()
    cpu_s = time.perf_counter() - t0
    if not _results_equal(r_card, r_cpu) or p_card != p_cpu:
        raise SystemExit(f"spot gpu_chain_wrap, {SPOT_SUBSET} triangles: "
                         "the card differs from the CPU")
    summary.update(exact_launches=launches["gpu_chain_wrap"],
                   peak_bytes=peak, held_bytes=held, cpu_s=cpu_s,
                   cpu_tris=SPOT_SUBSET)
    summaries["gpu_chain_wrap"] = summary
    print(f"spot gpu_chain_wrap: exact launches "
          f"{launches['gpu_chain_wrap'] // 5} per dispatch, ComputeOnly "
          f"equal with none; {SPOT_SUBSET} triangles byte-equal to the CPU "
          f"dispatch with PostDispatchInfo ({cpu_s:.1f} s on the CPU); peak "
          f"device memory {peak / 2 ** 20:.1f} MiB, {held / 2 ** 20:.1f} MiB "
          f"of it held before ({card})", flush=True)
    return launches, summaries


def spot_streams(tex, uv_tris, dev, card):
    """The exact stage on the first batch's slot stream of each of
    SPOT_STREAMS: kernel and twin equal, the work and its bound, both
    versions' event time.  Returns {name: record}."""
    from omm_tpu_torch.bake import (MAX_UTRI_PER_BATCH, Options, _config,
                                    setup_work_items, split_tail_light)
    from omm_tpu_torch.kernels import exact
    descs = {name: desc for name, desc, _, _ in spot_workloads(tex, uv_tris)}
    out = {}
    for name in SPOT_STREAMS:
        desc = descs[name]
        opts = Options.from_flags(desc.bake_flags)
        uvs = [it.uv_tri for it in setup_work_items(desc, opts)]
        level = desc.max_subdivision_level
        n = len(split_tail_light(list(range(len(uvs))), [max(
            1, MAX_UTRI_PER_BATCH // 4 ** level)])[0])
        args, kw, what = slot_streams(desc.texture, uvs,
                                      _config(desc, opts), level, n, dev)
        err = _kernel_equals_twin(args, kw, f"spot stream {name}")
        work = exact.exact_work(*args, **kw)
        bound_ms, bound_by = exact.bound(work)
        ms = _cuda_ms(lambda: exact.exact_counts(*args, **kw))
        plain_ms = _cuda_ms(lambda: exact.exact_counts(
            *args, exact="torch", **kw), reps=5, burst=1, warm=1)
        out[name] = {"items": n, "stream": what, "max_abs_err": err,
                     "event_ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "work": work}
        print(f"spot stream {name}, {n} items, {what}: kernel {ms:.4f} ms, "
              f"twin {plain_ms:.4f} ms (events); bound {bound_ms:.6f} ms "
              f"({bound_by}); " + ", ".join(f"{k} {v}" for k, v in
                                            work.items()) + f" ({card})",
              flush=True)
    return out


def _bake_counted(desc, device="cuda"):
    """(BakeResult, seconds, counts) of one bake, counts set to 0 just
    before it and read just after."""
    import omm_tpu_torch as ot
    ot.reset_launches()
    t0 = time.perf_counter()
    res = _bake(desc, device)
    return res, time.perf_counter() - t0, _counts()


def _pipe(counts):
    """The nonzero pipeline counts of one bake."""
    return {k[9:]: v for k, v in counts.items()
            if k.startswith("pipeline.") and v}


def _need(counts, what, **want):
    """Fail unless counts["pipeline.<k>"] (or "exact_classify") == v for
    each k=v; a callable v is a predicate."""
    for k, v in want.items():
        got = counts["exact_classify" if k == "exact" else f"pipeline.{k}"]
        if not (v(got) if callable(v) else got == v):
            raise SystemExit(f"{what}: {k} {got}, want {v}; counts "
                             f"{json.dumps(_pipe(counts))}")


def spec_phase(card):
    """Phase 14: the single-sync pipeline on the card.  Returns ({path:
    exact launches}, {path: summary})."""
    import dataclasses

    import omm_tpu_torch as ot
    from omm_tpu_torch import batch as tbatch
    from omm_tpu_torch import gpu
    from omm_tpu_torch.bake import split_tail_light
    nb = len(split_tail_light(list(range(N_TRIS)), [BATCH]))
    utri = N_TRIS * 4 ** SUBDIV
    tex, uv_tris = _workload()
    desc = _desc(tex, uv_tris)

    # (a) the first bake discovers every batch, the second captures
    first, t_first, c = _bake_counted(desc)
    _need(c, "first bench bake", discovery=nb, spec=0)
    print(f"spec (a): first bake {t_first:.4f} s, all discovery: "
          f"{json.dumps(_pipe(c))}")
    res, t_cap, c = _bake_counted(desc)
    _need(c, "second bench bake", spec=nb, discovery=0, spec_overflow=0,
          graph_capture=lambda n: n >= 1, exact=nb)
    print(f"spec (a): second bake {t_cap:.4f} s, captures "
          f"{c['pipeline.graph_capture']}, replays "
          f"{c['pipeline.graph_replay']}")
    if not _results_equal(res, first):
        raise SystemExit("the capturing bake differs from the discovery "
                         "bake")
    caps = dict(getattr(tex, tbatch.CAPS_ATTR))

    def discover():
        setattr(tex, tbatch.CAPS_ATTR, {})  # the discovery path
        return _bake(desc)

    paths = {"spec": lambda: _bake(desc), "discovery": discover}
    times = {k: [] for k in paths}
    counts = {k: {} for k in paths}
    for r in range(5):
        for name in (("spec", "discovery") if r % 2 == 0
                     else ("discovery", "spec")):
            ot.reset_launches()
            t0 = time.perf_counter()
            res = paths[name]()
            times[name].append(time.perf_counter() - t0)
            for k, v in _counts().items():
                counts[name][k] = counts[name].get(k, 0) + v
            if not _results_equal(res, first):
                raise SystemExit(f"a {name} bake differs from the first "
                                 "bake")
    _need(counts["spec"], "5 spec bakes", spec=5 * nb, discovery=0,
          spec_overflow=0, graph_capture=0, graph_replay=5 * nb,
          count_sync=lambda n: n <= 5 * nb, exact=5 * nb)
    _need(counts["discovery"], "5 discovery bakes", discovery=5 * nb,
          spec=0, graph_replay=0, exact=5 * nb)
    if getattr(tex, tbatch.CAPS_ATTR) != caps:
        raise SystemExit("the discovery bakes recorded other caps entries")
    sums, launches = {}, {}
    for name in paths:
        sm = _summary(utri, times[name])
        sm.update(per_bake=_per_bake(counts[name], "pipeline."),
                  exact_per_bake=counts[name]["exact_classify"] // 5,
                  times_s=times[name])
        sums[name] = sm
        launches[name] = counts[name]["exact_classify"]
        print(f"spec (a) {name} path, 5 bench bakes in turns: best "
              f"{sm['best_s']:.4f} s median {sm['median_s']:.4f} s "
              f"({sm['best_mutri_s']:.2f} M utri/s best); per bake "
              f"{json.dumps(sm['per_bake'])}, exact launches "
              f"{sm['exact_per_bake']} ({card})", flush=True)
    print("spec (a): caps " + json.dumps(
        {str(k): v for k, v in caps.items()}))

    # (a) both paths against the CPU on 16 triangles
    t16 = _workload()[0]
    card16 = [_bake_counted(_desc(t16, uv_tris[:16])) for _ in range(3)]
    _need(card16[2][2], "16-triangle replay", spec=1, graph_replay=1)
    tc = _workload()[0]
    cpu16 = [_bake_counted(_desc(tc, uv_tris[:16]), "cpu") for _ in range(2)]
    _need(cpu16[1][2], "16-triangle CPU capacity chain", spec=1,
          discovery=0)
    if not all(_results_equal(r[0], cpu16[0][0]) for r in card16 + cpu16):
        raise SystemExit("16 triangles: a path on the card or the CPU "
                         "differs")
    print("spec (a): 16 triangles, the card's discovery, capture and replay "
          "bakes byte-equal to the CPU's discovery and capacity-chain "
          f"bakes ({cpu16[0][1]:.1f} + {cpu16[1][1]:.1f} s on the CPU)",
          flush=True)

    # (b) forced overflow: an eighth of each capacity the bench needs
    to = _workload()[0]
    dto = _desc(to, uv_tris)
    small = {k: (tuple(max(c // 8, 1) for c in Cs), max(K // 8, 1),
                 tuple(max(n // 8, 1) for n in nbk))
             for k, (Cs, K, nbk) in caps.items()}
    setattr(to, tbatch.CAPS_ATTR, dict(small))
    res, t_of, c = _bake_counted(dto)
    _need(c, "overflow bake", spec=nb, spec_overflow=nb, discovery=nb)
    if not _results_equal(res, first):
        raise SystemExit("the overflowed bake differs from the discovery "
                         "bake")
    if getattr(to, tbatch.CAPS_ATTR) != caps:
        raise SystemExit("the overflow's rerun did not record the entries "
                         "the discovery path records")
    res2, _, c2 = _bake_counted(dto)
    _need(c2, "bake after the overflow", spec=nb, spec_overflow=0,
          discovery=0)
    if not _results_equal(res2, first):
        raise SystemExit("the bake after the overflow differs")
    seeded = json.dumps({str(k): v for k, v in small.items()})
    print(f"spec (b): caps seeded at an eighth, {seeded}: {nb} of {nb} "
          f"batches flagged and rerun ({t_of:.4f} s), byte-equal; entries "
          "grew to "
          "the discovery path's; next bake all capacity chain "
          f"({json.dumps(_pipe(c2))})", flush=True)
    sums["overflow"] = {"seconds": t_of, "counts": _pipe(c)}
    launches["overflow"] = c["exact_classify"] + c2["exact_classify"]

    # (c) the GPU baker, default engine and ComputeOnly
    F = gpu.GpuBakeFlags
    cfg = _gpu_cfg(_rgba(tex), uv_tris)
    co = dataclasses.replace(cfg, bake_flags=F.PerformSetupAndBake
                             | F.ComputeOnly)
    g_first = _bake(cfg)
    for d in (cfg, co, co):
        _bake(d)
    r_def, t_def, c_def = _bake_counted(cfg)
    r_co, t_co, c_co = _bake_counted(co)
    _need(c_def, "gpu default engine", spec=nb, discovery=0,
          graph_replay=nb, exact=nb)
    _need(c_co, "gpu ComputeOnly", spec=nb, discovery=0, graph_replay=nb,
          exact=0)
    if not (_results_equal(r_def, g_first) and _results_equal(r_co, g_first)):
        raise SystemExit("the GPU baker's capacity-chain dispatches differ "
                         "from its discovery dispatch")
    print(f"spec (c): gpu dispatch on the capacity chain, default "
          f"{t_def:.4f} s ({nb} exact launches), ComputeOnly {t_co:.4f} s "
          "(none), byte-equal to the discovery dispatch", flush=True)
    sums["gpu"] = {"default_s": t_def, "compute_only_s": t_co}
    launches["gpu"] = c_def["exact_classify"]

    # (d) one profiled bench bake
    root = os.path.dirname(os.path.abspath(__file__))
    prof = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "profile_torch_bake.py"),
         "--workload", "bench"], cwd=root, capture_output=True, text=True,
        timeout=600)
    print(prof.stdout, end="", flush=True)
    if prof.returncode != 0:
        raise SystemExit(f"profile_torch_bake.py failed: {prof.stderr}")
    sums["profile"] = [ln for ln in prof.stdout.splitlines()
                       if ln.startswith(("profiled", "pipeline", "launch",
                                         "device busy", "exact kernel",
                                         "omm.drain", "device kernels"))]
    print(f"memory_reserved after phase 14: "
          f"{torch.cuda.memory_reserved() / 2 ** 20:.1f} MiB "
          f"(allocated {torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB) "
          f"({card})", flush=True)
    return launches, sums


#: phase 15's labels: the bake's stages, the batch pipeline's post pass,
#: and finalize_items' stages in the order they run
POST_LABELS = ("omm.classify", "omm.row_post", "omm.finalize",
               "omm.promote", "omm.dedup_exact", "omm.dedup_near",
               "omm.compress", "omm.histograms", "omm.sort",
               "omm.serialize")


def _classify_with_posts(desc, device):
    """setup_work_items and classify_items of desc on `device`, its
    counts set to 0 just before classify_items and read just after:
    (opts, items, counts, seconds).  Fails unless every fast-path item
    carries a post equal to the recompute on its unpacked row."""
    import omm_tpu_torch as ot
    from omm_tpu_torch import native
    from omm_tpu_torch.bake import Options, classify_items, setup_work_items
    from omm_tpu_torch.planes import check_device
    opts = Options.from_flags(desc.bake_flags)
    items = setup_work_items(desc, opts)
    ot.reset_launches()
    t0 = time.perf_counter()
    classify_items(desc, opts, items, check_device(device))
    secs = time.perf_counter() - t0
    counts = _counts()
    fast = counts["route.fast_path"]
    posted = [it for it in items if it.post is not None]
    if fast != len(items) or len(posted) != fast:
        raise SystemExit(f"{len(posted)} of {len(items)} items ({fast} on "
                         "the fast path) carry a post")
    for k, it in enumerate(items):
        st = it.states
        want = (native.states3_digest(st), native.all_uniform_u8(st))
        if it.post != want:
            raise SystemExit(f"item {k}: post {it.post}, recomputed {want}")
    return opts, items, counts, secs


def post_phase(card):
    """Phase 15: the fused post pass on the card.  Returns (exact
    launches of classify_items, summary)."""
    from torch.profiler import ProfilerActivity, profile

    from omm_tpu_torch.bake import finalize_items, split_tail_light
    nb = len(split_tail_light(list(range(N_TRIS)), [BATCH]))
    tex, uv_tris = _workload()
    desc = _desc(tex, uv_tris)
    first = _bake(desc)  # the discovery path
    _bake(desc)  # captures the graphs
    torch.cuda.synchronize()
    opts, items, c, t_cls = _classify_with_posts(desc, "cuda")
    _need(c, "post classify", spec=nb, discovery=0, spec_overflow=0,
          graph_replay=nb, exact=nb)
    uniform = sum(1 for it in items if it.post[1] >= 0)
    t0 = time.perf_counter()
    res = finalize_items(desc, opts, items)
    t_fin = time.perf_counter() - t0
    if not _results_equal(res, first):
        raise SystemExit("post: the bake of items with posts differs from "
                         "the discovery bake")
    print(f"post: {len(items)} of {N_TRIS} bench items carry a post equal "
          f"to the recompute ({uniform} uniform); classify_items "
          f"{t_cls:.4f} s ({nb} batches on the chain, {c['exact_classify']}"
          f" exact launches), finalize_items {t_fin:.4f} s, byte-equal to "
          f"the discovery bake ({card})", flush=True)

    # 16 triangles with their posts, on the card and on the CPU
    d16 = [_desc(_workload()[0], uv_tris[:16]) for _ in range(2)]
    r16 = [finalize_items(d, o, its) for d, (o, its, _, _) in zip(
        d16, (_classify_with_posts(d16[0], "cuda"),
              _classify_with_posts(d16[1], "cpu")))]
    r_cpu = _bake(_desc(_workload()[0], uv_tris[:16]), "cpu")
    if not (_results_equal(r16[0], r16[1])
            and _results_equal(r16[0], r_cpu)):
        raise SystemExit("post: 16 triangles with posts, the card's bake "
                         "differs from the CPU's")
    print("post: 16 triangles classified with their posts on the card and "
          "on the CPU, byte-equal to each other and to ot.bake on the CPU",
          flush=True)

    # one profiled bake: omm.finalize split into its stages
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=all_threads()) as prof:
        t0 = time.perf_counter()
        res = _bake(desc)
        wall = time.perf_counter() - t0
    if not _results_equal(res, first):
        raise SystemExit("post: the profiled bake differs from the "
                         "discovery bake")
    ev = {e.key: e for e in prof.key_averages()}
    labels = {k: (ev[k].cpu_time_total / 1e3, ev[k].count)
              for k in POST_LABELS if k in ev}
    missing = [k for k in POST_LABELS if k not in labels]
    if missing:
        raise SystemExit(f"post: the profile has no {missing}")
    print(f"post: profiled bench bake {wall * 1e3:.3f} ms wall (host "
          f"labels, profiler on; {card}):")
    for k, (ms, n) in labels.items():
        print(f"  {k:18s} {ms:10.3f} ms x{n}")
    return c["exact_classify"], {
        "classify_s": t_cls, "finalize_s": t_fin, "uniform": uniform,
        "items_with_post": len(items), "profiled_wall_ms": wall * 1e3,
        "labels_ms": {k: v[0] for k, v in labels.items()}}


def all_threads():
    """torch.profiler's experimental config that records the labels of
    every thread: a bake's chains are issued by the batch pipeline's
    enqueue thread (omm.spec) and its rows written back by a pool
    (omm.row_post), not by the calling thread."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def profile_labels(prof):
    """({omm.* label: (host ms inclusive, calls, threads)}, device busy
    ms) of a torch.profiler profile: the labels' host spans (not their
    device-side spans), and the self device time of every device op."""
    from torch.autograd import DeviceType
    threads = {}
    for e in prof.events():
        if e.name.startswith("omm.") and e.device_type == DeviceType.CPU:
            threads.setdefault(e.name, set()).add(e.thread)
    labels, dev_us = {}, 0.0
    for e in prof.key_averages():
        if e.key.startswith("omm."):
            if e.device_type == DeviceType.CPU:
                labels[e.key] = (e.cpu_time_total / 1e3, e.count,
                                 len(threads.get(e.key, ())))
        elif e.device_type == DeviceType.CUDA:
            dev_us += e.self_device_time_total
    return labels, dev_us / 1e3


#: phase 16's labels: the calling thread's bake, its waits, the enqueue
#: thread's chains and the pool's post passes
DRAIN_LABELS = ("omm.classify", "omm.drain", "omm.spec", "omm.row_post")


def _gil_probe(tex, card):
    """Whether CUDAGraph.replay() lets other threads run Python: a pure
    Python loop counts for 0.3 s alone, then for 0.3 s while another
    thread replays one of tex's captured graphs (a sync after every 6
    replays, as a bake's drain has).  Returns (loop ratio, share of the
    window the replaying thread spent inside replay())."""
    import threading

    from omm_tpu_torch import planes
    st = next(c["graphs"] for c in getattr(tex, planes._CACHE_ATTR).values()
              if "graphs" in c)
    entry = next(iter(st.graphs.values()))

    def spin(sec):
        n, end = 0, time.perf_counter() + sec
        while time.perf_counter() < end:
            n += 1
        return n

    stop = threading.Event()
    inside = [0.0, 0]

    def replay():
        while not stop.is_set():
            with st.lock:
                t0 = time.perf_counter()
                entry.graph.replay()
                inside[0] += time.perf_counter() - t0
            inside[1] += 1
            if inside[1] % 6 == 0:
                torch.cuda.synchronize()

    alone = spin(0.3)
    th = threading.Thread(target=replay)
    th.start()
    try:
        t0 = time.perf_counter()
        shared = spin(0.3)
        window = time.perf_counter() - t0
    finally:
        stop.set()
        th.join()
    torch.cuda.synchronize()
    ratio, share = shared / alone, inside[0] / window
    print(f"drain (d): a Python loop ran {ratio:.3f} of its lone rate while "
          f"another thread replayed a bench graph {inside[1]} times, "
          f"{share:.3f} of the window inside replay() "
          f"({inside[0] / max(inside[1], 1) * 1e3:.3f} ms per call); "
          f"{'replay releases' if ratio > 1 - share / 2 else 'replay holds'}"
          f" the interpreter lock ({card})", flush=True)
    return ratio, share


def drain_phase(card):
    """Phase 16: the concurrent drain on the card.  Returns ({path: exact
    launches}, {path: summary})."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    import omm_tpu_torch as ot
    from omm_tpu_torch import batch as tbatch
    from omm_tpu_torch import native
    from omm_tpu_torch.bake import (Options, _config, setup_work_items,
                                    split_tail_light)
    nb = len(split_tail_light(list(range(N_TRIS)), [BATCH]))
    utri = N_TRIS * 4 ** SUBDIV
    tex, uv_tris = _workload()
    desc = _desc(tex, uv_tris)
    first = _bake(desc)  # the discovery path
    _bake(desc)  # captures the graphs
    torch.cuda.synchronize()
    launches, sums = {}, {}

    # (a) the threads of 5 drained bakes: a pool thread takes a batch
    # only while the threads before it are busy, so each bake counts its
    # post threads and the most post passes that ran at once
    seen = {"post": set(), "enqueue": set(), "running": 0, "most": 0}
    lock = threading.Lock()
    post_fn, run_fn = native.row_post_packed, tbatch._enqueue_spec

    def post(*a, **k):
        with lock:
            seen["post"].add(threading.get_ident())
            seen["running"] += 1
            seen["most"] = max(seen["most"], seen["running"])
        try:
            return post_fn(*a, **k)
        finally:
            with lock:
                seen["running"] -= 1

    def run(*a, **k):
        with lock:
            seen["enqueue"].add(threading.get_ident())
        return run_fn(*a, **k)

    me = threading.get_ident()
    per_bake, exact_a = [], 0
    native.row_post_packed, tbatch._enqueue_spec = post, run
    try:
        for _ in range(5):
            seen.update(post=set(), enqueue=set(), most=0)
            res, t_a, c = _bake_counted(desc)
            _need(c, "drained bench bake", spec=nb, discovery=0,
                  spec_overflow=0, graph_capture=0, graph_replay=nb,
                  count_sync=nb, exact=nb)
            if me in seen["post"]:
                raise SystemExit("drain: a post pass ran on the calling "
                                 "thread")
            if len(seen["enqueue"]) != 1 or me in seen["enqueue"]:
                raise SystemExit("drain: chains issued from "
                                 f"{len(seen['enqueue'])} threads (want one "
                                 "enqueue thread)")
            if not _results_equal(res, first):
                raise SystemExit("drain: a drained bake differs from the "
                                 "discovery bake")
            per_bake.append((t_a, len(seen["post"]), seen["most"]))
            exact_a += c["exact_classify"]
    finally:
        native.row_post_packed, tbatch._enqueue_spec = post_fn, run_fn
    if max(n for _, n, _ in per_bake) < 2:
        raise SystemExit("drain: every bake ran its post passes on one "
                         "thread")
    print(f"drain (a): 5 bench bakes, {nb} batches each issued from one "
          "enqueue thread, byte-equal to the discovery bake; per bake "
          "(seconds, post threads, most post passes at once): "
          f"{json.dumps(per_bake)}; last {json.dumps(_pipe(c))} ({card})",
          flush=True)
    launches["threads"] = exact_a
    sums["threads"] = per_bake

    # (b) 16 triangles in 4 batches of 4, with posts: the card's
    # discovery, capture and drained calls equal to the CPU's
    opts = Options.from_flags(desc.bake_flags)
    cfg = _config(desc, opts)
    uvs = [it.uv_tri for it in setup_work_items(desc, opts)][:16]

    def call16(t, device):
        posts = []
        outs = tbatch.classify_work_items_batches(
            t, cfg, [[(u, None) for u in uvs[k:k + 4]]
                     for k in range(0, 16, 4)], SUBDIV, device=device,
            post_out=posts)
        return [[r.packed.copy() for r in o] for o in outs], posts

    t16, tc = _workload()[0], _workload()[0]
    card16 = [call16(t16, "cuda") for _ in range(2)]
    ot.reset_launches()
    card16.append(call16(t16, "cuda"))
    c16 = _counts()
    # every batch starts on the chain; one that overflows the entry the
    # last discovered batch of its shape recorded reruns (and the next
    # call captures anew), as in the JAX package
    _need(c16, "16 triangles drained", spec=4,
          discovery=c16["pipeline.spec_overflow"])
    cpu16 = [call16(tc, "cpu") for _ in range(2)]

    def same(a, b):
        return a[1] == b[1] and all(
            np.array_equal(x, y) for oa, ob in zip(a[0], b[0])
            for x, y in zip(oa, ob))

    if not all(same(r, cpu16[0]) for r in card16 + cpu16[1:]):
        raise SystemExit("drain: 16 triangles, the card's rows or posts "
                         "differ from the CPU's")
    print("drain (b): 16 triangles in 4 batches with posts, the card's "
          "discovery, capturing and drained calls byte-equal to the CPU's "
          "discovery and drained calls; drained call "
          f"{json.dumps(_pipe(c16))}", flush=True)
    launches["batches16"] = c16["exact_classify"]

    # (c) the bench bake and the GPU baker's dispatch in turns with the
    # discovery path, which bakes a second texture of the same data with
    # its caps emptied before each bake: the GPU baker's dispatch makes
    # one call per scratch batch, and its second call finds the first's
    # entries, runs on the chain (capturing at them) and reruns what
    # overflows, so on a shared texture it would leave graphs that the
    # drained dispatches must capture again
    tex2 = _workload()[0]
    gcfg = _gpu_cfg(_rgba(tex), uv_tris)
    gcfg2 = _gpu_cfg(_rgba(tex2), uv_tris)
    for name, d, d2, caps_of in (
            ("bench", desc, _desc(tex2, uv_tris), tex2),
            ("gpu", gcfg, gcfg2, gcfg2.alpha_texture.channel_view(3))):
        ref = first if name == "bench" else _bake(d)

        def discover(d2=d2, caps_of=caps_of):
            setattr(caps_of, tbatch.CAPS_ATTR, {})
            return _bake(d2)

        results, times, counts = _in_turns(
            {"drain": lambda d=d: _bake(d), "discovery": discover})
        _need(counts["drain"], f"5 drained {name} bakes", spec=5 * nb,
              discovery=0, spec_overflow=0, graph_capture=0,
              graph_replay=5 * nb, count_sync=5 * nb, exact=5 * nb)
        # on the discovery path every batch ends once, discovered or
        # clean on the chain, and the bench bake (one call) discovers all
        c = counts["discovery"]
        ended = (c["pipeline.discovery"] + c["pipeline.spec"]
                 - c["pipeline.spec_overflow"])
        if ended != 5 * nb or (name == "bench"
                               and c["pipeline.discovery"] != 5 * nb):
            raise SystemExit(f"drain: 5 discovery {name} bakes: counts "
                             f"{json.dumps(_pipe(c))}")
        _need(c, f"5 discovery {name} bakes",
              exact=c["pipeline.discovery"] + c["pipeline.spec"])
        if not all(_results_equal(r, ref) for v in results.values()
                   for r in v):
            raise SystemExit(f"drain: a {name} bake in turns differs from "
                             "its discovery bake")
        for path in ("drain", "discovery"):
            sm = _summary(utri, times[path])
            sm["times_s"] = times[path]
            sums[f"{name}.{path}"] = sm
            key = name if path == "drain" else f"{name}_discovery"
            launches[key] = counts[path]["exact_classify"]
            print(f"drain (c) {name}, {path} path, 5 in turns: best "
                  f"{sm['best_s']:.4f} s median {sm['median_s']:.4f} s "
                  f"({sm['best_mutri_s']:.2f} M utri/s best); "
                  f"{json.dumps(_per_bake(counts[path], 'pipeline.'))} per "
                  f"bake ({card})", flush=True)

    # (d) does a graph replay let other threads run
    ratio, share = _gil_probe(tex, card)
    sums["gil_probe"] = {"loop_ratio": ratio, "replay_share": share}

    # (e) one drained bake profiled on every thread
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=all_threads()) as prof:
        t0 = time.perf_counter()
        res = _bake(desc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not _results_equal(res, first):
        raise SystemExit("drain: the profiled bake differs from the "
                         "discovery bake")
    labels, busy = profile_labels(prof)
    missing = [k for k in DRAIN_LABELS if k not in labels]
    if missing:
        raise SystemExit(f"drain: the profile has no {missing}")
    if labels["omm.spec"][2] != 1:
        raise SystemExit("drain: the profile shows omm.spec on "
                         f"{labels['omm.spec'][2]} threads")
    print(f"drain (e): profiled bench bake {wall * 1e3:.3f} ms wall, every "
          f"thread; device busy {busy:.3f} ms, idle share "
          f"{1 - busy / 1e3 / wall:.4f} ({card}):")
    for k in DRAIN_LABELS:
        ms, n, th = labels[k]
        print(f"  {k:14s} {ms:10.3f} ms x{n} on {th} thread(s)")
    sums["profile"] = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                       "labels": {k: labels[k] for k in DRAIN_LABELS}}
    return launches, sums


#: phase 17's streams: (name, the bake whose first batch it is, partial,
#: caps divided by)
CHAIN_STREAMS = (("bench", "bench", False, 1),
                 ("multimip_small", "multimip_small", False, 1),
                 ("wrapped", "wrapped", False, 1),
                 ("subdiv12", "subdiv12", False, 1),
                 ("partial", "bench", True, 1),
                 ("overflow", "bench", False, 8))
#: each chain kernel: (its wrappers' names in chain.recording, the device
#: kernels it launches as torch.profiler names them, its work function)
CHAIN_KERNELS = {
    "descend_sides": (("descend_sides",), "descend_kernel"),
    "tile_keys": (("tile_keys",), "keys_kernel"),
    "tile_slots": (("tile_slots", "slot_stream"), "slots_"),
}


def _first_batch_job(desc, dev, partial):
    """The first batch of desc's items as the bake batches them, as the
    batch pipeline's job on `dev`: fresh items, or partial ones (a third
    of each item's micro-triangles already resolved)."""
    from omm_tpu_torch import batch, host
    from omm_tpu_torch.bake import (MAX_UTRI_PER_BATCH, Options, _config,
                                    setup_work_items, split_tail_light)
    opts = Options.from_flags(desc.bake_flags)
    uvs = [it.uv_tri for it in setup_work_items(desc, opts)]
    level = desc.max_subdivision_level
    n = len(split_tail_light(list(range(len(uvs))), [max(
        1, MAX_UTRI_PER_BATCH // 4 ** level)])[0])
    uvs = uvs[:n]
    items = [(u, None) for u in uvs]
    if partial:
        items = []
        for k, u in enumerate(uvs):
            st = np.full(4 ** level, 3, np.uint8)
            st[k % 3::3] = 0
            items.append((u, st))
    pre = batch.precompute(desc.texture, uvs, level,
                           host._group_level(desc.texture, uvs, level))
    return batch._Batch(desc.texture, _config(desc, opts), items, level,
                        list(range(n)), [None] * n, not partial, pre, dev,
                        None)


def _chain_calls(job, dev, div):
    """Every chain kernel call of the job's discovery path and of its
    capacity chain at its caps entry divided by `div`, eagerly on the
    card (chain.recording): (calls of the discovery path, calls of the
    chain, the chain's payload)."""
    from omm_tpu_torch import batch
    from omm_tpu_torch.kernels import chain
    disc, spec = [], []
    with chain.recording(disc):
        batch._run_batch(job)
    Cs, K_cap, nblks = job.texture._omm_torch_caps[job.cap_key]
    entry = (tuple(max(c // div, 1) for c in Cs), max(K_cap // div, 1),
             tuple(max(n // div, 1) for n in nblks))
    inputs = [t.to(dev) for t in job.host_inputs()]
    with chain.recording(spec):
        pay = batch.spec_fn(job, entry)(*inputs)
    torch.cuda.synchronize()
    return disc, spec, pay


def _calls_equal_plain(calls, what):
    """Fail unless each recorded call's result equals its plain version's
    on the same inputs, on every lane.  Returns {wrapper: calls}."""
    from omm_tpu_torch.kernels import chain
    seen = {}
    for kernel, name, fn, plain, args, kw, out in calls:
        err = chain.result_diff(out, plain(*args, **kw))
        if err:
            raise SystemExit(f"chain kernels, {what}: {name} differs from "
                             f"its plain version by up to {err}")
        seen[name] = seen.get(name, 0) + 1
    torch.cuda.synchronize()
    return seen


def _call_work(name, args, kw, out):
    from omm_tpu_torch.kernels import chain
    if name == "descend_sides":
        return chain.descend_work(args[0], args[1], out, n_out=kw["n_out"],
                                  uv_flat=kw["uv_flat"], cls=kw["cls"],
                                  test=kw.get("test", True),
                                  act_span=kw.get("act_span", 0))
    if name == "tile_keys":
        return chain.tile_keys_work(args[0], args[1], out, kw["uv_flat"])
    return chain.tile_slots_work(*args)


@contextlib.contextmanager
def _plain_chain():
    """Within the block the two-phase stages take the chain kernels'
    plain versions on every device (the port's device program before the
    kernels), to compare the two in one process."""
    from omm_tpu_torch import twophase
    from omm_tpu_torch.kernels import chain
    swap = {"descend_sides": chain.descend_sides_torch,
            "tile_keys": chain.tile_keys_torch,
            "tile_slots": chain.tile_slots_torch,
            "chain_slot_stream": chain.slot_stream_torch}
    saved = {a: getattr(twophase, a) for a in swap}
    try:
        for a, f in swap.items():
            setattr(twophase, a, f)
        yield
    finally:
        for a, f in saved.items():
            setattr(twophase, a, f)


def device_kernels(prof):
    """(device kernels, device copies and sets, {kernel: (launches, ms)})
    of a torch.profiler profile."""
    from torch.autograd import DeviceType
    kernels, moves, by_name = 0, 0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("omm."):
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            moves += e.count
        else:
            kernels += e.count
            by_name[e.key] = (e.count, e.self_device_time_total / 1e3)
    return kernels, moves, by_name


def _profiled_bake(desc):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=all_threads()) as prof:
        t0 = time.perf_counter()
        res = _bake(desc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, busy = profile_labels(prof)
    kernels, moves, by_name = device_kernels(prof)
    return res, {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                 "idle_share": 1 - busy / 1e3 / wall,
                 "device_kernels": kernels, "device_moves": moves,
                 "top": sorted(((v[1], k[:60], v[0]) for k, v in
                                by_name.items()), reverse=True)[:6]}


def _parent_in_turns(parent, card):
    """bench and the GPU dispatch timed by tools/time_torch_bake.py, one
    process each, parent, this, this, parent: {workload: {"parent" |
    "this": [summaries]}}."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"profiles": {}}
    for who in ("parent", "this"):
        cmd = [sys.executable, os.path.join(root, "tools",
                                            "profile_torch_bake.py"),
               "--workload", "bench"]
        if who == "parent":
            cmd += ["--package-root", parent]
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise SystemExit(f"profile_torch_bake.py ({who}) failed: "
                             f"{r.stderr[-2000:]}")
        keep = [ln for ln in r.stdout.splitlines() if ln.startswith((
            "profiled", "device kernels", "device busy", "  exact",
            "  descend", "  keys", "  slots", "launch calls"))]
        out["profiles"][who] = keep
        print(f"chain (e) profiled bench bake, {who}:\n  "
              + "\n  ".join(keep), flush=True)
    for wl in ("bench", "gpu"):
        out[wl] = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            cmd = [sys.executable, os.path.join(root, "tools",
                                                "time_torch_bake.py"),
                   "--workload", wl]
            if who == "parent":
                cmd += ["--package-root", parent]
            r = subprocess.run(cmd, cwd=root, capture_output=True,
                               text=True, timeout=600)
            if r.returncode != 0:
                raise SystemExit(f"time_torch_bake.py ({who}, {wl}) failed:"
                                 f" {r.stderr[-2000:]}")
            rec = json.loads(r.stdout.strip().splitlines()[-1])
            out[wl][who].append({k: rec[k] for k in ("best_s", "median_s")})
            print(f"chain (e) {wl} {who}: best {rec['best_s']:.4f} s median "
                  f"{rec['median_s']:.4f} s ({rec['card']})", flush=True)
    return out


def chain_phase(card, parent=None):
    """Phase 17: the capacity chain's descent and tile-slot kernels.
    Returns ({kernel: record for the kernels line}, summary)."""
    import omm_tpu_torch as ot
    from omm_tpu_torch.kernels import chain
    dev = torch.device("cuda", 0)

    # (a) each kernel against its plain version on every stream
    tex, uv_tris = _workload()
    descs = {name: d for name, d, _, _ in spot_workloads(tex, uv_tris)}
    descs["bench"] = _desc(tex, uv_tris)
    bench_calls = None
    streams = {}
    for name, src, partial, div in CHAIN_STREAMS:
        desc = descs[src]
        desc.texture._omm_torch_caps = {}
        job = _first_batch_job(desc, dev, partial)
        disc, spec, pay = _chain_calls(job, dev, div)
        seen = _calls_equal_plain(disc + spec, name)
        m = len(job.bp["levels"]) - 1
        meta = pay[:4 * (m + 2 + len(job.bp["mips"]))].view(
            torch.int32).tolist()
        if (meta[m + 1] == 1) != (div > 1):
            raise SystemExit(f"chain kernels, {name}: meta {meta}")
        for need in ("descend_sides", "tile_keys", "tile_slots",
                     "slot_stream"):
            if need not in seen:
                raise SystemExit(f"chain kernels, {name}: no {need} call")
        streams[name] = {"items": job.T, "subdiv": job.subdiv,
                         "levels": list(job.bp["levels"]),
                         "mips": len(job.bp["mips"]), "meta": meta,
                         "calls": seen}
        print(f"chain (a) {name}: {job.T} items at {job.subdiv}, levels "
              f"{list(job.bp['levels'])}, {len(job.bp['mips'])} mip(s), "
              f"meta {meta}; every call equal to its plain version on "
              f"every lane: {json.dumps(seen)}", flush=True)
        if name == "bench":
            bench_calls = spec

    # (b) each kernel's time at bench's first batch (the capacity chain's
    # calls), its bound, the plain version's time
    recs = {}
    for kname, (wrappers, dev_name) in CHAIN_KERNELS.items():
        calls = [c for c in bench_calls if c[1] in wrappers]
        ms = ev_ms = plain_ms = bound_ms = 0.0
        nbytes = ops = 0
        for _, name, fn, plain, args, kw, out in calls:
            d = device_ms(lambda: fn(*args, **kw), dev_name)
            e = _cuda_ms(lambda: fn(*args, **kw))
            ms += d if d is not None else e
            ev_ms += e
            plain_ms += _cuda_ms(lambda: plain(*args, **kw), reps=5,
                                 burst=1, warm=1)
            work = _call_work(name, args, kw, out)
            bound_ms += chain.bound(work)[0]
            nbytes += work["bytes"]
            ops += work["ops"]
        bound_by = chain.bound({"bytes": nbytes, "ops": ops})[1]
        recs[kname] = {"calls_per_batch": len(calls), "ms": ms,
                       "event_ms": ev_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes": nbytes, "ops": ops,
                       "share_of_bound": bound_ms / ms if ms else None}
        print(f"chain (b) {kname}, bench's first batch ({len(calls)} "
              f"calls): device {ms:.5f} ms, events {ev_ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms; bound {bound_ms:.6f} ms ({bound_by}, "
              f"{nbytes} B, {ops} ops), {bound_ms / ms:.4f} of it ({card})",
              flush=True)

    # (c) launches per bench bake on the chain, counted just around it
    desc = _desc(*_workload())
    for _ in range(2):
        _bake(desc)
    torch.cuda.synchronize()
    ot.reset_launches()
    res = _bake(desc)
    counts = _counts()
    per_bake = {k: counts[k] for k in ("exact_classify", *CHAIN_KERNELS)}
    print(f"chain (c) launches per bench bake: {json.dumps(per_bake)}; "
          f"pipeline {json.dumps(_pipe(counts))}", flush=True)
    if min(per_bake.values()) == 0 or counts["pipeline.graph_replay"] != 6:
        raise SystemExit("chain (c): a kernel was not launched, or the bake "
                         "left the chain")
    for k in CHAIN_KERNELS:
        recs[k]["launches_per_bake"] = per_bake[k]

    # (d) device kernels and busy ms per bench bake, kernels against the
    # plain versions in their place, one profiled bake each in turns
    # after warm-ups on textures of their own
    descs = {"kernels": desc, "plain": _desc(*_workload())}
    with _plain_chain():
        for _ in range(2):
            ref = _bake(descs["plain"])
    if not _results_equal(ref, res):
        raise SystemExit("chain (d): the plain chain's bake differs")
    prof = {"kernels": [], "plain": []}
    times = {"kernels": [], "plain": []}
    for who in ("plain", "kernels", "kernels", "plain"):
        with _plain_chain() if who == "plain" else contextlib.nullcontext():
            r, p = _profiled_bake(descs[who])
            rounds = []
            for _ in range(5):
                t0 = time.perf_counter()
                r2 = _bake(descs[who])
                rounds.append(time.perf_counter() - t0)
        if not (_results_equal(r, res) and _results_equal(r2, res)):
            raise SystemExit(f"chain (d): a {who} bake differs")
        prof[who].append(p)
        times[who] += rounds
        print(f"chain (d) {who}: profiled bake {p['wall_ms']:.3f} ms wall, "
              f"device busy {p['device_busy_ms']:.3f} ms (idle share "
              f"{p['idle_share']:.4f}), {p['device_kernels']} device "
              f"kernels + {p['device_moves']} copies/sets; 5 bakes best "
              f"{min(rounds):.4f} s median {statistics.median(rounds):.4f} "
              f"s ({card})", flush=True)
        for ms, k, n in p["top"]:
            print(f"    {ms:9.4f} ms x{n:<4d} {k}")
    summary = {"streams": streams, "per_bake": per_bake,
               "profiles": prof,
               "bench_in_turns": {k: _summary(N_TRIS * 4 ** SUBDIV, v)
                                  for k, v in times.items()}}

    # (e) against the parent tree, where one is given
    if parent is not None:
        summary["parent_in_turns"] = _parent_in_turns(parent, card)
    else:
        print("chain (e): no --parent checkout given; the in-turns timing "
              "against it is not run", flush=True)
    return recs, summary


#: the chain kernels' sources, and the XLA programs of the JAX package
#: they replace (not Pallas kernels)
CHAIN_SOURCES = {"descend_sides": "omm_tpu_torch/csrc/chain_descend.cu",
                 "tile_keys": "omm_tpu_torch/csrc/chain_descend.cu",
                 "tile_slots": "omm_tpu_torch/csrc/chain_slots.cu"}
CHAIN_REPLACES = {"descend_sides": "omm_tpu/kernels/twophase.py:270",
                  "tile_keys": "omm_tpu/kernels/twophase.py:528",
                  "tile_slots": "omm_tpu/kernels/twophase.py:547"}


def main(parent=None):
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; it runs on the card "
                         "only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)

    import omm_tpu_torch as ot
    from omm_tpu_torch.bake import Options, _config, setup_work_items
    from omm_tpu_torch.kernels import build, exact

    # ---- 2. build (both CUDA libraries at once) ----
    import concurrent.futures as cf
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(build.cuda_library),
                  pool.submit(build.chain_cuda_library)]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, both "
          f"libraries at once, {build.build_dir()})")
    for lib in ("omm_exact_cuda", "omm_chain_cuda"):
        info = build.BUILD_INFO.get(lib, {})
        if info:
            print(f"  {lib}: {info['seconds']:.2f} s")
        for line in info.get("log", "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel ----
    tex, uv_tris = _workload()
    desc = _desc(tex, uv_tris)
    opts = Options.from_flags(desc.bake_flags)
    items = setup_work_items(desc, opts)
    cfg = _config(desc, opts)
    uvs = [it.uv_tri for it in items]
    err = 0
    for subdiv in (SUBDIV, 6):
        args, kw, what = slot_streams(tex, uvs, cfg, subdiv, BATCH, dev)
        e = _kernel_equals_twin(args, kw, what)
        err = max(err, e)
        shp = exact.shape(kw["H"], kw["W"])
        print(f"kernel phase, {what}; launch {shp['threads']} threads x "
              f"{shp['blocks_per_sm']} blocks/SM, {shp['smem_bytes']} B "
              f"shared; max_abs_err {e}", flush=True)
        if subdiv == SUBDIV:
            bench = (args, kw)
        elif kw["H"] * kw["W"] <= 32:
            raise SystemExit(f"subdivision {subdiv} stream has a window of "
                             f"{kw['H']}x{kw['W']}: want more than 32 "
                             "texels")
    args, kw = bench
    work = exact.exact_work(*args, **kw)
    bound_ms, bound_by = exact.bound(work)
    print("exact_work, bench stream: " + ", ".join(
        f"{k} {v}" for k, v in work.items()))
    ms = _cuda_ms(lambda: exact.exact_counts(*args, **kw))
    plain_ms = _cuda_ms(lambda: exact.exact_counts(*args, exact="torch",
                                                   **kw))
    print(f"exact stage, {args[2].shape[0]} blocks: kernel {ms:.4f} ms, "
          f"torch twin {plain_ms:.4f} ms (events); bound {bound_ms:.6f} ms "
          f"({bound_by}) ({card})", flush=True)

    # ---- 4. slice ----
    main_launches, _, results, bench_sum = _timed_bakes(
        *_workload_desc("bench", tex, uv_tris), "bake", card)
    launches = main_launches["exact_classify"]
    if launches == 0:
        raise SystemExit("the bake never launched the exact kernel")
    for k in CHAIN_KERNELS:
        if main_launches[k] == 0:
            raise SystemExit(f"the bake never launched the {k} kernel")
    print("main path launches in 5 bakes: " + json.dumps(
        {k: main_launches[k] for k in ("exact_classify", *CHAIN_KERNELS)}),
        flush=True)
    got = results[-1]

    # ---- 5. correctness ----
    nd = _check_shape(got, N_TRIS)
    print(f"shape: {N_TRIS} indices, {nd} descriptors at subdiv {SUBDIV}, "
          f"{len(got.array_data)} bytes of states; 5 bakes byte-equal")
    r_card, _ = _card_equals_cpu(lambda: _desc(tex, uv_tris[:16]),
                                 "16-triangle bench bake")
    _check_shape(r_card, 16)

    # ---- 6. nearest ----
    near_desc, utri = _workload_desc("nearest", tex, uv_tris)
    near_counts, _, near_res, near_sum = _timed_bakes(
        near_desc, utri, "nearest bake", card)
    _check_shape(near_res[-1], N_TRIS)
    p1 = near_counts["route.nearest_phase1_utri"] // 5
    sv = near_counts["route.nearest_survivors_utri"] // 5
    print(f"nearest per bake: phase-1 resolved {p1} utri of {utri} "
          f"({near_counts['route.nearest_phase1'] // 5} items), survivors "
          f"pass {sv} utri ({near_counts['route.nearest_survivors'] // 5} "
          "items)", flush=True)
    # the bench texture leaves the coarse pass nothing to resolve, so
    # every micro-triangle goes to phase 1 or to the survivors pass
    if p1 == 0 or sv == 0 or p1 + sv != utri:
        raise SystemExit("the nearest bake did not split its micro-"
                         "triangles between phase 1 and the survivors")
    _card_equals_cpu(lambda: _nearest_desc(tex, uv_tris[:16]),
                     "16-triangle nearest bake")

    # ---- 7. mixed ----
    mix_counts, _, _, mix_sum = _timed_bakes(
        *_workload_desc("mixed", tex, uv_tris), "mixed bake", card)
    linear_routes = ("fast_path", "dense", "linear_survivors", "degenerate")
    per = {r: mix_counts[f"route.{r}"] // 5 for r in linear_routes}
    print(f"mixed routes per bake (items): {json.dumps(per)}; exact "
          f"launches per bake {mix_counts['exact_classify'] // 5}",
          flush=True)
    if min(per.values()) == 0 or mix_counts["exact_classify"] == 0:
        raise SystemExit("a route of the mixed bake took no item")
    sub = _mixed_subset(*_mixed_tris(uv_tris))
    ot.reset_launches()
    _card_equals_cpu(lambda: _mixed_desc(tex, *sub),
                     f"{len(sub[0])}-triangle mixed subset")
    sub_routes = {k: v for k, v in ot.launches().items()
                  if k.startswith("route.") and v}
    print(f"mixed subset routes (card + CPU bakes): {json.dumps(sub_routes)}")
    if any(sub_routes.get(f"route.{r}", 0) == 0 for r in linear_routes):
        raise SystemExit("a route of the mixed bake took no item of the "
                         "card-vs-CPU subset")

    # ---- 8. aabb ----
    from omm_tpu_torch.types import BakeFlags

    def aabb_desc():
        d = _desc(tex, uv_tris[:16])
        d.bake_flags = (BakeFlags.DisableLevelLineIntersection
                        | BakeFlags.EnableAABBTesting)
        return d

    ot.reset_launches()
    _card_equals_cpu(aabb_desc, "16-triangle AABB-testing bake")
    if ot.launches()["route.host_engine"] == 0:
        raise SystemExit("the AABB bake did not run the host engine")

    # ---- 10. gpu (before 9, which stays last) ----
    gpu_counts, gpu_sum, co_sum = gpu_phase(tex, uv_tris, card)

    # ---- 11. farm (before 9) ----
    mesh_launches, mesh_sums, ref = mesh_phase(desc, N_TRIS * 4 ** SUBDIV,
                                               card)
    farm_launches, farm_sum = farm_phase(desc, ref, card)

    # ---- 12. surface (before 9) ----
    surface_launches, surface_sums = surface_phase(
        desc, N_TRIS * 4 ** SUBDIV, card)
    scene_launches, scene_sums, desc7, res7 = scene_phase(card)
    tools_launches = tools_phase(desc7, res7, card)

    # ---- 13. spots (before 9) ----
    spot_launches, spot_sums = spots_phase(tex, uv_tris, card)
    streams = spot_streams(tex, uv_tris, dev, card)
    print(f"memory_reserved after phase 13: "
          f"{torch.cuda.memory_reserved() / 2 ** 20:.1f} MiB (allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB) ({card})",
          flush=True)

    # ---- 14. spec (before 9) ----
    spec_launches, spec_sums = spec_phase(card)

    # ---- 15. post (before 9) ----
    post_launches, post_sum = post_phase(card)

    # ---- 16. drain (before 9) ----
    drain_launches, drain_sums = drain_phase(card)

    # ---- 17. chain kernels (before 9) ----
    chain_recs, chain_sum = chain_phase(card, parent)
    if [m for m in sys.modules if m.split(".")[0] in _BLOCKED]:
        raise SystemExit("jax or the JAX package was imported")

    # ---- 9. timing ----
    dev_ms = device_ms(lambda: exact.exact_counts(*args, **kw),
                       "exact_classify")
    ms_dev = dev_ms if dev_ms is not None else ms
    print(f"exact kernel device time {dev_ms} ms (profiler; None: not "
          f"traced, events used), at {bound_ms / ms_dev:.4f} of its bound "
          f"({card})", flush=True)

    by_path = {"bench": launches, "nearest": near_counts["exact_classify"],
               "mixed": mix_counts["exact_classify"],
               "gpu": gpu_counts["exact_classify"], "gpu_compute_only": 0,
               "mesh": mesh_launches["mesh"],
               "mesh2": mesh_launches["mesh2"], "farm": farm_launches,
               "surface.baker": surface_launches["baker"],
               "surface.capi": surface_launches["capi"],
               "surface.tools": tools_launches,
               "scene.level7": scene_launches[7],
               "scene.level9": scene_launches[9],
               **{f"spots.{k}": v for k, v in spot_launches.items()},
               **{f"spec.{k}": v for k, v in spec_launches.items()},
               "post.classify": post_launches,
               **{f"drain.{k}": v for k, v in drain_launches.items()}}
    print(json.dumps({"paths": {"bench": bench_sum, "nearest": near_sum,
                                "mixed": mix_sum, "gpu": gpu_sum,
                                "gpu_compute_only": co_sum,
                                "mesh": mesh_sums["mesh"],
                                "mesh2": mesh_sums["mesh2"],
                                "farm": farm_sum,
                                "surface": {**surface_sums,
                                            "tools_launches": tools_launches},
                                "scene": scene_sums, "spots": spot_sums,
                                "spec": spec_sums, "post": post_sum,
                                "drain": drain_sums, "chain": chain_sum},
                      "card": card}))
    print(json.dumps({"kernels": [{
        "name": "exact_classify", "route": "cuda",
        "source": "omm_tpu_torch/csrc/exact_classify.cu",
        "replaces": "omm_tpu/kernels/pallas_classify.py:290",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_per_bake": launches // 5,
        "max_abs_err": err, "ms": ms_dev, "event_ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "spot_streams": streams}] + [{
            "name": k, "route": "cuda", "source": CHAIN_SOURCES[k],
            "replaces": CHAIN_REPLACES[k], "launches": main_launches[k],
            "launches_per_bake": chain_recs[k]["launches_per_bake"],
            "max_abs_err": 0, "ms": chain_recs[k]["ms"],
            "event_ms": chain_recs[k]["event_ms"],
            "plain_ms": chain_recs[k]["plain_ms"],
            "bound_ms": chain_recs[k]["bound_ms"],
            "bound_by": chain_recs[k]["bound_by"], "library_ms": None,
            "calls_per_batch": chain_recs[k]["calls_per_batch"]}
            for k in CHAIN_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--farm-worker"]:
        farm_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    sys.argv[5])
    elif sys.argv[1:2] == ["--parent"]:
        main(os.path.abspath(sys.argv[2]))
    else:
        main()
