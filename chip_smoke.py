#!/usr/bin/env python3
"""Smoke test of omm_tpu_torch on one CUDA card: the quickest proof that
the port builds, runs its main path through its kernels, and is right.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

  1. device  card name and power limit (nvidia-smi), torch and CUDA
             versions; no CUDA device is an error, never a CPU fallback
  2. build   the exact-classification kernel, compiled by nvcc for
             sm_90a from omm_tpu_torch/csrc/, with ptxas's register and
             spill report and the launch shape
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

Each path's counts (`omm_tpu_torch.launches()`: kernel launches and
work items per route) are set to 0 just before its timed bakes and read
just after (the mesh and surface paths: around each timed bake; the
tools: around the whole of phase 12 c).  launches_by_path has a key for
each path: surface.baker, surface.capi and surface.tools for phase 12
(a) and (c), scene.level7 and scene.level9 for (b), spots.<name> for
each bake of phase 13 (around its 5 timed bakes).
jax and the JAX package omm_tpu are blocked from import for the whole
run, the farm's worker processes included: the port must not need
them.  Everything is reached through
omm_tpu_torch.  The checks against the JAX package's numpy oracle run
on the card as tests/test_torch_cuda.py.
The second-to-last line is the kernels' JSON record, the last line the
result: {"ok": true, "device": {...}}.
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


def _timed_bakes(desc, utri, what, card):
    """2 warm-up bakes (`_bake`), then 5 timed ones (each ending with the
    result on the host) with every count set to 0 just before them:
    (counts after the 5, times, results, summary)."""
    import omm_tpu_torch as ot
    for _ in range(2):
        _bake(desc)
    torch.cuda.synchronize()
    ot.reset_launches()
    times, results = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        results.append(_bake(desc))  # numpy arrays: on the host
        times.append(time.perf_counter() - t0)
    counts = ot.launches()
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
    times}, {name: each count summed over the rounds})."""
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
            for k, v in ot.launches().items():
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
    half of the benchmark items on the card (a warm-up, then FARM_ROUNDS
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


def main():
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

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.cuda_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, "
          f"{build.build_dir()})")
    for line in build.BUILD_INFO.get("omm_exact_cuda", {}).get(
            "log", "").splitlines():
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
               **{f"spots.{k}": v for k, v in spot_launches.items()}}
    print(json.dumps({"paths": {"bench": bench_sum, "nearest": near_sum,
                                "mixed": mix_sum, "gpu": gpu_sum,
                                "gpu_compute_only": co_sum,
                                "mesh": mesh_sums["mesh"],
                                "mesh2": mesh_sums["mesh2"],
                                "farm": farm_sum,
                                "surface": {**surface_sums,
                                            "tools_launches": tools_launches},
                                "scene": scene_sums, "spots": spot_sums},
                      "card": card}))
    print(json.dumps({"kernels": [{
        "name": "exact_classify", "route": "cuda",
        "source": "omm_tpu_torch/csrc/exact_classify.cu",
        "replaces": "omm_tpu/kernels/pallas_classify.py:290",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_per_bake": launches // 5,
        "max_abs_err": err, "ms": ms_dev, "event_ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "spot_streams": streams}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--farm-worker"]:
        farm_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    sys.argv[5])
    else:
        main()
