"""Work items per classification route, and the two-phase engine's
batches per path, counted in this process.

`omm_tpu_torch.launches()` reports the routes' counts beside the
kernels' launch counts, under "route.<name>";
`omm_tpu_torch.pipeline_counts()` reports the pipeline's.  Each route
adds the items it classifies where it classifies them (an item with
nothing left to classify is not counted); the nearest filter's two
passes also count their micro-triangles.  The pipeline counts batches:
those run through the capacity chain ("spec") and, of them, those whose
meta flagged an overflow ("spec_overflow"), which then run again on the
discovery path, as the batches without a caps entry do ("discovery");
the CUDA graphs captured and replayed for the chain; and every host
read of a device count ("count_sync": on the discovery path one per
descent level and one per mip, on the capacity chain the payload's
meta, one per batch); and every pinned host tensor made for a graph's
copies ("pinned_alloc": each static input copied in, each payload
copied out); and the scratch batches that the GPU baker's dispatches
execute ("gpu_batch", `gpu.Pipeline`'s maxScratchMemorySize batches).
Mesh slots count from worker threads, so every process-wide count,
these and the kernels' launch counts, is read and written under LOCK.
"""
from __future__ import annotations

import threading

NAMES = (
    "fast_path",          # two-phase engine, exact stage (batch)
    "dense",              # every micro-triangle (classify.classify_item)
    "linear_survivors",   # level-line pass over survivors (slivers)
    "degenerate",         # line triangles (classify.classify_degenerate)
    "nearest_phase1",     # nearest-filter window resolve (twophase)
    "nearest_survivors",  # nearest-filter survivors pass
    "host_engine",        # engine.resample_fine_item (nearest lines, AABB)
    "nearest_phase1_utri",     # micro-triangles phase-1 resolved
    "nearest_survivors_utri",  # micro-triangles left to the survivors
)

PIPELINE = (
    "spec",           # batches through the capacity chain
    "spec_overflow",  # of those, flagged and rerun on the discovery path
    "discovery",      # batches through the exact-size path (batch._run_batch)
    "graph_capture",  # CUDA graphs captured (graphs.run)
    "graph_replay",   # CUDA graph replays
    "count_sync",     # host reads of a device count
    "pinned_alloc",   # pinned host tensors made (graphs: inputs, payloads)
    "gpu_batch",      # scratch batches a GPU-baker dispatch executed
)

COUNTS = dict.fromkeys(NAMES + PIPELINE, 0)

#: guards COUNTS and the kernels' launch counts (re-entrant, so that
#: `omm_tpu_torch.reset_launches` can call `reset` while holding it)
LOCK = threading.RLock()


def count(name: str, n: int = 1) -> None:
    with LOCK:
        COUNTS[name] += int(n)


def reset() -> None:
    with LOCK:
        for k in COUNTS:
            COUNTS[k] = 0
