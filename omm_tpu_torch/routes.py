"""Work items per classification route, counted in this process.

`omm_tpu_torch.launches()` reports these counts beside the kernels'
launch counts, under "route.<name>".  Each route adds the items it
classifies where it classifies them (an item with nothing left to
classify is not counted); the nearest filter's two passes also count
their micro-triangles.  Mesh slots count from worker threads, so every
process-wide count, these and the kernels' launch counts, is read and
written under LOCK.
"""
from __future__ import annotations

import threading

NAMES = (
    "fast_path",          # two-phase engine, exact stage (batch._run_batch)
    "dense",              # every micro-triangle (classify.classify_item)
    "linear_survivors",   # level-line pass over survivors (slivers)
    "degenerate",         # line triangles (classify.classify_degenerate)
    "nearest_phase1",     # nearest-filter window resolve (twophase)
    "nearest_survivors",  # nearest-filter survivors pass
    "host_engine",        # engine.resample_fine_item (nearest lines, AABB)
    "nearest_phase1_utri",     # micro-triangles phase-1 resolved
    "nearest_survivors_utri",  # micro-triangles left to the survivors
)

COUNTS = dict.fromkeys(NAMES, 0)

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
