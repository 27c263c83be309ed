"""Launch counts of the port's hand-written kernels, by name.

Each wrapper adds one to its kernel's count where it launches the kernel
(`count`).  A launch recorded into a CUDA graph launches nothing yet:
while this thread's current stream is capturing, the launch is kept
aside for the graph (`captured`), and `graphs` adds a graph's captured
launches at each of its replays (`add`).  Mesh slots launch from several
threads, so the counts are read and written under `routes.LOCK`.
"""
from __future__ import annotations

import threading

import torch

from .. import routes

NAMES = ("exact_classify", "descend_sides", "tile_keys", "tile_slots")

COUNTS = dict.fromkeys(NAMES, 0)

#: per thread: launches recorded into the graph it is capturing
_CAPTURED = threading.local()


def count(name: str, n: int = 1) -> None:
    """Add n launches of kernel `name`, or, while this thread's current
    stream is capturing a CUDA graph, keep them for the graph."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        d = _CAPTURED.__dict__.setdefault("d", {})
        d[name] = d.get(name, 0) + n
        return
    with routes.LOCK:
        COUNTS[name] += n


def captured() -> dict:
    """The launches this thread recorded into graphs since the last call,
    by name (and forget them)."""
    d = _CAPTURED.__dict__.get("d", {})
    _CAPTURED.d = {}
    return d


def add(launches: dict) -> None:
    """Add a replayed graph's launches, by name."""
    with routes.LOCK:
        for k, v in launches.items():
            COUNTS[k] += v


def reset() -> None:
    with routes.LOCK:
        for k in COUNTS:
            COUNTS[k] = 0
