"""User-pluggable allocator for bake outputs (StdAllocator analog); the
port's copy of `omm_tpu/allocator.py`.

The reference routes every internal allocation through a user-supplied
`ommAllocatorInterface` (allocate/reallocate/free callbacks + userArg)
with an aligned-malloc default (`src/std_allocator.h:1-295`,
`CheckAndSetDefaultAllocator` bake.cpp:415-424).  The port's host
allocations are numpy arrays; the analog routes the *output* buffers (the
OMM array data, index buffers, serialized blobs) through the same
callback protocol and keeps the byte accounting the reference's allocator
wrapper provides, so memory-budgeted asset pipelines can plug in pools or
budget trackers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

Allocate = Callable[[int, int, object], np.ndarray]
Free = Callable[[np.ndarray, object], None]


@dataclass
class AllocatorStats:
    total_allocations: int = 0
    total_bytes: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0


class StdAllocator:
    """omm::StdAllocator: user callbacks with an aligned default.

    allocate(nbytes, alignment, user_arg) -> writable uint8 ndarray of at
    least nbytes; free(buffer, user_arg).  Either may be None (default
    numpy allocation / no-op free).
    """

    DEFAULT_ALIGNMENT = 16  # DEFAULT_MEMORY_ALIGNMENT (std_allocator.h)

    def __init__(self, allocate: Optional[Allocate] = None,
                 free: Optional[Free] = None, user_arg: object = None):
        self._allocate = allocate
        self._free = free
        self.user_arg = user_arg
        self.stats = AllocatorStats()
        self._live: dict[int, int] = {}

    def allocate(self, nbytes: int,
                 alignment: int = DEFAULT_ALIGNMENT) -> np.ndarray:
        if self._allocate is not None:
            buf = self._allocate(nbytes, alignment, self.user_arg)
            buf = np.frombuffer(buf, dtype=np.uint8, count=nbytes) \
                if not isinstance(buf, np.ndarray) else buf[:nbytes]
        else:
            buf = np.zeros(nbytes, dtype=np.uint8)
        s = self.stats
        s.total_allocations += 1
        s.total_bytes += nbytes
        s.live_bytes += nbytes
        s.peak_bytes = max(s.peak_bytes, s.live_bytes)
        self._live[id(buf)] = nbytes
        return buf

    def array(self, count: int, dtype) -> np.ndarray:
        """Typed output-buffer allocation through the callbacks."""
        dt = np.dtype(dtype)
        raw = self.allocate(count * dt.itemsize, max(dt.itemsize, 1))
        return raw.view(dt)[:count]

    def free(self, buf: np.ndarray):
        base = buf if buf.base is None else buf.base
        nbytes = self._live.pop(id(base), None)
        if nbytes is None:
            nbytes = base.nbytes if isinstance(base, np.ndarray) else 0
        self.stats.live_bytes = max(self.stats.live_bytes - nbytes, 0)
        if self._free is not None:
            self._free(buf, self.user_arg)


def check_and_set_default(allocator: Optional[StdAllocator]) -> StdAllocator:
    """CheckAndSetDefaultAllocator (bake.cpp:415-424)."""
    return allocator if allocator is not None else StdAllocator()
