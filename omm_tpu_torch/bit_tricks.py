"""Bit manipulation helpers (morton codes, pow2), vectorized for numpy.

The port's copy of `omm_tpu/bit_tricks.py`.  Semantics mirror the
reference's `src/util/bit_tricks.h`;
implementations are array-oriented so they run over whole index buffers at
once (the reference is scalar C++).
"""
from __future__ import annotations

import numpy as np


def next_pow2(v):
    """bit_tricks.h:25-34 — round up to next power of two (scalar or array)."""
    v = np.asarray(v, dtype=np.uint32)
    v = v + (v == 0).astype(np.uint32)
    v = v - np.uint32(1)
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> np.uint32(s))
    return v + np.uint32(1)


def is_pow2(x: int) -> bool:
    """bit_tricks.h:36-38."""
    return x > 0 and not (x & (x - 1))


def ctz(x: int) -> int:
    """Count trailing zeros; 32 for zero input (bit_tricks.h:66-77)."""
    if x == 0:
        return 32
    return (x & -x).bit_length() - 1


def bit_interleave(x, y):
    """Morton-interleave lower 16 bits of x (even) and y (odd)
    (bit_tricks.h:40-64)."""
    B = (np.uint32(0x55555555), np.uint32(0x33333333),
         np.uint32(0x0F0F0F0F), np.uint32(0x00FF00FF))
    x = np.asarray(x, dtype=np.uint32)
    y = np.asarray(y, dtype=np.uint32)
    for i, s in ((3, 8), (2, 4), (1, 2), (0, 1)):
        x = (x | (x << np.uint32(s))) & B[i]
        y = (y | (y << np.uint32(s))) & B[i]
    return x | (y << np.uint32(1))


def xy_to_morton(x, y):
    """bit_tricks.h:147-150."""
    return bit_interleave(x, y)


def _morton1(x):
    """Extract even bits (bit_tricks.h:126-134)."""
    x = np.asarray(x, dtype=np.uint32) & np.uint32(0x55555555)
    x = (x | (x >> np.uint32(1))) & np.uint32(0x33333333)
    x = (x | (x >> np.uint32(2))) & np.uint32(0x0F0F0F0F)
    x = (x | (x >> np.uint32(4))) & np.uint32(0x00FF00FF)
    x = (x | (x >> np.uint32(8))) & np.uint32(0x0000FFFF)
    return x


def morton_to_xy(i):
    """bit_tricks.h:152-155 — returns (x, y)."""
    i = np.asarray(i, dtype=np.uint32)
    return _morton1(i), _morton1(i >> np.uint32(1))
