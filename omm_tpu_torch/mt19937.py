"""Minimal MT19937 matching std::mt19937 exactly (the port's copy of
`omm_tpu/mt19937.py`).

The reference's LSH near-duplicate merge draws its bit-sampling indices from
std::mt19937 seeded with 42 (bake_cpu_impl.cpp:1145,1232-1237); reproducing
its exact output sequence is required for stats parity of merged bakes.
"""
from __future__ import annotations

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_MASK = 0xFFFFFFFF


class MT19937:
    def __init__(self, seed: int = 5489):
        mt = [0] * _N
        mt[0] = seed & _MASK
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & _MASK
        self._mt = mt
        self._idx = _N

    def _twist(self):
        mt = self._mt
        for i in range(_N):
            y = (mt[i] & _UPPER) | (mt[(i + 1) % _N] & _LOWER)
            nxt = mt[(i + _M) % _N] ^ (y >> 1)
            if y & 1:
                nxt ^= _MATRIX_A
            mt[i] = nxt
        self._idx = 0

    def __call__(self) -> int:
        if self._idx >= _N:
            self._twist()
        y = self._mt[self._idx]
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK
