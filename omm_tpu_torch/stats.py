"""Debug stats: decode packed OC1 data back into per-state totals.

The port's copy of `omm_tpu/stats.py`.  Mirrors CollectStats
(`debug_impl.cpp:511-643`) and the bit-decode in parse::GetTriangleStates
(`util/parse.h:45-76`).
"""
from __future__ import annotations

import numpy as np

from .types import (BakeResult, DebugStats, Format,
                    OpacityState, SpecialIndex, get_num_micro_triangles)


def decode_states(array_data: np.ndarray, offset: int, subdivision_level: int,
                  fmt: int) -> np.ndarray:
    """Unpack one micromap's states (parse.h:56-75). Returns (4^N,) uint8."""
    M = get_num_micro_triangles(subdivision_level)
    is2 = int(fmt) == int(Format.OC1_2_State)
    idx = np.arange(M)
    byte_index = idx >> (3 if is2 else 2)
    v = array_data[offset + byte_index]
    if is2:
        return ((v >> (idx & 7)) & 1).astype(np.uint8)
    return ((v >> ((idx << 1) & 7)) & 3).astype(np.uint8)


def get_omm_index(result: BakeResult, tri: int) -> int:
    """parse.h:20-28: the logical int32 index buffer is authoritative."""
    return int(result.index_buffer[tri])


def collect_stats(result: BakeResult, area: np.ndarray | None = None) -> DebugStats:
    """debug_impl.cpp:511-643.

    Special-index triangles count only toward the Fully* counters; regular
    triangles accumulate the per-desc state totals multiplied by reference
    count.
    """
    stats = DebugStats()
    tri_count = result.index_count

    refs: dict[int, list] = {}
    total_area = float(area.sum()) if area is not None else 0.0
    known_area = 0.0

    for i in range(tri_count):
        vm = get_omm_index(result, i)
        if vm == int(SpecialIndex.FullyTransparent):
            stats.total_fully_transparent += 1
            known_area += float(area[i]) if area is not None else 0.0
        elif vm == int(SpecialIndex.FullyOpaque):
            stats.total_fully_opaque += 1
            known_area += float(area[i]) if area is not None else 0.0
        elif vm == int(SpecialIndex.FullyUnknownTransparent):
            stats.total_fully_unknown_transparent += 1
        elif vm == int(SpecialIndex.FullyUnknownOpaque):
            stats.total_fully_unknown_opaque += 1
        else:
            e = refs.setdefault(vm, [0, 0.0])
            e[0] += 1
            e[1] += float(area[i]) if area is not None else 0.0

    per_desc = []
    for d in result.desc_array:
        st = decode_states(result.array_data, d.offset, d.subdivision_level,
                           d.format)
        per_desc.append((
            int(np.count_nonzero(st == int(OpacityState.Opaque))),
            int(np.count_nonzero(st == int(OpacityState.Transparent))),
            int(np.count_nonzero(st == int(OpacityState.UnknownOpaque))),
            int(np.count_nonzero(st == int(OpacityState.UnknownTransparent))),
        ))

    for vm, (nrefs, a) in refs.items():
        op, tr, uo, ut = per_desc[vm]
        tot_known = op + tr
        tot_unknown = uo + ut
        known = tot_known / float(tot_known + tot_unknown)
        known_area += known * a
        stats.total_opaque += nrefs * op
        stats.total_transparent += nrefs * tr
        stats.total_unknown_opaque += nrefs * uo
        stats.total_unknown_transparent += nrefs * ut

    stats.known_area_metric = (known_area / total_area) if area is not None and total_area else 0.0
    return stats


def get_stats(result: BakeResult, use_area: bool = False) -> DebugStats:
    """ommDebugGetStats (area-less) / GetStats2 (with triangle areas)."""
    area = result.triangle_area if use_area else None
    return collect_stats(result, area)
