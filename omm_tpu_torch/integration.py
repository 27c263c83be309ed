"""Renderer-integration helpers: consume bake outputs for OMM/BLAS builds.

The port's copy of `omm_tpu/integration.py`.  Analog of the reference's
client integration layer (omm-gpu-nvrhi, SURVEY.md §2.20): where that
layer translates dispatch chains into RHI commands and reads back
histograms for D3D12/Vulkan micromap builds, this module packages a
BakeResult into the exact structures those APIs take and provides the
DumpDebug-style CPU re-bake comparison (omm-gpu-nvrhi.cpp:799-806,
1159+): here the bake on the card against the port's bake on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .types import BakeResult, IndexFormat


@dataclass
class D3D12BuildInputs:
    """Maps onto D3D12_RAYTRACING_OPACITY_MICROMAP_ARRAY_DESC +
    the BLAS OMM attachment (integration_guide.md:753-755)."""

    input_buffer: bytes                  # arrayData
    per_omm_descs: np.ndarray            # (N, 2) uint32: byteOffset, (fmt<<16|level)
    per_omm_counts: list                 # pOMMUsageCounts entries
    omm_index_buffer: bytes
    omm_index_format: str                # DXGI format name
    omm_index_counts: list               # BLAS attachment usage counts


def to_d3d12_build_inputs(result: BakeResult) -> D3D12BuildInputs:
    descs = np.zeros((len(result.desc_array), 2), dtype=np.uint32)
    for i, d in enumerate(result.desc_array):
        descs[i, 0] = d.offset
        descs[i, 1] = (d.format << 16) | d.subdivision_level
    fmt_name = {IndexFormat.UINT_8: "DXGI_FORMAT_R8_UINT",
                IndexFormat.UINT_16: "DXGI_FORMAT_R16_UINT",
                IndexFormat.UINT_32: "DXGI_FORMAT_R32_UINT"}[result.index_format]
    return D3D12BuildInputs(
        input_buffer=result.array_data.tobytes(),
        per_omm_descs=descs,
        per_omm_counts=[(u.count, u.subdivision_level, u.format)
                        for u in result.desc_array_histogram],
        omm_index_buffer=result.packed_index_buffer().tobytes(),
        omm_index_format=fmt_name,
        omm_index_counts=[(u.count, u.subdivision_level, u.format)
                          for u in result.index_histogram],
    )


def to_vulkan_build_inputs(result: BakeResult) -> dict:
    """VkMicromapBuildInfoEXT-shaped dict (usage counts + data + triangle
    array); VK and DX12 share the OC1 encoding."""
    return {
        "usageCounts": [
            {"count": u.count, "subdivisionLevel": u.subdivision_level,
             "format": u.format} for u in result.desc_array_histogram],
        "data": result.array_data.tobytes(),
        "triangleArray": [
            {"dataOffset": d.offset, "subdivisionLevel": d.subdivision_level,
             "format": d.format} for d in result.desc_array],
        "indexBuffer": result.packed_index_buffer().tobytes(),
        "indexType": result.index_format.name,
        "indexUsageCounts": [
            {"count": u.count, "subdivisionLevel": u.subdivision_level,
             "format": u.format} for u in result.index_histogram],
    }


def conservative_memory_estimate(tri_count: int, max_subdiv: int,
                                 fmt_bits: int = 2) -> int:
    """Worst-case OMM array bytes: S = bits * 4^N * T / 8
    (integration_guide.md:669-675)."""
    return (fmt_bits * (4 ** max_subdiv) * tri_count) // 8


def dump_debug_compare(desc, result: BakeResult, device="cpu",
                       logger=None):
    """DumpDebug analog: re-bake on `device` (the CPU, where the exact
    stage runs its plain torch twin) and diff the stats
    (omm-gpu-nvrhi.cpp:1159+).  Returns (stats, oracle_stats, equal)."""
    from .bake import bake
    from .log import Logger
    from .stats import get_stats

    oracle = bake(desc, device=device,
                  logger=logger or Logger(lambda s, m: None))
    s1 = get_stats(result)
    s2 = get_stats(oracle)
    return s1, s2, s1 == s2
