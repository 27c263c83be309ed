"""Public data model: enums and descriptor structs.

The port's copy of `omm_tpu/types.py`: a re-design of the reference
C ABI surface (`include/omm.h`).  Enum values match the
reference exactly (they map to the DX/VK opacity-micromap spec), descriptors
are Python dataclasses instead of C structs; array inputs are numpy arrays
instead of raw pointers.

Reference citations:
  opacity states            omm.h:98-104
  special indices           omm.h:106-112
  OC1 formats               omm.h:114-122
  unknown-state promotion   omm.h:124-134
  texcoord/index formats    omm.h:143-159
  address/filter modes      omm.h:161-176
  alpha mode                omm.h:178-183
  bake input desc           omm.h:380-490
  bake result desc          omm.h:512-530
  debug stats               omm.h:1170-1196
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class Result(enum.IntEnum):
    SUCCESS = 0
    FAILURE = 1
    INVALID_ARGUMENT = 2
    INSUFFICIENT_SCRATCH_MEMORY = 3
    NOT_IMPLEMENTED = 4
    WORKLOAD_TOO_BIG = 5


class BakeError(Exception):
    """Raised by the pythonic API when a bake fails; carries a Result code."""

    def __init__(self, result: Result, message: str = ""):
        super().__init__(message or result.name)
        self.result = result


class OpacityState(enum.IntEnum):
    Transparent = 0
    Opaque = 1
    UnknownTransparent = 2
    UnknownOpaque = 3


class SpecialIndex(enum.IntEnum):
    FullyTransparent = -1
    FullyOpaque = -2
    FullyUnknownTransparent = -3
    FullyUnknownOpaque = -4


class Format(enum.IntEnum):
    INVALID = 0
    OC1_2_State = 1  # 1 bit per micro-triangle
    OC1_4_State = 2  # 2 bits per micro-triangle


class UnknownStatePromotion(enum.IntEnum):
    Nearest = 0
    ForceOpaque = 1
    ForceTransparent = 2


class TexCoordFormat(enum.IntEnum):
    UV16_UNORM = 0
    UV16_FLOAT = 1
    UV32_FLOAT = 2


class IndexFormat(enum.IntEnum):
    UINT_16 = 0
    UINT_32 = 1
    UINT_8 = 2


class TextureAddressMode(enum.IntEnum):
    Wrap = 0
    Mirror = 1
    Clamp = 2
    Border = 3
    MirrorOnce = 4


class TextureFilterMode(enum.IntEnum):
    Nearest = 0
    Linear = 1


class AlphaMode(enum.IntEnum):
    Test = 0
    Blend = 1


class TextureFormat(enum.IntEnum):
    """CPU texture formats (omm.h:282-287)."""

    UNORM8 = 0
    FP32 = 1


class TextureFlags(enum.IntFlag):
    NONE = 0
    DisableZOrder = 1 << 0


class BakeFlags(enum.IntFlag):
    """ommCpuBakeFlags (omm.h:298-335) plus internal extensions
    (bake_cpu_impl.cpp:33-49)."""

    NONE = 0
    EnableInternalThreads = 1 << 0
    DisableSpecialIndices = 1 << 1
    Force32BitIndices = 1 << 2
    DisableDuplicateDetection = 1 << 3
    EnableNearDuplicateDetection = 1 << 4
    EnableValidation = 1 << 5
    Allow8BitIndices = 1 << 6
    # Internal-only extensions:
    EnableAABBTesting = 1 << 7
    DisableLevelLineIntersection = 1 << 8
    DisableFineClassification = 1 << 9
    EnableNearDuplicateDetectionBruteForce = 1 << 10
    EnableEdgeHeuristic = 1 << 11


# Highest supported subdivision level; 4^12 micro-triangles (omm.h:436-440).
MAX_SUBDIV_LEVEL = 12
MAX_NUM_SUBDIV_LEVELS = MAX_SUBDIV_LEVEL + 1


@dataclass
class SamplerDesc:
    """ommSamplerDesc (omm.h:198-212)."""

    addressing_mode: TextureAddressMode = TextureAddressMode.Clamp
    filter: TextureFilterMode = TextureFilterMode.Linear
    border_alpha: float = 0.0


@dataclass
class BakeInputDesc:
    """ommCpuBakeInputDesc (omm.h:380-490); defaults match
    ommCpuBakeInputDescDefault (omm.h:462-490)."""

    texture: object = None  # Texture instance (omm_tpu_torch.texture.Texture)
    bake_flags: BakeFlags = BakeFlags.NONE
    runtime_sampler: SamplerDesc = field(default_factory=SamplerDesc)
    alpha_mode: AlphaMode = AlphaMode.Test
    # tex_coords: numpy array; either (V, 2) float32 for UV32_FLOAT, or a
    # uint8 byte buffer combined with tex_coord_format/stride.
    tex_coord_format: TexCoordFormat = TexCoordFormat.UV32_FLOAT
    tex_coords: Optional[np.ndarray] = None
    tex_coord_stride_in_bytes: int = 0
    index_format: IndexFormat = IndexFormat.UINT_32
    index_buffer: Optional[np.ndarray] = None
    index_count: int = 0
    dynamic_subdivision_scale: float = 2.0
    rejection_threshold: float = 0.0
    alpha_cutoff: float = 0.5
    near_duplicate_deduplication_factor: float = 0.15
    alpha_cutoff_less_equal: OpacityState = OpacityState.Transparent
    alpha_cutoff_greater: OpacityState = OpacityState.Opaque
    format: Format = Format.OC1_4_State
    formats: Optional[np.ndarray] = None  # per-triangle Format overrides
    unknown_state_promotion: UnknownStatePromotion = UnknownStatePromotion.ForceOpaque
    unresolved_tri_state: SpecialIndex = SpecialIndex.FullyUnknownOpaque
    max_subdivision_level: int = 8
    max_array_data_size: int = 0xFFFFFFFF
    subdivision_levels: Optional[np.ndarray] = None  # per-triangle uint8
    max_workload_size: int = 0xFFFFFFFFFFFFFFFF


@dataclass
class MicromapDesc:
    """ommCpuOpacityMicromapDesc (omm.h:492-500)."""

    offset: int  # byte offset into array data
    subdivision_level: int
    format: int


@dataclass
class UsageCount:
    """ommCpuOpacityMicromapUsageCount (omm.h:502-510)."""

    count: int
    subdivision_level: int
    format: int


@dataclass
class BakeResult:
    """ommCpuBakeResultDesc (omm.h:512-530).

    index_buffer is stored as int32 logically; `index_format` describes the
    packed width used when exporting bytes (see packed_index_buffer()).
    """

    array_data: np.ndarray  # uint8
    desc_array: list[MicromapDesc]
    desc_array_histogram: list[UsageCount]
    index_buffer: np.ndarray  # int32 view (special indices are negative)
    index_format: IndexFormat
    index_histogram: list[UsageCount]
    # Per input triangle UV area; used by stats (bake_cpu_impl.cpp:1904-1915).
    triangle_area: np.ndarray

    @property
    def index_count(self) -> int:
        return int(self.index_buffer.shape[0])

    def packed_index_buffer(self) -> np.ndarray:
        """Index buffer packed at the width given by index_format
        (bake_cpu_impl.cpp:1872-1902)."""
        if self.index_format == IndexFormat.UINT_8:
            return self.index_buffer.astype(np.int8)
        if self.index_format == IndexFormat.UINT_16:
            return self.index_buffer.astype(np.int16)
        return self.index_buffer.astype(np.int32)


@dataclass
class DebugStats:
    """ommDebugStats (omm.h:1170-1196)."""

    total_opaque: int = 0
    total_transparent: int = 0
    total_unknown_transparent: int = 0
    total_unknown_opaque: int = 0
    total_fully_opaque: int = 0
    total_fully_transparent: int = 0
    total_fully_unknown_opaque: int = 0
    total_fully_unknown_transparent: int = 0
    known_area_metric: float = 0.0


def is_known(state: int) -> bool:
    return state == OpacityState.Transparent or state == OpacityState.Opaque


def is_unknown(state: int) -> bool:
    return not is_known(state)


def is_compatible(state: OpacityState, fmt: Format) -> bool:
    """2-state formats only admit fully-known states (util.h semantics used
    by ValidateDesc, bake_cpu_impl.cpp:279-287)."""
    if fmt == Format.OC1_2_State:
        return is_known(state)
    return True


def get_num_micro_triangles(subdivision_level: int) -> int:
    """bird.h:22-24."""
    return 1 << (subdivision_level << 1)


def get_bit_count(fmt: Format) -> int:
    """bird.h:26-32 — bits per micro-triangle state."""
    return int(fmt)
