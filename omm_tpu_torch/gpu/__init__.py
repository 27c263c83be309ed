from .baker import (DispatchChain, DispatchConfigDesc, GpuBakeFlags, Pass,
                    Pipeline, PostDispatchInfo, PreDispatchInfo,
                    ScratchMemoryBudget)
from .rhi import (CommandRecorder, RecordingRHI, ResourceRange,
                  record_chain)

__all__ = ["DispatchChain", "DispatchConfigDesc", "GpuBakeFlags", "Pass",
           "Pipeline", "PostDispatchInfo", "PreDispatchInfo",
           "ScratchMemoryBudget", "CommandRecorder", "RecordingRHI",
           "ResourceRange", "record_chain"]
