"""Host milliseconds per bake in the program's span `omm.gpu.levels`:
the GPU baker's per-triangle subdivision levels (`_subdiv_levels`),
summed over its calls, those inside `get_pre_dispatch_info` too."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.gpu.levels")
