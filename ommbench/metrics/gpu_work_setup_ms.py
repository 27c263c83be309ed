"""Host milliseconds per bake in the program's span `omm.gpu.work_setup`:
the GPU baker's schedule key and WorkSetup (the first-occurrence dedup
of the triangles into work items)."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.gpu.work_setup")
