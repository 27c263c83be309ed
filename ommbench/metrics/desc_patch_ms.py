"""Host milliseconds per bake in the program's span `omm.desc_patch`: the
GPU baker's DescPatch pass."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.desc_patch")
