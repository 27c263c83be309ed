"""Host milliseconds per bake in the program's span `omm.finalize`: the
host tail (bake.finalize_items), serialize included."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.finalize")
