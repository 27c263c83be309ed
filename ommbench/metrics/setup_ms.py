"""Host milliseconds per bake in the program's span `omm.setup`: the CPU
baker's set-up and validation (bake.setup_work_items)."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.setup")
