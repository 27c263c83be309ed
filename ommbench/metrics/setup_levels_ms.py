"""Host milliseconds per bake in the program's span `omm.setup.levels`:
the subdivision level of every triangle (the SDK's area or edge
heuristic, or the constant level), inside `omm.setup`."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.setup.levels")
