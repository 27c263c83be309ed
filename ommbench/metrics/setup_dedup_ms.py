"""Host milliseconds per bake in the program's span `omm.setup.dedup`:
the pass over the triangles that skips the invalid ones and makes the
work items, one per distinct (UVs, level, format) key, inside
`omm.setup`."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.setup.dedup")
