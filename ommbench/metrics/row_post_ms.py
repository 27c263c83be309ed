"""Host milliseconds per bake in the program's span `omm.row_post`: the
post pass on packed rows (native.row_post_packed), on the pool's
threads."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.row_post")
