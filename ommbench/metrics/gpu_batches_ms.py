"""Host milliseconds per bake in the program's span `omm.gpu.batches`:
the GPU baker's scratch-batch loop, its calls of the batch pipeline
(`omm.plan`, `omm.submit`, `omm.drain`, `omm.post_wait` inside) and the
states they install."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.gpu.batches")
