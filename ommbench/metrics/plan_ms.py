"""Host milliseconds per bake in the program's span `omm.plan`: the batch
pipeline's routing, fast-path mask, descent schedule and window maxima,
before its first batch is built (batch.classify_work_items_batches)."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.plan")
