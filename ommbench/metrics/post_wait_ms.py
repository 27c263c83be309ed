"""Host milliseconds per bake in the program's span `omm.post_wait`: the
calling thread waiting on the post pool's write-backs, and the pool's
shutdown (batch.classify_work_items_batches)."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.post_wait")
