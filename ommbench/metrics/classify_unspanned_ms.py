"""Host milliseconds per bake in the program's span `omm.classify` that
none of its calling-thread children covers: `omm.classify` less the sum
of CHILDREN (a child that is absent counts 0).  None where the run has
no `omm.classify`."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"

#: the spans the port opens on the calling thread directly inside
#: omm.classify (bake.classify_items, batch.classify_work_items_batches)
CHILDREN = ("omm.coarse", "omm.chunk", "omm.plan", "omm.class_planes",
            "omm.submit", "omm.slow", "omm.drain", "omm.post_wait",
            "omm.discovery", "omm.set_states")


def read(run):
    whole = per_bake_ms(run, "omm.classify")
    if whole is None:
        return None
    return whole - sum(per_bake_ms(run, c) or 0.0 for c in CHILDREN)
