"""Host milliseconds per bake in the program's spans `omm.gpu.dispatch`
and `omm.gpu.execute` that none of their direct children covers: the
two less the sum of CHILDREN (a child that is absent counts 0), the
coverage of the GPU baker's spans.  None where the run has no
`omm.gpu.dispatch`."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"

PARENTS = ("omm.gpu.dispatch", "omm.gpu.execute")
#: the spans the port opens directly inside PARENTS (gpu/baker.py), each
#: opened by the GPU baker alone; every `omm.gpu.levels` is a direct
#: child of one of them
CHILDREN = ("omm.gpu.levels", "omm.gpu.work_setup", "omm.gpu.batches",
            "omm.desc_patch", "omm.gpu.tail")


def read(run):
    if per_bake_ms(run, PARENTS[0]) is None:
        return None
    return sum(per_bake_ms(run, s) or 0.0 for s in PARENTS) \
        - sum(per_bake_ms(run, c) or 0.0 for c in CHILDREN)
