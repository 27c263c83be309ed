"""Host milliseconds per bake in the program's span `omm.class_planes`:
the batch's padded planes and the class plane of each descent level,
computed on the device the first time a window class is seen and then
taken from the texture's cache (batch.batch_planes)."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.class_planes")
