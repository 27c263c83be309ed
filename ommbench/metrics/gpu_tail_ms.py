"""Host milliseconds per bake in the GPU baker's tail: the program's span
`omm.gpu.tail` (usage histograms, spatial sort and serialize, each also
under the CPU tail's name inside it).  None where the run has none."""
from ommbench.metrics._trace import per_bake_ms

SOURCE = "program_span"


def read(run):
    return per_bake_ms(run, "omm.gpu.tail")
