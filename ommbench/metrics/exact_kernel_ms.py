"""Device milliseconds per bake of the exact kernel
(exact_classify_kernel, csrc/exact_classify.cu), by name in the trace."""
from ommbench.metrics._trace import device_ms

SOURCE = "device_trace"


def read(run):
    return device_ms(run, ("exact_classify",))
