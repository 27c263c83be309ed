"""Device milliseconds per bake of the capacity chain's kernels
(descend_kernel, keys_kernel and slots_*, csrc/chain_*.cu), by name in
the trace."""
from ommbench.metrics._trace import device_ms

SOURCE = "device_trace"


def read(run):
    return device_ms(run, ("descend_kernel", "keys_kernel", "slots_"))
