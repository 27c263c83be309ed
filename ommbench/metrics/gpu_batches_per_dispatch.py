"""Scratch batches the GPU baker executes per bake (the pipeline's
gpu_batch: `gpu.Pipeline`'s maxScratchMemorySize batches that hold a
work item).  None where the program does not count them."""
SOURCE = "program_counter"


def read(run):
    n = run["counts"].get("gpu_batch")
    return n / run["bakes"] if n is not None and run["bakes"] else None
