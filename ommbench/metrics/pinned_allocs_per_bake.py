"""Pinned host tensors the program makes per bake (the pipeline's
pinned_alloc: each CUDA graph's inputs copied in and payload copied
out).  None where the program does not count them."""
SOURCE = "program_counter"


def read(run):
    n = run["counts"].get("pinned_alloc")
    return n / run["bakes"] if n is not None and run["bakes"] else None
