"""Host reads of a device count per bake (the pipeline's count_sync)."""
SOURCE = "program_counter"


def read(run):
    return run["counts"]["count_sync"] / run["bakes"] if run["bakes"] \
        else None
