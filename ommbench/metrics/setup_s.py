"""Seconds from the process's start to the first timed bake."""
SOURCE = "host_clock"


def read(run):
    return run["setup_s"]
