"""Micro-triangles requested per second: the summed 4^level over each
returned bake's distinct triangles (a triangle whose UVs repeat an
earlier one's shares its result and asks for nothing more), counted
from its inputs by the reference's heuristic, over the whole window."""
SOURCE = "host_clock"


def read(run):
    if not run["utri"] or run["window_s"] <= 0:
        return None
    return sum(run["utri"]) / run["window_s"]
