"""Small cells for the CPU tests: the benchmark's configurations and
traffic at a size a test run holds (a 256^2 atlas, a dozen quads)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("cpu_foliage4k.shared_atlas", "gpu_foliage4k.shared_atlas")
#: cells whose files are under ommbench/ but not entered in BENCHMARK.json
#: (the GPU baker's cell, left out by its spread on the chip)
NOT_ENTERED = {
    "gpu_foliage4k.shared_atlas": (
        {"name": "gpu_foliage4k", "file": "ommbench/configs/gpu_foliage4k.json"},
        {"name": "gpu_foliage4k.shared_atlas", "config": "gpu_foliage4k",
         "traffic": "shared_atlas", "chips": 1})}
SEED = 2 ** 31 + 12345


def shrink(c, size=256, quads=12, traced=3, library=4):
    """Cell `c` (run.cell) cut to a test's size, in place: its leaves
    scale with the atlas, as at full size; a mesh library holds
    `library` meshes, each baked once in the warm-up, as at full size."""
    c["config"]["texture"]["width"] = c["config"]["texture"]["height"] = size
    mesh = c["traffic"]["params"]["mesh"]
    mesh["quads"] = [quads, quads]
    if "library" in mesh:
        mesh["library"] = dict(mesh["library"], meshes=library)
        c["traffic"]["warmup"]["bakes"] = library
    c["traffic"]["trace"]["bakes"] = traced
    return c


def bench():
    """BENCHMARK.json with the cells of NOT_ENTERED added, as a later
    change would enter them."""
    from ommbench import run
    b = run.load_json(ROOT, "BENCHMARK.json")
    for config, workload in NOT_ENTERED.values():
        if all(w["name"] != workload["name"] for w in b["workloads"]):
            b["configs"].append(config)
            b["workloads"].append(workload)
    return b


@pytest.fixture
def small_cell():
    from ommbench import run
    bench_ = bench()

    def make(name, **kw):
        return shrink(run.cell(bench_, name), **kw)
    return make
