"""What a run loads, and how it finds its pieces: no module of JAX or of
the JAX package in a run, none of the program in the reference, and a
traffic mix and a metric added as files are found by name."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from ommbench import run

from ommbench_cells import CELLS, ROOT, SEED


def _python(code: str) -> str:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax(name):
    """A whole small run, in a fresh process, leaves no module whose
    top-level name is jax, jaxlib, flax or omm_tpu (omm_tpu_torch is the
    port and is compared whole, not by its prefix)."""
    out = _python(f"""
import json, sys
sys.path.insert(0, "ommbench/tests")
from ommbench import run
from ommbench_cells import bench, shrink
c = shrink(run.cell(bench(), "{name}"))
res = run.run_cell(c, {SEED}, 0.5, False, "cpu", 0.0)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"blocked": run.blocked_modules(), "tops": tops}}))
""")
    got = json.loads(out)
    assert got["blocked"] == []
    assert "omm_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "omm_tpu"} & set(got["tops"])


def test_blocked_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "omm_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "omm_tpu_torch_extra" not in run.blocked_modules()
    monkeypatch.setitem(sys.modules, "omm_tpu.bake", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.blocked_modules()[:2] == ["jax.numpy", "omm_tpu.bake"]


def test_the_reference_loads_nothing_of_the_program():
    out = _python("""
import json, sys
import numpy as np, torch
from ommbench import inputs
from ommbench.reference import classify, finalize, levels
from ommbench import check, control
plane = torch.zeros(64, 64); plane[:, 20:] = 1.0
tri = np.array([[[0.1, 0.1], [0.1, 0.6], [0.6, 0.1]]], np.float32)
finalize.bake(plane, tri, {"alpha_cutoff": 0.5, "max_subdivision_level": 4,
                           "dynamic_subdivision_scale": 0.0}, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    tops = set(json.loads(out))
    assert not {"omm_tpu_torch", "omm_tpu", "jax", "jaxlib", "flax"} & tops


def _tree_digest(path):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        if "__pycache__" in d:
            continue
        for f in sorted(files):
            h.update(f.encode())
            with open(os.path.join(d, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


#: a generator that a later change could add as a file: a disc on a
#: texture of its own per bake, cards drawn from 16 regions of a grid
DISC_REGIONS = """
import numpy as np
import torch

from ommbench.inputs import rng


class Discs:
    def __init__(self, seed, config, params, device):
        n = int(config["texture"]["width"])
        y, x = torch.meshgrid(torch.arange(n, device=device),
                              torch.arange(n, device=device), indexing="ij")
        self.textures = []
        for k in range(int(params["textures"])):
            r = 0.2 + 0.1 * k
            d = torch.hypot(x / n - 0.5, y / n - 0.5)
            self.textures.append({"format": "FP32", "mips": [
                torch.clamp((r - d) * n / 4, 0, 1).to(torch.float32)]})
        self.per_bake_texture = True
        self.seed, self.quads = seed, int(params["quads"])

    def texture_of(self, stream, i):
        return i % len(self.textures)

    def mesh(self, stream, i):
        r = rng(self.seed, stream, i)
        cell = r.integers(0, 16, self.quads)
        u0, v0 = (cell % 4) / 4.0, (cell // 4) / 4.0
        c = np.stack([np.stack([u0, v0], 1), np.stack([u0, v0 + .25], 1),
                      np.stack([u0 + .25, v0], 1),
                      np.stack([u0 + .25, v0 + .25], 1)], 1)
        base = 4 * np.arange(self.quads, dtype=np.uint32)[:, None]
        idx = base + np.array([0, 1, 2, 3, 1, 2], np.uint32)[None, :]
        return (c.reshape(-1, 2).astype(np.float32),
                idx.reshape(-1).astype(np.uint32))


def make(seed, config, params, device):
    return Discs(seed, config, params, device)
"""


@pytest.mark.parametrize("kind", ["parameters", "generator"])
def test_added_traffic_and_metric_files_are_found_by_name(tmp_path, kind):
    """A later change adds a cell with its own traffic mix (new
    parameters of a generator that is there, or a generator of its own)
    and a metric as new files and BENCHMARK.json entries; no file that is
    there changes."""
    here = os.path.join(ROOT, "ommbench")
    before = _tree_digest(here)
    tmp = tmp_path / "ommbench"
    for sub in ("traffic", "metrics", "entries", "generators"):
        shutil.copytree(os.path.join(here, sub), tmp / sub)
    traffic = run.load_json(here, "traffic", "shared_atlas.json")
    if kind == "parameters":
        # a new texture object per bake, from a pool of two
        p = traffic["params"]
        traffic.update(params=dict(p, textures=2, per_bake_texture=True,
                                   mesh=dict(p["mesh"], quads=[6, 9])))
    else:
        traffic.update(generator="disc_regions",
                       params={"textures": 2, "quads": 10})
        (tmp / "generators" / "disc_regions.py").write_text(DISC_REGIONS)
    traffic.update(name="added", check={"bakes": 2}, trace={"bakes": 3})
    (tmp / "traffic" / "added.json").write_text(json.dumps(traffic))
    (tmp / "metrics" / "bakes_done.py").write_text(
        'SOURCE = "program_counter"\n\n\n'
        'def read(run):\n    return float(run["bakes"] - run["failed"])\n')
    bench = run.load_json(ROOT, "BENCHMARK.json")
    bench["workloads"].append({"name": "cpu_foliage4k.added",
                               "config": "cpu_foliage4k",
                               "traffic": "added", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "bakes_done", "unit": "bakes",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "surface", "moves": "utri_per_s"})
    c = run.cell(bench, "cpu_foliage4k.added", here=str(tmp))
    assert c["traffic"]["generator"] == ("leaf_cards" if kind == "parameters"
                                         else "disc_regions")
    assert [m["name"] for m, _ in c["per_layer"]] == ["bakes_done"]
    c["config"]["texture"].update(width=128, height=128)
    out = run.run_cell(c, SEED, 1e9, True, "cpu", 0.0)
    assert out["correct"] is True, out["check"]
    assert out["metrics"] == {"bakes_done": {"value": 3.0,
                                             "unit": "bakes"}}
    # a broken timed path still reads as not correct there
    flip = run.run_cell(c, SEED, 1e9, True, "cpu", 0.0, call_wrapper=(
        lambda call: lambda state, inp: _flip_index(call(state, inp))))
    assert flip["correct"] is False
    assert _tree_digest(here) == before


def _flip_index(res):
    import copy
    import numpy as np
    res = copy.copy(res)
    ib = np.array(res.index_buffer, copy=True)
    ib[0] = -1 if ib[0] != -1 else -2
    res.index_buffer = ib
    return res


def test_metric_files_state_their_source():
    """Each metric file states its source, as BENCHMARK.json does where
    it names the metric."""
    bench = run.load_json(ROOT, "BENCHMARK.json")
    named = {m["name"]: m["source"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    here = os.path.join(ROOT, "ommbench", "metrics")
    files = [f[:-3] for f in os.listdir(here)
             if f.endswith(".py") and not f.startswith("_")]
    assert set(named) <= set(files)
    for name in files:
        mod = run.load_file(os.path.join(here, name + ".py"), name)
        assert mod.SOURCE in ("device_trace", "program_span",
                              "program_counter", "host_clock"), name
        assert mod.SOURCE == named.get(name, mod.SOURCE), name


def test_each_cell_reports_its_metrics():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric; each per-layer metric moves a metric the cell
    reports."""
    bench = run.load_json(ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        c = run.cell(bench, w["name"])
        e2e = {m["name"] for m, _ in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c["per_layer"]
        assert all(m["moves"] in e2e for m, _ in c["per_layer"])
