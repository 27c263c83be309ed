"""Run one cell of the benchmark of omm_tpu_torch once.

    python3 -m ommbench.run --workload <config>.<traffic> --seed N
                            --seconds S --trace 0|1

From the root of a checkout.  The cell, its configuration and its
traffic mix are found by name through BENCHMARK.json: the configuration
in `ommbench/configs/<config>.json` (the descriptor and the program's
entry, `ommbench/entries/<entry>.py`), the traffic in
`ommbench/traffic/<traffic>.json` (its generator,
`ommbench/generators/<generator>.py`, and the generator's parameters),
each metric in `ommbench/metrics/<metric>.py` (a `read(run)` that
returns its value, or None where it finds nothing to read).

Set-up makes the generator's textures from the seed, creates their
texture objects once (unless the traffic makes one per bake), and bakes
the traffic's `warmup.bakes` warm-up meshes.  With --trace 0 it then
bakes a new mesh per call, one call in flight, for --seconds, and prints
the cell's end-to-end metrics.  With --trace 1 it profiles `trace.bakes`
such bakes on every thread and prints the per-layer metrics, the
device's busy and window seconds, and the breakdown.  Either way it then
frees the program's state and checks a sample of the window's bakes
(`check.bakes` of them, each bake kept with the same chance, the draws
from the seed) against the plain reference (`check`, `reference`).

The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device (and breakdown with --trace 1), and
last the numbers compared, each with its limit; standard error ends with
the same numbers.  Without a CUDA device, with fewer devices than the
cell asks for, or with jax, jaxlib, flax or the JAX package loaded once
the window has closed, it exits with a code other than 0 and prints no
result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.abc
import importlib.util
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "ommbench")
#: top-level modules that may not be loaded in a run
BLOCKED = ("jax", "jaxlib", "flax", "omm_tpu")


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"import of {name} blocked: the "
                                      "benchmark runs the port alone")
        return None


def blocked_modules() -> list:
    """Loaded modules whose top-level name is blocked."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BLOCKED})


def process_start() -> float:
    """time.perf_counter() at this process's start (from /proc; the
    import of this module where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """The module in `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str, here: str = HERE) -> dict:
    """The cell `workload` of BENCHMARK.json with its configuration,
    traffic, generator, entry and metrics: {"workload", "config",
    "traffic", "generator", "entry", "end_to_end", "per_layer"}, each
    metric a (spec, module)."""
    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    config = load_json(ROOT, c["file"])
    traffic = load_json(here, "traffic", w["traffic"] + ".json")
    gen = load_file(os.path.join(here, "generators",
                                 traffic["generator"] + ".py"),
                    f"ommbench.generators.{traffic['generator']}")
    entry = load_file(os.path.join(here, "entries", config["entry"] + ".py"),
                      f"ommbench.entries.{config['entry']}")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in reported)]

    def mods(ms):
        return [(m, load_file(os.path.join(here, "metrics", m["name"] + ".py"),
                              f"ommbench.metrics.{m['name']}")) for m in ms]

    return {"workload": w, "config": config, "traffic": traffic,
            "generator": gen, "entry": entry, "end_to_end": mods(e2e), "per_layer": mods(per)}


class Reservoir:
    """k of a stream's items, each kept with the same chance whatever the
    stream's length (Algorithm R), the draws from the seed."""

    def __init__(self, seed: int, k: int):
        import numpy as np
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 7])
        self.k, self.n, self.slots = k, 0, []

    def offer(self, index: int, item) -> None:
        if self.n < self.k:
            self.slots.append((index, item))
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.slots[j] = (index, item)
        self.n += 1


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, call_wrapper=None, log=sys.stderr) -> dict:
    """One run of cell `c` (see `cell`) on `device`; returns the result
    line's object.  call_wrapper(call) -> call wraps the program's entry
    (the tests plant faults with it)."""
    import torch
    from torch.profiler import record_function

    import omm_tpu_torch as ot

    from . import check, inputs
    from . import trace as tr
    from .reference import finalize, levels

    config, traffic, entry = c["config"], c["traffic"], c["entry"]
    desc = config["descriptor"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    call = entry.call if call_wrapper is None else call_wrapper(entry.call)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # set-up: the textures, their texture objects, the warm-up bakes
    gen = c["generator"].make(seed, config, traffic["params"], dev)
    state = entry.prepare(ot, config, dev)
    shared = None if gen.per_bake_texture \
        else [entry.texture(state, t) for t in gen.textures]

    def bake(stream, i, timed):
        """(result or None, latency s, end time) of bake i of a stream;
        the mesh is made before the call and outside its latency."""
        with record_function(tr.MESH):
            uvs, idx = gen.mesh(stream, i)
            k = gen.texture_of(stream, i)
            inp = None if shared is None \
                else entry.describe(state, shared[k], uvs, idx)
        with record_function(tr.BAKE):
            t0 = time.perf_counter()
            try:
                if inp is None:
                    inp = entry.describe(
                        state, entry.texture(state, gen.textures[k]),
                        uvs, idx)
                res = call(state, inp)
            except Exception:
                if not timed:
                    raise
                traceback.print_exc(file=log)  # counted, not fatal
                res = None
            t1 = time.perf_counter()
        ok = res is not None and len(res.index_buffer) == len(idx) // 3
        return (res if ok else None), t1 - t0, t1

    before = ot.pipeline_counts()
    n_warm = int(traffic["warmup"]["bakes"])
    for i in range(n_warm):
        bake(inputs.WARMUP, i, False)
    sync()
    warm = {k: v - before[k] for k, v in ot.pipeline_counts().items()}

    kept = Reservoir(seed, int(traffic["check"]["bakes"]))
    lat, done, ends = [], [], []
    counts0 = ot.pipeline_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = tr.profiler() if trace else None

    def one(i):
        res, dt, t1 = bake(inputs.TIMED, i, True)
        ends.append(t1)
        if res is not None:
            lat.append(dt)
            done.append(i)
        kept.offer(i, res)
        return t1

    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s, {n_warm} warm-up bakes "
          f"({warm['discovery']} discovery batches, "
          f"{warm['graph_capture']} graph captures)", file=log)
    t_win = time.perf_counter()
    i = 0
    if trace:
        with prof:
            with record_function(tr.WINDOW):
                for i in range(int(traffic["trace"]["bakes"])):
                    t_end = one(i)
                sync()
        i += 1
    else:
        while True:
            t_end = one(i)
            i += 1
            if t_end - t_win >= seconds:
                break
    window_s = t_end - t_win
    attempted = i
    sync()
    fifths = [0] * 5
    for t in ends:
        fifths[min(4, int(5 * (t - t_win) / max(window_s, 1e-9)))] += 1
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counts = {k: v - counts0[k] for k, v in ot.pipeline_counts().items()}
    found = blocked_modules()
    if found:
        raise SystemExit("modules loaded that the run may not load: "
                         + ", ".join(found))

    def tris_of(j):
        return inputs.triangles(*gen.mesh(inputs.TIMED, j))

    def size_of(j):
        h, w = gen.textures[gen.texture_of(inputs.TIMED, j)]["mips"][0].shape
        return (int(w), int(h))

    utri = [levels.micro_triangles(
        inputs.distinct(tris_of(j)), size_of(j),
        desc["dynamic_subdivision_scale"], desc["max_subdivision_level"])
        for j in done]
    run = {"bakes": attempted, "failed": attempted - len(done),
           "latencies_s": lat, "utri": utri, "window_s": window_s,
           "setup_s": setup_s, "peak_bytes": peak, "counts": counts}
    out = {"correct": None, "attempted": attempted, "failed": run["failed"]}
    if trace:
        t_dig = time.perf_counter()
        run["trace"] = tr.digest(prof)
        prof = None
        print(f"trace read in {time.perf_counter() - t_dig:.3f} s",
              file=log)
        names = c["per_layer"]
    else:
        names = c["end_to_end"]
    metrics = {}
    for m, mod in names:
        v = mod.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": int(c["workload"]["chips"]),
        "memory_peak_bytes": int(peak)}
    if trace:
        d = run["trace"]
        out["device"]["busy_s"] = d["busy_us"] / 1e6
        out["device"]["window_s"] = d["window_us"] / 1e6
        out["breakdown"] = {"device_ops": d["device_ops"],
                            "idle_gaps": d["idle_gaps"]}

    # the check, once the program's state is freed
    state = shared = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = {k: 0 for k in check.LIMITS}
    t_ref = time.perf_counter()
    for j, res in sorted(kept.slots, key=lambda x: x[0]):
        planes = inputs.decoded(gen.textures[gen.texture_of(inputs.TIMED,
                                                            j)])
        if len(planes) != 1:
            raise NotImplementedError("the reference classifies one mip")
        ref = finalize.bake(planes[0], tris_of(j), desc, entry.BAKER)
        got = check.missing(ref) if res is None \
            else check.compare(ref, check.result_arrays(res))
        for k in readings:
            readings[k] += got[k]
    print(f"window {window_s:.3f} s, {attempted} bakes, {run['failed']} "
          f"failed; reference {time.perf_counter() - t_ref:.3f} s for "
          f"{len(kept.slots)} bakes", file=log)
    if not trace:
        print(f"bakes per fifth of the window {fifths}", file=log)
    print(f"pipeline counts in the window {counts}", file=log)
    out["correct"] = all(readings[k] <= check.LIMITS[k] for k in readings)
    out["check"] = {k: {"value": readings[k], "limit": check.LIMITS[k]}
                    for k in readings}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    sys.meta_path.insert(0, _Block())
    # the program's caches stay inside the checkout, at fixed paths
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")

    bench = load_json(ROOT, "BENCHMARK.json")
    c = cell(bench, args.workload)
    import torch
    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    import omm_tpu_torch
    pkg = os.path.dirname(os.path.abspath(omm_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        print(f"omm_tpu_torch came from {pkg}, not this checkout",
              file=sys.stderr)
        return 2
    out = run_cell(c, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_start)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
