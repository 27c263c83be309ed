"""Where the time of an omm_tpu_torch bake goes, on one CUDA card.

    python tools/profile_torch_bake.py [--workload W] [--trace PATH]
                                       [--package-root DIR]
    python tools/profile_torch_bake.py --exact-vs DIR [DIR ...] [--rounds N]

Runs one of chip_smoke.py's workloads on cuda:0: through
omm_tpu_torch.bake "bench" (the default: 1024^2 FP32 clamp texture, 256
triangles, subdivision 9), "nearest" (the same with the nearest filter)
or "mixed" (its 312-triangle mesh over every linear route), or "scene"
(the vegetation scene, every triangle at subdivision 9); or "gpu", the
bench triangles through the GPU baker's dispatch chain on its RGBA
texture (the DescPatch pass is the label omm.desc_patch).  2 warm-up
bakes (the first discovers the batches' capacities, the second
captures their CUDA graphs), then one bake under torch.profiler, on
every thread (the batch pipeline's enqueue thread issues the chains,
omm.spec, and a pool writes the rows back, omm.row_post).  Prints the
wall seconds of the profiled bake, host time per stage and route label
(omm.*) with the threads it ran on, the calling thread's waits on the
batches (omm.drain), the work items per route, the pipeline's counts
(batches per path, graph captures and replays, count syncs), the kernel and
graph launch calls, the host operations with the most self CPU time,
device time per kernel, and the device's busy and idle shares of the
bake's wall time, and the device kernels of the bake (their launches
by name for the hand-written kernels).  With --trace, the Chrome trace
is written to PATH.  With --package-root DIR the package is imported
from DIR (an unpacked checkout, such as a parent commit's), with this
checkout's workloads and measurement.

With --exact-vs it instead times the exact kernels built from each DIR
(a csrc/ directory with an exact_classify.cu of the same launch
interface, such as an earlier commit's) against the package's own, on
the first 48-triangle batch of the workload: each must equal the torch
twin, then N rounds in turns (the others, this, this, the others in
reverse), each taking a kernel's device time from torch.profiler over 50
launches and its time by CUDA events over bursts of launches.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("bench", "nearest", "mixed",
                                           "gpu", "scene"), default="bench")
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    ap.add_argument("--exact-vs", metavar="DIR", nargs="+",
                    help="time the exact kernels built from each DIR "
                    "against this one instead of profiling a bake")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--package-root", default=ROOT)
    args = ap.parse_args()
    if args.exact_vs:
        return compare_exact(args.exact_vs, args.rounds)
    import importlib.util

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pkg_root = os.path.abspath(args.package_root)
    sys.path.insert(0, pkg_root)
    # this checkout's workloads and measurement, whatever the package's
    # root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import omm_tpu_torch as ot
    if not os.path.abspath(ot.__file__).startswith(pkg_root + os.sep):
        raise SystemExit(f"omm_tpu_torch came from {ot.__file__}, not "
                         f"{pkg_root}")

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    desc, _ = chip_smoke._workload_desc(args.workload,
                                        *chip_smoke._workload())
    for _ in range(2):
        chip_smoke._bake(desc, dev)
    torch.cuda.synchronize()
    ot.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=chip_smoke.all_threads()) as prof:
        t0 = time.perf_counter()
        chip_smoke._bake(desc, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled {args.workload} bake: {wall:.4f} s wall (profiler on)")
    print("items per route: " + ", ".join(
        f"{k[6:]} {v}" for k, v in ot.launches().items()
        if k.startswith("route.") and v))
    print("pipeline: " + ", ".join(
        f"{k} {v}" for k, v in ot.pipeline_counts().items()))
    ev = prof.key_averages()
    calls = {e.key: e for e in ev}
    print("launch calls: " + ", ".join(
        f"{k} {calls[k].count} ({calls[k].cpu_time_total / 1e3:.3f} host ms)"
        if k in calls else f"{k} 0"
        for k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                  "cudaGraphLaunch")))
    labels, busy_ms = chip_smoke.profile_labels(prof)
    print("host time per stage label (ms, inclusive, summed over threads):")
    for k, (ms, n, th) in sorted(labels.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:22s} {ms:10.3f} x{n} on {th} thread(s)")
    if "omm.drain" in labels:
        ms, n, _ = labels["omm.drain"]
        print(f"omm.drain: the calling thread waited {ms:.3f} ms on {n} "
              "batches")
    rows = [(e.self_device_time_total, e.key, e.count) for e in ev
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("omm.")]  # not the labels' spans
    print("host ops by self CPU time (ms):")
    host = [e for e in ev if e.device_type != DeviceType.CUDA
            and not e.key.startswith("omm.")]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"  {e.self_cpu_time_total / 1e3:10.3f} x{e.count:<5d} "
              f"{e.key[:80]}")
    print("device time per kernel (ms):")
    for t, k, n in sorted(rows, reverse=True)[:15]:
        print(f"  {t / 1e3:10.3f} x{n:<5d} {k[:90]}")
    for t, k, n in rows:
        if "exact_classify" in k:
            print(f"exact kernel: {t / 1e3:.4f} ms device in {n} launches")
    kernels, moves, by_name = chip_smoke.device_kernels(prof)
    print(f"device kernels per bake: {kernels} (and {moves} device copies "
          f"and sets); package {os.path.relpath(pkg_root, ROOT)}")
    for tag in ("exact_classify", "descend_kernel", "keys_kernel",
                "slots_"):
        hit = [v for k, v in by_name.items() if tag in k]
        if hit:
            print(f"  {tag}: {sum(v[0] for v in hit)} launches, "
                  f"{sum(v[1] for v in hit):.4f} ms device")
    print(f"device busy {busy_ms:.3f} ms of {wall * 1e3:.3f} ms wall: "
          f"busy share {busy_ms / 1e3 / wall:.4f}, idle share "
          f"{1 - busy_ms / 1e3 / wall:.4f}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


def compare_exact(other_dirs, rounds):
    import subprocess

    import torch

    import chip_smoke
    from omm_tpu_torch.bake import Options, _config, setup_work_items
    from omm_tpu_torch.kernels import build, exact

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    libs = {"this": build.cuda_library()}
    for d in other_dirs:
        libs[d] = build.cuda_library(d)
    for name in libs:
        tag = build.cuda_library_name(None if name == "this" else name)
        for line in build.BUILD_INFO.get(tag, {}).get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")
    tex, uv_tris = chip_smoke._workload()
    desc = chip_smoke._desc(tex, uv_tris)
    opts = Options.from_flags(desc.bake_flags)
    cfg = _config(desc, opts)
    uvs = [it.uv_tri for it in setup_work_items(desc, opts)]
    args, kw, what = chip_smoke.slot_streams(tex, uvs, cfg, chip_smoke.SUBDIV,
                                             chip_smoke.BATCH, dev)
    print(f"stream: {what}")
    ta, tb = exact.exact_counts(*args, exact="torch", **kw)
    nblk = args[2].shape[0]
    outs = {}
    for name, lib in libs.items():
        a = torch.empty((nblk, exact.B), dtype=torch.int32, device=dev)
        b = torch.empty_like(a)
        outs[name] = (lib, a, b)
        exact.launch(lib, *args, a, b, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(a, ta) and torch.equal(b, tb)):
            raise SystemExit(f"the {name} kernel differs from the twin")
    work = exact.exact_work(*args, **kw)
    bound_ms, bound_by = exact.bound(work)
    print(f"bound {bound_ms:.6f} ms ({bound_by}); ops {work['ops']} bytes "
          f"{work['bytes']}")
    res = {name: [] for name in libs}
    order = list(other_dirs) + ["this", "this"] + list(other_dirs)[::-1]
    for r in range(rounds):
        for name in order:
            lib, a, b = outs[name]

            def fn():
                exact.launch(lib, *args, a, b, **kw)

            d = chip_smoke.device_ms(fn, "exact_classify")
            e = chip_smoke._cuda_ms(fn)
            res[name].append((d, e))
            print(f"round {r} {name}: device {d} ms, events {e:.6f} ms",
                  flush=True)
    for name, v in res.items():
        d = sorted(x[0] for x in v if x[0] is not None)
        e = sorted(x[1] for x in v)
        if d:
            print(f"{name}: device ms min {d[0]:.6f} median "
                  f"{d[len(d) // 2]:.6f}; at {bound_ms / d[0]:.4f} of the "
                  f"bound")
        print(f"{name}: event ms min {e[0]:.6f} median {e[len(e) // 2]:.6f}")


if __name__ == "__main__":
    main()
