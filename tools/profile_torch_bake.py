"""Where the time of an omm_tpu_torch bake goes, on one CUDA card.

    python tools/profile_torch_bake.py [--trace PATH]

Runs the benchmark workload (chip_smoke.py's: 1024^2 FP32 clamp
texture, 256 triangles, subdivision 9) through omm_tpu_torch.bake on
cuda:0: 2 warm-up bakes, then one bake under torch.profiler.  Prints the
wall seconds of the profiled bake, host time per stage label (omm.*),
device time per kernel, and the device's busy and idle shares of the
bake's wall time.  With --trace, the Chrome trace is written to PATH.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import omm_tpu_torch as ot

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    tex, uv_tris = chip_smoke._workload()
    desc = chip_smoke._desc(tex, uv_tris)
    for _ in range(2):
        ot.bake(desc, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ot.bake(desc, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled bake: {wall:.4f} s wall (profiler on)")
    ev = prof.key_averages()
    print("host time per stage label (ms, inclusive):")
    for e in sorted(ev, key=lambda e: -e.cpu_time_total):
        if e.key.startswith("omm."):
            print(f"  {e.key:18s} {e.cpu_time_total / 1e3:10.3f} "
                  f"x{e.count}")
    dev_us = 0.0
    rows = []
    for e in ev:
        if e.device_type != DeviceType.CUDA or e.key.startswith("omm."):
            continue  # host ops and the stage labels' device-side spans
        t = e.self_device_time_total
        rows.append((t, e.key, e.count))
        dev_us += t
    print("device time per kernel (ms):")
    for t, k, n in sorted(rows, reverse=True)[:15]:
        print(f"  {t / 1e3:10.3f} x{n:<5d} {k[:90]}")
    print(f"device busy {dev_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall: "
          f"busy share {dev_us / 1e6 / wall:.4f}, idle share "
          f"{1 - dev_us / 1e6 / wall:.4f}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
