"""Wall time of omm_tpu_torch bakes on one CUDA card, without a profiler.

    python tools/time_torch_bake.py [--workload bench|nearest|mixed|gpu|scene]
                                    [--package-root DIR]

Builds one of chip_smoke.py's workloads ("bench": 1024^2 FP32 clamp
texture, 256 triangles, subdivision 9; "nearest": the same with the
nearest filter; "mixed": its 312-triangle mesh over every linear route;
"gpu": the bench triangles through the GPU baker's dispatch chain on
its RGBA texture; "scene": the vegetation scene, 400 triangles over 6 UV
variants of a 512^2 foliage atlas, every one at subdivision 9) and
times it as chip_smoke.py does: 2 warm-up bakes, then 5 timed ones,
each ending with the result on the host, which must be byte-equal.
Prints one JSON line: the card's name and power limit, the workload, the
times, best and median seconds and micro-triangles per second.  With
--package-root DIR the package is imported from DIR (an unpacked
checkout, such as a parent commit's), so that two versions can be timed
in turns, one process each, in one call.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("bench", "nearest", "mixed",
                                           "gpu", "scene"), default="bench")
    ap.add_argument("--package-root", default=ROOT)
    args = ap.parse_args()
    pkg_root = os.path.abspath(args.package_root)
    sys.path.insert(0, pkg_root)

    import torch

    import omm_tpu_torch as ot

    # this checkout's workload and timing functions, whatever the
    # package's root
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if not os.path.abspath(ot.__file__).startswith(pkg_root + os.sep):
        raise SystemExit(f"omm_tpu_torch came from {ot.__file__}, not "
                         f"{pkg_root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    desc, utri = chip_smoke._workload_desc(args.workload,
                                           *chip_smoke._workload())
    _, times, _, summary = chip_smoke._timed_bakes(desc, utri, args.workload,
                                                   card)
    print(json.dumps({"card": card, "workload": args.workload,
                      "package_root": os.path.relpath(pkg_root, ROOT),
                      "times_s": times, **summary}))


if __name__ == "__main__":
    main()
