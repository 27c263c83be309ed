"""The control of `correct`: the plain reference computed on the atlas
rounded to bfloat16 (the precision below the configuration's FP32
texels), put in the program's place and judged by the same comparison.
It has to come out as not correct: every seed has to read above each
limit of `check` on at least one number.

    python3 -m ommbench.control --workload <cell> --seeds N [N ...]

For each seed it checks the bakes that a run of `bakes` bakes would
check (the same draws from the timed stream, at the cell's own sizes)
and prints
one JSON line of readings; the last line holds the smallest reading of
each number over the seeds.  It runs on the card when there is one.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, inputs, run
from .reference import finalize


def readings(c: dict, seed: int, device, bakes: int = 1000) -> dict:
    """{number: reading} of the control for one seed of cell `c`."""
    cfg, tr = c["config"], c["traffic"]
    desc = cfg["descriptor"]
    gen = c["generator"].make(seed, cfg, tr["params"], device)
    kept = run.Reservoir(seed, int(tr["check"]["bakes"]))
    for i in range(bakes):
        kept.offer(i, None)
    out = {k: 0 for k in check.LIMITS}
    for j, _ in kept.slots:
        tris = inputs.triangles(*gen.mesh(inputs.TIMED, j))
        plane = inputs.decoded(
            gen.textures[gen.texture_of(inputs.TIMED, j)])[0]
        low = plane.to(torch.bfloat16).to(torch.float32)
        ref = finalize.bake(plane, tris, desc, c["entry"].BAKER)
        ctl = finalize.bake(low, tris, desc, c["entry"].BAKER)
        for k, v in check.compare(ref, ctl).items():
            out[k] += v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    c = run.cell(run.load_json(run.ROOT, "BENCHMARK.json"), args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    low, fails = None, True
    for s in args.seeds:
        r = readings(c, s, device)
        print(json.dumps({"seed": s, "readings": r}), flush=True)
        low = r if low is None else {k: min(low[k], r[k]) for k in r}
        fails &= any(r[k] > lim for k, lim in check.LIMITS.items())
    print(json.dumps({"workload": args.workload, "device": device,
                      "smallest": low, "control_fails": fails}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
