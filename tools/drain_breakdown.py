"""Where the host time of a drained omm_tpu_torch bake goes, without a
profiler, and what each thread of the batch pipeline's drain buys.

    python tools/drain_breakdown.py [--workload bench|gpu] [--rounds N]

torch.profiler's CUPTI callbacks inflate each cudaGraphLaunch several
times over, so a profile cannot say how long the drain's parts take.
This script wraps them in wall clocks instead: the whole
classify_work_items_batches call, each batch's enqueue
(`batch._enqueue_spec`: copy-in, replay, copy-out), the replay call
alone (`torch.cuda.CUDAGraph.replay`), the calling thread's wait on each
payload (`batch._drain_spec`), each write-back and its post pass
(`native.row_post_packed`), summed over the call's threads.

It bakes one of chip_smoke.py's workloads on cuda:0 ("bench", or "gpu":
the GPU baker's dispatch, which asks for no posts) after 2 warm-ups, N
rounds in turns (the order reversed every other round) of four ways to
run the same drain, byte-equal to one another: "threads" (the
pipeline as it is: the enqueue thread and the write-back pool), and, for
comparison only, with the enqueue executor, the pool, or both replaced
by one that runs each task on the calling thread as it is submitted
("no_enqueue_thread", "no_pool", "calling_thread").  Prints the card's
name and power limit, and per way the best and median bake and the
median of each part, in ms.
"""
import argparse
import concurrent.futures as cf
import importlib
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _CallingThread:
    """An executor that runs each task on the submitting thread."""

    def __init__(self, *args, **kw):
        pass

    def submit(self, fn, *args, **kw):
        f = cf.Future()
        try:
            f.set_result(fn(*args, **kw))
        except Exception as e:  # the future carries it, as a pool's does
            f.set_exception(e)
        return f

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("bench", "gpu"), default="bench")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from omm_tpu_torch import batch, native

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)

    parts, lock = {}, threading.Lock()

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    parts[name] = parts.get(name, 0.0) + (
                        time.perf_counter() - t0)
        return wrapper

    tbake = importlib.import_module("omm_tpu_torch.bake")
    tgpu = importlib.import_module("omm_tpu_torch.gpu.baker")
    call = timed("classify", batch.classify_work_items_batches)
    tbake.classify_work_items_batches = tgpu.classify_work_items_batches = call
    batch._enqueue_spec = timed("enqueue", batch._enqueue_spec)
    batch._drain_spec = timed("drain_wait", batch._drain_spec)
    batch._Batch.write_back = timed("write_back", batch._Batch.write_back)
    native.row_post_packed = timed("post", native.row_post_packed)
    torch.cuda.CUDAGraph.replay = timed("replay", torch.cuda.CUDAGraph.replay)

    pool = batch.ThreadPoolExecutor

    def executors(enqueue_thread, write_back_pool):
        def make(max_workers, **kw):
            threaded = (enqueue_thread if max_workers == 1
                        else write_back_pool)
            return (pool(max_workers, **kw) if threaded
                    else _CallingThread())
        return make

    ways = {"threads": (True, True), "no_enqueue_thread": (False, True),
            "no_pool": (True, False), "calling_thread": (False, False)}
    tex, uv_tris = chip_smoke._workload()
    desc, _ = chip_smoke._workload_desc(args.workload, tex, uv_tris)
    ref = chip_smoke._bake(desc)
    chip_smoke._bake(desc)
    torch.cuda.synchronize()
    times = {w: [] for w in ways}
    per = {w: {} for w in ways}
    for r in range(args.rounds):
        for w in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            batch.ThreadPoolExecutor = executors(*ways[w])
            parts.clear()
            try:
                t0 = time.perf_counter()
                res = chip_smoke._bake(desc)
                times[w].append(time.perf_counter() - t0)
            finally:
                batch.ThreadPoolExecutor = pool
            if not chip_smoke._results_equal(res, ref):
                raise SystemExit(f"{w}: the bake differs from the first")
            for k, v in parts.items():
                per[w].setdefault(k, []).append(v)
    print(f"{args.workload}, {args.rounds} rounds in turns, ms ({card}):")
    for w in ways:
        t = times[w]
        print(f"  {w:18s} bake best {min(t) * 1e3:8.3f} median "
              f"{statistics.median(t) * 1e3:8.3f} | medians: " + ", ".join(
                  f"{k} {statistics.median(v) * 1e3:.3f}"
                  for k, v in sorted(per[w].items())))


if __name__ == "__main__":
    main()
