"""Reading a torch.profiler profile of the traced bakes: the program's
spans (`omm.*` labels) and the harness's own (`ommbench.*`), the device's
operations, the device's busy time (the union of its kernel, copy and
set intervals) and its idle gaps.

The profile is taken on every thread (`profile_all_threads`): the
program's batch pipeline issues its chains from an enqueue thread and
posts rows on a pool.  What each metric reads from the digest is in the
metric's own file under `metrics/`.
"""
from __future__ import annotations

import bisect

import torch

WINDOW = "ommbench.window"
BAKE = "ommbench.bake"
MESH = "ommbench.mesh"


def profiler():
    """A torch.profiler over the host and the card, on every thread."""
    from torch.profiler import ProfilerActivity, profile
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=cfg)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def digest(prof, top: int = 10) -> dict:
    """The profile's numbers, times in microseconds of the profiler's
    clock:

      labels_us: {span name: summed duration over every thread}
      label_calls: {span name: count}
      kernels: {device op name: [count, summed device us]}
      window_us: the traced window (the harness's WINDOW span)
      busy_us: the union of device intervals inside the window
      device_ops: the `top` device ops by summed time, [name, seconds]
      idle_gaps: the `top` names by idle device time, [name, seconds]:
        each gap goes to the innermost span open on the calling thread at
        its middle ("host" where none is); the calling thread is the
        one that opened the WINDOW span."""
    from torch.autograd import DeviceType
    labels, calls, kernels = {}, {}, {}
    spans_main, device = [], []
    win, main_thread = None, None
    for e in prof.events():
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if name.startswith(("omm.", "ommbench.")):
                labels[name] = labels.get(name, 0.0) + (end - start)
                calls[name] = calls.get(name, 0) + 1
                if name == WINDOW:
                    win, main_thread = (start, end), e.thread
                spans_main.append((start, end, name, e.thread))
        elif e.device_type == DeviceType.CUDA:
            if name.startswith(("omm.", "ommbench.")):
                continue  # a label's range on the device timeline
            device.append((start, end, name))
    if win is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    w0, w1 = win
    inside = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += e - s
    busy = _merge(inside)
    busy_us = sum(e - s for s, e in busy)

    # idle gaps, each named by the innermost calling-thread span open at
    # its middle (spans on one thread nest)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    spans_main = sorted(((s, e, n) for s, e, n, th in spans_main
                         if th == main_thread), key=lambda x: (x[0], -x[1]))
    starts = [s for s, _, _ in spans_main]
    by_name: dict = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = "host"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            _, e, n = spans_main[j]
            if e >= mid and n != WINDOW:
                name = n
                break
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0)
    return {
        "labels_us": labels, "label_calls": calls, "kernels": kernels,
        "window_us": w1 - w0, "busy_us": busy_us,
        "device_ops": [[n[:80], v[1] / 1e6] for n, v in sorted(
            kernels.items(), key=lambda kv: -kv[1][1])[:top]],
        "idle_gaps": [[n, v / 1e6] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
    }
