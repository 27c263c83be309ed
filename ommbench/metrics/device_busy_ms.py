"""Device milliseconds per bake with a kernel, copy or set running: the
union of their intervals in the traced window."""
SOURCE = "device_trace"


def read(run):
    t = run.get("trace")
    if not t or not run["bakes"] or t["busy_us"] <= 0:
        return None
    return t["busy_us"] / 1e3 / run["bakes"]
