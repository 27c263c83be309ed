"""Share of the traced window in which nothing ran on the device, in %."""
SOURCE = "device_trace"


def read(run):
    t = run.get("trace")
    if not t or t["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])
