"""The 95th percentile of the latencies of the traced window's bakes,
from the call to the result on the host, in ms: the bake latency under
the profiler, where the host's speed, which swings from run to run on a
shared host, sets it."""
import statistics

SOURCE = "host_clock"


def read(run):
    lat = run["latencies_s"]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[-1] * 1e3
