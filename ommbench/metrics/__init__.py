"""The benchmark's metrics, one file each, found by the metric's name in
BENCHMARK.json.  Each file gives SOURCE (where its number comes from)
and `read(run)`: the value, or None where the run holds nothing for it
to read.  `run` is the harness's record of one run: "bakes" (attempted),
"failed", "latencies_s" (of the bakes that returned), "utri" (each
returned bake's micro-triangles, counted from its inputs over its
distinct triangles), "window_s",
"setup_s", "peak_bytes", "counts" (`omm_tpu_torch.pipeline_counts()`
over the window), and with --trace 1 "trace" (`trace.digest`)."""
