"""The benchmark of omm_tpu_torch on one CUDA card: `python3 -m
ommbench.run --workload <config>.<traffic> --seed N --seconds S --trace
0|1` (see `run`).  It imports the port and nothing of the JAX package."""
