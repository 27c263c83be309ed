"""The benchmark's CPU tests: `python3 -m pytest ommbench/tests -q`."""
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(os.path.dirname(HERE)), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

# one thread per test process: several pytest workers share the host
torch.set_num_threads(1)

from ommbench_cells import small_cell  # noqa: E402,F401  (a fixture)
