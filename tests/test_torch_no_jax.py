"""omm_tpu_torch runs without jax.

A subprocess installs an import hook that makes every `import jax`
raise, then bakes a small fast-path descriptor on the CPU through
omm_tpu_torch.bake; the bake must succeed and jax must never enter
sys.modules.  This cannot be checked in-process: tests/conftest.py
imports jax."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc
import sys


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked in this process")
        return None


sys.meta_path.insert(0, NoJax())
sys.path.insert(0, %r)
import numpy as np
import torch
torch.set_num_threads(2)
import omm_tpu as omm
import omm_tpu_torch as ot

j, i = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
alpha = (np.hypot(i - 64, j - 64) < 40).astype(np.float32)
tex = omm.Texture([alpha], omm.TextureFormat.FP32)
tc = np.array([[0.05, 0.1], [0.1, 0.7], [0.7, 0.65],
               [0.2, 0.15], [0.25, 0.8], [0.85, 0.7]], np.float32)
desc = omm.BakeInputDesc(texture=tex, tex_coords=tc,
                         index_buffer=np.arange(6, dtype=np.uint32),
                         index_count=6, alpha_cutoff=0.5,
                         max_subdivision_level=5,
                         dynamic_subdivision_scale=0.0)
res = ot.bake(desc, device="cpu")
assert len(res.desc_array) == 2, res.desc_array
assert ot.launches() == {"exact_classify": 0}
assert "jax" not in sys.modules
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print("OK")
""" % (REPO,)


def test_port_bakes_without_jax():
    p = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("OK"), p.stdout
