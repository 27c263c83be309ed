"""omm_tpu_torch runs without jax and without the JAX package.

A subprocess installs an import hook that makes every import of jax,
jaxlib or omm_tpu raise, then builds a descriptor with the port's own
types and bakes it on the CPU through omm_tpu_torch.bake, then bakes it
with the nearest filter and a line triangle through the degenerate
route, dispatches a GPU-baker chain of an RGBA texture on the CPU, and
bakes over a mesh of two CPU slots, serializes the result and merges an
exact farm of two partitions, then bakes through ot.Baker and ot.capi
and runs the CLI's bake, stats and viewer subcommands with --device cpu;
the bakes must succeed and none of the blocked modules may enter
sys.modules.  This
cannot be checked in-process: tests/conftest.py imports jax.  An AST
scan checks the same of every source file of the port and of
chip_smoke.py, including imports on paths the bake does not take."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "omm_tpu")

SCRIPT = r"""
import importlib.abc
import sys

BLOCKED = %r


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, NoJax())
sys.path.insert(0, %r)
import numpy as np
import torch
torch.set_num_threads(2)
import omm_tpu_torch as ot

j, i = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
alpha = (np.hypot(i - 64, j - 64) < 40).astype(np.float32)
tex = ot.Texture([alpha], ot.TextureFormat.FP32)
tc = np.array([[0.05, 0.1], [0.1, 0.7], [0.7, 0.65],
               [0.2, 0.15], [0.25, 0.8], [0.85, 0.7]], np.float32)
desc = ot.BakeInputDesc(texture=tex, tex_coords=tc,
                        index_buffer=np.arange(6, dtype=np.uint32),
                        index_count=6, alpha_cutoff=0.5,
                        max_subdivision_level=5,
                        dynamic_subdivision_scale=0.0)
res = ot.bake(desc, device="cpu")
assert isinstance(res, ot.BakeResult)
assert len(res.desc_array) == 2, res.desc_array
counts = ot.launches()
assert counts["exact_classify"] == 0 and counts["route.fast_path"] == 2

# the nearest filter, and a line triangle through the degenerate route
desc.runtime_sampler.filter = ot.types.TextureFilterMode.Nearest
res = ot.bake(desc, device="cpu")
assert len(res.desc_array) == 2, res.desc_array
line = np.array([[0.2, 0.0], [0.2, 0.43], [0.2, 0.21]], np.float32)
desc = ot.BakeInputDesc(texture=tex, tex_coords=line,
                        index_buffer=np.arange(3, dtype=np.uint32),
                        index_count=3, alpha_cutoff=0.5,
                        max_subdivision_level=4,
                        dynamic_subdivision_scale=0.0)
ot.bake(desc, device="cpu")
counts = ot.launches()
assert counts["route.nearest_survivors"] == 2, counts
assert counts["route.degenerate"] == 1, counts

# the GPU baker's dispatch chain, both engines
rgba = np.stack([alpha, alpha.T, 1 - alpha, alpha], axis=-1)
for flags in (3, 3 | 4 | 8):
    cfg = ot.gpu.DispatchConfigDesc(
        bake_flags=ot.gpu.GpuBakeFlags(flags),
        alpha_texture=ot.Texture([rgba], ot.TextureFormat.FP32),
        alpha_texture_channel=1, tex_coords=tc,
        index_buffer=np.arange(6, dtype=np.uint32), index_count=6,
        max_subdivision_level=4, dynamic_subdivision_scale=0.0)
    res, post = ot.gpu.Pipeline().dispatch(cfg, device="cpu").execute()
    assert post.out_omm_desc_size_in_bytes == 8 * len(res.desc_array) > 0
    assert sum(ot.get_stats(res).__dict__[k] for k in (
        "total_opaque", "total_transparent", "total_unknown_opaque",
        "total_unknown_transparent")) == 2 * 4 ** 4

# a mesh bake over two CPU slots, a serialize round trip, an exact farm
desc = ot.BakeInputDesc(texture=tex, tex_coords=tc,
                        index_buffer=np.arange(6, dtype=np.uint32),
                        index_count=6, alpha_cutoff=0.5,
                        max_subdivision_level=5,
                        dynamic_subdivision_scale=0.0)
res = ot.bake(desc, device="cpu",
              mesh=ot.parallel.make_mesh(["cpu", "cpu"]))
blob = ot.serialize.serialize(ot.serialize.DeserializedDesc(
    flags=1, input_descs=[desc], result_descs=[res]))
back = ot.serialize.deserialize(blob)
assert back.result_descs[0].desc_array == res.desc_array
from omm_tpu_torch.parallel import multihost as mh
parts = mh.partition_items(mh.item_costs(desc), 2)
merged = mh.merge_exact(desc, [mh.classify_partition(desc, p, device="cpu")
                               for p in parts])
assert (merged.array_data == res.array_data).all()

# the library surface and the CLI
import os
import tempfile
from omm_tpu_torch import cli
bk = ot.Baker()
assert (bk.bake(desc, device="cpu").array_data == res.array_data).all()
got = ot.capi.omm_cpu_bake(ot.capi.omm_create_baker(), desc, device="cpu")
assert (got.array_data == res.array_data).all()
with tempfile.TemporaryDirectory() as d:
    p = os.path.join(d, "in.bin")
    bk.save_binary_to_disk(bk.serialize(input_descs=[desc]), p)
    for argv in (["bake", "--input-blob", p, "--out",
                  os.path.join(d, "out.bin")], ["stats", p],
                 ["viewer", p, "--frame", "--frame-rows", "2",
                  "--frame-cols", "4"]):
        assert cli.main(argv + ["--device", "cpu"]) == 0, argv
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK")
""" % (BLOCKED, REPO)


def test_port_bakes_without_jax():
    p = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("OK"), p.stdout


def _sources():
    pkg = os.path.join(REPO, "omm_tpu_torch")
    out = []
    for root, _, files in os.walk(pkg):
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py", "tools/profile_torch_bake.py",
                          "tools/time_torch_bake.py"]


def _imported(tree):
    """Top-level names of every module an import statement names
    (relative imports count as the port's own)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources())
def test_source_imports_neither_jax_nor_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted({m for m in _imported(tree) if m in BLOCKED})
    assert not bad, f"{path} imports {bad}"


def test_import_scan_sees_blocked_imports():
    """The scan is not vacuous: it finds each form of import."""
    src = ("import jax.numpy as jnp\nfrom omm_tpu import bake\n"
           "def f():\n    import jaxlib\n    from . import omm_tpu\n")
    assert sorted(set(_imported(ast.parse(src)))) == ["jax", "jaxlib",
                                                      "omm_tpu"]
