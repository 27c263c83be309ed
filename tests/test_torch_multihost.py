"""omm_tpu_torch.parallel.multihost against omm_tpu.parallel.multihost.

The copied helpers (partition_items, _pack2/_unpack2, item_costs,
dedup_loss) are pinned to their originals; the exact farm
(classify_partition, merge_exact) and the partition farm
(bake_partition, gather_results) must write the JAX package's blobs byte
for byte, read the JAX package's, and merge to the single-process bake.
The multi-process farms run 2 and 4 worker processes joined by
torch.distributed over gloo on the CPU, each with a mesh of two CPU
slots; the workers block jax and omm_tpu from import and gather every
blob with all_gather_object."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import omm_tpu as omm  # noqa: E402
import omm_tpu_torch as ot  # noqa: E402
from omm_tpu.parallel import multihost as jmh  # noqa: E402
from omm_tpu.types import BakeFlags  # noqa: E402
from omm_tpu_torch import convert  # noqa: E402
from omm_tpu_torch.parallel import multihost as tmh  # noqa: E402

from fixtures import standard_circle  # noqa: E402
from torch_native_guard import jax_native_pinned  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _farm_fields():
    """test_multihost_procs.farm_mesh_desc as numpy fields: 16 triangles
    (8 quads) over the 32x32 circle; quads 0-3 alternate between two UV
    rects (duplicates across partitions), quads 4-7 are jittered."""
    rects = [np.array([0.1, 0.1], np.float32),
             np.array([0.45, 0.45], np.float32)]
    rng = np.random.RandomState(7)
    uvs, idxb = [], []
    for q in range(8):
        b = rects[q % 2] if q < 4 else rng.rand(2).astype(np.float32) * 0.4
        base = len(uvs)
        uvs += [b, b + [0, 0.3], b + [0.3, 0], b + [0.3, 0.3]]
        idxb += [base, base + 1, base + 2, base + 3, base + 1, base + 2]
    return dict(tex_coords=np.asarray(uvs, np.float32),
                index_buffer=np.asarray(idxb, np.uint32),
                index_count=len(idxb), max_subdivision_level=3)


def _descs(flags=0):
    """The farm descriptor in both packages, from the same arrays."""
    plane = standard_circle(32, 32)
    f = _farm_fields()
    jdesc = omm.BakeInputDesc(
        texture=omm.Texture([plane], omm.TextureFormat.FP32),
        bake_flags=BakeFlags(flags), **f)
    tdesc = convert.bake_input([plane], 1, bake_flags=flags, **f)
    return jdesc, tdesc


def _assert_same(a, b):
    a, b = convert.result_to_numpy(a), convert.result_to_numpy(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("costs,n", [
    ([4 ** 3] * 6 + [4 ** 5] * 2, 3), ([4 ** 3] * 16, 4), ([64] * 8, 2),
    ([1, 4, 16, 64, 256, 1024, 4096], 3), ([5, 5], 5), ([], 3),
    ([64] * 9, 1)])
def test_partition_items_matches_jax(costs, n):
    got = tmh.partition_items(costs, n)
    want = jmh.partition_items(costs, n)
    assert [p.process_id for p in got] == [p.process_id for p in want]
    for g, w in zip(got, want):
        assert g.item_indices.dtype == w.item_indices.dtype
        assert np.array_equal(g.item_indices, w.item_indices)


@pytest.mark.parametrize("n", [1, 3, 4, 17, 64, 4 ** 6])
def test_pack2_matches_jax(n):
    states = np.random.RandomState(n).randint(0, 4, n).astype(np.uint8)
    packed = tmh._pack2(states)
    assert np.array_equal(packed, jmh._pack2(states))
    assert np.array_equal(tmh._unpack2(packed, n), states)
    assert np.array_equal(jmh._unpack2(packed, n), states)


def test_item_costs_and_init_match_jax():
    jdesc, tdesc = _descs()
    got = tmh.item_costs(tdesc)
    assert got.dtype == np.int64
    assert np.array_equal(got, jmh.item_costs(jdesc))
    assert tmh.init_distributed() == (0, 1) == jmh.init_distributed()
    with pytest.raises(ValueError, match="coordinator"):
        tmh.init_distributed(num_processes=2, process_id=0)


def test_partition_farm_blobs_match_jax():
    """bake_partition blobs (serialized results) are byte-equal to the
    JAX package's for the same partitions, with and without a mesh of
    two CPU slots; gather_results and dedup_loss agree."""
    jdesc, tdesc = _descs()
    parts = tmh.partition_items([4 ** 3] * 16, 4)
    mesh = ot.parallel.make_mesh(["cpu"] * 2)
    blobs = [tmh.bake_partition(tdesc, p, device="cpu") for p in parts]
    want = [jmh.bake_partition(jdesc, p, backend="numpy") for p in parts]
    assert blobs == want
    assert [tmh.bake_partition(tdesc, p, device="cpu", mesh=mesh)
            for p in parts] == want
    got_r, want_r = tmh.gather_results(blobs), jmh.gather_results(want)
    for g, w in zip(got_r, want_r):
        _assert_same(g, w)
    rep, jrep = tmh.dedup_loss(got_r), jmh.dedup_loss(want_r)
    assert (rep.per_partition, rep.global_distinct, rep.loss, rep.bound) \
        == (jrep.per_partition, jrep.global_distinct, jrep.loss, jrep.bound)
    assert 0 < rep.loss <= rep.bound


def test_exact_farm_merge_inprocess():
    """test_multihost_procs.py:174: three partitions classified by
    classify_partition on the CPU (one over a mesh of two CPU slots),
    with near-duplicate detection on: each OMMFARM1 blob byte-equal to
    the JAX package's, merge_exact byte-equal to ot.bake and to the numpy
    backend, and each package's merge reads the other's blobs."""
    flags = int(BakeFlags.EnableNearDuplicateDetection)
    jdesc, tdesc = _descs(flags)
    costs = tmh.item_costs(tdesc)
    parts = tmh.partition_items(costs.tolist(), 3)
    mesh = ot.parallel.make_mesh(["cpu"] * 2)
    blobs = [tmh.classify_partition(tdesc, p, device="cpu",
                                    mesh=mesh if k == 1 else None)
             for k, p in enumerate(parts)]
    jblobs = [jmh.classify_partition(jdesc, p, backend="numpy")
              for p in parts]
    assert blobs == jblobs
    merged = tmh.merge_exact(tdesc, blobs)
    want = omm.bake(jdesc, backend="numpy")
    _assert_same(merged, want)
    _assert_same(merged, ot.bake(tdesc, device="cpu"))
    _assert_same(jmh.merge_exact(jdesc, blobs), want)
    _assert_same(tmh.merge_exact(tdesc, jblobs), want)
    with pytest.raises(ValueError, match="missing states"):
        tmh.merge_exact(tdesc, blobs[:-1])
    with pytest.raises(ValueError, match="not an exact-farm"):
        tmh.merge_exact(tdesc, [b"OMMFARM0" + blobs[0][8:]])


_WORKER = r"""
import importlib.abc
import os
import sys

BLOCKED = ("jax", "jaxlib", "omm_tpu")


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, NoJax())
sys.path.insert(0, %r)
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from omm_tpu_torch import convert
from omm_tpu_torch.parallel import multihost as mh, shard

rank, n, coord, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
assert mh.init_distributed(coord, n, rank) == (rank, n)
a = np.load(os.path.join(outdir, "farm.npz"))
desc = convert.bake_input([a["plane"]], 1, tex_coords=a["tex_coords"],
                          index_buffer=a["index_buffer"],
                          index_count=int(a["index_count"]),
                          max_subdivision_level=3)
mesh = shard.make_mesh(["cpu", "cpu"])
parts_x = mh.partition_items(mh.item_costs(desc).tolist(), n)
xblob = mh.classify_partition(desc, parts_x[rank], device="cpu", mesh=mesh)
parts = mh.partition_items([4 ** 3] * (desc.index_count // 3), n)
blob = mh.bake_partition(desc, parts[rank], device="cpu", mesh=mesh)
got = [None] * n
dist.all_gather_object(got, (xblob, blob))
assert got[rank] == (xblob, blob)
if rank == 0:
    for k, (x, b) in enumerate(got):
        with open(os.path.join(outdir, f"xblob{k}.bin"), "wb") as f:
            f.write(x)
        with open(os.path.join(outdir, f"blob{k}.bin"), "wb") as f:
            f.write(b)
dist.destroy_process_group()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK", rank)
""" % REPO


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_process_farm(n, tmp_path):
    """test_multihost_procs.py:206/:289 on torch.distributed: n processes
    over gloo, each with a mesh of two CPU slots, classify and bake their
    partitions; the gathered blobs are byte-equal to the JAX package's,
    merge_exact equals ot.bake and the numpy backend, and the partition
    farm's dedup loss stays within its bound."""
    jdesc, tdesc = _descs()
    f = _farm_fields()
    np.savez(tmp_path / "farm.npz", plane=standard_circle(32, 32),
             tex_coords=f["tex_coords"], index_buffer=f["index_buffer"],
             index_count=f["index_count"])
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n), coord, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, out[-3000:]

    xblobs = [(tmp_path / f"xblob{k}.bin").read_bytes() for k in range(n)]
    blobs = [(tmp_path / f"blob{k}.bin").read_bytes() for k in range(n)]
    parts_x = jmh.partition_items(jmh.item_costs(jdesc).tolist(), n)
    parts = jmh.partition_items([4 ** 3] * 16, n)
    assert xblobs == [jmh.classify_partition(jdesc, p, backend="numpy")
                      for p in parts_x]
    assert blobs == [jmh.bake_partition(jdesc, p, backend="numpy")
                     for p in parts]
    want = omm.bake(jdesc, backend="numpy")
    merged = tmh.merge_exact(tdesc, xblobs)
    _assert_same(merged, want)
    _assert_same(merged, ot.bake(tdesc, device="cpu"))
    report = tmh.dedup_loss(tmh.gather_results(blobs))
    jreport = jmh.dedup_loss(jmh.gather_results(blobs))
    assert (report.per_partition, report.global_distinct) == (
        jreport.per_partition, jreport.global_distinct)
    assert report.global_distinct == len(want.desc_array)
    # the repeated rects of quads 0-3 fall in different partitions of 4
    assert (0 < report.loss if n == 4 else 0 <= report.loss)
    assert report.loss <= report.bound
    assert tmh.dedup_loss([merged]).loss == 0
