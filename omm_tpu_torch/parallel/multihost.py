"""Multi-process bake farm on torch.distributed.

Counterpart of `omm_tpu/parallel/multihost.py`, with the same names and
blobs.  The farm partitions at the WORK-ITEM level: each process owns a
contiguous range of the morton-sorted item order (`partition_items`),
classifies or bakes it on its own device (optionally split over a local
`shard.make_mesh` mesh), and only bytes travel between processes:

  * the exact farm: `classify_partition` returns an `OMMFARM1` blob of
    packed 2-bit states; `merge_exact` gathers every process's blob into
    the global item list and replays the global tail, so the merged
    result is byte-equal to `bake(desc)`;
  * the partition farm: `bake_partition` bakes a process's sub-mesh and
    returns a serialized result blob (`serialize`); `gather_results`
    reads them back and `dedup_loss` accounts what per-partition dedup
    lost.

The blobs are byte-equal to the JAX package's, so either package's
`merge_exact` and `gather_results` read the other's.  `init_distributed`
joins the processes over gloo; how the blobs travel (a
`torch.distributed.all_gather_object`, files, an object store) is the
caller's.  On one process everything degenerates to a single partition.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> tuple[int, int]:
    """Join the farm's process group; returns (rank, world size).  One
    process (num_processes None or 1) gets (0, 1) without touching
    torch.distributed.  Otherwise every process passes the same
    coordinator_address ("host:port" of rank 0) and num_processes, and
    its own process_id.  The backend is gloo: the farm moves host bytes,
    and NCCL refuses two ranks on one GPU."""
    if num_processes is None or num_processes <= 1:
        return 0, 1
    if coordinator_address is None:
        raise ValueError("init_distributed needs the coordinator's "
                         "host:port for more than one process")
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


@dataclass
class Partition:
    """One process's slice of a bake: work-item indices it owns."""

    process_id: int
    item_indices: np.ndarray  # int64, indices into the global item list


def partition_items(costs: Sequence[int], num_processes: int) -> list[Partition]:
    """Deterministic balanced partition of work items by classification
    cost (4^subdiv per item): contiguous ranges over the given order so
    each process's set stays spatially coherent (items arrive
    morton-sorted from the bake pipeline).  Greedy prefix splitting at
    equal-cost boundaries: every process computes the identical
    partition."""
    costs = np.asarray(costs, dtype=np.int64)
    n = len(costs)
    if num_processes <= 1 or n == 0:
        return [Partition(0, np.arange(n, dtype=np.int64))]
    cum = np.cumsum(costs)
    total = int(cum[-1])
    bounds = [0]
    for p in range(1, num_processes):
        target = total * p // num_processes
        bounds.append(int(np.searchsorted(cum, target, side="left") + 1))
    bounds.append(n)
    bounds = np.clip(np.asarray(bounds), 0, n)
    out = []
    for p in range(num_processes):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        out.append(Partition(p, np.arange(lo, max(hi, lo), dtype=np.int64)))
    return out


def bake_partition(desc, partition: Partition, device="cuda", logger=None,
                   mesh=None) -> bytes:
    """Bake only this process's triangles of `desc` on `device` (or over
    `mesh`, a mesh of this process's devices) and return the serialized
    result blob.  The partition is per TRIANGLE: the process bakes the
    sub-mesh of its triangles over the full texture, so dedup runs within
    the partition."""
    from .. import serialize as ser
    from ..bake import bake
    from ..types import BakeInputDesc

    idx = np.asarray(desc.index_buffer)[:desc.index_count].reshape(-1, 3)
    mine = idx[np.asarray(partition.item_indices)]
    sub = BakeInputDesc(**{**desc.__dict__,
                           "index_buffer": mine.reshape(-1),
                           "index_count": mine.size})
    result = bake(sub, device=device, logger=logger, mesh=mesh)
    d = ser.DeserializedDesc(flags=ser.SerializeFlags.COMPRESS,
                             result_descs=[result])
    return ser.serialize(d)


def item_costs(desc) -> np.ndarray:
    """Per-WORK-ITEM classification costs (4^subdiv) of the global desc,
    the exact farm's partitioning key.  Every process derives the
    identical item list (setup_work_items is deterministic), so costs,
    and therefore partitions, agree farm-wide without communication."""
    from ..bake import Options, setup_work_items
    from ..log import Logger
    from ..types import get_num_micro_triangles

    opts = Options.from_flags(desc.bake_flags)
    items = setup_work_items(desc, opts, Logger())
    return np.array([get_num_micro_triangles(it.subdivision_level)
                     for it in items], np.int64)


_FARM_MAGIC = b"OMMFARM1"


def _pack2(states: np.ndarray) -> np.ndarray:
    """Pack 2-bit opacity states (values 0..3) four per byte: the wire
    form of one work item's classification."""
    s = np.asarray(states, np.uint8)
    pad = (-len(s)) % 4
    if pad:
        s = np.concatenate([s, np.zeros(pad, np.uint8)])
    q = s.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).astype(np.uint8)


def _unpack2(packed: np.ndarray, n: int) -> np.ndarray:
    q = np.asarray(packed, np.uint8)
    out = np.empty((len(q), 4), np.uint8)
    out[:, 0] = q & 3
    out[:, 1] = (q >> 2) & 3
    out[:, 2] = (q >> 4) & 3
    out[:, 3] = q >> 6
    return out.reshape(-1)[:n]


def _global_items(desc, log):
    """(options, the global work-item list) of `desc`, validated."""
    from ..bake import (Options, setup_work_items, validate_desc,
                        validate_workload_size)

    opts = Options.from_flags(desc.bake_flags)
    validate_desc(desc, opts, log)
    items = setup_work_items(desc, opts, log)
    validate_workload_size(desc, opts, items, log)
    return opts, items


def classify_partition(desc, partition: Partition, device="cuda",
                       logger=None, mesh=None) -> bytes:
    """Exact-farm worker step: classify ONLY this process's work items of
    the GLOBAL desc on `device` (or over `mesh`) and return the packed
    states blob that travels between processes.  Every process derives
    the identical global work-item list; `merge_exact` replays the
    global tail, so the merged output is byte-equal to `bake(desc)`
    (the reference's global dedup, bake_cpu_impl.cpp:1031-1066)."""
    from ..bake import classify_items
    from ..log import Logger

    opts, items = _global_items(desc, logger or Logger())
    own = np.asarray(partition.item_indices, np.int64)
    sel = np.zeros(len(items), bool)
    sel[own] = True
    classify_items(desc, opts, items, device, mesh=mesh, sel=sel)

    parts = [_FARM_MAGIC, struct.pack("<II", len(items), len(own))]
    for i in own:
        st = np.asarray(items[int(i)].states, np.uint8)
        parts.append(struct.pack("<II", int(i), len(st)))
        parts.append(_pack2(st).tobytes())
    return b"".join(parts)


def merge_exact(desc, blobs: Sequence[bytes], allocator=None):
    """Exact-farm merge: gather every partition's packed states into the
    global work-item list and run the single-process global tail (dedup,
    near-duplicate merges, compression, histograms, spatial sort,
    serialization): the result is byte-equal to `bake(desc)`.
    Deterministic, so every process may run it, or one coordinator."""
    from ..bake import finalize_items
    from ..log import Logger

    opts, items = _global_items(desc, Logger())
    covered = np.zeros(len(items), bool)
    for blob in blobs:
        if blob[:8] != _FARM_MAGIC:
            raise ValueError("not an exact-farm states blob")
        total, count = struct.unpack_from("<II", blob, 8)
        if total != len(items):
            raise ValueError(
                f"farm blob disagrees on work-item count: {total} != "
                f"{len(items)} (desc mismatch across processes?)")
        off = 16
        for _ in range(count):
            i, n = struct.unpack_from("<II", blob, off)
            off += 8
            nbytes = (n + 3) // 4
            st = _unpack2(np.frombuffer(blob, np.uint8, nbytes, off), n)
            off += nbytes
            if len(items[i].states) != n:
                raise ValueError(f"farm blob item {i}: {n} states, "
                                 f"expected {len(items[i].states)}")
            items[i].states = st.copy()
            covered[i] = True
    if not covered.all():
        missing = np.flatnonzero(~covered)
        raise ValueError(f"exact-farm merge is missing states for "
                         f"{len(missing)} work items (first: "
                         f"{missing[:8].tolist()})")
    return finalize_items(desc, opts, items, allocator=allocator)


def gather_results(blobs: Sequence[bytes]):
    """Each process's serialized result blob read back into its
    BakeResult."""
    from .. import serialize as ser

    return [ser.deserialize(b).result_descs[0] for b in blobs]


@dataclass
class DedupLossReport:
    """Cross-partition deduplication accounting.

    `per_partition` is each partition's distinct-OMM count (its desc
    array length); `global_distinct` the number of distinct OMM
    identities (subdivision level, format, bit-block bytes) across the
    whole farm; `loss` the extra OMM descs the farm stores because dedup
    ran per partition instead of globally:

        loss = sum(per_partition) - global_distinct  >= 0

    Bound (exact dedup, i.e. near-duplicate merge disabled): every
    partition's distinct set is a subset of the global distinct set, so

        loss <= (num_partitions - 1) * global_distinct

    with equality only when every OMM appears in every partition.
    Near-duplicate merging voids the subset property, so the bound holds
    only for exact-dedup farms."""

    per_partition: list[int]
    global_distinct: int

    @property
    def loss(self) -> int:
        return sum(self.per_partition) - self.global_distinct

    @property
    def bound(self) -> int:
        return (len(self.per_partition) - 1) * self.global_distinct


def _omm_identities(result) -> set:
    """Distinct OMM identities of one BakeResult: (level, format, bit
    block bytes); block size = max(4^level * bits_per_state / 8, 1)
    (bake_cpu_impl.cpp:1131-1188)."""
    from ..types import Format, get_num_micro_triangles

    data = np.asarray(result.array_data)
    out = set()
    for d in result.desc_array:
        bits = 1 if d.format == int(Format.OC1_2_State) else 2
        size = max((get_num_micro_triangles(d.subdivision_level)
                    * bits) >> 3, 1)
        out.add((d.subdivision_level, d.format,
                 data[d.offset:d.offset + size].tobytes()))
    return out


def dedup_loss(partition_results: Sequence) -> DedupLossReport:
    """Account the cross-partition dedup loss of a farm bake (see
    DedupLossReport for the definition and the exact-dedup bound)."""
    per = [len(r.desc_array) for r in partition_results]
    seen: set = set()
    for r in partition_results:
        seen |= _omm_identities(r)
    return DedupLossReport(per_partition=per, global_distinct=len(seen))
