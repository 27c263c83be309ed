"""Plain reference of a bake's result: from the inputs to the serialized
arrays, as the reference SDK's bakers lay them out.

`bake` works out, for the CPU baker (bake_cpu_impl.cpp, BakeImpl) or
the GPU baker (bake_gpu_impl.cpp with its DescPatch and IndexWrite
passes), each triangle's level (`levels`), its micro-triangle states
(`classify`), the work items (triangles with equal UVs and level share
one), the special indices of uniform items, the merges of items with
equal states (the CPU baker only), the usage histograms, the spatial
sort, the packed array data, the descriptor array and the index
buffer.  Plain numpy and PyTorch; it reads nothing the program made.
It covers the configurations' flags: the default bake flags, no
near-duplicate merges and no array-size budget.
"""
from __future__ import annotations

import numpy as np
import torch

from . import classify, levels as levels_mod

MAX_LEVELS = 13
FULLY_UNKNOWN_OPAQUE = -4


def _morton(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """xy_to_morton (bit_tricks.h:40-64, 147-150): x in the even bits."""
    x = x.astype(np.uint64) & np.uint64(0xFFFF)
    y = y.astype(np.uint64) & np.uint64(0xFFFF)
    for s, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                 (1, 0x55555555)):
        x = (x | (x << np.uint64(s))) & np.uint64(m)
        y = (y | (y << np.uint64(s))) & np.uint64(m)
    return x | (y << np.uint64(1))


def spatial_order(uv_tris: np.ndarray, item_levels: np.ndarray,
                  special: np.ndarray) -> np.ndarray:
    """MicromapSpatialSort (bake_cpu_impl.cpp:1707-1754): items in
    descending (key, index) order, where a special item's key is
    2^63 | index and a regular item's is level << 60 | the Morton code of
    its centroid on a 2^13 grid under MirrorOnce addressing."""
    n = len(uv_tris)
    keys = np.zeros(n, np.uint64)
    idx = np.arange(n, dtype=np.uint64)
    keys[special] = (np.uint64(1) << np.uint64(63)) | idx[special]
    reg = ~special
    if reg.any():
        t = uv_tris[reg].astype(np.float32)
        centroid = ((t[:, 0] + t[:, 1]) + t[:, 2]) / np.float32(3.0)
        q = (np.float32(1 << 13) * centroid).astype(np.int32)
        q = np.abs(q.astype(np.float32) + np.float32(0.5)).astype(np.int32)
        q = np.clip(q, 0, (1 << 13) - 1)
        code = _morton(q[:, 0], q[:, 1])
        keys[reg] = (item_levels[reg].astype(np.uint64)
                     << np.uint64(60)) | code
    return np.lexsort((np.arange(n), keys))[::-1]


def pack_rows(states: torch.Tensor) -> torch.Tensor:
    """(T, M) 2-bit states -> (T, max(M/4, 1)) bytes, state j at bits
    2*(j % 4) of byte j // 4 (OC1_4_State, bake_cpu_impl.cpp:1802-1819)."""
    t, m = states.shape
    s = states.to(torch.int32)
    if m < 4:
        s = torch.nn.functional.pad(s, (0, 4 - m))
    s = s.reshape(t, -1, 4)
    b = s[..., 0] | (s[..., 1] << 2) | (s[..., 2] << 4) | (s[..., 3] << 6)
    return b.to(torch.uint8)


def bake(plane: torch.Tensor, uv_tris: np.ndarray, desc: dict,
         baker: str = "cpu") -> dict:
    """The reference's result of one bake.

    plane: the (h, w) fp32 alpha plane on the device that computes.
    uv_tris: (T, 3, 2) fp32 triangles of the index buffer.
    desc: the configuration's descriptor (alpha_cutoff, format,
    unknown_state_promotion, alpha_cutoff_greater,
    alpha_cutoff_less_equal, max_subdivision_level,
    dynamic_subdivision_scale).
    baker: "cpu" (ommCpuBake) or "gpu" (the GPU baker's dispatch).

    Returns {"tri_levels", "tri_states" (per triangle, the uint8 states
    its index points at, or None), "array_data", "descs" ((n, 3):
    offset, level, format), "index_buffer", "index_format", "desc_hist",
    "index_hist"}."""
    fmt = int(desc.get("format", 2))
    if fmt != 2:
        raise ValueError("the reference lays out OC1_4_State only")
    h, w = plane.shape
    uv_tris = np.asarray(uv_tris, np.float32).reshape(-1, 3, 2)
    T = len(uv_tris)
    tri_lv = levels_mod.levels(uv_tris, (w, h),
                               float(desc["dynamic_subdivision_scale"]),
                               int(desc["max_subdivision_level"]))
    if levels_mod.degenerate(uv_tris).any():
        raise ValueError("the reference classifies no degenerate triangle")
    finite = np.isfinite(uv_tris).all(axis=(1, 2))

    # work items: the first triangle of each (UVs, level) owns the item
    owner: dict = {}
    item_of = np.full(T, -1, np.int64)
    first = []
    for t in range(T):
        if not finite[t]:
            continue
        key = (uv_tris[t].tobytes(), int(tri_lv[t]))
        i = owner.get(key)
        if i is None:
            i = owner[key] = len(first)
            first.append(t)
        item_of[t] = i
    first = np.asarray(first, np.int64)
    n = len(first)
    item_lv = tri_lv[first] if n else np.zeros(0, np.int64)

    state_kw = {"promotion": int(desc.get("unknown_state_promotion", 1)),
                "cutoff_gt": int(desc.get("alpha_cutoff_greater", 1)),
                "cutoff_le": int(desc.get("alpha_cutoff_less_equal", 0))}
    dev = plane.device
    rows: list = [None] * n
    uniform = np.full(n, -1, np.int64)
    for lv in sorted(set(int(v) for v in item_lv)):
        sel = np.flatnonzero(item_lv == lv)
        tr = torch.from_numpy(uv_tris[first[sel]]).to(dev)
        st = classify.classify(plane, tr, lv, float(desc["alpha_cutoff"]),
                               **state_kw)
        lo = st.min(dim=1).values
        hi = st.max(dim=1).values
        uni = torch.where(lo == hi, lo.to(torch.int64),
                          torch.full_like(lo, -1, dtype=torch.int64))
        uniform[sel] = uni.cpu().numpy()
        host = st.cpu().numpy()
        for k, i in enumerate(sel):
            rows[i] = host[k]

    # special indices: an item of one state is that state's special index
    # (the CPU baker's promotion and the GPU baker's DescPatch)
    special_idx = np.where(uniform >= 0, -uniform - 1, 0)
    if baker == "cpu":
        # equal states (with UnknownTransparent read as UnknownOpaque)
        # merge into the first item that has them
        alias = np.arange(n)
        seen: dict = {}
        for i in range(n):
            s3 = np.where(rows[i] == 2, np.uint8(3), rows[i])
            j = seen.setdefault(s3.tobytes(), i)
            alias[i] = j
        live = alias == np.arange(n)
    else:
        alias = np.arange(n)
        live = np.ones(n, bool)
    special = special_idx != 0

    # histograms over the live regular items (format 2 row)
    reg = live & ~special
    desc_hist = np.zeros(MAX_LEVELS, np.int64)
    index_hist = np.zeros(MAX_LEVELS, np.int64)
    prims = np.bincount(alias[item_of[item_of >= 0]], minlength=n)
    for i in np.flatnonzero(reg):
        desc_hist[item_lv[i]] += 1
        index_hist[item_lv[i]] += prims[i]

    # the spatial sort runs over every item (merged ones are special
    # there: the CPU baker marks a merged item's special index -1)
    special_sort = special | ~live
    order = spatial_order(uv_tris[first], item_lv, special_sort)
    descs = []
    desc_of = np.full(n, -1, np.int64)
    chunks = []
    offset = 0
    for i in order:
        if special_sort[i]:
            continue
        m = 1 << (2 * int(item_lv[i]))
        stride = max(m // 4, 1)
        desc_of[i] = len(descs)
        descs.append((offset, int(item_lv[i]), fmt))
        chunks.append(rows[i])
        offset += stride
    array_data = np.zeros(offset, np.uint8)
    pos = 0
    for st in chunks:
        packed = pack_rows(torch.from_numpy(st)[None]).numpy()[0]
        array_data[pos:pos + len(packed)] = packed
        pos += len(packed)

    index_buffer = np.full(T, FULLY_UNKNOWN_OPAQUE, np.int32)
    for t in range(T):
        i = item_of[t]
        if i < 0:
            continue
        j = alias[i]
        index_buffer[t] = special_idx[j] if special[j] else desc_of[j]
    index_format = 0 if T <= 32767 else 1  # UINT_16, else UINT_32

    def hist_list(hist):
        return [(int(c), lv, fmt) for lv, c in enumerate(hist) if c]

    return {"tri_levels": tri_lv,
            "tri_states": [rows[alias[item_of[t]]] if item_of[t] >= 0
                           else None for t in range(T)],
            "array_data": array_data,
            "descs": np.asarray(descs, np.int64).reshape(-1, 3),
            "index_buffer": index_buffer, "index_format": index_format,
            "desc_hist": hist_list(desc_hist),
            "index_hist": hist_list(index_hist)}
