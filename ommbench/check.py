"""The comparison that decides `correct`: a bake's result against the
plain reference's (`reference.finalize.bake`).

Two numbers, each with the limit 0:

  - states_wrong: micro-triangles whose state, read through the result
    (the triangle's index, then its special index or its descriptor's
    level, offset and packed bits), differs from the reference's.  A
    bake of the sample that never came, or raised, counts every
    micro-triangle it requested.
  - layout_wrong: entries of the serialized result that differ from the
    reference's: index-buffer entries, descriptors, array-data bytes,
    histogram entries and the index format; a length that differs counts
    its difference.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"states_wrong": 0, "layout_wrong": 0}


def result_arrays(res) -> dict:
    """The fields of a program's BakeResult that are compared."""
    return {
        "array_data": np.asarray(res.array_data, np.uint8).reshape(-1),
        "descs": np.asarray([(d.offset, d.subdivision_level, d.format)
                             for d in res.desc_array],
                            np.int64).reshape(-1, 3),
        "index_buffer": np.asarray(res.index_buffer).astype(np.int64),
        "index_format": int(res.index_format),
        "desc_hist": [(int(u.count), int(u.subdivision_level), int(u.format))
                      for u in res.desc_array_histogram],
        "index_hist": [(int(u.count), int(u.subdivision_level),
                        int(u.format)) for u in res.index_histogram],
    }


def _unpack(data: np.ndarray, off: int, m: int):
    """m 2-bit states at byte `off`, or None past the end."""
    n = max(m // 4, 1)
    if off < 0 or off + n > len(data):
        return None
    b = data[off:off + n]
    return ((b[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3) \
        .reshape(-1)[:m].astype(np.uint8)


def requested(ref: dict) -> int:
    """Micro-triangles the reference classified (over triangles with an
    item)."""
    return sum(len(s) for s in ref["tri_states"] if s is not None)


def _diff_len(a, b) -> int:
    n = min(len(a), len(b))
    return int(np.count_nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))) \
        + abs(len(a) - len(b))


def compare(ref: dict, got: dict) -> dict:
    """{states_wrong, layout_wrong} of a program's result arrays `got`
    (result_arrays) against the reference's `ref`."""
    states_wrong = 0
    ib = got["index_buffer"]
    descs = got["descs"]
    data = got["array_data"]
    for t, want in enumerate(ref["tri_states"]):
        if want is None:
            continue
        m = len(want)
        level = int(ref["tri_levels"][t])
        have = None
        if t < len(ib):
            i = int(ib[t])
            if -4 <= i < 0:
                have = np.full(m, -i - 1, np.uint8)
            elif 0 <= i < len(descs):
                off, lv, fmt = (int(v) for v in descs[i])
                if lv == level and fmt == 2:
                    have = _unpack(data, off, m)
        states_wrong += m if have is None \
            else int(np.count_nonzero(have != want))

    layout = _diff_len(ib, ref["index_buffer"])
    layout += _diff_len(descs.reshape(-1), ref["descs"].reshape(-1))
    layout += _diff_len(data, ref["array_data"])
    for k in ("desc_hist", "index_hist"):
        layout += len(set(got[k]) ^ set(ref[k]))
    layout += int(got["index_format"] != ref["index_format"])
    return {"states_wrong": states_wrong, "layout_wrong": layout}


def missing(ref: dict) -> dict:
    """The readings of a bake of the sample that never came."""
    return {"states_wrong": requested(ref),
            "layout_wrong": len(ref["index_buffer"]) + ref["descs"].size
            + len(ref["array_data"]) + len(ref["desc_hist"])
            + len(ref["index_hist"]) + 1}
