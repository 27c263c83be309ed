"""Headless viewer: load, tweak, re-bake, render.

The port's copy of `omm_tpu/viewer.py`; its re-bakes run on the CUDA
card unless the session is given device="cpu".  The reference ships a
Donut/ImGui GUI viewer (`tools/viewer/viewer_app.cpp`) that loads
serialized `.bin` blobs (:584-593), re-bakes with interactively
tweakable `BakeInputDesc` parameters (reset-able widget per field,
:1114-1216) and renders macro/micro triangles with state colors, zoom to
micro-triangle level and OMM-reuse highlighting.  A bake host or a
card's machine reached over SSH has no display; this module is the
headless equivalent: a `ViewerSession` drives the same load -> tweak ->
re-bake -> render loop programmatically or from the CLI
(`python -m omm_tpu_torch.cli viewer ...`), writing PNG frames instead
of swapchain images.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import debug, serialize as ser
from .bake import bake
from .stats import get_stats
from .types import (BakeInputDesc, BakeResult, Format,
                    UnknownStatePromotion)

# The parameter set the reference viewer exposes as tweakable widgets
# (viewer_app.cpp:1114-1216).
TWEAKABLE = (
    "alpha_cutoff", "format", "max_subdivision_level",
    "dynamic_subdivision_scale", "unknown_state_promotion", "bake_flags",
    "alpha_cutoff_greater", "alpha_cutoff_less_equal",
    "near_duplicate_deduplication_factor", "max_workload_size",
    "max_array_data_size", "rejection_threshold",
)

_ENUM_FIELDS = {
    "format": Format,
    "unknown_state_promotion": UnknownStatePromotion,
}


def _pick_score(uv_tri: np.ndarray, uv, ids: np.ndarray,
                level: int) -> np.ndarray:
    """Interior score of point `uv` against micro-triangles `ids` at
    `level`: min orientation-normalized signed edge distance (>= 0
    strictly inside)."""
    from . import bird

    p = np.asarray(uv, np.float64)
    tris = bird.micro_triangle_uvs(
        np.asarray(uv_tri, np.float32), ids.astype(np.uint32),
        level).astype(np.float64)  # (N, 3, 2)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]

    def edge(p0, p1):
        return ((p1[:, 0] - p0[:, 0]) * (p[1] - p0[:, 1])
                - (p1[:, 1] - p0[:, 1]) * (p[0] - p0[:, 0]))

    e = np.stack([edge(a, b), edge(b, c), edge(c, a)])
    area2 = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
             - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    sgn = np.where(area2 < 0, -1.0, 1.0)
    return (e * sgn).min(axis=0)


def uv_to_micro_index(uv_tri: np.ndarray, uv, level: int) -> int:
    """Micro-triangle (bird curve) index containing a UV point inside the
    primitive — the pick half of the viewer's zoom-to-micro-triangle
    interaction.  Descends the bird hierarchy: curve index g at level l
    covers micro-triangles [g*4^(L-l), (g+1)*4^(L-l)) at level L
    (bird.h:57-118 recursion), so 4 interior tests per level find the
    cell in O(level) — no 4^level materialization.  Edge/vertex points
    resolve to the most-interior adjacent cell."""
    g = 0
    for lv in range(1, level + 1):
        kids = np.arange(4 * g, 4 * g + 4, dtype=np.uint32)
        g = int(kids[np.argmax(_pick_score(uv_tri, uv, kids, lv))])
    return g


class ViewerSession:
    """Load a serialized blob and iterate on its bake parameters."""

    def __init__(self, blob: bytes | str, device="cuda"):
        if isinstance(blob, str):
            blob = open(blob, "rb").read()
        self._deser = ser.deserialize(blob)
        if not self._deser.input_descs:
            raise ValueError("viewer needs a blob with input descs "
                             "(serialize with SerializeFlags from inputs)")
        self.device = device
        self.desc: BakeInputDesc = self._deser.input_descs[0]
        self._initial = {k: getattr(self.desc, k) for k in TWEAKABLE}
        self.result: Optional[BakeResult] = (
            self._deser.result_descs[0] if self._deser.result_descs else None)
        self._dirty = self.result is None

    # -- parameter widgets -------------------------------------------------
    def params(self) -> dict:
        """Current tweakable parameters (the viewer's widget state)."""
        return {k: getattr(self.desc, k) for k in TWEAKABLE}

    def set_param(self, name: str, value):
        """Set one tweakable parameter (marks the bake dirty)."""
        if name not in TWEAKABLE:
            raise KeyError(f"not a tweakable parameter: {name}")
        if name in _ENUM_FIELDS and not isinstance(value, _ENUM_FIELDS[name]):
            enum = _ENUM_FIELDS[name]
            value = enum[value] if isinstance(value, str) else enum(value)
        elif isinstance(getattr(self.desc, name), float):
            value = float(value)
        elif isinstance(getattr(self.desc, name), int) \
                and not isinstance(value, bool):
            value = int(value)
        setattr(self.desc, name, value)
        self._dirty = True

    def reset_param(self, name: str):
        """Per-widget reset arrow (viewer_app.cpp's reset-able widgets)."""
        self.set_param(name, self._initial[name])

    def reset_all(self):
        for k in TWEAKABLE:
            self.reset_param(k)

    # -- bake / render / inspect -------------------------------------------
    def rebake(self) -> BakeResult:
        self.result = bake(self.desc, device=self.device)
        self._dirty = False
        return self.result

    def _ensure_result(self) -> BakeResult:
        if self.result is None or self._dirty:
            self.rebake()
        return self.result

    def render(self, scale: int = 5, monochrome_unknowns: bool = False,
               highlight_reuse: bool = True) -> np.ndarray:
        """Full-texture state overlay (RGB float array)."""
        return debug.render_overlay(
            self.desc, self._ensure_result(), scale=scale,
            monochrome_unknowns=monochrome_unknowns,
            highlight_reuse=highlight_reuse)

    def zoom(self, primitive: int, scale: int = 12) -> np.ndarray:
        """Micro-triangle-level view of one primitive (the viewer's zoom)."""
        res = self._ensure_result()
        d = debug._single_prim_desc(self.desc, primitive)
        r = debug._single_prim_result(res, primitive)
        return debug.render_overlay(d, r, scale=scale)

    def stats(self):
        return get_stats(self._ensure_result())

    # -- inspection / reuse browsing ---------------------------------------
    def reuse_groups(self) -> list[tuple[int, list[int]]]:
        """OMM-reuse browser (the viewer's reuse highlighting,
        viewer_app.cpp reuse coloring): (desc index, primitives sharing
        it), most-reused first.  Special-index primitives are excluded
        (they reference no desc)."""
        res = self._ensure_result()
        groups: dict[int, list[int]] = {}
        for prim in range(res.index_count):
            v = int(res.index_buffer[prim])
            if v >= 0:
                groups.setdefault(v, []).append(prim)
        return sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0]))

    def inspect(self, primitive: int, micro: Optional[int] = None,
                uv: Optional[tuple] = None) -> dict:
        """Zoom-to-micro-triangle inspection: primitive-level info (desc
        index / special index, level, format, reuse partners), plus one
        micro-triangle's bird index, state, and UV corners when `micro`
        or a (u, v) point inside the primitive is given."""
        from . import bird, geom
        from .stats import decode_states
        from .types import OpacityState, SpecialIndex
        res = self._ensure_result()
        if not (0 <= primitive < res.index_count):
            raise IndexError(f"primitive {primitive} out of range "
                             f"(index_count={res.index_count})")
        v = int(res.index_buffer[primitive])
        tc = geom.triangles_from_indices(
            np.asarray(self.desc.index_buffer)[:self.desc.index_count],
            self.desc.tex_coords, self.desc.tex_coord_format,
            self.desc.tex_coord_stride_in_bytes)[primitive]
        out = {"primitive": primitive, "uv_tri": tc}
        if v < 0:
            out["special_index"] = SpecialIndex(v).name
            out["state"] = OpacityState(-v - 1).name
            return out
        d = res.desc_array[v]
        out.update(desc_index=v, subdivision_level=d.subdivision_level,
                   format=Format(d.format).name,
                   reused_by=[p for p in range(res.index_count)
                              if int(res.index_buffer[p]) == v])
        if micro is None and uv is not None:
            micro = uv_to_micro_index(tc, uv, d.subdivision_level)
        if micro is not None:
            M = 4 ** d.subdivision_level
            if not (0 <= micro < M):
                raise IndexError(f"micro index {micro} out of range ({M})")
            states = decode_states(res.array_data, d.offset,
                                   d.subdivision_level, d.format)
            out.update(
                micro_index=micro,
                micro_state=OpacityState(int(states[micro])).name,
                micro_uv=bird.micro_triangle_uvs(
                    tc, np.asarray([micro], np.uint32),
                    d.subdivision_level)[0])
        return out

    def save_png(self, path: str, **render_kw) -> str:
        img = self.render(**render_kw)
        debug._write_png(path, img)
        return path

    def save_blob(self, path: str, compress: bool = True) -> str:
        """Persist the tweaked inputs + current result as a new blob."""
        res = self._ensure_result()
        d = ser.DeserializedDesc(
            flags=(ser.SerializeFlags.COMPRESS if compress
                   else ser.SerializeFlags.NONE),
            input_descs=[self.desc], result_descs=[res])
        blob = ser.serialize(d)
        with open(path, "wb") as f:
            f.write(blob)
        return path
