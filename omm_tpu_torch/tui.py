"""Interactive terminal viewer (the reference viewer tool's interactive
affordances, SSH-native).

The port's copy of `omm_tpu/tui.py`, over the port's viewer.  The
reference ships a Donut/ImGui GUI (`tools/viewer/viewer_app.cpp`):
pan/zoom over the alpha texture with per-micro-triangle state colors,
click-to-inspect, tweakable bake parameters with per-widget reset
(:1114-1216), OMM-reuse highlighting, and re-bake on change.  A card's
machine is driven over SSH, so the interactive build targets the
terminal: the same loop — pan, zoom to micro-triangle level, inspect
the cell under the crosshair, step parameters, re-bake, browse reuse
groups — rendered as half-block cells (two texture samples per
character) with the reference's state LUT (debug_impl.cpp:245-259).

Layering (so the interaction logic is testable without a terminal):

  * `TuiViewer`   — the model: viewport, crosshair, parameter cursor,
    key dispatch, message log; `frame_rgb()` returns the pixels any
    front end draws.
  * `render_ansi` — one frame as 24-bit-color ANSI half-blocks (also the
    `--frame` one-shot for docs/CI).
  * `run_curses`  — the interactive loop (curses, 256-color quantized).

Keys: arrows/hjkl pan · +/- zoom · g zoom-to-primitive · n/p cycle
primitive · i inspect crosshair · u reuse browser · tab/c parameter
cursor · [ ] step parameter · x reset parameter · R reset all ·
r re-bake · s save PNG · q quit.
"""
from __future__ import annotations

import numpy as np

from .types import Format, UnknownStatePromotion
from .viewer import TWEAKABLE, ViewerSession

# Parameter step sizes for '['/']' (the widget drag analog); enums cycle.
_STEPS = {
    "alpha_cutoff": 0.05,
    "dynamic_subdivision_scale": 0.5,
    "rejection_threshold": 0.05,
    "near_duplicate_deduplication_factor": 0.05,
    "max_subdivision_level": 1,
    "bake_flags": 1,
    "max_workload_size": 1 << 20,
    "max_array_data_size": 1 << 16,
}
from .types import OpacityState

_ENUM_CYCLES = {
    "format": [Format.OC1_2_State, Format.OC1_4_State],
    "unknown_state_promotion": list(UnknownStatePromotion),
    "alpha_cutoff_greater": list(OpacityState),
    "alpha_cutoff_less_equal": list(OpacityState),
}
# Valid domains for stepped parameters (the widget range analog): the
# status line must never display a value the bake would reject or alias.
_CLAMP = {
    "alpha_cutoff": (0.0, 1.0),
    "rejection_threshold": (0.0, 1.0),
    "near_duplicate_deduplication_factor": (0.0, 1.0),
    "max_subdivision_level": (0, 12),
}


class TuiViewer:
    """Interaction model over a ViewerSession (no terminal I/O here)."""

    def __init__(self, session: ViewerSession, auto_rebake: bool = False):
        self.s = session
        self.auto_rebake = auto_rebake
        w, h = session.desc.texture.size(0)
        self.tex_size = (w, h)
        self.center = np.array([0.5, 0.5], np.float64)   # viewport center, UV
        self.span = 1.0                                   # UV extent shown
        self.cur_prim = 0
        self.param_i = 0
        self.messages: list[str] = []
        self._overlay = None  # cached (scale, image)

    # -- rendering -----------------------------------------------------------
    def _image(self) -> np.ndarray:
        """Overlay image at a scale fitting the current zoom (cached until
        the bake or zoom bucket changes)."""
        # scale so the current window spans >= ~256 overlay samples, but
        # cap the canvas at ~128 MB (scale 8 on a 1024² texture would be
        # an 800 MB float RGB allocation)
        need = max(1, int(np.ceil(256.0 / (self.tex_size[0] * self.span))))
        w, h = self.tex_size
        cap = max(1, int(np.sqrt(128e6 / (12.0 * w * h))))
        scale = min(8, need, cap)
        from .types import BakeError
        try:
            res = self.s._ensure_result()
        except BakeError as e:
            # invalid parameter combo: keep showing the last good frame
            self._say(f"bake failed: {e}")
            if self._overlay is not None:
                return self._overlay[1]
            raise
        key = (scale, id(res))
        if self._overlay is None or self._overlay[0] != key:
            self._overlay = (key, self.s.render(scale=scale))
        return self._overlay[1]

    def frame_rgb(self, rows: int, cols: int) -> np.ndarray:
        """(2*rows, cols, 3) float RGB for half-block drawing: the
        viewport window resampled (nearest) from the overlay image."""
        img = self._image()
        H, W = img.shape[:2]
        ph, pw = 2 * rows, cols
        # window in image pixels (aspect: terminal cells are ~2:1, the
        # half-block split restores square-ish samples)
        su = self.span
        sv = self.span * ph / pw if pw else self.span
        u0, v0 = self.center[0] - su / 2, self.center[1] - sv / 2
        us = (u0 + (np.arange(pw) + 0.5) / pw * su) * W
        vs = (v0 + (np.arange(ph) + 0.5) / ph * sv) * H
        xi = np.clip(us.astype(np.int64), 0, W - 1)
        yi = np.clip(vs.astype(np.int64), 0, H - 1)
        out = img[yi][:, xi]
        # grey out samples outside [0,1]² so the texture border is visible
        oob = ((us < 0) | (us >= W))[None, :] | ((vs < 0) | (vs >= H))[:, None]
        out = np.where(oob[..., None], np.float32(0.15), out)
        return out

    def status_lines(self) -> list[str]:
        p = list(TWEAKABLE)[self.param_i]
        val = self.s.params()[p]
        if hasattr(val, "name"):
            val = val.name
        elif isinstance(val, float):
            val = f"{val:.4g}"
        dirty = "*dirty*" if self.s._dirty else "baked"
        lines = [
            f"prim {self.cur_prim}  zoom {1.0 / self.span:.1f}x  "
            f"center ({self.center[0]:.4f},{self.center[1]:.4f})  [{dirty}]",
            f"param> {p} = {val}   ([ ] step, x reset, r re-bake)",
        ]
        lines += self.messages[-3:]
        return lines

    # -- helpers -------------------------------------------------------------
    def _tris(self) -> np.ndarray:
        from . import geom
        d = self.s.desc
        return geom.triangles_from_indices(
            np.asarray(d.index_buffer)[:d.index_count], d.tex_coords,
            d.tex_coord_format, d.tex_coord_stride_in_bytes)

    def prim_at(self, uv) -> int:
        """Primitive whose UV triangle contains the point (-1 if none) —
        the bake's own containment test (geom.point_in_triangle), so
        crosshair picking never disagrees with classification."""
        from . import geom
        inside = geom.point_in_triangle(self._tris(),
                                        np.asarray(uv, np.float32))
        hits = np.flatnonzero(inside)
        return int(hits[0]) if hits.size else -1

    def zoom_to_prim(self, prim: int):
        tri_count = self.s.desc.index_count // 3
        if not (0 <= prim < tri_count):
            raise IndexError(f"primitive {prim} out of range "
                             f"(mesh has {tri_count})")
        t = self._tris()[prim].astype(np.float64)
        lo, hi = t.min(axis=0), t.max(axis=0)
        self.center = (lo + hi) / 2
        self.span = max(float((hi - lo).max()) * 1.3, 1e-4)
        self.cur_prim = prim

    def _say(self, msg: str):
        self.messages.append(msg)

    def inspect_center(self):
        prim = self.prim_at(self.center)
        if prim < 0:
            self._say("no primitive under crosshair")
            return
        from .types import BakeError
        try:
            info = self.s.inspect(prim, uv=tuple(self.center))
        except BakeError as e:
            self._say(f"bake failed: {e}")
            return
        if "special_index" in info:
            self._say(f"prim {prim}: {info['special_index']} "
                      f"({info['state']})")
        else:
            self._say(
                f"prim {prim} desc {info['desc_index']} "
                f"lvl {info['subdivision_level']} {info['format']} "
                f"µtri {info.get('micro_index')} = "
                f"{info.get('micro_state')} "
                f"(reused by {len(info['reused_by'])})")
        self.cur_prim = prim

    def show_reuse(self):
        groups = self.s.reuse_groups()[:3]
        if not groups:
            self._say("no reuse (every primitive unique/special)")
        for di, prims in groups:
            self._say(f"desc {di} reused by {len(prims)}: "
                      f"{prims[:8]}{'...' if len(prims) > 8 else ''}")

    def _step_param(self, sign: int):
        name = list(TWEAKABLE)[self.param_i]
        cur = self.s.params()[name]
        if name in _ENUM_CYCLES:
            cyc = _ENUM_CYCLES[name]
            nxt = cyc[(cyc.index(cur) + sign) % len(cyc)]
            self.s.set_param(name, nxt)
        else:
            if isinstance(cur, float):
                val = cur + sign * _STEPS.get(name, 0.1)
            else:
                val = int(cur) + sign * int(_STEPS.get(name, 1))
            lo, hi = _CLAMP.get(name, (0, None))
            val = max(lo, val) if hi is None else min(max(lo, val), hi)
            self.s.set_param(name, val)
        if self.auto_rebake:
            self._rebake()

    def _rebake(self) -> bool:
        """Re-bake, reporting failures as messages instead of tearing the
        session down (invalid parameter combos raise BakeError)."""
        from .types import BakeError
        try:
            self.s.rebake()
            return True
        except BakeError as e:
            self._say(f"bake failed: {e}")
            return False

    # -- key dispatch ----------------------------------------------------------
    def handle_key(self, key: str) -> bool:
        """Apply one key; returns False when the session should end."""
        pan = 0.15 * self.span
        tri_count = self.s.desc.index_count // 3
        if key in ("q", "Q"):
            return False
        elif key in ("KEY_LEFT", "h"):
            self.center[0] -= pan
        elif key in ("KEY_RIGHT", "l"):
            self.center[0] += pan
        elif key in ("KEY_UP", "k"):
            self.center[1] -= pan
        elif key in ("KEY_DOWN", "j"):
            self.center[1] += pan
        elif key in ("+", "="):
            self.span = max(self.span / 1.5, 1e-4)
        elif key in ("-", "_"):
            self.span = min(self.span * 1.5, 4.0)
        elif key == "g":
            self.zoom_to_prim(self.cur_prim)
        elif key == "n":
            self.cur_prim = (self.cur_prim + 1) % max(tri_count, 1)
            self.zoom_to_prim(self.cur_prim)
        elif key == "p":
            self.cur_prim = (self.cur_prim - 1) % max(tri_count, 1)
            self.zoom_to_prim(self.cur_prim)
        elif key == "i":
            self.inspect_center()
        elif key == "u":
            self.show_reuse()
        elif key in ("\t", "c"):
            self.param_i = (self.param_i + 1) % len(TWEAKABLE)
        elif key == "C":
            self.param_i = (self.param_i - 1) % len(TWEAKABLE)
        elif key == "]":
            self._step_param(+1)
        elif key == "[":
            self._step_param(-1)
        elif key == "x":
            self.s.reset_param(list(TWEAKABLE)[self.param_i])
        elif key == "R":
            self.s.reset_all()
        elif key == "r":
            if self._rebake():
                self._say("re-baked")
        elif key == "s":
            path = self.s.save_png("omm_tui_frame.png")
            self._say(f"saved {path}")
        return True


def render_ansi(viewer: TuiViewer, rows: int = 24, cols: int = 80) -> str:
    """One frame as 24-bit ANSI half-blocks + status lines (the --frame
    one-shot; also what tests assert against)."""
    px = np.clip(viewer.frame_rgb(rows, cols) * 255.0, 0,
                 255).astype(np.uint8)
    out = []
    for r in range(rows):
        top, bot = px[2 * r], px[2 * r + 1]
        line = []
        for cx in range(cols):
            tr, tg, tb = (int(v) for v in top[cx])
            br, bg, bb = (int(v) for v in bot[cx])
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                        f"\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    out += viewer.status_lines()
    return "\n".join(out)


def run_curses(session: ViewerSession, auto_rebake: bool = False) -> None:
    """Interactive loop (blocks until 'q').  256-color quantization of the
    RGB frame; falls back with a clear error on non-color terminals."""
    import curses

    viewer = TuiViewer(session, auto_rebake=auto_rebake)

    def to216(c: np.ndarray) -> int:
        q = np.minimum((c * 6.0).astype(np.int32), 5)
        return 16 + 36 * int(q[0]) + 6 * int(q[1]) + int(q[2])

    def loop(scr):
        curses.start_color()
        curses.use_default_colors()
        has256 = curses.COLORS >= 256
        # Half-block cells need a (fg, bg) pair per color COMBINATION —
        # up to 216² — which exhausts 256-pair terminals after one frame
        # (pair() would then return default colors forever).  On small
        # COLOR_PAIRS tables fall back to full blocks: fg-only, <= 216
        # pairs total, half the vertical resolution but always readable.
        half_blocks = has256 and curses.COLOR_PAIRS > 4096
        pairs: dict[tuple, int] = {}

        def pair(fg: int, bg: int) -> int:
            k = (fg, bg)
            if k not in pairs:
                idx = len(pairs) + 1
                if idx >= curses.COLOR_PAIRS - 1:
                    return 0
                curses.init_pair(idx, fg, bg)
                pairs[k] = idx
            return pairs[k]

        scr.nodelay(False)
        scr.keypad(True)
        while True:
            maxy, maxx = scr.getmaxyx()
            rows = max(4, maxy - 6)
            cols = max(16, maxx - 1)
            px = viewer.frame_rgb(rows, cols)
            scr.erase()
            for r in range(rows):
                for cx in range(cols):
                    if half_blocks:
                        fg = to216(px[2 * r, cx])
                        bg = to216(px[2 * r + 1, cx])
                        at = curses.color_pair(pair(fg, bg))
                        ch = "▀"
                    elif has256:
                        mean = (px[2 * r, cx] + px[2 * r + 1, cx]) / 2
                        at = curses.color_pair(pair(to216(mean), -1))
                        ch = "█"
                    else:
                        at = 0
                        ch = "▀"
                    try:
                        scr.addstr(r, cx, ch, at)
                    except curses.error:
                        pass
            for i, line in enumerate(viewer.status_lines()):
                try:
                    scr.addstr(rows + i, 0, line[:maxx - 1])
                except curses.error:
                    pass
            scr.refresh()
            k = scr.getkey()
            if not viewer.handle_key(k):
                return

    curses.wrapper(loop)
