"""Debug image dumps: render baked micromap states over the alpha texture.

The port's copy of `omm_tpu/debug.py`, on the port's own `bird`, `geom`,
`stats`, `texture` and `types`; the render is host numpy (float64
barycentrics included), so its images are byte-equal to the JAX
package's for the same result.  Analog of ommDebugSaveAsImages
(debug_impl.cpp:132-509): draws every primitive's micro-triangle states
color-coded over the (upscaled) inverted alpha texture and writes PNGs.
The reference rasterizes per micro-triangle with the CPU conservative
rasterizer; here the whole overlay is produced in one vectorized pass —
each canvas pixel computes its barycentric coordinates in the macro
triangle, maps them to the micro-triangle grid and through the inverse
bird curve (dbary2index) to its state.

State colors match the reference LUT (debug_impl.cpp:245-259):
Transparent=blue, Opaque=green, UnknownTransparent=magenta,
UnknownOpaque=yellow (monochrome mode folds UT into yellow).
"""
from __future__ import annotations

import os

import numpy as np

from . import bird, geom
from .stats import decode_states, get_omm_index
from .types import BakeInputDesc, BakeResult, get_num_micro_triangles

STATE_COLOR_DEFAULT = np.array(
    [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]],
    dtype=np.float32)
STATE_COLOR_MONO = np.array(
    [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0], [1.0, 1.0, 0.0]],
    dtype=np.float32)


def _canvas(texture, scale: int) -> np.ndarray:
    """Inverted-alpha grayscale canvas, upscaled (debug_impl.cpp:147-157)."""
    a = texture.load_plane(0)
    gray = np.float32(1.0) - a
    gray = (np.int8(np.float32(127.0) * gray + np.float32(0.5))
            .astype(np.float32)) / np.float32(127.0)
    gray = np.clip(gray, 0.0, 1.0)
    up = np.repeat(np.repeat(gray, scale, axis=0), scale, axis=1)
    return np.stack([up, up, up], axis=-1)


def _de_degenerate(t: np.ndarray) -> np.ndarray:
    """Extrude the middle point of a degenerate triangle for display
    (debug_impl.cpp:190-217)."""
    p0, p1, p2 = t[0], t[1], t[2]
    aabb_s = t.min(axis=0)
    aabb_e = t.max(axis=0)

    def extrude(mid):
        d = aabb_e - aabb_s
        return np.float32(0.5) * np.array([d[1], -d[0]], np.float32) + mid

    d01 = np.linalg.norm(p0 - p1)
    d02 = np.linalg.norm(p0 - p2)
    d12 = np.linalg.norm(p1 - p2)
    t = t.copy()
    if d01 > d02 and d01 > d12:
        t[2] = extrude(p2)
    elif d02 > d01 and d02 > d12:
        t[1] = extrude(p1)
    else:
        t[0] = extrude(p0)
    return t


def render_overlay(desc: BakeInputDesc, result: BakeResult, scale: int = 5,
                   monochrome_unknowns: bool = False,
                   highlight_reuse: bool = True) -> np.ndarray:
    """Render all primitives into one RGB float image (h*scale, w*scale, 3)."""
    tex = desc.texture
    w, h = tex.size(0)
    img = _canvas(tex, scale)
    H, W = img.shape[:2]
    lut = STATE_COLOR_MONO if monochrome_unknowns else STATE_COLOR_DEFAULT

    tris = geom.triangles_from_indices(
        np.asarray(desc.index_buffer)[:desc.index_count], desc.tex_coords,
        desc.tex_coord_format, desc.tex_coord_stride_in_bytes)
    tri_count = desc.index_count // 3
    drawn: set[int] = set()

    for prim in range(tri_count):
        vm = get_omm_index(result, prim)
        if vm >= 0:
            d = result.desc_array[vm]
            level = d.subdivision_level
            states = decode_states(result.array_data, d.offset, level, d.format)
        else:
            level = 0
            states = np.array([~vm & 3], dtype=np.uint8)
        reuse = highlight_reuse and vm >= 0 and vm in drawn
        drawn.add(vm)

        t = tris[prim]
        if not np.isfinite(t).all():
            continue
        if bool(geom.is_degenerate(t)):
            t = _de_degenerate(t)

        # Pixel bounding box of the triangle on the canvas.
        px = t[:, 0] * W
        py = t[:, 1] * H
        x0 = max(int(np.floor(px.min())), 0)
        x1 = min(int(np.ceil(px.max())) + 1, W)
        y0 = max(int(np.floor(py.min())), 0)
        y1 = min(int(np.ceil(py.max())) + 1, H)
        if x1 <= x0 or y1 <= y0:
            continue

        ys, xs = np.meshgrid(np.arange(y0, y1), np.arange(x0, x1),
                             indexing="ij")
        cx = (xs.astype(np.float64) + 0.5)
        cy = (ys.astype(np.float64) + 0.5)
        # Barycentrics of pixel centers in the macro triangle.
        d = ((py[1] - py[2]) * (px[0] - px[2])
             + (px[2] - px[1]) * (py[0] - py[2]))
        if d == 0:
            continue
        bu = ((py[1] - py[2]) * (cx - px[2]) + (px[2] - px[1]) * (cy - py[2])) / d
        bv = ((py[2] - py[0]) * (cx - px[2]) + (px[0] - px[2]) * (cy - py[2])) / d
        bw = 1.0 - bu - bv
        inside = (bu >= 0) & (bv >= 0) & (bw >= 0)
        if not inside.any():
            continue

        # Map barycentrics (p1 weight, p2 weight) to the micro-tri grid and
        # through the inverse bird curve (bird.h:159-167).
        steps = float(1 << level)
        gu = np.clip((bv * steps).astype(np.int64), 0, (1 << level) - 1)
        gv = np.clip((bw * steps).astype(np.int64), 0, (1 << level) - 1)
        gw = np.clip(((1.0 - bv - bw) * steps).astype(np.int64), 0,
                     (1 << level) - 1)
        idx = bird.dbary2index(gu.astype(np.uint32), gv.astype(np.uint32),
                               gw.astype(np.uint32), level)
        idx = np.minimum(idx, get_num_micro_triangles(level) - 1)
        color = lut[states[idx]]
        if reuse:
            color = np.clip(color + np.float32(0.35), 0.0, 1.0)

        region = img[y0:y1, x0:x1]
        blended = np.where(inside[..., None],
                           0.6 * color + 0.4 * region, region)
        img[y0:y1, x0:x1] = blended.astype(np.float32)
    return img


def _prim_states(result: BakeResult, prim: int):
    """(level, states, vm_index) for one primitive, special indices decoded
    to a single-state level-0 array."""
    vm = get_omm_index(result, prim)
    if vm >= 0:
        d = result.desc_array[vm]
        return d.subdivision_level, decode_states(
            result.array_data, d.offset, d.subdivision_level, d.format), vm
    return 0, np.array([~vm & 3], dtype=np.uint8), vm


def render_cutout(desc: BakeInputDesc, result: BakeResult, prim: int,
                  monochrome_unknowns: bool = False,
                  highlight_reuse: bool = False, max_dim: int = 8192,
                  max_pixels: int = 1 << 22) -> np.ndarray:
    """Detailed per-OMM closeup (debug_impl.cpp:189-250, detailedCutout):
    the viewport is the primitive's UV AABB rendered at a virtual
    max_dim-wide upscale of the alpha texture, with

      - the (inverted) alpha as background, checker-tinted per source texel
        so individual texels read at high zoom,
      - the micro-triangle state fill (upright micro-tris darkened, which
        draws the micro-tri grid),
      - the alpha-cutoff contour line in red, one pass per mip.

    The whole closeup is produced as one vectorized pass over the cutout
    pixels rather than the reference's three conservative-raster passes.
    Returns an RGB float32 image.
    """
    tex = desc.texture
    w, h = tex.size(0)
    lut = STATE_COLOR_MONO if monochrome_unknowns else STATE_COLOR_DEFAULT
    from .types import TextureFilterMode
    linear = desc.runtime_sampler.filter == TextureFilterMode.Linear
    cutoff = np.float32(desc.alpha_cutoff)

    level, states, _vm = _prim_states(result, prim)
    tris = geom.triangles_from_indices(
        np.asarray(desc.index_buffer)[:desc.index_count], desc.tex_coords,
        desc.tex_coord_format, desc.tex_coord_stride_in_bytes)
    t = tris[prim].astype(np.float64)
    if bool(geom.is_degenerate(tris[prim])):
        t = _de_degenerate(tris[prim]).astype(np.float64)

    aabb_s = t.min(axis=0)
    aabb_e = t.max(axis=0)
    span = np.maximum(aabb_e - aabb_s, 1e-9)
    # Per-axis virtual upscale (reference kMaxDim=8192), then shrink until
    # the cutout fits the pixel budget.
    sx = max(max_dim // w, 1)
    sy = max(max_dim // h, 1)
    while (int(span[0] * w * sx) + 1) * (int(span[1] * h * sy) + 1) \
            > max_pixels and (sx > 1 or sy > 1):
        sx = max(sx // 2, 1)
        sy = max(sy // 2, 1)
    src = np.array([w * sx, h * sy], np.float64)  # virtual canvas size
    off = np.floor(src * aabb_s).astype(np.int64)
    size = np.floor(src * span).astype(np.int64) + 1

    # Global (virtual-canvas) pixel centers of the cutout.
    gx = off[0] + np.arange(size[0], dtype=np.float64)
    gy = off[1] + np.arange(size[1], dtype=np.float64)
    u = (gx / src[0])[None, :]
    v = (gy / src[1])[:, None]
    uv = np.stack(np.broadcast_arrays(u, v), axis=-1).astype(np.float32)

    # Background: inverted bilinear alpha, texel-parity checker tint.
    mode = desc.runtime_sampler.addressing_mode
    a = tex.bilinear(mode, uv.reshape(-1, 2), 0).reshape(uv.shape[:2]) \
        if linear else _nearest_alpha(tex, mode, uv, 0)
    gray = np.clip(np.float32(1.0) - a, 0.0, 1.0) * np.float32(0.85)
    texel = np.floor(uv * np.array([w, h], np.float32)).astype(np.int64)
    checker = (texel[..., 0] % 2) == (texel[..., 1] % 2)
    gray = gray + checker.astype(np.float32) * np.float32(0.15)
    img = np.stack([gray, gray, gray], axis=-1)

    # Micro-triangle state fill over the macro triangle.
    px = t[:, 0] * src[0]
    py = t[:, 1] * src[1]
    cx = gx[None, :] + 0.5
    cy = gy[:, None] + 0.5
    d = ((py[1] - py[2]) * (px[0] - px[2])
         + (px[2] - px[1]) * (py[0] - py[2]))
    if d != 0:
        bu = ((py[1] - py[2]) * (cx - px[2])
              + (px[2] - px[1]) * (cy - py[2])) / d
        bv = ((py[2] - py[0]) * (cx - px[2])
              + (px[0] - px[2]) * (cy - py[2])) / d
        bw = 1.0 - bu - bv
        inside = (bu >= 0) & (bv >= 0) & (bw >= 0)
        steps = float(1 << level)
        mx = (1 << level) - 1
        gu = np.clip((bv * steps).astype(np.int64), 0, mx)
        gv = np.clip((bw * steps).astype(np.int64), 0, mx)
        gw = np.clip(((1.0 - bv - bw) * steps).astype(np.int64), 0, mx)
        idx = bird.dbary2index(gu.astype(np.uint32), gv.astype(np.uint32),
                               gw.astype(np.uint32), level)
        idx = np.minimum(idx, get_num_micro_triangles(level) - 1)
        color = lut[states[idx]]
        # three floors sum to steps-1 for upright cells, steps-2 for
        # inverted ones; darkening uprights draws the micro-tri grid
        upright = (gu + gv + gw) == (1 << level) - 1
        color = np.where(upright[..., None], color * np.float32(0.9), color)
        if highlight_reuse:
            color = color * np.float32(0.5)
        img = np.where(inside[..., None],
                       0.5 * color + 0.5 * img, img).astype(np.float32)

    # Alpha-cutoff contour in red, one pass per mip (debug_impl.cpp
    # DrawContourLine): a canvas pixel is on the contour when the 2x2
    # bilinear samples behind it straddle the cutoff.
    red = np.array([1.0, 0.0, 0.0], np.float32)
    for mip in range(tex.mip_count):
        if linear:
            samples = []
            for (ox, oy) in ((0, 0), (1, 0), (0, 1), (1, 1)):
                suv = np.stack(np.broadcast_arrays(
                    (gx - ox)[None, :] / src[0],
                    (gy - oy)[:, None] / src[1]), axis=-1).astype(np.float32)
                samples.append(tex.bilinear(mode, suv.reshape(-1, 2), mip)
                               .reshape(suv.shape[:2]))
            above = sum((s > cutoff).astype(np.int32) for s in samples)
            mean = sum(samples) / np.float32(4.0)
            contour = ((above != 0) & (above != 4)) \
                | (np.abs(mean - cutoff) < np.float32(1e-6))
            img = np.where(contour[..., None], red, img)
        else:
            opaque = _nearest_alpha(tex, mode, uv, mip) > cutoff
            img = np.where(opaque[..., None],
                           np.float32(0.5) * (img + red), img)
    return img.astype(np.float32)


def _nearest_alpha(texture, mode, uv, mip):
    """Nearest-texel alpha over a (h, w, 2) UV grid."""
    from .texture import get_tex_coord
    info = texture.info[mip]
    pix = np.floor(uv * np.array(info.size, np.float32)).astype(np.int32)
    coord = get_tex_coord(mode, pix, np.array(info.size, np.int32),
                          np.array(info.size_log2, np.int32), info.is_pow2)
    coord = np.clip(coord, 0, np.array(info.size, np.int32) - 1)
    return texture.load_plane(mip)[coord[..., 1], coord[..., 0]]


def save_as_images(desc: BakeInputDesc, result: BakeResult, path: str,
                   file_postfix: str = "", one_file: bool = True,
                   dump_only_first_omm: bool = False,
                   monochrome_unknowns: bool = False,
                   detailed_cutout: bool = False, scale: int = 5) -> list[str]:
    """ommDebugSaveAsImages analog; returns written file paths."""
    if detailed_cutout and one_file:
        # debug_impl.cpp:137-138: the cutout is per-OMM by construction
        from .types import BakeError, Result
        raise BakeError(Result.INVALID_ARGUMENT,
                        "detailedCutout requires oneFile=False")
    os.makedirs(path, exist_ok=True)
    written = []
    if one_file:
        img = render_overlay(desc, result, scale=scale,
                             monochrome_unknowns=monochrome_unknowns)
        fname = os.path.join(path, f"0_{file_postfix}.png")
        _write_png(fname, img)
        written.append(fname)
    else:
        tri_count = desc.index_count // 3
        if dump_only_first_omm:
            tri_count = min(tri_count, 1)
        drawn: set[int] = set()
        for prim in range(tri_count):
            if detailed_cutout:
                vm = get_omm_index(result, prim)
                img = render_cutout(
                    desc, result, prim,
                    monochrome_unknowns=monochrome_unknowns,
                    highlight_reuse=vm >= 0 and vm in drawn)
                drawn.add(vm)
            else:
                sub = _single_prim_desc(desc, prim)
                img = render_overlay(sub, _single_prim_result(result, prim),
                                     scale=scale,
                                     monochrome_unknowns=monochrome_unknowns)
            fname = os.path.join(path, f"0_{prim}_{file_postfix}.png")
            _write_png(fname, img)
            written.append(fname)
    return written


def _single_prim_desc(desc: BakeInputDesc, prim: int) -> BakeInputDesc:
    import copy
    sub = copy.copy(desc)
    ib = np.asarray(desc.index_buffer).reshape(-1)[3 * prim:3 * prim + 3]
    sub.index_buffer = ib
    sub.index_count = 3
    return sub


def _single_prim_result(result: BakeResult, prim: int) -> BakeResult:
    import copy
    sub = copy.copy(result)
    sub.index_buffer = result.index_buffer[prim:prim + 1]
    return sub


def _write_png(fname: str, img: np.ndarray):
    from PIL import Image
    arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr, "RGB").save(fname)
