"""Line rasterization: conservative DDA cell walk + Bresenham.

The port's copy of `omm_tpu/kernels/raster.py`, pinned to it by
tests/test_torch_copies.py.  Ports of RasterizeLineConservativeImpl
(util/cpu_raster.h:487-555) and the Bresenham RasterizeLineImpl
(cpu_raster.h:385-484).  The walks are
inherently sequential per segment; degenerate (point/line) UV triangles are
rare, so these run on host in fp32 numpy and yield visited cell lists.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def bresenham_line_cells(p0, p1, raster_size):
    """Visited cells of the Bresenham walk (cpu_raster.h:385-484).

    Endpoints are swapped so p0.x <= p1.x before scaling, like the
    reference.  Returns int32 (K, 2)."""
    a = np.asarray(p0, np.float32)
    b = np.asarray(p1, np.float32)
    if a[0] > b[0]:
        a, b = b, a
    x0 = int(a[0] * raster_size[0])
    x1 = int(b[0] * raster_size[0])
    y0 = int(a[1] * raster_size[1])
    y1 = int(b[1] * raster_size[1])

    cells = []

    def plot_low(x0, y0, x1, y1):
        dx = x1 - x0
        dy = y1 - y0
        yi = 1
        if dy < 0:
            yi = -1
            dy = -dy
        d = 2 * dy - dx
        y = y0
        for x in range(x0, x1 + 1):
            cells.append((x, y))
            if d > 0:
                y += yi
                d += 2 * (dy - dx)
            else:
                d += 2 * dy

    def plot_high(x0, y0, x1, y1):
        dx = x1 - x0
        dy = y1 - y0
        xi = 1
        if dx < 0:
            xi = -1
            dx = -dx
        d = 2 * dx - dy
        x = x0
        for y in range(y0, y1 + 1):
            cells.append((x, y))
            if d > 0:
                x += xi
                d += 2 * (dx - dy)
            else:
                d += 2 * dx

    if abs(y1 - y0) < abs(x1 - x0):
        if x0 > x1:
            plot_low(x1, y1, x0, y0)
        else:
            plot_low(x0, y0, x1, y1)
    else:
        if y0 > y1:
            plot_high(x1, y1, x0, y0)
        else:
            plot_high(x0, y0, x1, y1)
    return np.asarray(cells, dtype=np.int32).reshape(-1, 2)


def conservative_line_cells(p0, p1, raster_size, offset):
    """Visited (x, y) int cells of the conservative DDA walk.

    p0, p1: (2,) fp32 segment endpoints in UV space.
    raster_size: (w, h) ints; offset: (2,) fp32 (pixel units).
    Returns int32 array (K, 2).
    """
    rf = np.array(raster_size, dtype=np.float32)
    off = np.array(offset, dtype=np.float32)
    a = np.asarray(p0, dtype=np.float32) * rf + off
    b = np.asarray(p1, dtype=np.float32) * rf + off
    if a[0] > b[0]:
        a, b = b, a

    direction = b - a
    origin = a
    x = int(np.floor(a[0]))
    y = int(np.floor(a[1]))

    step_x = 1 if direction[0] > 0 else (-1 if direction[0] < 0 else 0)
    step_y = 1 if direction[1] > 0 else (-1 if direction[1] < 0 else 0)

    inf = np.float32(np.inf)
    t_delta_x = F(1.0) / np.abs(direction[0]) if step_x != 0 else inf
    t_delta_y = F(1.0) / np.abs(direction[1]) if step_y != 0 else inf

    if step_x != 0:
        next_bx = F(x + (1.0 if step_x > 0 else 0.0))
        t_max_x = (next_bx - origin[0]) / direction[0]
    else:
        t_max_x = inf
    if step_y != 0:
        next_by = F(y + (1.0 if step_y > 0 else 0.0))
        t_max_y = (next_by - origin[1]) / direction[1]
    else:
        t_max_y = inf

    if step_x == 0 and step_y == 0:
        return np.array([[x, y]], dtype=np.int32)

    y_min = int(min(np.floor(a[1]), np.floor(b[1])))
    y_max = int(max(np.ceil(a[1]), np.ceil(b[1])))
    x_min = int(min(np.floor(a[0]), np.floor(b[0])))
    x_max = int(max(np.ceil(a[0]), np.ceil(b[0])))

    cells = []
    while x_min <= x <= x_max and y_min <= y <= y_max:
        cells.append((x, y))
        if t_max_x < t_max_y:
            x += step_x
            t_max_x = F(t_max_x + t_delta_x)
        else:
            y += step_y
            t_max_y = F(t_max_y + t_delta_y)
    return np.asarray(cells, dtype=np.int32).reshape(-1, 2)


def conservative_line_cells_batch(p0, p1, raster_size, offset):
    """Vectorized conservative DDA over a batch of segments.

    Reproduces conservative_line_cells' exact visit sequence per segment
    (identical fp32 op order, element-wise) without the per-segment
    Python walk — the degenerate-triangle fine pass calls this once per
    16k-micro-triangle chunk instead of 16k times.

    p0, p1: (B, 2) fp32 endpoints in UV space.
    Returns (x, y, mask): (B, K) int32 cells with K = max walk length.
    """
    rf = np.array(raster_size, dtype=np.float32)
    off = np.array(offset, dtype=np.float32)
    a = np.asarray(p0, dtype=np.float32) * rf + off
    b = np.asarray(p1, dtype=np.float32) * rf + off
    swap = a[:, 0] > b[:, 0]
    a2 = np.where(swap[:, None], b, a)
    b2 = np.where(swap[:, None], a, b)
    a, b = a2, b2

    direction = b - a
    x = np.floor(a[:, 0]).astype(np.int64)
    y = np.floor(a[:, 1]).astype(np.int64)

    step_x = np.where(direction[:, 0] > 0, 1,
                      np.where(direction[:, 0] < 0, -1, 0))
    step_y = np.where(direction[:, 1] > 0, 1,
                      np.where(direction[:, 1] < 0, -1, 0))

    inf = np.float32(np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_delta_x = np.where(step_x != 0,
                             np.float32(1.0) / np.abs(direction[:, 0]), inf)
        t_delta_y = np.where(step_y != 0,
                             np.float32(1.0) / np.abs(direction[:, 1]), inf)
        next_bx = (x + np.where(step_x > 0, 1.0, 0.0)).astype(np.float32)
        t_max_x = np.where(step_x != 0,
                           (next_bx - a[:, 0]) / direction[:, 0], inf)
        next_by = (y + np.where(step_y > 0, 1.0, 0.0)).astype(np.float32)
        t_max_y = np.where(step_y != 0,
                           (next_by - a[:, 1]) / direction[:, 1], inf)

    point = (step_x == 0) & (step_y == 0)
    y_min = np.minimum(np.floor(a[:, 1]), np.floor(b[:, 1])).astype(np.int64)
    y_max = np.maximum(np.ceil(a[:, 1]), np.ceil(b[:, 1])).astype(np.int64)
    x_min = np.minimum(np.floor(a[:, 0]), np.floor(b[:, 0])).astype(np.int64)
    x_max = np.maximum(np.ceil(a[:, 0]), np.ceil(b[:, 0])).astype(np.int64)

    K = int(np.max(np.where(point, 1,
                            (x_max - x_min) + (y_max - y_min) + 1)))
    B = a.shape[0]
    xs = np.zeros((B, K), dtype=np.int32)
    ys = np.zeros((B, K), dtype=np.int32)
    mask = np.zeros((B, K), dtype=bool)

    alive = ((x_min <= x) & (x <= x_max) & (y_min <= y) & (y <= y_max)
             & ~point)
    for k in range(K):
        xs[:, k] = x
        ys[:, k] = y
        # a zero-direction segment emits exactly one cell
        mask[:, k] = alive | (point if k == 0 else False)
        take_x = t_max_x < t_max_y
        x = np.where(alive & take_x, x + step_x, x)
        y = np.where(alive & ~take_x, y + step_y, y)
        t_max_x = np.where(alive & take_x,
                           (t_max_x + t_delta_x).astype(np.float32),
                           t_max_x)
        t_max_y = np.where(alive & ~take_x,
                           (t_max_y + t_delta_y).astype(np.float32),
                           t_max_y)
        alive = (alive & (x_min <= x) & (x <= x_max)
                 & (y_min <= y) & (y <= y_max))
        if not alive.any():
            break
    return xs, ys, mask
