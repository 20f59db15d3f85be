"""OpenCV's polygon fill, polyline and resizes, in numpy.

The JAX package's preparation tools burn footprints with ``cv2.fillPoly`` /
``cv2.polylines`` and regrid with ``cv2.resize``; the card's machine has no
cv2, so this module gives the same pixels:

* :func:`fill_poly`: ``cv2.fillPoly(canvas, polys, value)`` with integer
  vertices (8-connected, shift 0). All rings of one call go into one edge
  table, so the fill follows the even-odd rule and holes stay empty. Every
  edge is also drawn as an 8-connected line, so the boundary pixels are in.
  A row's spans run from the rounded x of one edge to the floor of the
  next. Edges that leave the canvas follow OpenCV's clipped lines (its
  ``clipLine``, truncating double arithmetic), so the fill near a vertex
  off the canvas is OpenCV's, not the exact polygon's. OpenCV's source is
  not consulted here: these rules were worked out against cv2 5.0 on random
  polygons.
* :func:`polylines`: ``cv2.polylines(canvas, polys, True, value)`` at
  thickness 1: each closed ring as 8-connected lines (Bresenham, drawn from
  the left end point).
* :func:`resize_nearest`: ``cv2.resize(..., INTER_NEAREST)``: output index
  ``o`` reads ``floor(o * (1 / (dst / src)))`` computed in double.
* :func:`resize_linear`: ``cv2.resize(..., INTER_LINEAR)``: half-pixel
  centres, replicated borders, in float64 (OpenCV uses 11-bit fixed-point
  weights for 8-bit images and float32 ones otherwise, so the two agree to
  the rounding of those weights).

``tests/test_torch_preprocess.py`` holds the drawing to cv2 on random
polygons (0 differing pixels) and the resizes to cv2 exactly (nearest) and
within a stated tolerance (linear).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_SHIFT = 16  # OpenCV's fixed-point x of a fill edge (XY_SHIFT)
_HALF = 1 << (_SHIFT - 1)
_FILL_CHUNK = 1 << 22  # rows x edges evaluated at once
_FAR = 1 << 60  # the fixed-point x of an edge's part off the canvas


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int
               ) -> Tuple[bool, int, int, int, int]:
    """OpenCV's ``clipLine`` on a w x h image: (any part visible, the end
    points moved onto the border). The end points move even when the line
    stays invisible, as OpenCV's do."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w: int, h: int, x: int, y: int) -> bool:
    return not (0 <= x < w and 0 <= y < h)


def _line(w: int, h: int, x1: int, y1: int, x2: int, y2: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of OpenCV's 8-connected line from (x1, y1) to (x2, y2),
    clipped to the w x h image: the major axis steps every pixel, the minor
    one where Bresenham's error turns negative, starting from the left end
    point (``LineIterator`` with ``leftToRight``)."""
    if _outside(w, h, x1, y1) or _outside(w, h, x2, y2):
        visible, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not visible:
            return np.empty(0, np.int64), np.empty(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # minor steps after k major steps: ceil((2 k minor - major) / (2 major))
    m = -((major - 2 * k * minor) // (2 * major)) if major else k
    if dy > dx:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def _ring_lines(w: int, h: int, ring: np.ndarray):
    """The lines of a closed ring's edges, each from the previous vertex."""
    pts = [(int(x), int(y)) for x, y in ring]
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        yield (x0, y0, x1, y1), _line(w, h, x0, y0, x1, y1)


def _tdiv(num: int, den: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(num) // abs(den)
    return q if (num < 0) == (den < 0) else -q


def _edge_pieces(w: int, h: int, x0: int, y0: int, x1: int, y1: int):
    """OpenCV's fill edges of one polygon side, as (first row, end row,
    fixed-point x at the first row, x step a row) pieces; none for a
    horizontal side. A side inside the canvas is one piece. A side that
    leaves it runs along its clipped line (``clipLine``) over the clipped
    rows, the last one included, and beyond them lies off the canvas on
    the side its end point lies (x at +-``_FAR``); a side whose clipped line
    is horizontal keeps its rows and takes its x from the clipped ends."""
    if y0 == y1:
        return []
    if not (_outside(w, h, x0, y0) or _outside(w, h, x1, y1)):
        step = _tdiv((x1 - x0) << _SHIFT, y1 - y0)
        return [(y0, y1, x0 << _SHIFT, step) if y0 < y1
                else (y1, y0, x1 << _SHIFT, step)]
    _, t0x, t0y, t1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
    if t0y == t1y:
        step = _tdiv((t1x - t0x) << _SHIFT, y1 - y0)
        return [(y0, y1, t0x << _SHIFT, step) if y0 < y1
                else (y1, y0, t1x << _SHIFT, step)]
    if y0 > y1:
        x0, y0, x1, y1, t0x, t0y, t1x, t1y = x1, y1, x0, y0, t1x, t1y, t0x, t0y
    step = _tdiv((t1x - t0x) << _SHIFT, t1y - t0y)

    def piece(first: int, end: int, x_end: Optional[int] = None):
        """Rows [first, end) on the clipped line, or off the canvas beside
        the end point ``x_end`` when that lies left or right of it."""
        if x_end is not None and not 0 <= x_end < w:
            return first, end, _FAR if x_end >= w else -_FAR, 0
        return first, end, (t0x << _SHIFT) + (first - t0y) * step, step

    pieces = [piece(y0, t0y, x0), piece(max(t0y, y0), min(t1y + 1, y1)),
              piece(t1y + 1, y1, x1)]
    return [p for p in pieces if p[0] < p[1]]


def polylines(canvas: np.ndarray, polys: Sequence[np.ndarray], value) -> None:
    """``cv2.polylines(canvas, polys, True, value)`` (thickness 1, 8-connected)
    on a 2-D canvas, in place; ``polys`` are (n, 2) integer (x, y) rings."""
    h, w = canvas.shape[:2]
    for ring in polys:
        for _, (ys, xs) in _ring_lines(w, h, ring):
            canvas[ys, xs] = value


def fill_poly(canvas: np.ndarray, polys: Sequence[np.ndarray], value) -> None:
    """``cv2.fillPoly(canvas, polys, value)`` (8-connected, shift 0) on a 2-D
    canvas, in place; ``polys`` are (n, 2) integer (x, y) rings, filled
    together by the even-odd rule, their outlines included."""
    h, w = canvas.shape[:2]
    edges: List[Tuple[int, int, int, int]] = []
    for ring in polys:
        for (x0, y0, x1, y1), (ys, xs) in _ring_lines(w, h, ring):
            canvas[ys, xs] = value
            edges += _edge_pieces(w, h, x0, y0, x1, y1)
    if len(edges) < 2:
        return
    top, bot, x, step = (np.array(c, np.int64) for c in zip(*edges))
    first, last = max(int(top.min()), 0), min(int(bot.max()), h)
    rows_at_once = max(1, _FILL_CHUNK // len(edges))
    for r0 in range(first, last, rows_at_once):
        rows = np.arange(r0, min(r0 + rows_at_once, last), dtype=np.int64)
        active = (top[None] <= rows[:, None]) & (rows[:, None] < bot[None])
        xs = np.where(active, x[None] + (rows[:, None] - top[None]) * step[None],
                      np.iinfo(np.int64).max)
        xs.sort(axis=1)
        n_active = active.sum(1)
        n_pairs = len(edges) // 2
        left, right = xs[:, 0:2 * n_pairs:2], xs[:, 1:2 * n_pairs:2]
        pair = np.arange(n_pairs)[None] * 2 + 1 < n_active[:, None]
        x1, x2 = (left + _HALF) >> _SHIFT, right >> _SHIFT
        pair &= (x1 < w) & (x2 >= 0)
        ri, pi = np.nonzero(pair)
        if not len(ri):
            continue
        lo = np.maximum(x1[ri, pi], 0)
        hi = np.minimum(x2[ri, pi], w - 1)
        # +1 where a span starts, -1 past its end, over the spans' columns
        c0, c1 = int(lo.min()), int(hi.max()) + 1
        marks = np.zeros((len(rows), max(c1 - c0, 0) + 1), np.int32)
        np.add.at(marks, (ri, lo - c0), 1)
        np.add.at(marks, (ri, hi + 1 - c0), -1)
        fill = np.cumsum(marks[:, :-1], axis=1) > 0
        canvas[rows[0]: rows[-1] + 1, c0:c1][fill] = value


def _cv2_channels(out: np.ndarray) -> np.ndarray:
    """cv2 returns a one-channel image as (H, W)."""
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out


def _nearest_index(src: int, dst: int) -> np.ndarray:
    # OpenCV inverts the scale dst / src in double: 1 / (dst / src) rounds
    # otherwise than src / dst, and the floor follows it
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                      src - 1)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``:
    output pixel ``o`` of each axis reads ``floor(o * (1 / (dst / src)))``;
    a one-channel image comes back as (H, W), as cv2 returns it."""
    h, w = img.shape[:2]
    return _cv2_channels(img[_nearest_index(h, height)[:, None],
                             _nearest_index(w, width)[None, :]])


def _linear_taps(src: int, dst: int):
    """Source indices and weights of one axis under half-pixel centres,
    borders replicated."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f)
    frac = f - i0
    i0 = i0.astype(np.int64)
    return (np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), frac)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)`` in
    float64, cast back to the input's dtype (rounded for integer types); a
    one-channel image comes back as (H, W), as cv2 returns it."""
    h, w = img.shape[:2]
    y0, y1, fy = _linear_taps(h, height)
    x0, x1, fx = _linear_taps(w, width)
    a = img.astype(np.float64)
    fy = fy.reshape((-1, 1) + (1,) * (a.ndim - 2))
    fx = fx.reshape((1, -1) + (1,) * (a.ndim - 2))
    top = a[y0][:, x0] * (1 - fx) + a[y0][:, x1] * fx
    bot = a[y1][:, x0] * (1 - fx) + a[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return _cv2_channels(out.astype(img.dtype))
