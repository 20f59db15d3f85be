"""Seeded synthetic cities in the layout the port's city predictor reads.

The pattern of ``chip_smoke.py:write_city``: ``<root>/<name>_s2.tif`` (6
bands, uint16 in [0, 5000)), ``<name>_s1.tif`` (2 bands, float32 in
[-25, 5)), the 64-px / 56-px fishnet ``<name>_s2_grid.shp`` with the fields
``sum``, ``count`` and ``isv`` (valid where a cell holds >= 20 built-up
pixels of a WSF mask that is built-up in a central disc of half the area,
and 64 x 64 pixels), and the min-max tables ``<stats>/s2x_minmax.txt`` and
``<stats>/s1x_minmax.txt``.

:func:`fishgrid_cells` and :func:`write_grid` are frozen copies of the
port's ``data/grid.py:fishgrid_cells`` and ``data/shapefile.py:
write_shapefile`` (rectangles only) at the commit that added the
benchmark, so that no change to the port moves the inputs. The rasters are
drawn on the device from the seed and written with ``synth/tiff.py``.
"""
from __future__ import annotations

import math
import os
import struct

import numpy as np
import torch

from benchmark.synth.tiff import write_tiff

GEOTRANSFORM = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
WINDOW, STRIDE, MIN_BUILT = 64, 56, 20
S2_MAX, S1_MIN, S1_MAX = 5000.0, -25.0, 5.0


def fishgrid_cells(width, height, gt, window_size=WINDOW, offset=STRIDE):
    """Cell bounds (minx, miny, maxx, maxy): regular columns top to bottom,
    then the boundary column, the boundary row and the corner cell."""
    xres, yres = gt[1], gt[5]
    x0, y0 = gt[0], gt[3]
    x1, y1 = x0 + xres * width, y0 + yres * height
    xmin, xmax = min(x0, x1), max(x0, x1)
    ymin, ymax = min(y0, y1), max(y0, y1)
    gx, gy = abs(window_size * xres), abs(window_size * yres)
    ox, oy = abs(offset * xres), abs(offset * yres)
    rows = math.floor((height - window_size) / offset) + 1
    cols = math.floor((width - window_size) / offset) + 1
    diff_row = height - ((rows - 1) * offset + window_size)
    diff_col = width - ((cols - 1) * offset + window_size)
    cells = []
    left, right = xmin, xmin + gx
    for _c in range(cols):
        top, bottom = ymax, ymax - gy
        for _r in range(rows):
            cells.append((left, bottom, right, top))
            top -= oy
            bottom = max(ymin, bottom - oy)
        left += ox
        right = min(xmax, right + ox)
    if diff_col > 0:
        top, bottom = ymax, ymax - gy
        for _r in range(rows):
            cells.append((xmax - gx, bottom, xmax, top))
            top -= oy
            bottom = max(ymin, bottom - oy)
    if diff_row > 0:
        left, right = xmin, xmin + gx
        for _c in range(cols):
            cells.append((left, ymin, right, ymin + gy))
            left += ox
            right = min(xmax, right + ox)
    if diff_col > 0 or diff_row > 0:
        cells.append((xmax - gx, ymin, xmax, ymin + gy))
    return cells


def cell_window(bounds, gt):
    """(xoff, yoff, xcount, ycount) of a cell, as the grid reader rounds."""
    minx, miny, maxx, maxy = bounds
    return (round((minx - gt[0]) / gt[1]), round((gt[3] - maxy) / -gt[5]),
            round((maxx - minx) / gt[1]), round((maxy - miny) / -gt[5]))


def write_grid(path, cells, fields, values):
    """Polygon shapefile (``.shp``, ``.shx``, ``.dbf``) of rectangles with
    numeric fields ``fields`` (name, length) and one value list each."""
    base = path[:-4]
    body, shx, offset = bytearray(), bytearray(), 50
    g = [math.inf, math.inf, -math.inf, -math.inf]
    for i, (minx, miny, maxx, maxy) in enumerate(cells):
        g = [min(g[0], minx), min(g[1], miny), max(g[2], maxx), max(g[3], maxy)]
        ring = [(minx, maxy), (maxx, maxy), (maxx, miny), (minx, miny),
                (minx, maxy)]
        content = struct.pack("<i4dii", 5, minx, miny, maxx, maxy, 1, 5)
        content += struct.pack("<i", 0)
        content += b"".join(struct.pack("<2d", x, y) for x, y in ring)
        clen = len(content) // 2
        body += struct.pack(">ii", i + 1, clen) + content
        shx += struct.pack(">ii", offset, clen)
        offset += 4 + clen

    def header(words):
        return (struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(">i", words)
                + struct.pack("<ii", 1000, 5) + struct.pack("<4d", *g)
                + struct.pack("<4d", 0, 0, 0, 0))

    with open(base + ".shp", "wb") as f:
        f.write(header(50 + len(body) // 2) + body)
    with open(base + ".shx", "wb") as f:
        f.write(header(50 + len(shx) // 2) + shx)
    descs, rec_len = bytearray(), 1
    for name, flen in fields:
        descs += (name.encode("ascii")[:10].ljust(11, b"\x00") + b"N"
                  + b"\x00" * 4 + bytes([flen, 0]) + b"\x00" * 14)
        rec_len += flen
    with open(base + ".dbf", "wb") as f:
        f.write(struct.pack("<BBBBIHH", 3, 24, 1, 1, len(cells),
                            32 + len(descs) + 1, rec_len))
        f.write(b"\x00" * 20 + descs + b"\x0d")
        for i in range(len(cells)):
            f.write(b" " + b"".join(str(int(v[i])).rjust(flen).encode("ascii")
                                     for (_, flen), v in zip(fields, values)))
        f.write(b"\x1a")


def make(side: int, seed: int, device) -> dict:
    """The rasters of one ``side`` x ``side`` city, numpy: ``s2``, ``s1``
    and the WSF mask ``wsf`` (bool)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ (0xC17 + side))
    s2 = torch.randint(0, int(S2_MAX), (side, side, 6), generator=gen,
                       device=device, dtype=torch.int32)
    s1 = torch.rand((side, side, 2), generator=gen, device=device)
    yy, xx = np.ogrid[:side, :side]
    disc = (yy - side / 2) ** 2 + (xx - side / 2) ** 2 <= side * side / (2 * np.pi)
    return {"s2": s2.cpu().numpy().astype(np.uint16),
            "s1": (S1_MIN + (S1_MAX - S1_MIN) * s1).cpu().numpy(),
            "wsf": disc}


def valid_windows(wsf: np.ndarray, gt=GEOTRANSFORM) -> tuple:
    """(cells, sums, counts, isv, windows of the valid cells in cell
    order)."""
    h, w = wsf.shape
    cells = fishgrid_cells(w, h, gt)
    sums, counts, isv, pos = [], [], [], []
    for c in cells:
        x, y, xc, yc = cell_window(c, gt)
        x, y = max(x, 0), max(y, 0)
        xc, yc = min(xc, w - x), min(yc, h - y)
        s, n = int(wsf[y:y + yc, x:x + xc].sum()), xc * yc
        ok = s >= MIN_BUILT and n >= WINDOW * WINDOW
        sums.append(s)
        counts.append(n)
        isv.append(int(ok))
        if ok:
            pos.append(cell_window(c, gt))
    return cells, sums, counts, isv, pos


def write(root: str, stats: str, name: str, city: dict) -> int:
    """Write one city and the tables; returns its number of valid windows."""
    os.makedirs(root, exist_ok=True)
    os.makedirs(stats, exist_ok=True)
    s2 = os.path.join(root, f"{name}_s2.tif")
    write_tiff(s2, city["s2"], GEOTRANSFORM)
    write_tiff(os.path.join(root, f"{name}_s1.tif"), city["s1"], GEOTRANSFORM)
    cells, sums, counts, isv, pos = valid_windows(city["wsf"])
    write_grid(s2[:-4] + "_grid.shp", cells,
               [("sum", 19), ("count", 19), ("isv", 19)], [sums, counts, isv])
    np.savetxt(os.path.join(stats, "s2x_minmax.txt"),
               np.stack([np.zeros(6), np.full(6, S2_MAX)]))
    np.savetxt(os.path.join(stats, "s1x_minmax.txt"),
               np.stack([np.full(2, S1_MIN), np.full(2, S1_MAX)]))
    return len(pos)
