"""Fishnet grids, WSF validity tagging, and the city-grid dataset.

The port's copy of ``srbh_tpu/data/grid.py`` (numpy), twins of the
reference's grid machinery:

* :func:`fishgrid_cells`      — Fishgridnew_bound
  (generate_WSF_mask_Globeheight_grid.py:275-449): column-major 64-px cells
  with 56-px stride, plus snapped-to-edge boundary column/row/corner cells
  when the extent isn't an exact multiple. Written as a ``*_grid.shp``.
* :func:`fishgrid_stats`      — zonal WSF validity
  (demo_preprocess_height_v2.py:1143-1186): per cell, count raster pixels
  ``> condition[0]``; valid when ``sum >= condition[1]`` and
  ``size >= condition[2]``; writes sum/count/isv DBF fields.
* :func:`generate_index`      — polygon bounds -> pixel windows
  (BH_loader.py:908-929) with optional ``isv > 0`` filtering.
* :class:`GridImageDataset`   — gridimgLoader (BH_loader.py:933-993):
  windowed S2+S1 reads at grid positions, per-band normalisation, NO
  datarange clipping (matching the reference's commented-out clip).
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np

from srbh_tpu_torch.data.shapefile import (
    ShapeRecord,
    read_shapefile,
    update_dbf_fields,
    write_shapefile,
)
from srbh_tpu_torch.data.tiff import TiffReader
from srbh_tpu_torch.ops.normalize import load_stats_table, norm_offsets


def fishgrid_cells(width: int, height: int, geotransform,
                   window_size: int = 64, offset: int = 56
                   ) -> List[Tuple[float, float, float, float]]:
    """Cell bounds (minx, miny, maxx, maxy) in the reference's write order:
    regular columns (top->bottom), boundary column, boundary row, corner."""
    gt = geotransform
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


def write_fishgrid(tif_path: str, window_size: int = 64, offset: int = 56,
                   prj_wkt: Optional[str] = None) -> str:
    """Fishgridnew_bound: ``<tif>_grid.shp`` next to the raster.

    The grid inherits the raster's CRS as a ``.prj`` sidecar (the reference
    stamps the layer SRS from the raster projection,
    generate_WSF_mask_Globeheight_grid.py:323-327); pass ``prj_wkt``. A
    raster with GeoKeys and no ``prj_wkt`` raises: the EPSG -> WKT table
    (``srbh_tpu/data/crs.py``) is not ported (``ROADMAP.md`` Queue 1 item
    14). A raster without GeoKeys gets no ``.prj``."""
    r = TiffReader(tif_path)
    cells = fishgrid_cells(r.width, r.height, r.geotransform,
                           window_size, offset)
    if prj_wkt is None and r.info().geo_keys:
        raise NotImplementedError(
            f"{tif_path} carries GeoKeys: pass prj_wkt; the EPSG -> .prj "
            "table (srbh_tpu/data/crs.py) is not ported yet: ROADMAP.md "
            "Queue 1 item 14")
    out = tif_path[:-4] + "_grid.shp"
    write_shapefile(out, [ShapeRecord(c) for c in cells], prj_wkt=prj_wkt)
    return out


def fishgrid_bounds_cells(xmin: float, xmax: float, ymin: float, ymax: float,
                          gridwidth: float, gridheight: float
                          ) -> List[Tuple[float, float, float, float]]:
    """Generic non-overlapping fishnet over an extent (Fishgrid,
    demo_preprocess_height_v2.py:157-224): column-major top->bottom cells;
    the last row's bottom and last column's right edge are clamped to the
    extent, matching the reference's ``max(ymin, …)``/``min(xmax, …)``."""
    rows = math.ceil((ymax - ymin) / gridheight)
    cols = math.ceil((xmax - xmin) / gridwidth)
    cells = []
    left, right = float(xmin), float(xmin) + gridwidth
    for _c in range(cols):
        top, bottom = float(ymax), float(ymax) - gridheight
        for _r in range(rows):
            cells.append((left, bottom, right, top))
            top -= gridheight
            bottom = max(float(ymin), bottom - gridheight)
        left += gridwidth
        right = min(float(xmax), right + gridwidth)
    return cells


def write_fishgrid_bounds(outfile: str, xmin: float, xmax: float,
                          ymin: float, ymax: float, gridwidth: float,
                          gridheight: float,
                          prj_wkt: Optional[str] = None) -> str:
    """Fishgrid (demo_preprocess_height_v2.py:157-224) writer."""
    cells = fishgrid_bounds_cells(xmin, xmax, ymin, ymax,
                                  gridwidth, gridheight)
    write_shapefile(outfile, [ShapeRecord(c) for c in cells],
                    prj_wkt=prj_wkt)
    return outfile


def write_fishgrid_tif(tif_path: str, window_size: int = 256,
                       prj_wkt: Optional[str] = None) -> str:
    """Fishgridnew (demo_preprocess_height_v2.py:227-306): non-overlapping
    grid of ``int(window_size * xres)`` map units over the raster's extent,
    written as ``<tif>_grid.shp`` (the reference truncates the cell size to
    an integer — preserved)."""
    r = TiffReader(tif_path)
    gt = r.geotransform
    xmin, ymax = gt[0], gt[3]
    xmax = xmin + gt[1] * r.width
    ymin = ymax + gt[5] * r.height
    grid_size = float(int(window_size * gt[1]))
    return write_fishgrid_bounds(tif_path[:-4] + "_grid.shp",
                                 xmin, xmax, ymin, ymax,
                                 grid_size, grid_size, prj_wkt)


def fishgrid_stats(tif_file: str, shp_file: str,
                   fieldname=("sum", "count", "isv"),
                   condition=(0, 20, 4096)):
    """Zonal validity of each grid cell against a mask raster; rewrites the
    shapefile with sum/count/isv fields and returns the records."""
    records = read_shapefile(shp_file)
    r = TiffReader(tif_file)
    gt = r.geotransform
    x0, y0, pw, ph = gt[0], gt[3], gt[1], -gt[5]
    sums, counts, valids = [], [], []
    for rec in records:
        minx, miny, maxx, maxy = rec.bounds
        xoff = int((minx - x0) / pw)
        yoff = int((y0 - maxy) / ph)
        xcount = int((maxx - minx) / pw)
        ycount = int((maxy - miny) / ph)
        xoff, yoff = max(xoff, 0), max(yoff, 0)
        xcount = min(xcount, r.width - xoff)
        ycount = min(ycount, r.height - yoff)
        data = r.read((xoff, yoff, xcount, ycount))[..., 0].astype(np.uint8)
        data = (data > condition[0]).astype(np.uint8)
        s, c = int(data.sum()), int(data.size)
        sums.append(s)
        counts.append(c)
        valids.append(1 if (s >= condition[1] and c >= condition[2]) else 0)
    # in-place DBF update: preserves every pre-existing attribute column
    # (vrt_sum/absdiff/isv2/... from compare_grid_products) like the
    # reference's OGR field updates (demo_preprocess_height_v2.py:1148-1153)
    fields = [(fieldname[0], "N", 19, 0), (fieldname[1], "N", 19, 0),
              (fieldname[2], "N", 19, 0)]
    return update_dbf_fields(shp_file, fields, [sums, counts, valids],
                             records=records)


def count_fishgrid_valid(shp_file: str, fieldname: str = "isv") -> int:
    """Count cells with field == 1 (demo_preprocess_height_v2.py:1189-1207)."""
    return sum(1 for r in read_shapefile(shp_file)
               if r.attributes.get(fieldname) == 1)


def generate_index(shp_file: str, geotransform,
                   validname: Optional[str] = None
                   ) -> List[Tuple[int, int, int, int]]:
    """Polygon bounds -> (xoff, yoff, xcount, ycount) windows
    (BH_loader.py:908-929), optionally filtering ``validname > 0``."""
    records = read_shapefile(shp_file)
    if validname is not None:
        records = [r for r in records
                   if (r.attributes.get(validname) or 0) > 0]
    gt = geotransform
    x0, y0, pw, ph = gt[0], gt[3], gt[1], -gt[5]
    pos = []
    for r in records:
        minx, miny, maxx, maxy = r.bounds
        xoff = round((minx - x0) / pw)
        yoff = round((y0 - maxy) / ph)
        xcount = round((maxx - minx) / pw)
        ycount = round((maxy - miny) / ph)
        pos.append((xoff, yoff, xcount, ycount))
    return pos


class GridImageDataset:
    """Windowed city reads at fishnet positions (gridimgLoader twin).

    Ragged cells (xcount/ycount < window) are zero-padded to the fixed
    window so a batch keeps one shape; the padded region is
    cropped back out at mosaic accumulation using the true counts. The
    reference feeds the ragged tile directly (BH_loader.py:965-990), whose
    convs implicitly zero-pad at the short edge — a (theoretical)
    divergence in deep-layer bleed near that edge. In the shipped workflow
    it never occurs: fishgrid_cells snaps boundary cells to the image edge
    at full window size, so every predictor window is 64 px.
    """

    def __init__(self, rootname: str, cityname: str, datastats: str,
                 normmethod: str = "minmax", s1dir: str = "s1",
                 s2dir: str = "s2", gridvalid: Optional[str] = None,
                 nchans: int = 6, window: int = 64):
        self.nchans = nchans
        self.window = window
        self.s2path = os.path.join(rootname, f"{cityname}_s2.tif")
        self.s1path = os.path.join(rootname, f"{cityname}_s1.tif")
        self.gridpath = os.path.join(rootname, f"{cityname}_s2_grid.shp")
        self.s2 = TiffReader(self.s2path)
        self.s1 = TiffReader(self.s1path)
        if (self.s2.width, self.s2.height) != (self.s1.width, self.s1.height):
            raise ValueError("width/height mismatch in s1 & s2")
        self.width, self.height = self.s2.width, self.s2.height
        self.geotrans = self.s2.geotransform
        self.pos = generate_index(self.gridpath, self.geotrans, gridvalid)
        self.s2_off, self.s2_scale = norm_offsets(load_stats_table(
            os.path.join(datastats, f"{s2dir}_{normmethod}.txt"), nchans),
            normmethod)
        self.s1_off, self.s1_scale = norm_offsets(load_stats_table(
            os.path.join(datastats, f"{s1dir}_{normmethod}.txt")), normmethod)

    def __len__(self):
        return len(self.pos)

    def __getitem__(self, index):
        xoff, yoff, xcount, ycount = self.pos[index]
        s2 = self.s2.read((xoff, yoff, xcount, ycount))[..., : self.nchans]
        s1 = self.s1.read((xoff, yoff, xcount, ycount))
        img = np.concatenate([s2, s1], axis=-1).astype(np.float32)
        bs2 = self.nchans
        img[..., :bs2] = (img[..., :bs2] - self.s2_off) / self.s2_scale
        img[..., bs2:] = (img[..., bs2:] - self.s1_off) / self.s1_scale
        # NOTE: no datarange clip here (BH_loader.py:984-986 is commented out)
        if img.shape[:2] != (self.window, self.window):
            pad = np.zeros((self.window, self.window, img.shape[2]), np.float32)
            pad[: img.shape[0], : img.shape[1]] = img
            img = pad
        return {"image": img,
                "pos": np.array([xoff, yoff, xcount, ycount], np.int32)}
