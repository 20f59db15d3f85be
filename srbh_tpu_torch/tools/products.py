"""Height-product comparison & sample-selection toolbox.

The port's copy of ``srbh_tpu/tools/products.py``, without cv2 (the card's
machine has none): ``sample_height_rmse`` regrids with ``data/raster.py``'s
``resize_nearest`` (exactly ``cv2.resize``'s INTER_NEAREST), and the
``try`` statements of the JAX module become checks made before the call
(``crs.supported_epsg``, ``crs.wkt_error``; ``main_proc_product`` copies an
already-common tile where the JAX module hard-links it, the same bytes).
The files written are byte-equal to the JAX package's. It all runs on the
host: ``python -m srbh_tpu_torch.tools.products`` does no device work and
takes no device argument.

Capability twins of the long tail of ``demo_preprocess_height_v2.py`` —
the CNBH-10m / CBRA-2020 product processing, per-grid validity comparison,
sample clipping/selection, and the mosaic/extent utilities they rest on —
implemented over the framework's own GeoTIFF/shapefile codecs (no GDAL):

* :class:`VirtualMosaic`            — BuildVRT + per-window gdal.Warp
  (demo_preprocess_…py:586-605 ``merge_alltif`` + the ``gdal.Warp('tmp.vrt',
  outputBounds=…)`` pattern used throughout): a lazy union of rasters read
  through fixed-resolution windows with nearest resampling.
* :func:`raster_extent_shapefile`   — ``Raster_extent[_prj]`` (:309-427):
  one bbox polygon per raster with location/year attributes.
* :func:`add_field_by_expression`   — ``addField_byExpression`` (:122-153):
  vector field calculator (default: elevation -> floor number / 3).
* :func:`zonal_stats`               — ``zonal_stats`` (:450-571): per-feature
  envelope sum/count written back into the DBF.
* :func:`calculate_iou`             — (:732-737).
* :func:`compare_grid_products`     — ``compare_twotiff_valid[_iou]``
  (:740-1036): per valid grid cell, reference window vs product-mosaic
  window; writes vrt_sum / vrt_count / absdiff (+ diou) and the isv2/3/4
  validity cascade into the grid shapefile.
* :func:`clip_valid_samples`        — ``clip_twotiff_valid`` (:1058-1139):
  writes per-valid-cell sample GeoTIFF pairs named ``{city}_{FID}.tif``.
* :func:`sample_height_rmse`        — ``cal_rmse`` (:1389-1406): the
  CNBH-vs-reference sample RMSE with the exact masking recipe.
* :func:`count_valid_samples`       — ``main_sample_stats`` (:1587-1610):
  per-city valid-cell counts written to a ``num_valid`` CSV.
* :func:`compare_height_products`   — the per-city IoU/RMSE/MAE/ME sweep the
  reference runs piecemeal (``main_select_heightvalid`` + the comparison
  loops), consolidated into one CSV-writing driver.
* :func:`main_sample_selection`     — the end-to-end driver of
  ``main_sample_selection`` (:1698-1753): fishgrid -> zonal validity ->
  product comparison -> count.
* :func:`warp_window`               — ``gdal.Warp(dstSRS=…)`` (clip_vrt,
  :608-655): resample the mosaic onto a grid in another CRS via
  :mod:`srbh_tpu_torch.data.crs`.
* :func:`clip_city_mosaic`          — ``clip_tiff_whole`` (:1317-1386):
  tile selection by extent-index intersection + city-window mosaic write,
  cross-CRS capable.

Everything here is host-side preparation (SURVEY.md L0); no TPU content.
"""
from __future__ import annotations

import csv
import os
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from srbh_tpu_torch.data import crs as _crs
from srbh_tpu_torch.data.grid import (
    count_fishgrid_valid,
    fishgrid_stats,
    write_fishgrid,
)
from srbh_tpu_torch.data.raster import resize_nearest
from srbh_tpu_torch.data.shapefile import (
    ShapeRecord,
    read_shapefile,
    update_dbf_fields,
    write_shapefile,
)
from srbh_tpu_torch.data.tiff import TiffReader, write_tiff
from srbh_tpu_torch.tools.preprocess import (
    compare_array_sums,
    compare_metrics_from_sums,
)


def _valid_mask(arr: np.ndarray, nodata) -> np.ndarray:
    """Pixels carrying data: not ``nodata`` and not NaN. CNBH-style float
    products use NaN fill; ``arr != nodata`` alone would treat a NaN collar
    as data and punch holes into earlier rasters. ``arr == arr`` is the
    dtype-safe NaN test (all-True for integer arrays)."""
    finite = arr == arr
    if nodata != nodata:  # nodata itself is NaN
        return finite
    return finite & (arr != nodata)


class VirtualMosaic:
    """A lazy union of same-CRS rasters, read through windows.

    Twin of ``gdal.BuildVRT`` (merge_alltif) + the per-feature
    ``gdal.Warp(format='VRT', outputBounds=[...], xRes=…, yRes=…)`` reads:
    :meth:`read_window` samples the mosaic on a fixed-resolution grid over
    the requested bounds with nearest resampling; pixels no source covers
    get ``nodata``. Later rasters in the list win on overlap (VRT order).
    """

    def __init__(self, tif_paths: Sequence[str], nodata: float = 0.0,
                 band: int = 0):
        if not tif_paths:
            raise ValueError("empty mosaic")
        self.readers = [TiffReader(p) for p in tif_paths]
        self.nodata = nodata
        self.band = band

    def read_window(self, bounds: Tuple[float, float, float, float],
                    resolution: float, dtype=np.float64) -> np.ndarray:
        minx, miny, maxx, maxy = bounds
        w = int(round((maxx - minx) / resolution))
        h = int(round((maxy - miny) / resolution))
        out = np.full((h, w), self.nodata, dtype)
        # target pixel centres (y runs top-down like a north-up geotransform)
        cx = minx + (np.arange(w) + 0.5) * resolution
        cy = maxy - (np.arange(h) + 0.5) * resolution
        for r in self.readers:
            gt = r.geotransform
            px = np.floor((cx - gt[0]) / gt[1]).astype(np.int64)
            py = np.floor((cy - gt[3]) / gt[5]).astype(np.int64)
            okx = (px >= 0) & (px < r.width)
            oky = (py >= 0) & (py < r.height)
            if not (okx.any() and oky.any()):
                continue
            x0, x1 = int(px[okx].min()), int(px[okx].max())
            y0, y1 = int(py[oky].min()), int(py[oky].max())
            tile = r.read((x0, y0, x1 - x0 + 1, y1 - y0 + 1))[..., self.band]
            sub = tile[np.ix_(py[oky] - y0, px[okx] - x0)].astype(dtype)
            # nodata transparency (gdal.BuildVRT srcNodata=VRTNodata
            # semantics, demo_preprocess_height_v2.py:586-607): a later
            # raster's valid pixels win, but its nodata collar must not
            # punch holes into earlier rasters' data.
            dst = out[np.ix_(oky, okx)]
            valid = _valid_mask(sub, self.nodata)
            dst[valid] = sub[valid]
            out[np.ix_(oky, okx)] = dst
        return out

    def sample(self, xs: np.ndarray, ys: np.ndarray,
               dtype=np.float64) -> np.ndarray:
        """Nearest-pixel values at scattered map coordinates (the warp
        primitive). Later rasters' *valid* pixels win on overlap; nodata is
        transparent, like :meth:`read_window`."""
        xs = np.asarray(xs, float)
        ys = np.asarray(ys, float)
        out = np.full(xs.shape, self.nodata, dtype)
        for r in self.readers:
            gt = r.geotransform
            px = np.floor((xs - gt[0]) / gt[1]).astype(np.int64)
            py = np.floor((ys - gt[3]) / gt[5]).astype(np.int64)
            ok = (px >= 0) & (px < r.width) & (py >= 0) & (py < r.height)
            if not ok.any():
                continue
            x0, x1 = int(px[ok].min()), int(px[ok].max())
            y0, y1 = int(py[ok].min()), int(py[ok].max())
            tile = r.read((x0, y0, x1 - x0 + 1, y1 - y0 + 1))[..., self.band]
            vals = tile[py[ok] - y0, px[ok] - x0].astype(dtype)
            cur = out[ok]
            valid = _valid_mask(vals, self.nodata)
            cur[valid] = vals[valid]
            out[ok] = cur
        return out


def raster_extent_shapefile(
    filelist: Sequence[str], outfile: str,
    loc_from_name: Optional[Callable[[str], str]] = None,
    year: int = 2020,
) -> List[dict]:
    """One bbox polygon per raster, with ``location``/``year`` attributes
    (Raster_extent, demo_preprocess_…py:309-358; for the _prj variant's
    cross-CRS case, reproject query bounds with
    :func:`srbh_tpu_torch.data.crs.transform_bounds` — see
    :func:`clip_city_mosaic`)."""
    loc_from_name = loc_from_name or (lambda stem: stem.split("_")[0])
    records = []
    rows = []
    for f in filelist:
        r = TiffReader(f)
        gt = r.geotransform
        x0, y0 = gt[0], gt[3]
        x1, y1 = x0 + gt[1] * r.width, y0 + gt[5] * r.height
        bounds = (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
        loc = loc_from_name(Path(f).stem)
        rec = ShapeRecord(bounds)
        rec.attributes = {"location": loc, "year": year}
        records.append(rec)
        rows.append({"location": loc, "year": year, "bounds": bounds})
    write_shapefile(outfile, records,
                    [("location", "C", 32, 0), ("year", "N", 19, 0)])
    return rows


def add_field_by_expression(shp_file: str, new_field: str = "FloorNum",
                            old_field: str = "elevation",
                            fn: Callable[[float], float] = lambda v: v / 3):
    """DBF field calculator (addField_byExpression, :122-153; default is the
    reference's elevation -> floor-number divide-by-3)."""
    records = read_shapefile(shp_file)
    values = [int(fn(rec.attributes.get(old_field) or 0)) for rec in records]
    update_dbf_fields(shp_file, [(new_field, "N", 19, 0)], [values])
    return values


def zonal_stats(shp_file: str, tif_file: str,
                fieldname: Tuple[str, str] = ("sum", "count"),
                threshold: float = 0.0):
    """Per-feature envelope sum/count of raster pixels > threshold, written
    into the DBF (zonal_stats, :450-571)."""
    r = TiffReader(tif_file)
    gt = r.geotransform
    sums, counts = [], []
    for rec in read_shapefile(shp_file):
        minx, miny, maxx, maxy = rec.bounds
        xoff = max(0, int((minx - gt[0]) / gt[1]))
        yoff = max(0, int((gt[3] - maxy) / -gt[5]))
        xcount = min(int((maxx - minx) / gt[1]), r.width - xoff)
        ycount = min(int((maxy - miny) / -gt[5]), r.height - yoff)
        data = r.read((xoff, yoff, xcount, ycount))[..., 0]
        mask = data > threshold
        sums.append(int(mask.sum()))
        counts.append(int(mask.size))
    update_dbf_fields(shp_file, [(fieldname[0], "N", 19, 0),
                                 (fieldname[1], "N", 19, 0)], [sums, counts])
    return sums, counts


def calculate_iou(gt_mask: np.ndarray, pred_mask: np.ndarray) -> float:
    """(demo_preprocess_…py:732-737)."""
    overlap = (pred_mask * gt_mask).sum()
    union = ((pred_mask + gt_mask) > 0).sum()
    return float(overlap / union) if union else 0.0


def compare_grid_products(
    ref_tif: str, mosaic: VirtualMosaic, shp_file: str,
    fieldname=("vrt_sum", "vrt_count", "absdiff"),
    validname=("isv", "isv2", "isv3", "isv4"),
    nresolution: float = 2.5,
    condition=(0, 2000, 65536, 0.3),
    use_iou: bool = False,
):
    """Per-grid-cell reference-vs-product comparison
    (compare_twotiff_valid, :740-830; _iou variant, :832-936).

    For every cell with ``isv > 0``: binarise the reference window
    (pixel-offset read) and the product window (mosaic warp read) at
    ``> condition[0]``; write ``vrt_sum``/``vrt_count``/``absdiff`` and the
    validity cascade — isv2 = enough product pixels
    (sum >= condition[1] and count >= condition[2]); isv3 = agreement
    (diff-fraction, or 1-IoU when ``use_iou``, <= condition[3]);
    isv4 = isv2 & isv3. ``diou`` (1 - IoU) is stored when ``use_iou``.
    """
    r = TiffReader(ref_tif)
    gt = r.geotransform
    records = read_shapefile(shp_file)
    cols: Dict[str, list] = {k: [] for k in
                             (*fieldname, *validname[1:], "diou")}
    for rec in records:
        if (rec.attributes.get(validname[0]) or 0) == 0:
            for k in cols:
                cols[k].append(0)
            continue
        minx, miny, maxx, maxy = rec.bounds
        xoff = int((minx - gt[0]) / gt[1])
        yoff = int((gt[3] - maxy) / -gt[5])
        xcount = int((maxx - minx) / gt[1])
        ycount = int((maxy - miny) / -gt[5])
        d1 = r.read((max(0, xoff), max(0, yoff),
                     min(xcount, r.width - max(0, xoff)),
                     min(ycount, r.height - max(0, yoff))))[..., 0]
        d1 = (d1 > condition[0]).astype(np.uint8)
        d2 = mosaic.read_window((minx, miny, maxx, maxy), nresolution)
        d2 = (d2 > condition[0]).astype(np.uint8)
        isum, icount = int(d2.sum()), int(d2.size)
        isv2 = 1 if (isum >= condition[1] and icount >= condition[2]) else 0
        if d1.shape == d2.shape:
            diff = int((d1 != d2).sum())
            diou = 1.0 - calculate_iou(d1, d2)
        else:
            diff, diou = 65536, 1.0  # dimension mismatch: mark for deletion
        isv3 = int((diou if use_iou else diff / icount) <= condition[3])
        cols[fieldname[0]].append(isum)
        cols[fieldname[1]].append(icount)
        cols[fieldname[2]].append(diff)
        cols[validname[1]].append(isv2)
        cols[validname[2]].append(isv3)
        cols[validname[3]].append(1 if (isv2 and isv3) else 0)
        cols["diou"].append(round(diou, 6))
    fields = [(k, "N", 19, 0) for k in (*fieldname, *validname[1:])]
    values = [cols[k] for k in (*fieldname, *validname[1:])]
    if use_iou:
        fields.append(("diou", "N", 19, 6))
        values.append(cols["diou"])
    update_dbf_fields(shp_file, fields, values)
    return cols


def clip_valid_samples(ref_tif: str, mosaic: VirtualMosaic, shp_file: str,
                       respath: str, subdir=("bh", "cbra"),
                       validname: str = "isv4", savename: str = "FID",
                       nresolution: float = 2.5) -> List[str]:
    """Write per-valid-cell GeoTIFF pairs ``{city}_{FID}.tif`` under
    ``respath/{subdir}`` (clip_twotiff_valid, :1058-1139)."""
    citycode = os.path.basename(shp_file).split("_")[0]
    for d in subdir:
        os.makedirs(os.path.join(respath, d), exist_ok=True)
    r = TiffReader(ref_tif)
    gt = r.geotransform
    written = []
    for i, rec in enumerate(read_shapefile(shp_file)):
        if (rec.attributes.get(validname) or 0) == 0:
            continue
        fid = rec.attributes.get(savename, i)
        basename = f"{citycode}_{fid}.tif"
        minx, miny, maxx, maxy = rec.bounds
        xoff = int((minx - gt[0]) / gt[1])
        yoff = int((gt[3] - maxy) / -gt[5])
        xcount = int((maxx - minx) / gt[1])
        ycount = int((maxy - miny) / -gt[5])
        d1 = r.read((max(0, xoff), max(0, yoff),
                     min(xcount, r.width - max(0, xoff)),
                     min(ycount, r.height - max(0, yoff))))[..., 0]
        cell_gt = (minx, gt[1], 0.0, maxy, 0.0, gt[5])
        p1 = os.path.join(respath, subdir[0], basename)
        write_tiff(p1, d1, geotransform=cell_gt, compress="PACKBITS")
        d2 = mosaic.read_window((minx, miny, maxx, maxy), nresolution)
        cell_gt2 = (minx, nresolution, 0.0, maxy, 0.0, -nresolution)
        p2 = os.path.join(respath, subdir[1], basename)
        write_tiff(p2, d2.astype(d1.dtype), geotransform=cell_gt2,
                   compress="PACKBITS")
        written += [p1, p2]
    return written


def sample_height_rmse(cbra_path: str, cnbh_path: str, bh_path: str,
                       iname: str) -> float:
    """CNBH-vs-reference sample RMSE with the exact recipe of ``cal_rmse``
    (:1389-1406): CNBH nan->0, nearest-resize to 256; CBRA 255->1 mask;
    reference uint heights with the (0,2] -> 3-floor clamp, x3 m/floor;
    RMSE over the nonzero masked differences."""
    cnbh = TiffReader(os.path.join(cnbh_path, iname)).read()[..., 0]
    cnbh = np.nan_to_num(cnbh.astype(np.float64))
    cnbh = resize_nearest(cnbh, 256, 256)
    cbra = TiffReader(os.path.join(cbra_path, iname)).read()[..., 0].copy()
    cbra[cbra == 255] = 1
    bh = TiffReader(os.path.join(bh_path, iname)).read()[..., 0].copy()
    bh[(bh <= 2) & (bh > 0)] = 3
    bh = bh.astype(np.float64) * 3
    diff = (cnbh * cbra - bh).ravel()
    diff = diff[diff != 0]
    return float(np.sqrt((diff ** 2).mean())) if diff.size else 0.0


def count_valid_samples(shp_files: Sequence[str], out_csv: Optional[str] = None,
                        fieldname: str = "isv4") -> Dict[str, int]:
    """Per-city valid-cell counts, optionally written as the reference's
    ``num_valid`` CSV (main_sample_stats, :1587-1610)."""
    counts = {}
    for f in shp_files:
        city = os.path.basename(f).split("_")[0]
        counts[city] = count_fishgrid_valid(f, fieldname)
    if out_csv:
        with open(out_csv, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["", "num_valid"])
            for city, n in counts.items():
                w.writerow([city, n])
    return counts


def compare_height_products(city_pairs: Dict[str, Tuple[str, str]],
                            out_csv: str,
                            threshold: float = 0.0) -> List[dict]:
    """Per-city product sweep: IoU of the building masks + RMSE/MAE/ME of
    heights over the mask union, one CSV row per city plus an ``all`` row.

    Consolidates the reference's piecemeal comparison drivers
    (cal_rmse/calculate_iou + the per-city loops of main_proc_CNBH10m /
    main_select_heightvalid) into one artifact. ``city_pairs`` maps city ->
    (raster_a, raster_b); rasters are regridded to ``raster_a``'s grid
    (nearest) when shapes differ.
    """
    rows = []
    totals = {"inter": 0, "union": 0, "sq": 0.0, "abs": 0.0,
              "me_sum": 0.0, "count": 0}
    for city, (a_tif, b_tif) in city_pairs.items():
        a = TiffReader(a_tif).read()[..., 0].astype(np.float64)
        b = TiffReader(b_tif).read()[..., 0].astype(np.float64)
        s = compare_array_sums(a, b, threshold)
        rows.append({"city": city, **compare_metrics_from_sums(s, ndigits=6)})
        for k in totals:
            totals[k] += s[k]
    rows.append({"city": "all", **compare_metrics_from_sums(totals, ndigits=6)})
    with open(out_csv, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["city", "iou", "rmse", "mae",
                                           "me", "count"])
        w.writeheader()
        w.writerows(rows)
    return rows


def main_sample_selection(city_tifs: Sequence[str], product_tifs: Sequence[str],
                          window_size: int = 256,
                          grid_condition=(0, 4000, 65536),
                          compare_condition=(0, 4000, 65536, 0.65),
                          nresolution: float = 2.5,
                          out_csv: Optional[str] = None) -> Dict[str, int]:
    """End-to-end sample selection (main_sample_selection, :1698-1753):
    per city raster, build/refresh the fishgrid, tag zonal validity (isv),
    compare against the product mosaic (isv2/3/4 with the reference's
    IoU<=0.65 rule), then count the surviving samples."""
    mosaic = VirtualMosaic(list(product_tifs))
    shp_files = []
    for tif in city_tifs:
        shp = tif[:-4] + "_grid.shp"
        if not os.path.exists(shp):
            write_fishgrid(tif, window_size=window_size, offset=window_size)
        fishgrid_stats(tif, shp, fieldname=("sum", "count", "isv"),
                       condition=grid_condition)
        compare_grid_products(tif, mosaic, shp, nresolution=nresolution,
                              condition=compare_condition, use_iou=True)
        shp_files.append(shp)
    return count_valid_samples(shp_files, out_csv)


def warp_window(mosaic: VirtualMosaic,
                bounds: Tuple[float, float, float, float],
                resolution: float, dst_crs=None, src_crs=None,
                dtype=np.float64) -> np.ndarray:
    """``gdal.Warp(outputBounds=…, xRes=…, dstSRS=…)`` twin (clip_vrt,
    demo_preprocess_height_v2.py:608-655): sample the mosaic on a
    ``dst_crs`` grid over ``bounds`` by inverse-mapping target pixel
    centres into the mosaic's CRS (nearest). With either CRS omitted this
    degrades to the same-CRS :meth:`VirtualMosaic.read_window`."""
    if dst_crs is None or src_crs is None:
        return mosaic.read_window(bounds, resolution, dtype)
    minx, miny, maxx, maxy = bounds
    w = int(round((maxx - minx) / resolution))
    h = int(round((maxy - miny) / resolution))
    cx = minx + (np.arange(w) + 0.5) * resolution
    cy = maxy - (np.arange(h) + 0.5) * resolution
    gx, gy = np.meshgrid(cx, cy)
    sx, sy = _crs.transform(dst_crs, src_crs, gx.ravel(), gy.ravel())
    return mosaic.sample(sx, sy, dtype).reshape(h, w)


def raster_crs(reader: TiffReader):
    """Projection object from a GeoTIFF's GeoKeys (EPSG), or None when the
    file carries no CRS — the get_tif_meta 'proj' slot of the reference."""
    info = reader.info()
    # info() normalises geo payloads to little-endian regardless of the
    # file's byte order
    code = _crs.epsg_from_geokeys(info.geo_keys or b"")
    return _crs.from_epsg(code) if code else None


def warp_raster(src_tif: str, out_tif: str, dst_epsg: int,
                resolution: float, src_crs=None, nodata: float = 0.0,
                dtype=np.float32) -> str:
    """Rewrite one raster in another CRS — the per-tile
    ``gdal.Warp(dstSRS=…)`` of clip_tiff_whole's 'need to reproject to the
    same projection' branch (demo_preprocess_height_v2.py:1356-1371).
    ``src_crs`` defaults to the tile's own GeoKeys; the output is stamped
    with ``dst_epsg`` GeoKeys so downstream reads stay CRS-aware."""
    r = TiffReader(src_tif)
    src = _crs.as_projection(src_crs) if src_crs is not None else raster_crs(r)
    if src is None:
        raise ValueError(f"{src_tif}: no CRS in GeoKeys; pass src_crs")
    dst = _crs.from_epsg(dst_epsg)
    gt = r.geotransform
    b = (gt[0], gt[3] + gt[5] * r.height, gt[0] + gt[1] * r.width, gt[3])
    db = _crs.transform_bounds(src, dst, b)
    data = warp_window(VirtualMosaic([src_tif], nodata=nodata), db,
                       resolution, dst_crs=dst, src_crs=src)
    write_tiff(out_tif, data.astype(dtype),
               geotransform=(db[0], resolution, 0.0, db[3], 0.0, -resolution),
               compress="DEFLATE", nodata=nodata,
               geo_keys=_crs.geokeys_for_epsg(dst_epsg))
    return out_tif


def main_proc_product(product_tifs: Sequence[str], query_shps: Sequence[str],
                      resroot: str, suffix: str = "CNBH10m",
                      nresolution: float = 10.0, nodata: float = 0.0,
                      common_epsg: Optional[int] = None) -> List[str]:
    """The main_proc_CNBH10m / main_proc_CBRA drivers
    (demo_preprocess_height_v2.py:1418-1525): extent-index the product tiles
    once (``all_grid.shp``), pre-warping mixed-CRS tiles to ``common_epsg``
    first (the reference's reproject branch), then clip one city-extent
    mosaic per query grid shapefile. Idempotent at every level: the extent
    index, warped tiles, and per-city outputs are skipped when present.
    Product tiles must be named ``{suffix}_{location}.tif``."""
    os.makedirs(resroot, exist_ok=True)
    files = list(product_tifs)
    codes = []
    for f in files:
        r = TiffReader(f)
        codes.append(_crs.epsg_from_geokeys(r.info().geo_keys or b""))
    distinct = {c for c in codes if c}
    if common_epsg is None and len(distinct) == 1:
        common_epsg = next(iter(distinct))
    if common_epsg is None and len(distinct) > 1:
        # fail loudly: mosaicking tiles whose geotransforms live in
        # different coordinate systems silently mis-locates every city
        # product (same contract as crs.from_wkt's guards)
        raise ValueError(
            f"product tiles span multiple CRSes {sorted(distinct)}; pass "
            "common_epsg to pick the warp target")
    # tiles without GeoKeys (code None) are assumed to already be in the
    # common frame — warping them is impossible and pre-CRS behaviour kept
    # them as-is
    needs_warp = (common_epsg is not None
                  and any(c is not None and c != common_epsg for c in codes))
    if needs_warp:
        warped_dir = os.path.join(resroot, "warped")
        os.makedirs(warped_dir, exist_ok=True)
        new_files = []
        for f, c in zip(files, codes):
            out = os.path.join(warped_dir, os.path.basename(f))
            if c is None or c == common_epsg:
                # keep already-common tiles alongside the warped ones so the
                # mosaic directory stays single (a copy: the JAX package
                # hard-links where it can, the same bytes)
                if not os.path.exists(out):
                    shutil.copyfile(f, out)
            elif not os.path.exists(out):
                warp_raster(f, out, common_epsg, nresolution, nodata=nodata)
            new_files.append(out)
        files = new_files

    grid = os.path.join(resroot, "all_grid.shp")
    prefix = suffix + "_"
    if not os.path.exists(grid):
        raster_extent_shapefile(
            files, grid,
            loc_from_name=lambda stem: (stem[len(prefix):]
                                        if stem.startswith(prefix) else stem))
        # an exotic-but-homogeneous EPSG: no .prj, no warp
        if common_epsg is not None and _crs.supported_epsg(common_epsg):
            with open(grid[:-4] + ".prj", "w") as f:
                f.write(_crs.wkt_for_epsg(common_epsg))

    by_dir = {os.path.dirname(f) for f in files}
    if len(by_dir) != 1:
        raise ValueError("product tiles must share one directory after "
                         f"warping, got {sorted(by_dir)}")
    tif_dir = by_dir.pop()
    outs = []
    for q in query_shps:
        city = os.path.basename(q).split("_")[0]
        out = os.path.join(resroot, f"{city}.tif")
        clip_city_mosaic(q, grid, tif_dir, out, suffix=suffix,
                         nresolution=nresolution, nodata=nodata)
        outs.append(out)
    return outs


def _read_prj(shp_file: str) -> Optional[str]:
    prj = shp_file[:-4] + ".prj"
    if os.path.exists(prj):
        with open(prj) as f:
            return f.read()
    return None


def clip_city_mosaic(query_shp: str, grid_shp: str, tif_dir: str,
                     out_tif: str, suffix: str = "CNBH10m",
                     nresolution: float = 10.0, nodata: float = 0.0,
                     location_field: str = "location",
                     dtype=np.float32) -> Optional[np.ndarray]:
    """Per-city product mosaic clip (clip_tiff_whole,
    demo_preprocess_height_v2.py:1317-1386): select the extent-index grid
    tiles intersecting the query city's bounds, mosaic
    ``{tif_dir}/{suffix}_{location}.tif``, and write ONE city-extent raster
    at ``nresolution`` in the query's CRS — warping through
    :mod:`srbh_tpu_torch.data.crs` when the tile CRS differs (the reference's
    gdal.Warp(dstSRS=query_srs) branch). Idempotent: returns None if
    ``out_tif`` already exists, like the reference's early-return."""
    if os.path.exists(out_tif):
        return None
    query = read_shapefile(query_shp)
    if not query:
        raise ValueError(f"{query_shp}: no records")
    qb = (min(r.bounds[0] for r in query), min(r.bounds[1] for r in query),
          max(r.bounds[2] for r in query), max(r.bounds[3] for r in query))
    query_prj = _read_prj(query_shp)
    grid_prj = _read_prj(grid_shp)
    cross = (query_prj and grid_prj
             and " ".join(query_prj.split()) != " ".join(grid_prj.split()))
    gb = (_crs.transform_bounds(query_prj, grid_prj, qb) if cross else qb)

    files = []
    for rec in read_shapefile(grid_shp):
        minx, miny, maxx, maxy = rec.bounds
        if minx > gb[2] or maxx < gb[0] or miny > gb[3] or maxy < gb[1]:
            continue
        loc = str(rec.attributes.get(location_field, "") or "")
        if loc.endswith(".tif"):
            loc = loc[:-4]
        files.append(os.path.join(tif_dir, f"{suffix}_{loc}.tif"))
    if not files:
        raise ValueError(f"{query_shp}: no {suffix} tiles intersect")
    mosaic = VirtualMosaic(files, nodata=nodata)
    data = warp_window(mosaic, qb, nresolution,
                       dst_crs=query_prj if cross else None,
                       src_crs=grid_prj if cross else None)
    gt = (qb[0], nresolution, 0.0, qb[3], 0.0, -nresolution)
    # stamp the output CRS (gdal.Warp(dstSRS=...) keeps it; so do we)
    geo_keys = None
    out_prj = query_prj or grid_prj
    if out_prj and _crs.wkt_error(out_prj) is None:
        code = _crs.epsg_of(out_prj)
        if code:
            geo_keys = _crs.geokeys_for_epsg(code)
    write_tiff(out_tif, data.astype(dtype), geotransform=gt,
               compress="DEFLATE", nodata=nodata, geo_keys=geo_keys)
    return data.astype(dtype)


def _cli(argv=None):
    """CLI twin of the reference's __main__ driver blocks
    (demo_preprocess_height_v2.py:1756-1785 and the main_* functions)."""
    import argparse

    ap = argparse.ArgumentParser(prog="srbh-products")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("extent", help="bbox shapefile of rasters")
    p.add_argument("tifs", nargs="+")
    p.add_argument("--out", required=True)

    p = sub.add_parser("select", help="end-to-end sample selection")
    p.add_argument("--city-tifs", nargs="+", required=True)
    p.add_argument("--product-tifs", nargs="+", required=True)
    p.add_argument("--window", type=int, default=256)
    p.add_argument("--out-csv", default="num_valid.csv")

    p = sub.add_parser("compare", help="per-city product sweep CSV")
    p.add_argument("--pairs", nargs="+", required=True,
                   help="city=a.tif:b.tif ...")
    p.add_argument("--out-csv", required=True)

    p = sub.add_parser("clip-samples", help="clip valid sample pairs")
    p.add_argument("--ref-tif", required=True)
    p.add_argument("--product-tifs", nargs="+", required=True)
    p.add_argument("--shp", required=True)
    p.add_argument("--respath", required=True)

    p = sub.add_parser("clip-city", help="city-extent product mosaic")
    p.add_argument("--query-shp", required=True)
    p.add_argument("--grid-shp", required=True)
    p.add_argument("--tif-dir", required=True)
    p.add_argument("--out-tif", required=True)
    p.add_argument("--suffix", default="CNBH10m")
    p.add_argument("--resolution", type=float, default=10.0)

    args = ap.parse_args(argv)
    if args.cmd == "extent":
        raster_extent_shapefile(args.tifs, args.out)
    elif args.cmd == "select":
        counts = main_sample_selection(args.city_tifs, args.product_tifs,
                                       window_size=args.window,
                                       out_csv=args.out_csv)
        print(counts)
    elif args.cmd == "compare":
        pairs = {}
        for spec in args.pairs:
            city, rest = spec.split("=", 1)
            a, b = rest.split(":", 1)
            pairs[city] = (a, b)
        rows = compare_height_products(pairs, args.out_csv)
        print(rows[-1])
    elif args.cmd == "clip-samples":
        clip_valid_samples(args.ref_tif, VirtualMosaic(args.product_tifs),
                           args.shp, args.respath)
    elif args.cmd == "clip-city":
        clip_city_mosaic(args.query_shp, args.grid_shp, args.tif_dir,
                         args.out_tif, suffix=args.suffix,
                         nresolution=args.resolution)


if __name__ == "__main__":  # pragma: no cover
    _cli()
