"""Raw-data preprocessing toolbox.

The port's copy of ``srbh_tpu/tools/preprocess.py``, without cv2 (the
card's machine has none): footprints are burnt by ``data/raster.py``'s
``fill_poly`` / ``polylines``, pixel for pixel ``cv2.fillPoly`` /
``cv2.polylines`` on integer vertices, and ``compare_array_sums`` regrids
with its ``resize_nearest`` (exactly ``cv2.resize``'s INTER_NEAREST). The
written rasters and manifests are byte-equal to the JAX package's. It all
runs on the host: ``python -m srbh_tpu_torch.tools.preprocess`` does no
device work and takes no device argument.

Capability twins of the reference's GDAL/OGR-driven preparation scripts
(generate_WSF_mask_Globeheight_grid.py, demo_preprocess_height_v2.py),
implemented over the framework's own raster/vector codecs:

* :func:`shp2tif`            — rasterise polygon shapefiles onto a reference
  raster's grid, burning a constant or a DBF attribute
  (generate_WSF_mask_…py:33-66; demo_preprocess_…py building-footprint
  rasterisation).
* :func:`shp_to_tiff`        — rasterise onto a self-defined grid at a fixed
  resolution from the layer extent (demo_preprocess_…py:27-70).
* :func:`clip_tiff_by_tiff`  — clip one raster to another's extent
  (generate_WSF_mask_…py:78-98, the WSF2019-to-city step).
* :func:`main_gen_mask`      — per-city WSF mask generation driver
  (:101-134): clip WSF to each ``*_s2.tif`` extent.
* :func:`mosaic_rasters`     — nearest-grid mosaic of overlapping rasters
  (the gdal BuildVRT + Translate merge path).
* :func:`compare_rasters`    — IoU / RMSE / MAE between two height products
  (demo_preprocess_…py raster-comparison functions).
* :func:`floor_field_to_height` — vector floor-count -> metres field calc.
* :func:`download_sentinel12` / :func:`build_sentinel12_manifest` — the
  ESA WorldCover composite fetch driver (demo_preprocess_…py:1210-1261):
  grid-intersection + exact ``aws s3 cp`` command construction run here
  (offline); the copies themselves need network egress, so by default a
  ``download_manifest.sh`` is written for off-device execution
  (SRBH_ALLOW_NETWORK=1 executes in place).
"""
from __future__ import annotations

import os
import shlex
import subprocess
from glob import glob
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from srbh_tpu_torch.data import crs as _crs
from srbh_tpu_torch.data.grid import fishgrid_stats, write_fishgrid
from srbh_tpu_torch.data.raster import fill_poly, polylines, resize_nearest
from srbh_tpu_torch.data.shapefile import read_shapefile
from srbh_tpu_torch.data.tiff import TiffReader, write_tiff


def shp2tif(shp_path: str, ref_tif: str, out_tif: str,
            burn_value: float = 1.0, attribute: Optional[str] = None,
            dtype=np.uint8, all_touched: bool = False):
    """Rasterise polygons onto the reference raster's grid."""
    ref = TiffReader(ref_tif)
    gt = ref.geotransform
    h, w = ref.height, ref.width
    canvas = np.zeros((h, w), np.float64)
    inv_px, inv_py = 1.0 / gt[1], 1.0 / (-gt[5])
    for rec in read_shapefile(shp_path):
        value = (rec.attributes.get(attribute, 0)
                 if attribute else burn_value) or 0
        if not rec.rings:
            continue
        polys = []
        for ring in rec.rings:
            px = (ring[:, 0] - gt[0]) * inv_px
            py = (gt[3] - ring[:, 1]) * inv_py
            polys.append(np.stack([px, py], -1).round().astype(np.int32))
        # burn directly onto the canvas: a per-record full-frame mask would
        # make city-scale footprint rasterisation O(records * H * W)
        fill_poly(canvas, polys, float(value))
        if all_touched:
            for poly in polys:
                polylines(canvas, [poly], float(value))
    out = canvas.astype(dtype)
    write_tiff(out_tif, out, geotransform=gt, like=ref.info(),
               compress="DEFLATE")
    return out


def shp_to_tiff(shp_file: str, output_tiff: str, attribute: str = "class",
                nresolution: float = 2.5, dtype=np.uint8):
    """Rasterise polygons onto a self-defined grid at ``nresolution``
    (demo_preprocess_height_v2.py:27-70): the grid spans the layer extent
    with geotransform ``(xmin, res, 0, ymax, 0, -res)``, nodata 0, and the
    burn value comes from ``attribute``."""
    recs = read_shapefile(shp_file)
    if not recs:
        raise ValueError(f"{shp_file}: no records")
    xmin = min(r.bounds[0] for r in recs)
    ymin = min(r.bounds[1] for r in recs)
    xmax = max(r.bounds[2] for r in recs)
    ymax = max(r.bounds[3] for r in recs)
    w = int(abs((xmax - xmin) / nresolution))
    h = int(abs((ymax - ymin) / nresolution))
    canvas = np.zeros((h, w), np.float64)
    inv = 1.0 / nresolution
    for rec in recs:
        value = rec.attributes.get(attribute, 0) or 0
        if not rec.rings:
            continue
        polys = []
        for ring in rec.rings:
            px = (ring[:, 0] - xmin) * inv
            py = (ymax - ring[:, 1]) * inv
            polys.append(np.stack([px, py], -1).round().astype(np.int32))
        fill_poly(canvas, polys, float(value))
    out = canvas.astype(dtype)
    gt = (xmin, nresolution, 0.0, ymax, 0.0, -nresolution)
    write_tiff(output_tiff, out, geotransform=gt, compress="DEFLATE",
               nodata=0)
    return out


def clip_tiff_by_tiff(src_tif: str, extent_tif: str, out_tif: str,
                      compress: Optional[str] = "DEFLATE"):
    """Clip ``src_tif`` to ``extent_tif``'s bounds on the source grid."""
    src = TiffReader(src_tif)
    ext = TiffReader(extent_tif)
    sgt, egt = src.geotransform, ext.geotransform
    x0, y0 = egt[0], egt[3]
    x1 = x0 + egt[1] * ext.width
    y1 = y0 + egt[5] * ext.height
    xoff = int(round((x0 - sgt[0]) / sgt[1]))
    yoff = int(round((y0 - sgt[3]) / sgt[5]))
    xcount = int(round((x1 - x0) / sgt[1]))
    ycount = int(round((y1 - y0) / sgt[5]))
    xoff, yoff = max(0, xoff), max(0, yoff)
    xcount = min(xcount, src.width - xoff)
    ycount = min(ycount, src.height - yoff)
    if xcount <= 0 or ycount <= 0:
        raise ValueError(
            f"{extent_tif} does not overlap {src_tif} "
            f"(window {xoff},{yoff} size {xcount}x{ycount})")
    data = src.read((xoff, yoff, xcount, ycount))
    gt = (sgt[0] + xoff * sgt[1], sgt[1], 0.0,
          sgt[3] + yoff * sgt[5], 0.0, sgt[5])
    write_tiff(out_tif, data, geotransform=gt, like=src.info(),
               compress=compress)
    return data


def main_gen_mask(citydir: str, wsf_tif: str, outdir: str,
                  suffix: str = "_s2.tif") -> list:
    """Per-city WSF mask clip driver (generate_WSF_mask_…py:101-134)."""
    os.makedirs(outdir, exist_ok=True)
    outputs = []
    for tif in sorted(glob(os.path.join(citydir, "*" + suffix))):
        city = Path(tif).name[: -len(suffix)]
        out = os.path.join(outdir, f"{city}_wsf.tif")
        if not os.path.exists(out):
            clip_tiff_by_tiff(wsf_tif, tif, out)
        outputs.append(out)
    return outputs


def mosaic_rasters(tif_paths: Sequence[str], out_tif: str,
                   nodata: float = 0.0):
    """Union-extent mosaic on the first raster's grid (VRT-merge twin);
    later rasters win on overlap."""
    readers = [TiffReader(p) for p in tif_paths]
    gt0 = readers[0].geotransform
    px, py = gt0[1], gt0[5]
    xs, ys = [], []
    for r in readers:
        g = r.geotransform
        xs += [g[0], g[0] + g[1] * r.width]
        ys += [g[3], g[3] + g[5] * r.height]
    x0, y0 = min(xs), max(ys)
    w = int(round((max(xs) - x0) / px))
    h = int(round((min(ys) - y0) / py))
    canvas = np.full((h, w, readers[0].spp), nodata,
                     readers[0].dtype.newbyteorder("="))
    for pth, r in zip(tif_paths, readers):
        g = r.geotransform
        if (abs(g[1] - px) > 1e-9 * abs(px)
                or abs(g[5] - py) > 1e-9 * abs(py)):
            raise ValueError(
                f"{pth}: resolution {g[1]}x{g[5]} differs from the mosaic "
                f"grid {px}x{py}; resample first (tools.products.warp_raster"
                " or VirtualMosaic handle mixed grids)")
        if r.spp != readers[0].spp:
            raise ValueError(f"{pth}: {r.spp} bands != {readers[0].spp}")
        cx = int(round((g[0] - x0) / px))
        cy = int(round((g[3] - y0) / py))
        data = r.read()
        canvas[cy: cy + r.height, cx: cx + r.width] = data
    write_tiff(out_tif, canvas, geotransform=(x0, px, 0, y0, 0, py),
               like=readers[0].info(), compress="DEFLATE")
    return canvas


def compare_array_sums(a: np.ndarray, b: np.ndarray,
                       threshold: float = 0.0) -> dict:
    """Raw mask/diff sums for a height-product pair: ``b`` is regridded to
    ``a``'s grid (nearest) when shapes differ; metrics run over the union of
    the >threshold masks. Shared by :func:`compare_rasters` and
    ``tools.products.compare_height_products`` (the sums, unlike the derived
    metrics, aggregate additively across cities)."""
    if a.shape != b.shape:
        b = resize_nearest(b, a.shape[1], a.shape[0])
    ma, mb = a > threshold, b > threshold
    both = ma | mb
    diff = (a - b)[both]
    return {"inter": int((ma & mb).sum()), "union": int(both.sum()),
            "sq": float((diff ** 2).sum()), "abs": float(np.abs(diff).sum()),
            "me_sum": float(diff.sum()), "count": int(diff.size)}


def compare_metrics_from_sums(s: dict, ndigits: Optional[int] = None) -> dict:
    """Derive iou/rmse/mae/me/count from :func:`compare_array_sums` output."""
    n = s["count"]
    out = {
        "iou": s["inter"] / s["union"] if s["union"] else 0.0,
        "rmse": float(np.sqrt(s["sq"] / n)) if n else 0.0,
        "mae": s["abs"] / n if n else 0.0,
        "me": s["me_sum"] / n if n else 0.0,
        "count": n,
    }
    if ndigits is not None:
        out = {k: (round(v, ndigits) if k != "count" else v)
               for k, v in out.items()}
    return out


def compare_rasters(a_tif: str, b_tif: str, threshold: float = 0.0) -> dict:
    """IoU of the >threshold masks + RMSE/MAE/ME over their union
    (demo_preprocess_…py height-product comparison)."""
    a = TiffReader(a_tif).read()[..., 0].astype(np.float64)
    b = TiffReader(b_tif).read()[..., 0].astype(np.float64)
    return compare_metrics_from_sums(compare_array_sums(a, b, threshold))


def floor_field_to_height(values: np.ndarray, m_per_floor: float = 3.0,
                          min_floors: int = 2) -> np.ndarray:
    """Floor counts -> metres with a minimum-floor clamp
    (stats_dataset_globe.py:211-226 field math)."""
    v = np.asarray(values).copy()
    v[(v > 0) & (v < min_floors + 1)] = min_floors
    return v * m_per_floor


def build_sentinel12_manifest(query_shp: str, ref_shp: str, resroot: str,
                              typelist=("s1_vvvhratio", "s2_rgbnir"),
                              year: str = "2020"):
    """Tile manifest for the ESA WorldCover Sentinel-1/2 composites
    (download_sentinel12, demo_preprocess_height_v2.py:1210-1261).

    The reference intersects the city extent with the WorldCover composite
    grid (``esa_worldcover_grid_composites``) and ``aws s3 cp``s each
    matching tile. Everything except the copy is pure geometry + string
    work, done here: returns ``(fplist, commands)`` where ``fplist`` are
    the local destination paths and ``commands`` the exact
    ``aws s3 cp <url> <dir> --no-sign-request`` invocations.

    ``ref_shp`` is the grid in ESRI-shapefile form (the reference reads the
    .fgb FlatGeobuf build of the same grid; convert once with
    ``ogr2ogr grid.shp esa_worldcover_grid_composites.fgb``). Attribute
    columns consumed: ``ll_tile`` (landcover tile id) and
    ``{type}_{year}`` s3 paths — the reference's exact schema.
    """
    cells = read_shapefile(query_shp)
    if not cells:
        raise ValueError(f"{query_shp}: empty query")
    qb = [min(c.bounds[0] for c in cells), min(c.bounds[1] for c in cells),
          max(c.bounds[2] for c in cells), max(c.bounds[3] for c in cells)]
    qprj = Path(query_shp).with_suffix(".prj")
    gprj = Path(ref_shp).with_suffix(".prj")
    if qprj.exists() != gprj.exists():
        # fail loudly (crs.from_wkt policy): with only one sidecar we
        # cannot tell whether the CRSs match, and silently assuming they
        # do turns a projected-vs-geographic mismatch into an empty or
        # wrong tile intersection with no error
        missing = gprj if qprj.exists() else qprj
        raise ValueError(
            f"{missing}: missing .prj sidecar — cannot verify the query "
            "and WorldCover grid share a CRS; ship BOTH sidecars (or "
            "neither, which asserts a shared CRS)")
    if qprj.exists() and gprj.exists():
        qwkt, gwkt = qprj.read_text(), gprj.read_text()
        if qwkt.strip() != gwkt.strip():  # query -> grid CRS (ref :1223)
            qb = list(_crs.transform_bounds(qwkt, gwkt, tuple(qb)))
    tiles = [r for r in read_shapefile(ref_shp)
             if not (r.bounds[2] < qb[0] or r.bounds[0] > qb[2]
                     or r.bounds[3] < qb[1] or r.bounds[1] > qb[3])]
    def _cmd(url, respath):
        # quoted: respath may contain spaces; runs correctly both via the
        # manifest shell script and the SRBH_ALLOW_NETWORK subprocess path
        return ("aws s3 cp " + shlex.quote(str(url)) + " "
                + shlex.quote(respath) + " --no-sign-request")

    fplist, commands = [], []
    for typ in typelist:
        respath = os.path.join(resroot, typ)
        if typ == "landcover":
            ver = ("v100/2020/map", "v100") if year == "2020" \
                else ("v200/2021/map", "v200")
            for rec in tiles:
                tile = rec.attributes.get("ll_tile")
                if tile is None:
                    continue
                yr = "2020" if year == "2020" else "2021"
                url = (f"s3://esa-worldcover/{ver[0]}/"
                       f"ESA_WorldCover_10m_{yr}_{ver[1]}_{tile}_Map.tif")
                fplist.append(os.path.join(respath, os.path.basename(url)))
                commands.append(_cmd(url, respath))
        else:
            # the reference grid ships as .fgb with full column names
            # ("s1_vvvhratio_2020"); converted shapefiles truncate DBF
            # fields to 10 chars — accept both spellings
            field = f"{typ}_{year}"
            for rec in tiles:
                url = rec.attributes.get(field)
                if url is None:
                    url = rec.attributes.get(field[:10])
                if not url:
                    continue
                fplist.append(os.path.join(respath,
                                           os.path.basename(str(url))))
                commands.append(_cmd(url, respath))
    return fplist, commands


def download_sentinel12(query_shp: str, resroot: str,
                        typelist=("s1_vvvhratio", "s2_rgbnir"),
                        year: str = "2020", ref_shp: Optional[str] = None):
    """Sentinel-1/2 composite fetch driver (demo_preprocess_…py:1210-1261).

    Builds the tile manifest offline (:func:`build_sentinel12_manifest`);
    already-present files are skipped like the reference. The actual S3
    copies need network egress, absent here, so by default the commands
    are written to ``{resroot}/download_manifest.sh`` for off-device
    execution and the destination list is returned; set
    ``SRBH_ALLOW_NETWORK=1`` to execute them in place.
    """
    if ref_shp is None:
        raise ValueError(
            "pass ref_shp: the esa_worldcover_grid_composites grid "
            "(shapefile form) the reference intersects against")
    fplist, commands = build_sentinel12_manifest(query_shp, ref_shp,
                                                 resroot, typelist, year)
    todo = [c for f, c in zip(fplist, commands) if not os.path.exists(f)]
    if not todo:
        return fplist
    if os.environ.get("SRBH_ALLOW_NETWORK") == "1":
        for typ in typelist:
            os.makedirs(os.path.join(resroot, typ), exist_ok=True)
        for c in todo:
            subprocess.run(shlex.split(c), check=True)
        return fplist
    os.makedirs(resroot, exist_ok=True)
    manifest = os.path.join(resroot, "download_manifest.sh")
    with open(manifest, "w") as f:
        f.write("#!/bin/sh\n# generated by srbh_tpu (zero-egress image);\n"
                "# run off-device to fetch the WorldCover composites\n")
        for typ in typelist:
            f.write(f"mkdir -p {shlex.quote(os.path.join(resroot, typ))}\n")
        f.write("\n".join(todo) + "\n")
    print(f"download_sentinel12: no network egress here — wrote "
          f"{len(todo)} copy commands to {manifest}")
    return fplist


def _cli(argv=None):
    """CLI twin of generate_WSF_mask_Globeheight_grid.py's __main__ +
    demo_preprocess_height_v2.py's main_shp2tif/main2 drivers."""
    import argparse

    ap = argparse.ArgumentParser(prog="srbh-preprocess")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("gen-mask", help="clip the WSF raster per city")
    p.add_argument("--citydir", required=True)
    p.add_argument("--wsf", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--suffix", default="_s2.tif")

    p = sub.add_parser("shp2tif", help="rasterise onto a reference grid")
    p.add_argument("--shp", required=True)
    p.add_argument("--ref-tif", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--attribute", default=None)

    p = sub.add_parser("shp-to-tiff", help="rasterise onto an own 2.5 m grid")
    p.add_argument("--shp", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--attribute", default="class")
    p.add_argument("--resolution", type=float, default=2.5)

    p = sub.add_parser("clip", help="clip a raster to another's extent")
    p.add_argument("--src", required=True)
    p.add_argument("--extent", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("mosaic", help="merge rasters onto the first's grid")
    p.add_argument("tifs", nargs="+")
    p.add_argument("--out", required=True)

    p = sub.add_parser("grid", help="write the 64/56 fishnet + WSF validity")
    p.add_argument("--tif", required=True)
    p.add_argument("--wsf", required=True)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--offset", type=int, default=56)

    a = ap.parse_args(argv)
    if a.cmd == "gen-mask":
        main_gen_mask(a.citydir, a.wsf, a.outdir, a.suffix)
    elif a.cmd == "shp2tif":
        shp2tif(a.shp, a.ref_tif, a.out, attribute=a.attribute)
    elif a.cmd == "shp-to-tiff":
        shp_to_tiff(a.shp, a.out, attribute=a.attribute,
                    nresolution=a.resolution)
    elif a.cmd == "clip":
        clip_tiff_by_tiff(a.src, a.extent, a.out)
    elif a.cmd == "mosaic":
        mosaic_rasters(a.tifs, a.out)
    elif a.cmd == "grid":
        shp = write_fishgrid(a.tif, a.window, a.offset)
        fishgrid_stats(a.wsf, shp)
        print(shp)


if __name__ == "__main__":  # pragma: no cover
    _cli()
