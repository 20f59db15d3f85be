"""The port's product tools (no cv2, no ``try``) against the JAX package's.

Every file written is compared byte for byte: the extent shapefiles, the
DBF fields that ``add_field_by_expression``, ``zonal_stats`` and
``compare_grid_products`` add, the sample pairs of ``clip_valid_samples``,
the CSVs of ``count_valid_samples`` / ``compare_height_products``, the
rasters of ``warp_raster``, ``main_proc_product`` (mixed CRSs warped to a
common EPSG code, an already-common tile copied, the extent index's
``.prj``; an EPSG code without a WKT, which gets none) and
``clip_city_mosaic`` (across CRSs, and with a ``.prj`` the parser refuses,
which stamps no GeoKeys), and each ``_cli`` subcommand's outputs. Arrays
(``VirtualMosaic`` windows and samples, ``warp_window``) are equal, and
``sample_height_rmse`` (a nearest resize to 256) gives the same float.
"""
import os

import numpy as np
import pytest

from srbh_tpu.data import crs as jcrs
from srbh_tpu.data import tiff as jtiff
from srbh_tpu.tools import products as jprod
from srbh_tpu_torch.data import crs
from srbh_tpu_torch.data.shapefile import ShapeRecord, write_shapefile
from srbh_tpu_torch.tools import products as prod
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _twice(tmp_path, fn):
    """Run ``fn(module, root)`` in a fresh tree for each package and compare
    the trees byte for byte; returns both results."""
    got = {}
    for mod, name in ((jprod, "jax"), (prod, "port")):
        root = tmp_path / name
        os.makedirs(root)
        got[name] = fn(mod, str(root))
    want, mine = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(mine) == sorted(want)
    for p in want:
        assert mine[p] == want[p], p
    return got["jax"], got["port"]


def _city(root, seed=0, side=64):
    """A reference height raster on a 1 m grid, two product tiles that
    overlap it (one with a NaN collar) and a 16 m fishgrid tagged valid."""
    rng = np.random.default_rng(seed)
    ref = (rng.random((side, side)) < 0.4).astype(np.uint8) * \
        rng.integers(1, 30, (side, side)).astype(np.uint8)
    gt = (1000.0, 1.0, 0.0, 2000.0, 0.0, -1.0)
    jtiff.write_tiff(os.path.join(root, "metro.tif"), ref, geotransform=gt)
    p1 = np.where(rng.random((side, side // 2 + 8)) < 0.9, ref[:, :side // 2 + 8], 0)
    jtiff.write_tiff(os.path.join(root, "CNBH_a.tif"), p1.astype(np.float32),
                     geotransform=gt)
    p2 = ref[:, side // 2 - 8:].astype(np.float32)
    p2[:, :3] = np.nan
    jtiff.write_tiff(os.path.join(root, "CNBH_b.tif"), p2,
                     geotransform=(1000.0 + side // 2 - 8, 1.0, 0.0, 2000.0,
                                   0.0, -1.0))
    cells = [(1000.0 + x, 2000.0 - y - 16, 1000.0 + x + 16, 2000.0 - y)
             for x in range(0, side, 16) for y in range(0, side, 16)]
    recs = [ShapeRecord(c, {"FID": i, "isv": int(i % 5 != 0),
                            "elevation": 3.0 * i + 1.5})
            for i, c in enumerate(cells)]
    write_shapefile(os.path.join(root, "metro_grid.shp"), recs,
                    [("FID", "N", 10, 0), ("isv", "N", 10, 0),
                     ("elevation", "N", 19, 3)])
    return [os.path.join(root, f) for f in ("CNBH_a.tif", "CNBH_b.tif")]


def test_virtual_mosaic_windows_and_samples_equal_jax(tmp_path):
    tiles = _city(str(tmp_path))
    jm, pm = jprod.VirtualMosaic(tiles), prod.VirtualMosaic(tiles)
    for bounds, res in (((1000.0, 1936.0, 1064.0, 2000.0), 1.0),
                        ((990.5, 1950.0, 1080.0, 2010.0), 2.5),
                        ((1010.0, 1960.0, 1030.0, 1990.0), 0.5)):
        np.testing.assert_array_equal(pm.read_window(bounds, res),
                                      jm.read_window(bounds, res))
    xs = np.random.default_rng(1).uniform(990.0, 1070.0, 300)
    ys = np.random.default_rng(2).uniform(1930.0, 2005.0, 300)
    np.testing.assert_array_equal(pm.sample(xs, ys), jm.sample(xs, ys))
    np.testing.assert_array_equal(
        prod.warp_window(pm, (1000.0, 1936.0, 1064.0, 2000.0), 2.0),
        jprod.warp_window(jm, (1000.0, 1936.0, 1064.0, 2000.0), 2.0))


def test_grid_comparison_and_samples_equal_jax(tmp_path):
    def run(mod, root):
        tiles = _city(root)
        shp = os.path.join(root, "metro_grid.shp")
        mosaic = mod.VirtualMosaic(tiles)
        out = [mod.add_field_by_expression(shp),
               mod.zonal_stats(shp, os.path.join(root, "metro.tif")),
               mod.compare_grid_products(os.path.join(root, "metro.tif"),
                                         mosaic, shp, nresolution=1.0,
                                         condition=(0, 20, 256, 0.3))]
        shp2 = os.path.join(root, "iou", "metro_grid.shp")
        os.makedirs(os.path.dirname(shp2))
        for e in (".shp", ".shx", ".dbf"):
            with open(shp[:-4] + e, "rb") as a, open(shp2[:-4] + e, "wb") as b:
                b.write(a.read())
        out.append(mod.compare_grid_products(
            os.path.join(root, "metro.tif"), mosaic, shp2, nresolution=1.0,
            condition=(0, 20, 256, 0.65), use_iou=True))
        out.append([os.path.relpath(p, root) for p in mod.clip_valid_samples(
            os.path.join(root, "metro.tif"), mosaic, shp2,
            os.path.join(root, "samples"), nresolution=1.0)])
        out.append(mod.count_valid_samples([shp, shp2],
                                           os.path.join(root, "nv.csv")))
        return out

    want, got = _twice(tmp_path, run)
    assert got == want
    assert len(got[4]) > 2 and sum(got[2]["isv4"]) > 0


def test_height_product_sweep_and_rmse_equal_jax(tmp_path):
    def run(mod, root):
        rng = np.random.default_rng(5)
        pairs = {}
        for i, shape in enumerate([(40, 40), (40, 40), (30, 50)]):
            a = os.path.join(root, f"a{i}.tif")
            b = os.path.join(root, f"b{i}.tif")
            jtiff.write_tiff(a, rng.integers(0, 40, (40, 40)).astype(np.uint16))
            jtiff.write_tiff(b, (rng.random(shape) * 40).astype(np.float32))
            pairs[f"city{i}"] = (a, b)
        rows = mod.compare_height_products(pairs, os.path.join(root, "c.csv"),
                                           threshold=3.0)
        for d, arr in (("cbra", rng.integers(0, 2, (256, 256)) * 255),
                       ("cnbh", rng.random((64, 64)) * 20),
                       ("bh", rng.integers(0, 12, (256, 256)))):
            os.makedirs(os.path.join(root, d))
            dtype = np.float32 if d == "cnbh" else np.uint8
            if d == "cnbh":
                arr[:3] = np.nan
            jtiff.write_tiff(os.path.join(root, d, "s.tif"), arr.astype(dtype))
        rmse = mod.sample_height_rmse(*(os.path.join(root, d)
                                        for d in ("cbra", "cnbh", "bh")), "s.tif")
        return rows, rmse

    (jrows, jrmse), (rows, rmse) = _twice(tmp_path, run)
    assert rows == jrows and rmse == jrmse and rmse > 0


def test_main_sample_selection_equals_jax(tmp_path):
    def run(mod, root):
        tiles = _city(root, seed=3)
        os.remove(os.path.join(root, "metro_grid.shp"))
        return mod.main_sample_selection(
            [os.path.join(root, "metro.tif")], tiles, window_size=16,
            grid_condition=(0, 8, 256), compare_condition=(0, 8, 256, 0.65),
            nresolution=1.0, out_csv=os.path.join(root, "nv.csv"))

    want, got = _twice(tmp_path, run)
    assert got == want and got["metro"] > 0


def _utm_tiles(root, codes):
    tdir = os.path.join(root, "tiles")
    os.makedirs(tdir)
    tiles = []
    for i, code in enumerate(codes):
        p = os.path.join(tdir, f"CNBH10m_t{i}.tif")
        gt = ((500000.0 + 800.0 * i, 10.0, 0.0, 4831000.0, 0.0, -10.0)
              if code != 4326 else
              (-81.003 + 0.009 * i, 0.0001, 0.0, 43.625, 0.0, -0.0001))
        arr = np.full((100, 100), i + 1, np.float32)
        arr[::7, ::5] = 0.0
        jtiff.write_tiff(p, arr, geotransform=gt,
                         geo_keys=None if code is None else
                         jcrs.geokeys_for_epsg(code))
        tiles.append(p)
    return tiles


def test_warp_raster_bytes_equal_jax(tmp_path):
    def run(mod, root):
        t = _utm_tiles(root, [32617])[0]
        out = os.path.join(root, "w.tif")
        mod.warp_raster(t, out, 4326, 0.0002)
        mod.warp_raster(t, os.path.join(root, "w2.tif"), 3857, 25.0,
                        src_crs=crs.wkt_for_epsg(32617))
        return str(mod.raster_crs(mod.TiffReader(out)))

    want, got = _twice(tmp_path, run)
    assert got == want


@pytest.mark.parametrize("codes,common", [((32617, 32617, 4326), 4326),
                                          ((32617, None, 32617), None),
                                          ((3395, 3395), None)])
def test_main_proc_product_equals_jax(tmp_path, codes, common):
    def run(mod, root):
        tiles = _utm_tiles(root, codes)
        q = os.path.join(root, "cityA_grid.shp")
        if common == 4326:
            b = jcrs.transform_bounds(32617, 4326,
                                      (500300.0, 4830300.0, 501700.0, 4830700.0))
            write_shapefile(q, [ShapeRecord(b)], prj_wkt=crs.wkt_for_epsg(4326))
            res = 0.0001
        else:
            write_shapefile(q, [ShapeRecord((500200.0, 4830200.0,
                                             501500.0, 4830900.0))])
            res = 10.0
        outs = mod.main_proc_product(tiles, [q], os.path.join(root, "res"),
                                     nresolution=res, common_epsg=common)
        again = mod.main_proc_product(tiles, [q], os.path.join(root, "res"),
                                      nresolution=res, common_epsg=common)
        assert again == outs
        return [os.path.relpath(p, root) for p in outs]

    want, got = _twice(tmp_path, run)
    assert got == want == [os.path.join("res", "cityA.tif")]
    has_prj = os.path.exists(tmp_path / "port" / "res" / "all_grid.prj")
    assert has_prj == (common == 4326 or codes[0] == 32617)


@pytest.mark.parametrize("query", ["utm", "geographic", "unparsable"])
def test_clip_city_mosaic_equals_jax(tmp_path, query):
    bad = 'PROJCS["x",PROJECTION["Bonne"],UNIT["metre",1]]'

    def run(mod, root):
        tiles = _utm_tiles(root, [32617, 32617])
        grid = os.path.join(root, "extent.shp")
        mod.raster_extent_shapefile(tiles, grid,
                                    loc_from_name=lambda s: s.split("_", 1)[1])
        with open(grid[:-4] + ".prj", "w") as f:
            f.write(bad if query == "unparsable" else crs.wkt_for_epsg(32617))
        q = os.path.join(root, "city_q.shp")
        if query == "geographic":
            b = jcrs.transform_bounds(32617, 4326,
                                      (500200.0, 4830200.0, 501200.0, 4830800.0))
            write_shapefile(q, [ShapeRecord(b)], prj_wkt=crs.wkt_for_epsg(4326))
            res = 0.0001
        else:
            write_shapefile(q, [ShapeRecord((500200.0, 4830200.0,
                                             501200.0, 4830800.0))],
                            prj_wkt=None if query == "unparsable" else
                            crs.wkt_for_epsg(32617))
            res = 10.0
        out = os.path.join(root, "city.tif")
        data = mod.clip_city_mosaic(q, grid, os.path.dirname(tiles[0]), out,
                                    nresolution=res)
        assert mod.clip_city_mosaic(q, grid, os.path.dirname(tiles[0]), out,
                                    nresolution=res) is None
        return data

    want, got = _twice(tmp_path, run)
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("cmd", ["extent", "select", "compare", "clip-samples",
                                 "clip-city"])
def test_cli_subcommands_equal_jax(tmp_path, cmd, capsys):
    def run(mod, root):
        tiles = _city(root, seed=7)
        metro = os.path.join(root, "metro.tif")
        argv = {
            "extent": ["extent", *tiles, "--out", os.path.join(root, "e.shp")],
            "select": ["select", "--city-tifs", metro, "--product-tifs", *tiles,
                       "--window", "16", "--out-csv",
                       os.path.join(root, "nv.csv")],
            "compare": ["compare", "--pairs", f"metro={metro}:{tiles[0]}",
                        f"m2={metro}:{tiles[1]}", "--out-csv",
                        os.path.join(root, "c.csv")],
            "clip-samples": ["clip-samples", "--ref-tif", metro,
                             "--product-tifs", *tiles, "--shp",
                             os.path.join(root, "metro_grid.shp"),
                             "--respath", os.path.join(root, "s")],
            "clip-city": ["clip-city", "--query-shp",
                          os.path.join(root, "metro_grid.shp"), "--grid-shp",
                          os.path.join(root, "e.shp"), "--tif-dir", root,
                          "--out-tif", os.path.join(root, "city.tif"),
                          "--suffix", "CNBH", "--resolution", "2.0"],
        }
        if cmd == "clip-city":  # the tiles are named {suffix}_{location}
            mod.raster_extent_shapefile(
                tiles, os.path.join(root, "e.shp"),
                loc_from_name=lambda s: s.split("_", 1)[1])
        if cmd == "clip-samples":
            write_shapefile(os.path.join(root, "metro_grid.shp"),
                            [ShapeRecord((1000.0 + x, 1984.0 - y, 1016.0 + x,
                                          2000.0 - y), {"FID": x + y, "isv4": 1})
                             for x in (0, 32) for y in (0, 16)],
                            [("FID", "N", 10, 0), ("isv4", "N", 10, 0)])
        mod._cli(argv[cmd])
        return capsys.readouterr().out.replace(root, "<root>")

    want, got = _twice(tmp_path, run)
    assert got == want
