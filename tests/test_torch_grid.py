"""The port's GeoTIFF metadata and writer, shapefiles and fishnet grids
against the JAX package's.

Everything here is exact: the same arguments give the same file bytes, the
same cells, windows and attributes, and the same dataset samples (float32,
compared with tolerance 0).
"""
import dataclasses
import os

import numpy as np
import pytest

from srbh_tpu.data import grid as jgrid
from srbh_tpu.data import shapefile as jshp
from srbh_tpu.data import tiff as jtiff
from srbh_tpu_torch.data import grid, shapefile, tiff
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)


GT = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
CMAP = {0: (0, 0, 0, 255), 1: (0, 40, 255, 255), 6: (127, 0, 0, 255)}
# a GeoKeyDirectory (version 1.1.0, 2 keys: model type projected, EPSG 32650)
GEO_KEYS = np.array([1, 1, 0, 2, 1024, 0, 1, 1, 3072, 0, 1, 32650],
                    "<u2").tobytes()
GEO_DOUBLES = np.array([6378137.0, 298.257223563], "<f8").tobytes()
GEO_ASCII = b"WGS 84 / UTM zone 50N|\x00"


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _like(mod):
    return mod.TiffInfo(width=1, height=1, count=1, dtype=np.dtype("u1"),
                        compression=1, geotransform=GT, geo_keys=GEO_KEYS,
                        geo_doubles=GEO_DOUBLES, geo_ascii=GEO_ASCII)


CASES = {
    "u8_colormap_nodata_like": dict(
        array=("u1", (37, 29)), compress=None, colormap=CMAP, nodata=0.0,
        like=True),
    "u16_deflate_geokeys_strips": dict(
        array=("u2", (300, 41)), compress="DEFLATE", geo_keys=GEO_KEYS,
        like=True, rows_per_strip=128),
    "f32_packbits_rotated": dict(
        array=("f4", (20, 16, 3)), compress="PACKBITS", nodata=-9999.5,
        geotransform=(10.0, 2.5, 0.1, 20.0, 0.2, -2.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_tiff_bytes_equal_jax(case, tmp_path):
    spec = dict(CASES[case])
    dtype, shape = spec.pop("array")
    rng = np.random.default_rng(len(case))
    array = (rng.integers(0, 7, shape) if dtype == "u1" else
             rng.uniform(0, 6e4, shape)).astype(dtype)
    use_like = spec.pop("like", False)
    for mod, name in ((jtiff, "jax.tif"), (tiff, "port.tif")):
        mod.write_tiff(str(tmp_path / name), array,
                       like=_like(mod) if use_like else None, **spec)
    assert _read(tmp_path / "port.tif") == _read(tmp_path / "jax.tif")
    np.testing.assert_array_equal(
        tiff.TiffReader(str(tmp_path / "port.tif")).read(),
        array.reshape(array.shape[:2] + (-1,)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiff_info_equals_jax(case, tmp_path):
    spec = dict(CASES[case])
    dtype, shape = spec.pop("array")
    array = np.arange(np.prod(shape)).reshape(shape).astype(dtype)
    path = str(tmp_path / "src.tif")
    jtiff.write_tiff(path, array, like=_like(jtiff) if spec.pop("like", False)
                     else None, **spec)
    want = dataclasses.asdict(jtiff.TiffReader(path).info())
    got = dataclasses.asdict(tiff.TiffReader(path).info())
    assert got == want
    assert got["nodata"] == spec.get("nodata")
    assert (got["colormap"] is not None) == ("colormap" in spec)


def test_nodata_that_is_not_a_number_reads_as_none(tmp_path):
    path = str(tmp_path / "a.tif")
    jtiff.write_tiff(path, np.zeros((4, 4), np.uint8), nodata="n/a")
    assert jtiff.TiffReader(path).nodata is None
    assert tiff.TiffReader(path).nodata is None


def _records(mod, rng, n=9):
    return [mod.ShapeRecord(
        (float(x), float(y), float(x) + 64.0, float(y) + 64.0),
        {"isv": int(rng.integers(0, 2)), "sum": int(rng.integers(0, 4096)),
         "name": f"cell{i}", "frac": float(rng.uniform())})
        for i, (x, y) in enumerate(rng.uniform(0, 1e4, (n, 2)))]


FIELDS = [("isv", "N", 19, 0), ("sum", "N", 19, 0), ("name", "C", 12, 0),
          ("frac", "N", 19, 6)]


def test_shapefiles_cross_read_and_are_byte_equal(tmp_path):
    for mod, name in ((jshp, "jax"), (shapefile, "port")):
        mod.write_shapefile(str(tmp_path / f"{name}.shp"),
                            _records(mod, np.random.default_rng(3)), FIELDS,
                            prj_wkt='PROJCS["test"]')
    for ext in (".shp", ".shx", ".dbf", ".prj"):
        assert _read(tmp_path / f"port{ext}") == _read(tmp_path / f"jax{ext}")
    for reader, written in ((shapefile, "jax"), (jshp, "port")):
        other = jshp if reader is shapefile else shapefile
        got = reader.read_shapefile(str(tmp_path / f"{written}.shp"))
        want = other.read_shapefile(str(tmp_path / f"{written}.shp"))
        assert [(r.bounds, r.attributes) for r in got] == \
            [(r.bounds, r.attributes) for r in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.rings[0], b.rings[0])


def test_update_dbf_fields_equals_jax(tmp_path):
    for mod, name in ((jshp, "jax"), (shapefile, "port")):
        path = str(tmp_path / f"{name}.shp")
        mod.write_shapefile(path, _records(mod, np.random.default_rng(4)),
                            FIELDS, prj_wkt='PROJCS["test"]')
        mod.update_dbf_fields(path, [("isv", "N", 19, 0), ("new", "N", 8, 2)],
                              [[1] * 9, [0.5 * i for i in range(9)]])
    for ext in (".shp", ".shx", ".dbf", ".prj"):
        assert _read(tmp_path / f"port{ext}") == _read(tmp_path / f"jax{ext}")


@pytest.mark.parametrize("width,height,gt", [
    (64 + 56, 64 + 56, (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)),  # exact multiple
    (200, 150, GT),  # ragged: boundary column, row and corner
    (64, 300, (-1e5, 2.5, 0.0, 3e5, 0.0, -2.5)),  # one column
])
def test_fishgrid_cells_equal_jax(width, height, gt):
    got = grid.fishgrid_cells(width, height, gt, 64, 56)
    assert got == jgrid.fishgrid_cells(width, height, gt, 64, 56)
    assert len(got) > 0


def test_fishgrid_bounds_cells_equal_jax():
    args = (3.0, 1000.0, -20.0, 700.0, 128.0, 96.0)
    assert grid.fishgrid_bounds_cells(*args) == jgrid.fishgrid_bounds_cells(*args)


def _city(root, rng, w=200, h=150, geo_keys=None):
    """A synthetic city (JAX's writer): s2 6-band uint16, s1 2-band float32,
    a 0/255 WSF mask, min-max tables."""
    os.makedirs(root, exist_ok=True)
    jtiff.write_tiff(os.path.join(root, "demo_s2.tif"),
                     rng.integers(0, 5000, (h, w, 6)).astype(np.uint16),
                     geotransform=GT, geo_keys=geo_keys)
    jtiff.write_tiff(os.path.join(root, "demo_s1.tif"),
                     rng.uniform(-25, 5, (h, w, 2)).astype(np.float32),
                     geotransform=GT)
    wsf = (rng.random((h, w)) < 0.002).astype(np.uint8) * 255
    wsf[: h // 2, : w // 2] = 255  # a built-up block: some cells valid
    jtiff.write_tiff(os.path.join(root, "demo_wsf.tif"), wsf, geotransform=GT)
    os.makedirs(os.path.join(root, "stats"), exist_ok=True)
    np.savetxt(os.path.join(root, "stats", "s2x_minmax.txt"),
               np.stack([np.full(6, 0.0), np.full(6, 5000.0)]))
    np.savetxt(os.path.join(root, "stats", "s1x_minmax.txt"),
               np.stack([np.full(2, -25.0), np.full(2, 5.0)]))


@pytest.fixture(scope="module")
def cities(tmp_path_factory):
    """The same city twice, its grid written and tagged by each package."""
    root = tmp_path_factory.mktemp("cities")
    for mod, name in ((jgrid, "jax"), (grid, "port")):
        d = str(root / name)
        _city(d, np.random.default_rng(0))
        mod.write_fishgrid(os.path.join(d, "demo_s2.tif"), 64, 56)
        mod.fishgrid_stats(os.path.join(d, "demo_wsf.tif"),
                           os.path.join(d, "demo_s2_grid.shp"),
                           condition=(0, 20, 4096))
    return root


def test_fishgrid_stats_and_index_equal_jax(cities):
    ext = (".shp", ".shx", ".dbf")
    for e in ext:
        assert _read(cities / "port" / f"demo_s2_grid{e}") == \
            _read(cities / "jax" / f"demo_s2_grid{e}")
    shp = str(cities / "port" / "demo_s2_grid.shp")
    recs = shapefile.read_shapefile(shp)
    assert [r.attributes for r in recs] == \
        [r.attributes for r in jshp.read_shapefile(shp)]
    n_valid = grid.count_fishgrid_valid(shp)
    assert n_valid == jgrid.count_fishgrid_valid(shp)
    assert 0 < n_valid < len(recs)
    for valid in (None, "isv"):
        got = grid.generate_index(shp, GT, valid)
        assert got == jgrid.generate_index(shp, GT, valid)
    assert len(grid.generate_index(shp, GT, "isv")) == n_valid


def test_grid_dataset_samples_equal_jax(cities):
    root = str(cities / "port")
    kw = dict(s1dir="s1x", s2dir="s2x", gridvalid="isv", nchans=6)
    got = grid.GridImageDataset(root, "demo", os.path.join(root, "stats"), **kw)
    want = jgrid.GridImageDataset(root, "demo", os.path.join(root, "stats"),
                                  **kw)
    assert len(got) == len(want) > 0
    assert (got.width, got.height, got.geotrans) == \
        (want.width, want.height, want.geotrans)
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert a["image"].shape == (64, 64, 8) and a["image"].dtype == np.float32
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["pos"], b["pos"])
    # a ragged window is zero-padded to the window on both sides
    got.pos[0] = want.pos[0] = (150, 100, 50, 50)
    np.testing.assert_array_equal(got[0]["image"], want[0]["image"])
    assert not got[0]["image"][50:].any()


def test_write_fishgrid_tif_equals_jax(tmp_path):
    _city(str(tmp_path), np.random.default_rng(1))
    src = str(tmp_path / "demo_wsf.tif")
    out = jgrid.write_fishgrid_tif(src, 32)
    want = {e: _read(out[:-4] + e) for e in (".shp", ".shx", ".dbf")}
    assert grid.write_fishgrid_tif(src, 32) == out
    for e, data in want.items():
        assert _read(out[:-4] + e) == data


def test_write_fishgrid_with_geokeys_needs_a_prj(tmp_path):
    _city(str(tmp_path), np.random.default_rng(2), geo_keys=GEO_KEYS)
    src = str(tmp_path / "demo_s2.tif")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        grid.write_fishgrid(src)
    out = grid.write_fishgrid(src, prj_wkt='PROJCS["utm50n"]')
    with open(out[:-4] + ".prj") as f:
        assert f.read() == 'PROJCS["utm50n"]'
    assert grid.fishgrid_cells(200, 150, GT) == \
        [r.bounds for r in shapefile.read_shapefile(out)]
