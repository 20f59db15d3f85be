"""The port's preparation tools (no cv2) against the JAX package's (cv2).

* The rasteriser: ``raster.fill_poly`` / ``raster.polylines`` differ from
  ``cv2.fillPoly`` / ``cv2.polylines`` on 0 pixels, in a hypothesis
  property test on random integer polygons (several rings a call, vertices
  off the canvas, collinear and repeated points, canvases of one row or
  column) and on named cases (holes, multi-part records, horizontal edges,
  shared vertices, slivers one pixel wide).
* ``resize_nearest`` equals ``cv2.resize`` INTER_NEAREST exactly;
  ``resize_linear`` equals INTER_LINEAR within 1e-5 of the value range for
  float images and 1 for uint8 ones (cv2's fixed-point weights).
* ``shp2tif`` (a constant, an attribute, ``all_touched``), ``shp_to_tiff``,
  ``clip_tiff_by_tiff``, ``main_gen_mask`` and ``mosaic_rasters`` write the
  JAX package's GeoTIFFs byte for byte, on footprints with holes, several
  parts and vertices off the raster; ``compare_rasters`` /
  ``compare_array_sums`` (shapes that differ included), the Sentinel
  manifest and each ``_cli`` subcommand give the JAX package's results.
"""
import os

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from srbh_tpu.data import shapefile as jshp
from srbh_tpu.data import tiff as jtiff
from srbh_tpu.tools import preprocess as jprep
from srbh_tpu_torch.data import raster
from srbh_tpu_torch.data.shapefile import ShapeRecord, write_shapefile
from srbh_tpu_torch.tools import preprocess as prep
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

GT = (500000.0, 2.5, 0.0, 4649776.0, 0.0, -2.5)
GEO_KEYS = np.array([1, 1, 0, 2, 1024, 0, 1, 1, 3072, 0, 1, 32650],
                    "<u2").tobytes()


def _draw_both(h, w, polys, fill=True):
    polys = [np.asarray(p, np.int32) for p in polys]
    want, got = np.zeros((h, w)), np.zeros((h, w))
    if fill:
        cv2.fillPoly(want, polys, 3.0)
        raster.fill_poly(got, polys, 3.0)
    else:
        cv2.polylines(want, polys, True, 3.0)
        raster.polylines(got, polys, 3.0)
    return int((want != got).sum())


_vertex = st.tuples(st.integers(-25, 70), st.integers(-25, 70))
_ring = st.lists(_vertex, min_size=1, max_size=9)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(h=st.integers(1, 48), w=st.integers(1, 48),
       rings=st.lists(_ring, min_size=1, max_size=4))
def test_fill_poly_equals_cv2(h, w, rings):
    assert _draw_both(h, w, rings) == 0


@settings(max_examples=200, deadline=None, derandomize=True)
@given(h=st.integers(1, 48), w=st.integers(1, 48),
       rings=st.lists(_ring, min_size=1, max_size=3))
def test_polylines_equals_cv2(h, w, rings):
    assert _draw_both(h, w, rings, fill=False) == 0


@settings(max_examples=100, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       ring=st.lists(st.tuples(st.integers(-3000, 3000),
                               st.integers(-3000, 3000)), min_size=2, max_size=6))
def test_fill_poly_far_off_the_canvas_equals_cv2(h, w, ring):
    assert _draw_both(h, w, [ring]) == 0


CASES = {
    "square_with_hole": [[(2, 2), (30, 2), (30, 30), (2, 30)],
                         [(10, 10), (20, 10), (20, 20), (10, 20)]],
    "two_parts": [[(1, 1), (8, 1), (8, 8)], [(20, 20), (35, 22), (25, 34)]],
    "shared_vertex": [[(5, 5), (15, 5), (10, 12)], [(10, 12), (20, 20), (4, 22)]],
    "collinear": [[(0, 0), (5, 5), (10, 10), (20, 20), (0, 20)]],
    "repeated_points": [[(3, 3), (3, 3), (20, 4), (20, 4), (9, 25)]],
    "horizontal_edges": [[(2, 5), (12, 5), (12, 9), (25, 9), (25, 14), (2, 14)]],
    "sliver_row": [[(3, 7), (30, 7), (30, 8), (3, 8)]],
    "sliver_column": [[(6, 2), (7, 2), (7, 33), (6, 33)]],
    "sliver_diagonal": [[(0, 0), (30, 29), (30, 30), (0, 1)]],
    "off_every_side": [[(-10, 18), (18, -12), (50, 18), (18, 47)]],
    "hole_off_canvas": [[(-5, -5), (45, -5), (45, 45), (-5, 45)],
                        [(30, 30), (60, 30), (60, 60), (30, 60)]],
    "degenerate_point": [[(4, 4)]],
    "segment": [[(4, 4), (30, 17)]],
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fill", [True, False])
def test_named_polygons_equal_cv2(name, fill):
    for h, w in ((36, 36), (20, 33), (1, 40), (40, 1)):
        assert _draw_both(h, w, CASES[name], fill) == 0, (h, w)


@pytest.mark.parametrize("dtype", ["u1", "u2", "f4", "f8"])
def test_resize_nearest_equals_cv2(dtype):
    rng = np.random.default_rng(1)
    for _ in range(150):
        h, w = rng.integers(1, 90, 2)
        dh, dw = rng.integers(1, 300, 2)
        shape = (h, w) if rng.random() < 0.5 else (h, w, int(rng.integers(1, 5)))
        img = (rng.random(shape) * 200).astype(dtype)
        want = cv2.resize(img, (int(dw), int(dh)), interpolation=cv2.INTER_NEAREST)
        got = raster.resize_nearest(img, int(dw), int(dh))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,tol", [("f4", 1e-5), ("f8", 1e-5), ("u1", 1)])
def test_resize_linear_close_to_cv2(dtype, tol):
    rng = np.random.default_rng(2)
    for scale in (0.25, 0.5, 0.7, 1.5, 2.0, 4.0):
        h, w = rng.integers(2, 60, 2)
        img = (rng.random((h, w, 4)) * (255 if dtype == "u1" else 1.0)).astype(dtype)
        size = (max(1, int(w * scale)), max(1, int(h * scale)))
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        got = raster.resize_linear(img, *size)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(float) - want.astype(float)).max() <= tol


def _footprints(path, module_write, rings_fn=None):
    """Footprint records in a 100 x 80 raster at 2.5 m: rectangles, one with
    a hole, a two-part record, a sliver, records crossing the raster's
    edges and one outside it, each with a floors field."""
    x0, y0 = GT[0], GT[3]

    def ring(px):
        return np.array([(x0 + 2.5 * x, y0 - 2.5 * y) for x, y in px], float)

    shapes = [
        [[(5, 5), (25, 5), (25, 20), (5, 20), (5, 5)]],
        [[(30, 4), (60, 4), (60, 30), (30, 30), (30, 4)],
         [(38, 10), (50, 10), (50, 22), (38, 22), (38, 10)]],
        [[(2, 40), (12, 40), (7, 55), (2, 40)],
         [(20, 45), (35, 45), (35, 60), (20, 45)]],
        [[(70, 10), (90, 11), (90, 12), (70, 11), (70, 10)]],
        [[(-8, 60), (10, 62), (14, 90), (-3, 86), (-8, 60)]],
        [[(85, -6), (110, 3), (95, 30), (85, -6)]],
        [[(200, 200), (210, 200), (210, 210), (200, 200)]],
        [[(40.4, 40.6), (55.5, 41.2), (49.7, 58.3), (40.4, 40.6)]],
    ]
    records = []
    for i, parts in enumerate(shapes):
        rings = [ring(p) for p in parts]
        pts = np.concatenate(rings)
        rec = ShapeRecord((pts[:, 0].min(), pts[:, 1].min(),
                           pts[:, 0].max(), pts[:, 1].max()),
                          {"floors": i + 1, "class": (i % 6) + 1}, rings=rings)
        records.append(rec)
    module_write(path, records, [("floors", "N", 10, 0), ("class", "N", 10, 0)])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(0)
    jtiff.write_tiff(str(root / "ref.tif"), np.zeros((80, 100), np.uint8),
                     geotransform=GT, geo_keys=GEO_KEYS)
    _footprints(str(root / "fp.shp"), write_shapefile)
    for i, gt0 in enumerate((GT[0] - 40.0, GT[0] + 160.0)):
        jtiff.write_tiff(str(root / f"wsf{i}.tif"),
                         rng.integers(0, 2, (120, 90)).astype(np.uint8) * 255,
                         geotransform=(gt0, 2.5, 0.0, GT[3] + 30.0, 0.0, -2.5),
                         geo_keys=GEO_KEYS)
    os.makedirs(root / "cities")
    jtiff.write_tiff(str(root / "cities" / "abc_s2.tif"),
                     rng.integers(0, 5000, (20, 25, 3)).astype(np.uint16),
                     geotransform=(GT[0] + 10.0, 10.0, 0.0, GT[3] - 20.0,
                                   0.0, -10.0), geo_keys=GEO_KEYS)
    return root


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kw", [dict(burn_value=5.0),
                                dict(attribute="floors"),
                                dict(attribute="floors", all_touched=True),
                                dict(attribute="floors", dtype=np.float32)])
def test_shp2tif_bytes_equal_jax(scene, tmp_path, kw):
    a = jprep.shp2tif(str(scene / "fp.shp"), str(scene / "ref.tif"),
                      str(tmp_path / "j.tif"), **kw)
    b = prep.shp2tif(str(scene / "fp.shp"), str(scene / "ref.tif"),
                     str(tmp_path / "p.tif"), **kw)
    np.testing.assert_array_equal(a, b)
    assert b.any() and _bytes(tmp_path / "j.tif") == _bytes(tmp_path / "p.tif")


@pytest.mark.parametrize("attribute,res", [("class", 2.5), ("floors", 5.0)])
def test_shp_to_tiff_bytes_equal_jax(scene, tmp_path, attribute, res):
    a = jprep.shp_to_tiff(str(scene / "fp.shp"), str(tmp_path / "j.tif"),
                          attribute=attribute, nresolution=res)
    b = prep.shp_to_tiff(str(scene / "fp.shp"), str(tmp_path / "p.tif"),
                         attribute=attribute, nresolution=res)
    np.testing.assert_array_equal(a, b)
    assert _bytes(tmp_path / "j.tif") == _bytes(tmp_path / "p.tif")


def test_clip_mask_and_mosaic_bytes_equal_jax(scene, tmp_path):
    for mod, name in ((jprep, "j"), (prep, "p")):
        d = tmp_path / name
        mod.mosaic_rasters([str(scene / "wsf0.tif"), str(scene / "wsf1.tif")],
                           str(d) + "_mosaic.tif")
        mod.clip_tiff_by_tiff(str(d) + "_mosaic.tif", str(scene / "ref.tif"),
                              str(d) + "_clip.tif")
        assert mod.main_gen_mask(str(scene / "cities"), str(d) + "_mosaic.tif",
                                 str(d)) == [str(d / "abc_wsf.tif")]
    for suffix in ("_mosaic.tif", "_clip.tif", "/abc_wsf.tif"):
        assert _bytes(str(tmp_path / "j") + suffix) == \
            _bytes(str(tmp_path / "p") + suffix), suffix


def test_compare_and_floor_math_equal_jax(scene, tmp_path):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 30, (40, 50)).astype(np.float64)
    for b in (rng.integers(0, 30, (40, 50)).astype(np.float64),
              rng.integers(0, 30, (17, 23)).astype(np.float64)):
        assert prep.compare_array_sums(a, b, 2.0) == \
            jprep.compare_array_sums(a, b, 2.0)
    s = prep.compare_array_sums(a, a[:13, :7], 0.0)
    assert prep.compare_metrics_from_sums(s, 6) == \
        jprep.compare_metrics_from_sums(s, 6)
    jtiff.write_tiff(str(tmp_path / "b.tif"), a[:20, :25].astype(np.uint8))
    assert prep.compare_rasters(str(scene / "wsf0.tif"), str(tmp_path / "b.tif")) \
        == jprep.compare_rasters(str(scene / "wsf0.tif"), str(tmp_path / "b.tif"))
    v = rng.integers(0, 9, 30)
    np.testing.assert_array_equal(prep.floor_field_to_height(v),
                                  jprep.floor_field_to_height(v))


def _worldcover_grid(path, with_prj):
    recs = []
    for i, (x, y) in enumerate([(110, 30), (113, 30), (116, 33), (140, 0)]):
        recs.append(ShapeRecord((x, y, x + 3.0, y + 3.0), {
            "ll_tile": f"N{y:02d}E{x:03d}",
            "s1_vvvhrat": f"s3://b/s1/S1_{i}.tif",
            "s2_rgbnir_2020": f"s3://b/s2/S2 {i}.tif"}))
    write_shapefile(path, recs, [("ll_tile", "C", 16, 0),
                                 ("s1_vvvhrat", "C", 40, 0),
                                 ("s2_rgbnir_2020", "C", 40, 0)],
                    prj_wkt=(None if not with_prj else
                             'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID['
                             '"WGS 84",6378137,298.257223563]],PRIMEM['
                             '"Greenwich",0],UNIT["degree",0.0174532925199433]]'))


def test_sentinel_manifest_equals_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("SRBH_ALLOW_NETWORK", raising=False)
    _worldcover_grid(str(tmp_path / "grid.shp"), True)
    write_shapefile(str(tmp_path / "q.shp"),
                    [ShapeRecord((400000.0, 3400000.0, 560000.0, 3560000.0))],
                    prj_wkt=prep._crs.wkt_for_epsg(32650))
    for mod, name in ((jprep, "j"), (prep, "p")):
        for types in (("s1_vvvhratio", "s2_rgbnir"), ("landcover",)):
            out = mod.download_sentinel12(str(tmp_path / "q.shp"),
                                          str(tmp_path / name / "_".join(types)),
                                          typelist=types,
                                          ref_shp=str(tmp_path / "grid.shp"))
            assert out == mod.build_sentinel12_manifest(
                str(tmp_path / "q.shp"), str(tmp_path / "grid.shp"),
                str(tmp_path / name / "_".join(types)), types)[0]
    for types in ("s1_vvvhratio_s2_rgbnir", "landcover"):
        j = _bytes(tmp_path / "j" / types / "download_manifest.sh")
        p = _bytes(tmp_path / "p" / types / "download_manifest.sh")
        assert p == j.replace(str(tmp_path / "j").encode(),
                              str(tmp_path / "p").encode())
    os.remove(tmp_path / "grid.prj")
    with pytest.raises(ValueError, match="missing .prj"):
        prep.build_sentinel12_manifest(str(tmp_path / "q.shp"),
                                       str(tmp_path / "grid.shp"), "x")


@pytest.mark.parametrize("cmd", ["gen-mask", "shp2tif", "shp-to-tiff", "clip",
                                 "mosaic", "grid"])
def test_cli_subcommands_equal_jax(scene, tmp_path, cmd, capsys):
    for mod, name in ((jprep, "j"), (prep, "p")):
        d = tmp_path / name
        os.makedirs(d)
        jtiff.write_tiff(str(d / "s2.tif"), np.zeros((64, 80), np.uint16),
                         geotransform=GT, geo_keys=GEO_KEYS)
        argv = {
            "gen-mask": ["gen-mask", "--citydir", str(scene / "cities"),
                         "--wsf", str(scene / "wsf0.tif"), "--outdir", str(d)],
            "shp2tif": ["shp2tif", "--shp", str(scene / "fp.shp"), "--ref-tif",
                        str(scene / "ref.tif"), "--out", str(d / "o.tif"),
                        "--attribute", "floors"],
            "shp-to-tiff": ["shp-to-tiff", "--shp", str(scene / "fp.shp"),
                            "--out", str(d / "o.tif")],
            "clip": ["clip", "--src", str(scene / "wsf0.tif"), "--extent",
                     str(scene / "ref.tif"), "--out", str(d / "o.tif")],
            "mosaic": ["mosaic", str(scene / "wsf0.tif"), str(scene / "wsf1.tif"),
                       "--out", str(d / "o.tif")],
            "grid": ["grid", "--tif", str(d / "s2.tif"), "--wsf",
                     str(scene / "wsf0.tif"), "--window", "16", "--offset", "14"],
        }[cmd]
        mod._cli(argv)
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == files and len(files) > 1
    for f in files:
        assert _bytes(tmp_path / "j" / f) == _bytes(tmp_path / "p" / f), f
    if cmd == "grid":
        out = capsys.readouterr().out.split()
        assert [os.path.basename(p) for p in out] == ["s2_grid.shp"] * 2


def test_port_shapefile_rings_read_back_by_jax(scene):
    recs = jshp.read_shapefile(str(scene / "fp.shp"))
    assert [len(r.rings) for r in recs] == [1, 2, 2, 1, 1, 1, 1, 1]
    assert recs[1].attributes == {"floors": 2, "class": 2}
