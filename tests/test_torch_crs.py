"""The port's coordinate reference systems against the JAX package's.

* Every projection's forward and inverse transform, on seeded points, is
  bit-equal to the JAX package's (the same float64 operations in the same
  order): each EPSG code of the table and the WKT-only families (LCC 1SP /
  2SP, Albers, both polar stereographic variants, Mercator with a standard
  parallel, spherical LAEA, a Transverse Mercator on a shifted datum);
  ``transform`` (with the Helmert datum shift) and ``transform_bounds`` too.
* WKT and GeoKeys round trips for every EPSG code of the table: the same
  WKT text and GeoKey bytes, read back to the same code.
* ``supported_epsg`` is true exactly where the JAX ``wkt_for_epsg`` answers,
  and ``wkt_error`` gives the message of the JAX ``from_wkt``'s
  ``ValueError`` exactly where it raises.
"""
import numpy as np
import pytest

from srbh_tpu.data import crs as jcrs
from srbh_tpu_torch.data import crs
from test_torch_port_rules import _one_torch_thread  # noqa: F401 (autouse)

EPSG = ([4326, 5070, 3857, 3395, 3413, 3976, 3031, 5041, 5042, 32661, 32761,
         3035, 6931, 6932] + list(range(32601, 32661)) + list(range(32701, 32761)))
WKT_CODES = [c for c in EPSG if c not in (3395, 5041, 5042, 32661, 32761)]

BEIJING = ('PROJCS["Beijing 1954 / Gauss-Kruger zone 20",GEOGCS['
           '"Beijing 1954",DATUM["Beijing_1954",SPHEROID['
           '"Krassowsky 1940",6378245,298.3],TOWGS84[15.8,-154.4,'
           '-82.3,0,0,0,0]],PRIMEM["Greenwich",0],UNIT["degree",'
           '0.0174532925199433]],PROJECTION["Transverse_Mercator"],'
           'PARAMETER["central_meridian",117],PARAMETER['
           '"scale_factor",1],PARAMETER["false_easting",500000],'
           'UNIT["metre",1]]')
_GEO = ('GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
        '298.257223563]],PRIMEM["Greenwich",0],UNIT["degree",'
        '0.0174532925199433]]')


def _projcs(projection, params):
    body = ",".join(f'PARAMETER["{k}",{v}]' for k, v in params.items())
    return (f'PROJCS["x",{_GEO},PROJECTION["{projection}"],{body},'
            'UNIT["metre",1]]')


WKTS = {
    "lcc_2sp": _projcs("Lambert_Conformal_Conic_2SP", {
        "standard_parallel_1": 25, "standard_parallel_2": 47,
        "latitude_of_origin": 0, "central_meridian": 105}),
    "lcc_1sp": _projcs("Lambert_Conformal_Conic_1SP", {
        "latitude_of_origin": 40, "central_meridian": -3,
        "scale_factor": 0.9988, "false_easting": 600000}),
    "albers": _projcs("Albers_Conic_Equal_Area", {
        "standard_parallel_1": 25, "standard_parallel_2": 47,
        "latitude_of_center": 0, "longitude_of_center": 105}),
    "polar_b": _projcs("Polar_Stereographic", {
        "latitude_of_origin": -65, "central_meridian": 30}),
    "polar_a": _projcs("Polar_Stereographic", {
        "latitude_of_origin": 90, "central_meridian": 0,
        "scale_factor": 0.97}),
    "mercator_2sp": _projcs("Mercator_2SP", {
        "standard_parallel_1": 30, "central_meridian": 20}),
    "laea_sphere": ('PROJCS["s",GEOGCS["s",DATUM["WGS_1984",SPHEROID["s",'
                    '6371228,0]],PRIMEM["Greenwich",0],UNIT["degree",'
                    '0.0174532925199433]],PROJECTION['
                    '"Lambert_Azimuthal_Equal_Area"],PARAMETER['
                    '"latitude_of_center",45],PARAMETER["longitude_of_center",'
                    '-100],UNIT["metre",1]]'),
    "beijing_tm": BEIJING,
}

BAD_WKTS = [
    "", "   ", 'PROJCS["x",PROJECTION["Bonne"]]',
    'GEOGCS["g",DATUM["Tokyo"],PRIMEM["Greenwich",0]]',
    'GEOGCS["g",DATUM["WGS_1984"],PRIMEM["Paris",2.33722917]]',
    _projcs("Transverse_Mercator", {"central_meridian": 3}).replace(
        'UNIT["metre",1]', 'UNIT["US survey foot",0.3048006096012192]'),
    _projcs("Lambert_Conformal_Conic_1SP", {"latitude_of_origin": 0}),
    _projcs("Albers_Conic_Equal_Area", {"standard_parallel_1": 20,
                                        "standard_parallel_2": -20}),
    _projcs("Polar_Stereographic", {"latitude_of_origin": 70,
                                    "scale_factor": 0.99}),
    'PROJCS["WGS 84 / UTM zone 0N",' + _GEO + ',UNIT["metre",1]]',
    'PROJCS["WGS 84 / UTM zone 61N",' + _GEO + ',UNIT["metre",1]]',
    'GEOGCS["g",DATUM["WGS_1984",SPHEROID["s",6378137,e]]]',
    _projcs("Transverse_Mercator", {"central_meridian": "1.2.3"}),
    'GEOGCS["g",DATUM["D",SPHEROID["s",6378137,298.3],TOWGS84[1,x,3]]]',
]


def _points(proj, seed):
    """Seeded geographic points where the projection is defined, and their
    projected coordinates (from the JAX projection)."""
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-179.0, 179.0, 256)
    lat = rng.uniform(-84.0, 84.0, 256)
    if isinstance(proj, jcrs.TransverseMercator):
        lon = proj.lon0 + rng.uniform(-5.0, 5.0, 256)
    if isinstance(proj, jcrs.PolarStereographic):
        lat = np.abs(lat) * (1.0 if proj.north else -1.0)
    if isinstance(proj, jcrs.LambertAzimuthalEqualArea):
        lon = proj.lon0 + rng.uniform(-60.0, 60.0, 256)
        lat = np.clip(proj.lat0 + rng.uniform(-40.0, 40.0, 256), -89.9, 89.9)
    return lon, lat


def _same(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _forward_inverse(jp, pp, seed):
    lon, lat = _points(jp, seed)
    xy = jp.forward(lon, lat)
    _same(pp.forward(lon, lat), xy)
    _same(pp.inverse(*xy), jp.inverse(*xy))


@pytest.mark.parametrize("code", EPSG)
def test_epsg_projection_transforms_bit_equal_jax(code):
    _forward_inverse(jcrs.from_epsg(code), crs.from_epsg(code), code)


@pytest.mark.parametrize("name", sorted(WKTS))
def test_wkt_projection_transforms_bit_equal_jax(name):
    jp, pp = jcrs.from_wkt(WKTS[name]), crs.from_wkt(WKTS[name])
    assert type(pp).__name__ == type(jp).__name__
    assert repr(pp) == repr(jp)
    _forward_inverse(jp, pp, len(name))


@pytest.mark.parametrize("src,dst", [(BEIJING, 4326), (32650, BEIJING),
                                     (5070, 32614), (3857, WKTS["albers"]),
                                     (3035, 4326)])
def test_transform_and_bounds_bit_equal_jax(src, dst):
    rng = np.random.default_rng(5)
    lon = rng.uniform(112.0, 122.0, 64) if dst != 32614 else \
        rng.uniform(-101.0, -97.0, 64)
    lat = rng.uniform(30.0, 45.0, 64)
    x, y = jcrs.from_epsg(4326).forward(lon, lat)
    x, y = jcrs.transform(4326, src, x, y)
    _same(crs.transform(src, dst, x, y), jcrs.transform(src, dst, x, y))
    b = (float(x.min()), float(y.min()), float(x.max()), float(y.max()))
    assert crs.transform_bounds(src, dst, b) == jcrs.transform_bounds(src, dst, b)


@pytest.mark.parametrize("code", EPSG)
def test_geokeys_and_wkt_round_trips_equal_jax(code):
    keys = crs.geokeys_for_epsg(code)
    assert keys == jcrs.geokeys_for_epsg(code)
    assert crs.epsg_from_geokeys(keys) == jcrs.epsg_from_geokeys(keys) == code
    assert crs.supported_epsg(code) == (code in WKT_CODES)
    if code in WKT_CODES:
        wkt = crs.wkt_for_epsg(code)
        assert wkt == jcrs.wkt_for_epsg(code)
        assert crs.wkt_error(wkt) is None
        assert crs.epsg_of(wkt) == jcrs.epsg_of(wkt) == code
    else:
        with pytest.raises(ValueError, match="unsupported EPSG"):
            crs.wkt_for_epsg(code)
    assert crs.epsg_of(crs.from_epsg(code)) == jcrs.epsg_of(jcrs.from_epsg(code))


def test_supported_epsg_is_where_jax_has_a_wkt():
    for code in list(range(2000, 7000, 7)) + list(range(32590, 32770)):
        try:
            jcrs.wkt_for_epsg(code)
            jax_has = True
        except ValueError:
            jax_has = False
        assert crs.supported_epsg(code) == jax_has, code


@pytest.mark.parametrize("i", range(len(BAD_WKTS)))
def test_wkt_error_is_the_jax_refusal(i):
    wkt = BAD_WKTS[i]
    with pytest.raises(ValueError) as jax_err:
        jcrs.from_wkt(wkt)
    why = crs.wkt_error(wkt)
    assert why is not None
    with pytest.raises(ValueError) as err:
        crs.from_wkt(wkt)
    assert str(err.value) == why
    if "malformed" not in why:  # the JAX package names float's own error
        assert why == str(jax_err.value)


def test_geokey_edge_cases_equal_jax():
    user = np.array([1, 1, 0, 1, 3072, 0, 1, 32767], "<u2").tobytes()
    geo = np.array([1, 1, 0, 2, 1024, 0, 1, 2, 2048, 0, 1, 4326], "<u2").tobytes()
    big = np.array([1, 1, 0, 1, 3072, 0, 1, 32650], ">u2").tobytes()
    for keys, endian in ((b"", "<"), (b"\x01\x00", "<"), (user, "<"),
                         (geo, "<"), (big, ">")):
        assert crs.epsg_from_geokeys(keys, endian) == \
            jcrs.epsg_from_geokeys(keys, endian)
    assert crs.utm_zone_of(117.3, -33.0) == jcrs.utm_zone_of(117.3, -33.0)
