"""Coordinate reference systems for the height-product workflows.

The port's copy of ``srbh_tpu/data/crs.py`` (numpy float64, the same
operations in the same order, so every transform is bit-equal to the JAX
package's). It has no ``try`` statement: where the JAX callers catch the
``ValueError`` of an unsupported EPSG code or WKT, the port's callers ask
:func:`supported_epsg` or :func:`wkt_error` first.

The reference leans on GDAL/OGR for every cross-projection step —
``osr.CoordinateTransformation`` in ``clip_vrt``
(demo_preprocess_height_v2.py:608-655), ``gdal.Warp(dstSRS=…)`` in
``clip_tiff_whole`` (:1317-1386) and ``Raster_extent_prj`` (:362-427).
This module is the self-contained equivalent:

* an exact-ellipsoid Transverse Mercator (Karney/Krüger n-series, order
  n^4 — sub-millimetre inside a UTM zone);
* ellipsoidal Lambert Conformal Conic (1SP/2SP) and Albers Equal-Area
  (incl. EPSG:5070 Conus Albers), Snyder-worked-example-anchored;
* ellipsoidal Polar Stereographic (variants A/B: UPS, NSIDC EPSG:3413/
  3976, Antarctic EPSG:3031) and Mercator (EPSG:3395) plus the spherical
  Pseudo-Mercator (EPSG:3857), EPSG-GN7-2-worked-example-anchored;
* 7-parameter TOWGS84 Helmert datum shifts applied through the WGS84
  geocentric hub in :func:`transform`;
* a WKT1 reader/writer covering the PROJCS/GEOGCS strings that GeoTIFF
  ``.prj`` sidecars and product metadata carry.

Everything is vectorised numpy over degrees; no GDAL, no pyproj.
"""
from __future__ import annotations

import math
import re
import struct
from typing import Optional, Tuple, Union

import numpy as np

# WGS84 defaults
_A = 6378137.0
_F = 1.0 / 298.257223563

ArrayLike = Union[float, np.ndarray]


def _taupf(tau: np.ndarray, e: float) -> np.ndarray:
    """tan(conformal latitude) from tan(latitude) on the ellipsoid."""
    tau1 = np.hypot(1.0, tau)
    sig = np.sinh(e * np.arctanh(e * tau / tau1))
    return np.hypot(1.0, sig) * tau - sig * tau1


def _tauf(taup: np.ndarray, e: float) -> np.ndarray:
    """Inverse of :func:`_taupf` by Newton iteration (GeographicLib recipe)."""
    e2m = 1.0 - e * e
    tau = taup / e2m
    stol = 0.1 * np.sqrt(np.finfo(float).eps) * np.maximum(1.0, np.abs(taup))
    for _ in range(5):
        taupa = _taupf(tau, e)
        dtau = ((taup - taupa) * (1.0 + e2m * tau * tau)
                / (e2m * np.hypot(1.0, tau) * np.hypot(1.0, taupa)))
        tau = tau + dtau
        if np.all(np.abs(dtau) < stol):
            break
    return tau


class Geographic:
    """Identity projection: coordinates are (lon, lat) degrees."""

    is_geographic = True

    def __init__(self, a: float = _A, f: float = _F, towgs84=None):
        self.a, self.f = a, f
        self.towgs84 = None if towgs84 is None else tuple(towgs84)

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        return np.asarray(lon, float), np.asarray(lat, float)

    def inverse(self, x: ArrayLike, y: ArrayLike):
        return np.asarray(x, float), np.asarray(y, float)

    def __repr__(self):
        return f"Geographic(a={self.a}, 1/f={1 / self.f:.9f})"


class TransverseMercator:
    """Ellipsoidal Transverse Mercator (Krüger series, order n^4).

    ``forward`` maps (lon, lat) degrees to (easting, northing) metres;
    ``inverse`` maps back. ``lat0`` shifts the northing origin by the
    rectifying arc to the latitude of origin, matching the WKT1
    ``latitude_of_origin`` parameter.
    """

    is_geographic = False

    def __init__(self, lon0: float, k0: float = 0.9996,
                 false_easting: float = 500000.0,
                 false_northing: float = 0.0, lat0: float = 0.0,
                 a: float = _A, f: float = _F, towgs84=None):
        self.lon0, self.k0 = float(lon0), float(k0)
        self.false_easting = float(false_easting)
        self.false_northing = float(false_northing)
        self.lat0 = float(lat0)
        self.a, self.f = a, f
        self.towgs84 = None if towgs84 is None else tuple(towgs84)
        n = f / (2.0 - f)
        self._e = math.sqrt(f * (2.0 - f))
        self._A1 = a / (1.0 + n) * (1.0 + n * n / 4.0 + n ** 4 / 64.0)
        self._alpha = (
            n / 2.0 - 2.0 * n ** 2 / 3.0 + 5.0 * n ** 3 / 16.0
            + 41.0 * n ** 4 / 180.0,
            13.0 * n ** 2 / 48.0 - 3.0 * n ** 3 / 5.0 + 557.0 * n ** 4 / 1440.0,
            61.0 * n ** 3 / 240.0 - 103.0 * n ** 4 / 140.0,
            49561.0 * n ** 4 / 161280.0,
        )
        self._beta = (
            n / 2.0 - 2.0 * n ** 2 / 3.0 + 37.0 * n ** 3 / 96.0
            - n ** 4 / 360.0,
            n ** 2 / 48.0 + n ** 3 / 15.0 - 437.0 * n ** 4 / 1440.0,
            17.0 * n ** 3 / 480.0 - 37.0 * n ** 4 / 840.0,
            4397.0 * n ** 4 / 161280.0,
        )
        self._xi0 = 0.0
        if self.lat0 != 0.0:
            self._xi0 = float(self._xi_eta(np.asarray(self.lat0),
                                           np.asarray(self.lat0) * 0.0)[0])

    def _xi_eta(self, lat_deg: np.ndarray, dlon_deg: np.ndarray):
        phi = np.radians(lat_deg)
        lam = np.radians(dlon_deg)
        taup = _taupf(np.tan(phi), self._e)
        h = np.hypot(taup, np.cos(lam))
        xip = np.arctan2(taup, np.cos(lam))
        etap = np.arcsinh(np.sin(lam) / h)
        xi, eta = xip, etap
        for j, aj in enumerate(self._alpha, start=1):
            xi = xi + aj * np.sin(2 * j * xip) * np.cosh(2 * j * etap)
            eta = eta + aj * np.cos(2 * j * xip) * np.sinh(2 * j * etap)
        return xi, eta

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        lon = np.asarray(lon, float)
        lat = np.asarray(lat, float)
        dlon = (lon - self.lon0 + 180.0) % 360.0 - 180.0
        xi, eta = self._xi_eta(lat, dlon)
        x = self.false_easting + self.k0 * self._A1 * eta
        y = self.false_northing + self.k0 * self._A1 * (xi - self._xi0)
        return x, y

    def inverse(self, x: ArrayLike, y: ArrayLike):
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        eta = (x - self.false_easting) / (self.k0 * self._A1)
        xi = (y - self.false_northing) / (self.k0 * self._A1) + self._xi0
        xip, etap = xi, eta
        for j, bj in enumerate(self._beta, start=1):
            xip = xip - bj * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
            etap = etap - bj * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
        s, c = np.sinh(etap), np.cos(xip)
        taup = np.sin(xip) / np.hypot(s, c)
        tau = _tauf(taup, self._e)
        lat = np.degrees(np.arctan(tau))
        lon = self.lon0 + np.degrees(np.arctan2(s, c))
        return lon, lat

    def __repr__(self):
        return (f"TransverseMercator(lon0={self.lon0}, k0={self.k0}, "
                f"E0={self.false_easting}, N0={self.false_northing})")


def utm(zone: int, south: bool = False, a: float = _A,
        f: float = _F) -> TransverseMercator:
    """The UTM zone projection (central meridian 6*zone - 183)."""
    if not 1 <= zone <= 60:
        raise ValueError(f"bad UTM zone {zone}")
    return TransverseMercator(lon0=6.0 * zone - 183.0, k0=0.9996,
                              false_easting=500000.0,
                              false_northing=10000000.0 if south else 0.0,
                              a=a, f=f)


def utm_zone_of(lon: float, lat: float) -> Tuple[int, bool]:
    """(zone, south) for a geographic point (standard 6-degree zones)."""
    zone = int((float(lon) + 180.0) // 6.0) + 1
    return min(max(zone, 1), 60), float(lat) < 0.0


# ---------------------------------------------------------------------------
# Conic projections (Snyder, "Map Projections — A Working Manual", USGS PP
# 1395) — the CRSs the CNBH/CBRA-style height products ship in when not UTM
# (demo_preprocess_height_v2.py:608-655 warps across arbitrary dstSRS; this
# is the self-contained equivalent for the conic families).
# ---------------------------------------------------------------------------


def _conic_m(phi, e):
    """m(phi) = cos(phi)/sqrt(1 - e^2 sin^2 phi) (Snyder 14-15)."""
    s = np.sin(phi)
    return np.cos(phi) / np.sqrt(1.0 - (e * s) ** 2)


def _conic_t(phi, e):
    """t(phi) = tan(pi/4 - phi/2) / ((1-e sin)/(1+e sin))^(e/2) (15-9)."""
    s = e * np.sin(phi)
    return np.tan(np.pi / 4.0 - phi / 2.0) / ((1.0 - s) / (1.0 + s)) ** (e / 2.0)


def _conic_q(phi, e):
    """q(phi), the Albers equal-area auxiliary (Snyder 3-12).

    Spherical limit (e=0): the bracket tends to 2 sin(phi) — required for
    sphere-datum LAEA products (e.g. EASE-Grid v1 style WKTs), where the
    general form would divide by e.
    """
    s = np.sin(phi)
    if e == 0.0:
        return 2.0 * s
    es = e * s
    return (1.0 - e * e) * (s / (1.0 - es * es)
                            - (0.5 / e) * np.log((1.0 - es) / (1.0 + es)))


_LCC_DEGENERATE = ("degenerate Lambert Conformal Conic: standard parallel(s) "
                   "at the equator (n=0 is the Mercator limit)")
_ALBERS_DEGENERATE = ("degenerate Albers: standard parallel(s) at the equator "
                      "(n=0 is the cylindrical limit)")
_POLAR_BOTH = ("Polar Stereographic: give EITHER a standard parallel "
               "(variant B) OR a scale factor at the pole (variant A)")


def _lcc_cone(lat1: float, lat2: Optional[float], e: float):
    """(n, t(lat1)) of a Lambert Conformal Conic (Snyder 15-8/15-9)."""
    p1 = math.radians(lat1)
    t1 = float(_conic_t(np.asarray(p1), e))
    if lat2 is None or abs(lat2 - lat1) < 1e-12:
        return math.sin(p1), t1
    p2 = math.radians(lat2)
    m1, m2 = (float(_conic_m(np.asarray(p), e)) for p in (p1, p2))
    t2 = float(_conic_t(np.asarray(p2), e))
    return (math.log(m1) - math.log(m2)) / (math.log(t1) - math.log(t2)), t1


def _albers_cone(lat1: float, lat2: Optional[float], e: float):
    """(n, m(lat1), q(lat1)) of an Albers cone (Snyder 14-14/14-12)."""
    p1 = math.radians(lat1)
    m1 = float(_conic_m(np.asarray(p1), e))
    q1 = float(_conic_q(np.asarray(p1), e))
    if lat2 is None or abs(lat2 - lat1) < 1e-12:
        return math.sin(p1), m1, q1
    p2 = math.radians(lat2)
    m2 = float(_conic_m(np.asarray(p2), e))
    q2 = float(_conic_q(np.asarray(p2), e))
    return (m1 * m1 - m2 * m2) / (q2 - q1), m1, q1


def _polar_both(lat_ts: float, k0: Optional[float]) -> bool:
    """A variant-B polar stereographic (|lat_ts| < 90) given a scale factor
    other than 1."""
    return (abs(abs(float(lat_ts)) - 90.0) >= 1e-9 and k0 is not None
            and not math.isclose(float(k0), 1.0, rel_tol=1e-9))


class LambertConformalConic:
    """Ellipsoidal Lambert Conformal Conic, 2SP (EPSG 9802) or 1SP
    (EPSG 9801 when ``lat2`` is omitted; ``k0`` then applies)."""

    is_geographic = False

    def __init__(self, lat1: float, lat2: Optional[float] = None,
                 lat0: float = 0.0, lon0: float = 0.0, k0: float = 1.0,
                 false_easting: float = 0.0, false_northing: float = 0.0,
                 a: float = _A, f: float = _F, towgs84=None):
        self.lat1, self.lat2, self.lat0, self.lon0 = lat1, lat2, lat0, lon0
        self.k0 = float(k0)
        self.false_easting = float(false_easting)
        self.false_northing = float(false_northing)
        self.a, self.f = a, f
        self.towgs84 = None if towgs84 is None else tuple(towgs84)
        e = self._e = math.sqrt(f * (2.0 - f))
        p1 = math.radians(lat1)
        self._n, t1 = _lcc_cone(lat1, lat2, e)
        if abs(self._n) < 1e-12:
            raise ValueError(_LCC_DEGENERATE)
        m1 = float(_conic_m(np.asarray(p1), e))
        self._F = m1 / (self._n * t1 ** self._n)
        t0 = float(_conic_t(np.asarray(math.radians(lat0)), e))
        self._rho0 = self.a * self.k0 * self._F * t0 ** self._n

    def _rho(self, phi):
        return self.a * self.k0 * self._F * _conic_t(phi, self._e) ** self._n

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        lon = np.asarray(lon, float)
        phi = np.radians(np.asarray(lat, float))
        rho = self._rho(phi)
        th = self._n * np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = self.false_easting + rho * np.sin(th)
        y = self.false_northing + self._rho0 - rho * np.cos(th)
        return x, y

    def inverse(self, x: ArrayLike, y: ArrayLike):
        x = np.asarray(x, float) - self.false_easting
        y = self._rho0 - (np.asarray(y, float) - self.false_northing)
        sgn = 1.0 if self._n >= 0 else -1.0
        rho = sgn * np.hypot(x, y)
        th = np.arctan2(sgn * x, sgn * y)
        lon = self.lon0 + np.degrees(th / self._n)
        t = (rho / (self.a * self.k0 * self._F)) ** (1.0 / self._n)
        e = self._e
        phi = np.pi / 2.0 - 2.0 * np.arctan(t)
        for _ in range(12):
            s = e * np.sin(phi)
            phi = np.pi / 2.0 - 2.0 * np.arctan(
                t * ((1.0 - s) / (1.0 + s)) ** (e / 2.0))
        return lon, np.degrees(phi)

    def __repr__(self):
        return (f"LambertConformalConic(lat1={self.lat1}, lat2={self.lat2}, "
                f"lat0={self.lat0}, lon0={self.lon0})")


class AlbersEqualArea:
    """Ellipsoidal Albers Equal-Area Conic (EPSG 9822, Snyder 14-x) —
    the CRS of the CONUS raster products (e.g. EPSG:5070)."""

    is_geographic = False

    def __init__(self, lat1: float, lat2: Optional[float] = None,
                 lat0: float = 0.0, lon0: float = 0.0,
                 false_easting: float = 0.0, false_northing: float = 0.0,
                 a: float = _A, f: float = _F, towgs84=None):
        self.lat1, self.lat2, self.lat0, self.lon0 = lat1, lat2, lat0, lon0
        self.false_easting = float(false_easting)
        self.false_northing = float(false_northing)
        self.a, self.f = a, f
        self.towgs84 = None if towgs84 is None else tuple(towgs84)
        e = self._e = math.sqrt(f * (2.0 - f))
        self._n, m1, q1 = _albers_cone(lat1, lat2, e)
        if abs(self._n) < 1e-12:
            raise ValueError(_ALBERS_DEGENERATE)
        self._C = m1 * m1 + self._n * q1
        q0 = float(_conic_q(np.asarray(math.radians(lat0)), e))
        self._rho0 = self.a * math.sqrt(self._C - self._n * q0) / self._n

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        lon = np.asarray(lon, float)
        phi = np.radians(np.asarray(lat, float))
        q = _conic_q(phi, self._e)
        rho = self.a * np.sqrt(self._C - self._n * q) / self._n
        th = self._n * np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = self.false_easting + rho * np.sin(th)
        y = self.false_northing + self._rho0 - rho * np.cos(th)
        return x, y

    def inverse(self, x: ArrayLike, y: ArrayLike):
        x = np.asarray(x, float) - self.false_easting
        y = self._rho0 - (np.asarray(y, float) - self.false_northing)
        sgn = 1.0 if self._n >= 0 else -1.0
        rho = np.hypot(x, y)
        th = np.arctan2(sgn * x, sgn * y)
        lon = self.lon0 + np.degrees(th / self._n)
        q = (self._C - (rho * self._n / self.a) ** 2) / self._n
        e, e2 = self._e, self._e ** 2
        # Snyder 3-16 iteration from the spherical start phi = asin(q/2)
        phi = np.arcsin(np.clip(q / 2.0, -1.0, 1.0))
        for _ in range(12):
            s = np.sin(phi)
            es = e * s
            phi = phi + ((1.0 - es * es) ** 2 / (2.0 * np.cos(phi))) * (
                q / (1.0 - e2) - s / (1.0 - es * es)
                + (0.5 / e) * np.log((1.0 - es) / (1.0 + es)))
        return lon, np.degrees(phi)

    def __repr__(self):
        return (f"AlbersEqualArea(lat1={self.lat1}, lat2={self.lat2}, "
                f"lat0={self.lat0}, lon0={self.lon0})")


# ---------------------------------------------------------------------------
# Azimuthal / cylindrical projections (Snyder PP 1395 §21 / §7; EPSG
# Guidance Note 7-2): the high-latitude products (NSIDC EPSG:3413,
# Antarctic EPSG:3031, UPS) and the web-tiled mosaics (EPSG:3857/3395) —
# the remaining dstSRS families of demo_preprocess_height_v2.py:608-655.
# ---------------------------------------------------------------------------


class PolarStereographic:
    """Ellipsoidal Polar Stereographic — EPSG method 9810 (variant A,
    origin at the pole, ``k0`` given) when ``|lat_ts| == 90``, else
    EPSG 9829 (variant B, true scale at the standard parallel ``lat_ts``,
    from which ``k0 = m_F * C / (2 t_F)`` is derived). Snyder 21-33/34.
    The sign of ``lat_ts`` selects the aspect (north/south pole)."""

    is_geographic = False

    def __init__(self, lat_ts: float = 90.0, lon0: float = 0.0,
                 k0: Optional[float] = None,
                 false_easting: float = 0.0, false_northing: float = 0.0,
                 a: float = _A, f: float = _F, towgs84=None):
        self.lat_ts, self.lon0 = float(lat_ts), float(lon0)
        self.north = self.lat_ts >= 0.0
        self.false_easting = float(false_easting)
        self.false_northing = float(false_northing)
        self.a, self.f = a, f
        self.towgs84 = None if towgs84 is None else tuple(towgs84)
        e = self._e = math.sqrt(f * (2.0 - f))
        self._C = math.sqrt((1.0 + e) ** (1.0 + e) * (1.0 - e) ** (1.0 - e))
        if abs(abs(self.lat_ts) - 90.0) < 1e-9:  # variant A
            self.k0 = 1.0 if k0 is None else float(k0)
        else:  # variant B: k0 derived from the standard parallel
            if _polar_both(self.lat_ts, k0):
                raise ValueError(_POLAR_BOTH)
            pf = math.radians(abs(self.lat_ts))
            mf = float(_conic_m(np.asarray(pf), e))
            tf = float(_conic_t(np.asarray(pf), e))
            self.k0 = mf * self._C / (2.0 * tf)

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        lon = np.asarray(lon, float)
        lat = np.asarray(lat, float)
        s = 1.0 if self.north else -1.0
        t = _conic_t(np.radians(s * lat), self._e)
        rho = 2.0 * self.a * self.k0 * t / self._C
        dlon = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = self.false_easting + rho * np.sin(dlon)
        y = self.false_northing - s * rho * np.cos(dlon)
        return x, y

    def inverse(self, x: ArrayLike, y: ArrayLike):
        s = 1.0 if self.north else -1.0
        dx = np.asarray(x, float) - self.false_easting
        dy = np.asarray(y, float) - self.false_northing
        rho = np.hypot(dx, dy)
        t = rho * self._C / (2.0 * self.a * self.k0)
        e = self._e
        phi = np.pi / 2.0 - 2.0 * np.arctan(t)  # conformal start
        for _ in range(12):
            es = e * np.sin(phi)
            phi = np.pi / 2.0 - 2.0 * np.arctan(
                t * ((1.0 - es) / (1.0 + es)) ** (e / 2.0))
        lon = self.lon0 + np.degrees(np.arctan2(dx, -s * dy))
        lon = (lon + 180.0) % 360.0 - 180.0
        return lon, s * np.degrees(phi)

    def __repr__(self):
        return (f"PolarStereographic(lat_ts={self.lat_ts}, "
                f"lon0={self.lon0}, k0={self.k0})")


class Mercator:
    """Ellipsoidal Mercator — EPSG 9804 (variant A, ``k0`` given) /
    EPSG 9805 (variant B, ``lat_ts`` standard parallel, k0 = m(lat_ts)).
    ``y`` is ``a k0`` times the isometric latitude, i.e. ``-a k0 ln t``
    with the same Snyder 15-9 ``t`` the anchored conformal-conic code
    uses (EPSG:3395 World Mercator)."""

    is_geographic = False

    def __init__(self, k0: float = 1.0, lat_ts: Optional[float] = None,
                 lon0: float = 0.0, false_easting: float = 0.0,
                 false_northing: float = 0.0,
                 a: float = _A, f: float = _F, towgs84=None):
        self.lon0 = float(lon0)
        self.lat_ts = None if lat_ts is None else float(lat_ts)
        self.false_easting = float(false_easting)
        self.false_northing = float(false_northing)
        self.a, self.f = a, f
        self.towgs84 = None if towgs84 is None else tuple(towgs84)
        e = self._e = math.sqrt(f * (2.0 - f))
        if lat_ts is not None:
            self.k0 = float(_conic_m(np.asarray(math.radians(lat_ts)), e))
        else:
            self.k0 = float(k0)

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        lon = np.asarray(lon, float)
        phi = np.radians(np.asarray(lat, float))
        x = self.false_easting + self.a * self.k0 * np.radians(
            (lon - self.lon0 + 180.0) % 360.0 - 180.0)
        y = self.false_northing - self.a * self.k0 * np.log(
            _conic_t(phi, self._e))
        return x, y

    def inverse(self, x: ArrayLike, y: ArrayLike):
        dx = np.asarray(x, float) - self.false_easting
        dy = np.asarray(y, float) - self.false_northing
        lon = self.lon0 + np.degrees(dx / (self.a * self.k0))
        t = np.exp(-dy / (self.a * self.k0))
        e = self._e
        phi = np.pi / 2.0 - 2.0 * np.arctan(t)
        for _ in range(12):
            es = e * np.sin(phi)
            phi = np.pi / 2.0 - 2.0 * np.arctan(
                t * ((1.0 - es) / (1.0 + es)) ** (e / 2.0))
        return lon, np.degrees(phi)

    def __repr__(self):
        return f"Mercator(k0={self.k0}, lon0={self.lon0})"


class PseudoMercator:
    """Spherical "Popular Visualisation Pseudo-Mercator" (EPSG method
    1024; EPSG:3857) — WGS84 geographic coordinates mapped with the
    SPHERICAL Mercator formulas on R = a. NOT the ellipsoidal Mercator:
    the two differ by up to ~21 km in northing (EPSG GN7-2 warns the
    WKT1 encoding via Mercator_1SP + PROJ4 extension is deliberate)."""

    is_geographic = False

    def __init__(self, lon0: float = 0.0, false_easting: float = 0.0,
                 false_northing: float = 0.0,
                 a: float = _A, f: float = _F, towgs84=None):
        self.lon0 = float(lon0)
        self.false_easting = float(false_easting)
        self.false_northing = float(false_northing)
        self.a, self.f = a, f  # the DATUM stays WGS84 ellipsoidal
        self.towgs84 = None if towgs84 is None else tuple(towgs84)

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        lon = np.asarray(lon, float)
        phi = np.radians(np.asarray(lat, float))
        x = self.false_easting + self.a * np.radians(
            (lon - self.lon0 + 180.0) % 360.0 - 180.0)
        y = self.false_northing + self.a * np.log(
            np.tan(np.pi / 4.0 + phi / 2.0))
        return x, y

    def inverse(self, x: ArrayLike, y: ArrayLike):
        dx = np.asarray(x, float) - self.false_easting
        dy = np.asarray(y, float) - self.false_northing
        lon = self.lon0 + np.degrees(dx / self.a)
        lat = np.degrees(2.0 * np.arctan(np.exp(dy / self.a)) - np.pi / 2.0)
        return lon, lat

    def __repr__(self):
        return f"PseudoMercator(lon0={self.lon0})"


class LambertAzimuthalEqualArea:
    """Ellipsoidal Lambert Azimuthal Equal-Area (EPSG method 9820,
    Snyder PP 1395 §24) — the pan-European product grid (EPSG:3035,
    ETRS89-LAEA) and the EASE-Grid 2.0 polar products (EPSG:6931/6932).

    Oblique aspect uses the authalic-latitude formulation (EPSG GN7-2
    worked example anchors tests/test_crs_laea.py); ``|lat0| == 90``
    switches to the polar-aspect closed forms."""

    is_geographic = False

    def __init__(self, lat0: float = 0.0, lon0: float = 0.0,
                 false_easting: float = 0.0, false_northing: float = 0.0,
                 a: float = _A, f: float = _F, towgs84=None):
        self.lat0, self.lon0 = float(lat0), float(lon0)
        self.false_easting = float(false_easting)
        self.false_northing = float(false_northing)
        self.a, self.f = a, f
        self.towgs84 = None if towgs84 is None else tuple(towgs84)
        e = self._e = math.sqrt(f * (2.0 - f))
        self._qp = float(_conic_q(np.asarray(math.pi / 2.0), e))
        self._polar = abs(abs(self.lat0) - 90.0) < 1e-9
        self._south = self.lat0 < 0
        if not self._polar:
            p0 = math.radians(lat0)
            q0 = float(_conic_q(np.asarray(p0), e))
            self._beta0 = math.asin(min(1.0, max(-1.0, q0 / self._qp)))
            self._rq = a * math.sqrt(self._qp / 2.0)
            self._d = (a * float(_conic_m(np.asarray(p0), e))
                       / (self._rq * math.cos(self._beta0)))

    def _dlam(self, lon):
        return np.radians((np.asarray(lon, float) - self.lon0 + 180.0)
                          % 360.0 - 180.0)

    def forward(self, lon: ArrayLike, lat: ArrayLike):
        phi = np.radians(np.asarray(lat, float))
        q = _conic_q(phi, self._e)
        lam = self._dlam(lon)
        if self._polar:
            # Snyder 24-23/25: rho = a sqrt(qp -+ q), pole-centred
            sgn = -1.0 if self._south else 1.0
            rho = self.a * np.sqrt(np.maximum(self._qp - sgn * q, 0.0))
            x = self.false_easting + rho * np.sin(lam)
            y = self.false_northing - sgn * rho * np.cos(lam)
            return x, y
        beta = np.arcsin(np.clip(q / self._qp, -1.0, 1.0))
        sb0, cb0 = math.sin(self._beta0), math.cos(self._beta0)
        b = self._rq * np.sqrt(
            2.0 / (1.0 + sb0 * np.sin(beta)
                   + cb0 * np.cos(beta) * np.cos(lam)))
        x = self.false_easting + b * self._d * np.cos(beta) * np.sin(lam)
        y = self.false_northing + (b / self._d) * (
            cb0 * np.sin(beta) - sb0 * np.cos(beta) * np.cos(lam))
        return x, y

    def _phi_from_beta(self, beta):
        """Authalic -> geodetic latitude (Snyder 3-18 series)."""
        e2 = self._e ** 2
        e4, e6 = e2 * e2, e2 * e2 * e2
        return beta + (
            (e2 / 3.0 + 31.0 * e4 / 180.0 + 517.0 * e6 / 5040.0)
            * np.sin(2.0 * beta)
            + (23.0 * e4 / 360.0 + 251.0 * e6 / 3780.0) * np.sin(4.0 * beta)
            + (761.0 * e6 / 45360.0) * np.sin(6.0 * beta))

    def inverse(self, x: ArrayLike, y: ArrayLike):
        dx = np.asarray(x, float) - self.false_easting
        dy = np.asarray(y, float) - self.false_northing
        if self._polar:
            sgn = -1.0 if self._south else 1.0
            rho = np.hypot(dx, dy)
            q = sgn * (self._qp - (rho / self.a) ** 2)
            beta = np.arcsin(np.clip(q / self._qp, -1.0, 1.0))
            lam = np.arctan2(dx, -sgn * dy)
            lon = self.lon0 + np.degrees(lam)
            return lon, np.degrees(self._phi_from_beta(beta))
        sb0, cb0 = math.sin(self._beta0), math.cos(self._beta0)
        rho = np.hypot(dx / self._d, self._d * dy)
        c = 2.0 * np.arcsin(np.clip(rho / (2.0 * self._rq), -1.0, 1.0))
        with np.errstate(invalid="ignore"):
            beta = np.where(
                rho == 0.0, self._beta0,
                np.arcsin(np.clip(
                    np.cos(c) * sb0 + self._d * dy * np.sin(c) * cb0
                    / np.where(rho == 0.0, 1.0, rho), -1.0, 1.0)))
        lam = np.arctan2(dx * np.sin(c),
                         self._d * rho * cb0 * np.cos(c)
                         - self._d ** 2 * dy * sb0 * np.sin(c))
        lon = self.lon0 + np.degrees(lam)
        return lon, np.degrees(self._phi_from_beta(beta))

    def __repr__(self):
        return (f"LambertAzimuthalEqualArea(lat0={self.lat0}, "
                f"lon0={self.lon0})")


# ---------------------------------------------------------------------------
# Datum shifts: TOWGS84 7-parameter Helmert (EPSG 9606 position-vector),
# applied through geocentric coordinates when src/dst datums differ —
# gdal.Warp(dstSRS=...)'s behaviour for TOWGS84-bearing SRS definitions.
# ---------------------------------------------------------------------------

_TOWGS84_ZERO = (0.0,) * 7


def _geodetic_to_ecef(lon, lat, a, f):
    e2 = f * (2.0 - f)
    phi = np.radians(np.asarray(lat, float))
    lam = np.radians(np.asarray(lon, float))
    s, c = np.sin(phi), np.cos(phi)
    n = a / np.sqrt(1.0 - e2 * s * s)
    return n * c * np.cos(lam), n * c * np.sin(lam), n * (1.0 - e2) * s


def _ecef_to_geodetic(x, y, z, a, f):
    e2 = f * (2.0 - f)
    p = np.hypot(x, y)
    lam = np.arctan2(y, x)
    phi = np.arctan2(z, p * (1.0 - e2))
    for _ in range(6):
        s = np.sin(phi)
        n = a / np.sqrt(1.0 - e2 * s * s)
        phi = np.arctan2(z + e2 * n * s, p)
    return np.degrees(lam), np.degrees(phi)


def _helmert(x, y, z, params, inverse=False):
    """EPSG 9606 position-vector transformation: translations in metres,
    rotations in arc-seconds, scale in ppm."""
    dx, dy, dz, rx, ry, rz, ds = params
    arc = math.pi / (180.0 * 3600.0)
    rx, ry, rz = rx * arc, ry * arc, rz * arc
    m = 1.0 + ds * 1e-6
    if not inverse:
        x2 = dx + m * (x - rz * y + ry * z)
        y2 = dy + m * (rz * x + y - rx * z)
        z2 = dz + m * (-ry * x + rx * y + z)
        return x2, y2, z2
    # small-angle exact-enough reverse (EPSG reverses by negating params)
    x, y, z = x - dx, y - dy, z - dz
    mi = 1.0 / m
    return (mi * (x + rz * y - ry * z),
            mi * (-rz * x + y + rx * z),
            mi * (ry * x - rx * y + z))


def _datum_of(p) -> Tuple[float, float, Tuple[float, ...]]:
    return (p.a, p.f, getattr(p, "towgs84", None) or _TOWGS84_ZERO)


def _same_datum(p, q) -> bool:
    pa, pf, pt = _datum_of(p)
    qa, qf, qt = _datum_of(q)
    return (abs(pa - qa) < 1e-6 and abs(pf - qf) < 1e-15
            and all(abs(u - v) < 1e-12 for u, v in zip(pt, qt)))


def _shift_datum(lon, lat, src, dst):
    """Geographic coordinates on src's datum -> dst's datum via the WGS84
    geocentric hub (h = 0; sub-mm for surface rasters)."""
    sa, sf, st = _datum_of(src)
    da, df, dt = _datum_of(dst)
    x, y, z = _geodetic_to_ecef(lon, lat, sa, sf)
    if any(st):
        x, y, z = _helmert(x, y, z, st)
    if any(dt):
        x, y, z = _helmert(x, y, z, dt, inverse=True)
    return _ecef_to_geodetic(x, y, z, da, df)


_PARAM_RE = re.compile(r'PARAMETER\s*\[\s*"([^"]+)"\s*,\s*([-+0-9.eE]+)',
                       re.IGNORECASE)
_SPHEROID_RE = re.compile(
    r'SPHEROID\s*\[\s*"[^"]*"\s*,\s*([-+0-9.eE]+)\s*,\s*([-+0-9.eE]+)',
    re.IGNORECASE)
_UTM_RE = re.compile(r'UTM\s+zone\s+(\d+)\s*([NS])', re.IGNORECASE)


_NUMBER = re.compile(r"\s*[+-]?(nan|inf(inity)?|(\d+\.?\d*|\.\d+)"
                     r"(e[+-]?\d+)?)\s*", re.IGNORECASE)


def _numbers(*texts: str) -> bool:
    """Whether ``float`` reads every text."""
    return all(_NUMBER.fullmatch(t) for t in texts)


def _parse_wkt(wkt: str):
    """(projection, "") of a WKT1 string, or (None, why ``from_wkt``
    refuses it)."""
    if wkt is None or not str(wkt).strip():
        return None, "empty WKT"
    wkt = str(wkt)
    a, f = _A, _F
    m = _SPHEROID_RE.search(wkt)
    if m:
        if not _numbers(m.group(1), m.group(2)):
            return None, f"malformed SPHEROID {m.group(0)!r}"
        a = float(m.group(1))
        invf = float(m.group(2))
        f = 1.0 / invf if invf else 0.0
    # fail-loud guards: a non-Greenwich prime meridian or a non-metre /
    # non-degree UNIT (e.g. US state-plane feet) would parse "successfully"
    # and then silently mis-locate every transformed coordinate
    pm = re.search(r'PRIMEM\s*\[\s*"[^"]*"\s*,\s*([-0-9.eE+]+)', wkt)
    if pm and not _numbers(pm.group(1)):
        return None, f"malformed PRIMEM {pm.group(0)!r}"
    if pm and abs(float(pm.group(1))) > 1e-9:
        return None, (f"unsupported prime meridian {pm.group(1)} "
                      "(only Greenwich)")
    is_projected = "PROJCS" in wkt.upper()
    # the LAST top-level UNIT clause governs the CRS's coordinate unit
    # (earlier ones inside GEOGCS of a PROJCS are the angular unit).
    # Checked BEFORE the datum guard: a feet-unit WKT is wrong regardless
    # of its datum name, and the unit error is the actionable one.
    units = re.findall(r'UNIT\s*\[\s*"[^"]*"\s*,\s*([-0-9.eE+]+)', wkt)
    if units:
        if not _numbers(units[-1]):
            return None, f"malformed UNIT factor {units[-1]!r}"
        u = float(units[-1])
        want = 1.0 if is_projected else 0.0174532925199433
        if not math.isclose(u, want, rel_tol=1e-6):
            kind = "metre" if is_projected else "degree"
            return None, (
                f"unsupported UNIT factor {u} (only {kind}-based CRS; "
                "got e.g. feet?) — reproject the raster first")
    # Datum policy. Accepted:
    #   * the WGS84 family — "WGS_1984"/"WGS 84", GDAL's "D_WGS_1984",
    #     WKT2's "World Geodetic System 1984";
    #   * zero-shift-by-convention datums (NAD83/GRS80, ETRS89), treated as
    #     TOWGS84[0,..] like GDAL without datum grids (<~1.5 m) — the CONUS
    #     product CRSs (CBRA/CNBH-style Albers) sit on NAD83;
    #   * ANY datum carrying an explicit TOWGS84 clause (e.g. Beijing 1954
    #     on Krassowsky) — transform() applies the 7-parameter Helmert
    #     shift through the WGS84 geocentric hub.
    # An unknown datum WITHOUT TOWGS84 still fails loudly: parsing it would
    # relabel its coordinates as WGS84 — a silent ~100 m error.
    towgs84 = None
    tw = re.search(r"TOWGS84\s*\[([^\]]*)\]", wkt)
    if tw:
        texts = [v for v in tw.group(1).split(",") if v.strip()]
        if not _numbers(*texts):
            return None, f"malformed TOWGS84 {tw.group(0)!r}"
        vals = [float(v) for v in texts]
        towgs84 = tuple((vals + [0.0] * 7)[:7])
    dm = re.search(r'DATUM\s*\[\s*"([^"]*)"', wkt)
    if dm and towgs84 is None:
        dname = re.sub(r"[^a-z0-9]", "", dm.group(1).lower())
        known = ("wgs1984", "wgs84", "worldgeodeticsystem1984",
                 "nad83", "northamerican1983", "northamericandatum1983",
                 "etrs89", "etrs1989", "europeanterrestrialreference")
        if not any(t in dname for t in known):
            return None, (
                f"unsupported datum {dm.group(1)!r} without a TOWGS84 "
                "clause — add TOWGS84 or reproject the raster first")
    if not is_projected:
        return Geographic(a, f, towgs84=towgs84), ""
    found = _PARAM_RE.findall(wkt)
    if not _numbers(*(v for _, v in found)):
        return None, "malformed PARAMETER value"
    params = {k.lower(): float(v) for k, v in found}
    proj_m = re.search(r'PROJECTION\s*\[\s*"([^"]+)"', wkt, re.IGNORECASE)
    name = (proj_m.group(1) if proj_m else "").lower().replace(" ", "_")
    e = math.sqrt(f * (2.0 - f))
    if name == "transverse_mercator":
        return TransverseMercator(
            lon0=params.get("central_meridian", 0.0),
            k0=params.get("scale_factor", 1.0),
            false_easting=params.get("false_easting", 0.0),
            false_northing=params.get("false_northing", 0.0),
            lat0=params.get("latitude_of_origin", 0.0),
            a=a, f=f, towgs84=towgs84), ""
    if name.startswith("lambert_conformal_conic"):
        lat1 = params.get("standard_parallel_1",
                          params.get("latitude_of_origin", 0.0))
        lat2 = params.get("standard_parallel_2")
        if abs(_lcc_cone(lat1, lat2, e)[0]) < 1e-12:
            return None, _LCC_DEGENERATE
        return LambertConformalConic(
            lat1=lat1, lat2=lat2,
            lat0=params.get("latitude_of_origin", 0.0),
            lon0=params.get("central_meridian",
                            params.get("longitude_of_center", 0.0)),
            k0=params.get("scale_factor", 1.0),
            false_easting=params.get("false_easting", 0.0),
            false_northing=params.get("false_northing", 0.0),
            a=a, f=f, towgs84=towgs84), ""
    if name in ("albers_conic_equal_area", "albers", "albers_equal_area",
                "albers_conic_equal_area_(spcs)"):
        lat1 = params.get("standard_parallel_1", 0.0)
        lat2 = params.get("standard_parallel_2")
        if abs(_albers_cone(lat1, lat2, e)[0]) < 1e-12:
            return None, _ALBERS_DEGENERATE
        return AlbersEqualArea(
            lat1=lat1, lat2=lat2,
            lat0=params.get("latitude_of_origin",
                            params.get("latitude_of_center", 0.0)),
            lon0=params.get("central_meridian",
                            params.get("longitude_of_center", 0.0)),
            false_easting=params.get("false_easting", 0.0),
            false_northing=params.get("false_northing", 0.0),
            a=a, f=f, towgs84=towgs84), ""
    if name in ("polar_stereographic", "polar_stereographic_(variant_a)",
                "polar_stereographic_(variant_b)",
                "stereographic_north_pole", "stereographic_south_pole"):
        # GDAL WKT1 encodes variant B's standard parallel as
        # latitude_of_origin (scale_factor 1); ESRI's aliases use
        # standard_parallel_1. |lat| == 90 selects variant A (k0 given).
        lat_ts = params.get(
            "latitude_of_origin",
            params.get("standard_parallel_1",
                       params.get("latitude_of_standard_parallel", 90.0)))
        k0 = params.get("scale_factor")
        if _polar_both(lat_ts, k0):
            return None, _POLAR_BOTH
        return PolarStereographic(
            lat_ts=lat_ts,
            lon0=params.get("central_meridian",
                            params.get("longitude_of_origin", 0.0)),
            k0=k0,
            false_easting=params.get("false_easting", 0.0),
            false_northing=params.get("false_northing", 0.0),
            a=a, f=f, towgs84=towgs84), ""
    if name in ("mercator_1sp", "mercator_2sp", "mercator",
                "mercator_(variant_a)", "mercator_(variant_b)",
                "popular_visualisation_pseudo_mercator"):
        # EPSG:3857's WKT1 reads as Mercator_1SP but its semantics are
        # SPHERICAL (EPSG method 1024) — GDAL marks it via the PROJCS
        # name and/or a PROJ4 extension with +b == +a; honouring the
        # ellipsoidal reading would be a ~21 km northing error
        pj = re.search(r'PROJCS\s*\[\s*"([^"]*)"', wkt, re.IGNORECASE)
        pname = (pj.group(1) if pj else "").lower()
        ext = re.search(r'EXTENSION\s*\[\s*"PROJ4"\s*,\s*"([^"]*)"', wkt,
                        re.IGNORECASE)
        spherical = ("pseudo-mercator" in pname or "web mercator" in pname
                     or name == "popular_visualisation_pseudo_mercator"
                     or (ext is not None and "+a=6378137" in ext.group(1)
                         and "+b=6378137" in ext.group(1)))
        if spherical:
            return PseudoMercator(
                lon0=params.get("central_meridian", 0.0),
                false_easting=params.get("false_easting", 0.0),
                false_northing=params.get("false_northing", 0.0),
                a=a, f=f, towgs84=towgs84), ""
        return Mercator(
            k0=params.get("scale_factor", 1.0),
            lat_ts=params.get("standard_parallel_1"),
            lon0=params.get("central_meridian", 0.0),
            false_easting=params.get("false_easting", 0.0),
            false_northing=params.get("false_northing", 0.0),
            a=a, f=f, towgs84=towgs84), ""
    if name in ("lambert_azimuthal_equal_area",
                "lambert_azimuthal_equal_area_(spherical)"):
        # GDAL WKT1 writes latitude_of_center; ESRI Latitude_Of_Origin
        return LambertAzimuthalEqualArea(
            lat0=params.get("latitude_of_center",
                            params.get("latitude_of_origin", 0.0)),
            lon0=params.get("longitude_of_center",
                            params.get("central_meridian", 0.0)),
            false_easting=params.get("false_easting", 0.0),
            false_northing=params.get("false_northing", 0.0),
            a=a, f=f, towgs84=towgs84), ""
    um = _UTM_RE.search(wkt)
    if um and not name:
        zone = int(um.group(1))
        if not 1 <= zone <= 60:
            return None, f"bad UTM zone {zone}"
        proj = utm(zone, um.group(2).upper() == "S", a, f)
        proj.towgs84 = towgs84  # carry the datum shift through the fallback
        return proj, ""
    return None, f"unsupported projection {name!r}"


def wkt_error(wkt: str) -> Optional[str]:
    """Why :func:`from_wkt` refuses ``wkt``, or None when it parses."""
    return _parse_wkt(wkt)[1] or None


def from_wkt(wkt: str):
    """Parse a WKT1 ``.prj`` string into a projection object.

    Supports GEOGCS (geographic degrees) and PROJCS with
    ``Transverse_Mercator`` (which covers every UTM zone the products
    ship in) and the conic, polar, Mercator and LAEA families. Raises
    ValueError on other projections (:func:`wkt_error` says why without
    raising) so callers fail loudly rather than silently mis-locating
    rasters.
    """
    proj, why = _parse_wkt(wkt)
    if proj is None:
        raise ValueError(why)
    return proj


# GRS80 (NAD83's ellipsoid; treated as zero-shift vs WGS84 like GDAL
# without datum grids — <~1.5 m for the CONUS products)
_A_GRS80 = 6378137.0
_F_GRS80 = 1.0 / 298.257222101


def from_epsg(code: int):
    """Projection for the EPSG codes the height products ship in:
    4326 (WGS84 geographic), the 326xx/327xx WGS84 UTM zones, and
    5070 (NAD83 / Conus Albers — the CONUS raster products)."""
    code = int(code)
    if code == 4326:
        return Geographic()
    if 32601 <= code <= 32660:
        return utm(code - 32600)
    if 32701 <= code <= 32760:
        return utm(code - 32700, south=True)
    if code == 5070:
        return AlbersEqualArea(lat1=29.5, lat2=45.5, lat0=23.0, lon0=-96.0,
                               a=_A_GRS80, f=_F_GRS80)
    if code == 3857:  # WGS 84 / Pseudo-Mercator (web tiles)
        return PseudoMercator()
    if code == 3395:  # WGS 84 / World Mercator
        return Mercator()
    if code == 3413:  # WGS 84 / NSIDC Sea Ice Polar Stereographic North
        return PolarStereographic(lat_ts=70.0, lon0=-45.0)
    if code == 3976:  # WGS 84 / NSIDC Sea Ice Polar Stereographic South
        return PolarStereographic(lat_ts=-70.0, lon0=0.0)
    if code == 3031:  # WGS 84 / Antarctic Polar Stereographic
        return PolarStereographic(lat_ts=-71.0, lon0=0.0)
    if code in (5041, 32661):  # WGS 84 / UPS North (E,N)
        return PolarStereographic(lat_ts=90.0, k0=0.994,
                                  false_easting=2000000.0,
                                  false_northing=2000000.0)
    if code in (5042, 32761):  # WGS 84 / UPS South (E,N)
        return PolarStereographic(lat_ts=-90.0, k0=0.994,
                                  false_easting=2000000.0,
                                  false_northing=2000000.0)
    if code == 3035:  # ETRS89-extended / LAEA Europe (pan-EU products)
        return LambertAzimuthalEqualArea(
            lat0=52.0, lon0=10.0, false_easting=4321000.0,
            false_northing=3210000.0, a=_A_GRS80, f=_F_GRS80)
    if code == 6931:  # WGS 84 / NSIDC EASE-Grid 2.0 North
        return LambertAzimuthalEqualArea(lat0=90.0, lon0=0.0)
    if code == 6932:  # WGS 84 / NSIDC EASE-Grid 2.0 South
        return LambertAzimuthalEqualArea(lat0=-90.0, lon0=0.0)
    raise ValueError(f"unsupported EPSG:{code}")


def supported_epsg(code: int) -> bool:
    """Whether :func:`wkt_for_epsg` knows ``code``; :func:`from_epsg` knows
    every such code, and 3395 and the UPS codes besides."""
    code = int(code)
    return (code in (4326, 5070, 3857, 3413, 3976, 3031, 3035, 6931, 6932)
            or 32601 <= code <= 32660 or 32701 <= code <= 32760)


def epsg_from_geokeys(geo_keys: bytes, endian: str = "<") -> Optional[int]:
    """EPSG CRS code from a GeoTIFF GeoKeyDirectory (tag 34735) payload:
    ProjectedCSTypeGeoKey (3072) wins over GeographicTypeGeoKey (2048)."""
    if not geo_keys or len(geo_keys) < 8:
        return None
    vals = struct.unpack(endian + "H" * (len(geo_keys) // 2),
                         geo_keys[: (len(geo_keys) // 2) * 2])
    nkeys = vals[3]
    code = None
    for i in range(min(nkeys, (len(vals) - 4) // 4)):
        kid, loc, _cnt, val = vals[4 + 4 * i: 8 + 4 * i]
        if loc != 0:
            continue
        if val in (0, 32767):
            # 32767 is the GeoTIFF "user-defined" sentinel, not an EPSG
            # code (GeoTIFF spec §6.3.1.1); returning it would send
            # callers into from_epsg(32767)
            continue
        if kid == 3072:
            return int(val)
        if kid == 2048:
            code = int(val)
    return code


def geokeys_for_epsg(code: int) -> bytes:
    """GeoTIFF GeoKeyDirectory (tag 34735) payload declaring an EPSG CRS —
    the writer-side twin of :func:`epsg_from_geokeys` (little-endian, like
    every TIFF the codec writes)."""
    code = int(code)
    geographic = 4000 <= code < 5000
    keys = [(1024, 0, 1, 2 if geographic else 1),  # GTModelType
            (1025, 0, 1, 1),                       # GTRasterType: PixelIsArea
            (2048 if geographic else 3072, 0, 1, code)]
    vals = [1, 1, 0, len(keys)]
    for k in keys:
        vals.extend(k)
    return struct.pack("<" + "H" * len(vals), *vals)


_WKT_GEO_4326 = ('GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",'
                 '6378137,298.257223563]],PRIMEM["Greenwich",0],'
                 'UNIT["degree",0.0174532925199433]]')


def wkt_for_epsg(code: int) -> str:
    """Canonical WKT1 for the supported EPSG codes (4326 and WGS84 UTM) —
    enough for ``.prj`` sidecars that :func:`from_wkt` round-trips."""
    code = int(code)
    if code == 4326:
        return _WKT_GEO_4326
    if 32601 <= code <= 32660 or 32701 <= code <= 32760:
        south = code > 32700
        zone = code - (32700 if south else 32600)
        return (
            f'PROJCS["WGS 84 / UTM zone {zone}{"S" if south else "N"}",'
            f'{_WKT_GEO_4326},PROJECTION["Transverse_Mercator"],'
            f'PARAMETER["latitude_of_origin",0],'
            f'PARAMETER["central_meridian",{6 * zone - 183}],'
            f'PARAMETER["scale_factor",0.9996],'
            f'PARAMETER["false_easting",500000],'
            f'PARAMETER["false_northing",{10000000 if south else 0}],'
            f'UNIT["metre",1]]')
    if code == 5070:
        return (
            'PROJCS["NAD83 / Conus Albers",GEOGCS["NAD83",'
            'DATUM["North_American_Datum_1983",SPHEROID["GRS 1980",'
            '6378137,298.257222101]],PRIMEM["Greenwich",0],'
            'UNIT["degree",0.0174532925199433]],'
            'PROJECTION["Albers_Conic_Equal_Area"],'
            'PARAMETER["latitude_of_center",23],'
            'PARAMETER["longitude_of_center",-96],'
            'PARAMETER["standard_parallel_1",29.5],'
            'PARAMETER["standard_parallel_2",45.5],'
            'PARAMETER["false_easting",0],PARAMETER["false_northing",0],'
            'UNIT["metre",1]]')
    if code == 3857:
        return (
            'PROJCS["WGS 84 / Pseudo-Mercator",' + _WKT_GEO_4326 + ','
            'PROJECTION["Mercator_1SP"],'
            'PARAMETER["central_meridian",0],'
            'PARAMETER["scale_factor",1],'
            'PARAMETER["false_easting",0],PARAMETER["false_northing",0],'
            'UNIT["metre",1],EXTENSION["PROJ4","+proj=merc +a=6378137 '
            '+b=6378137 +lat_ts=0 +lon_0=0 +x_0=0 +y_0=0 +k=1 +units=m '
            '+nadgrids=@null +wktext +no_defs"]]')
    if code in (3413, 3976, 3031):
        lat, lon = {3413: (70, -45), 3976: (-70, 0), 3031: (-71, 0)}[code]
        nm = {3413: "NSIDC Sea Ice Polar Stereographic North",
              3976: "NSIDC Sea Ice Polar Stereographic South",
              3031: "Antarctic Polar Stereographic"}[code]
        return (
            f'PROJCS["WGS 84 / {nm}",' + _WKT_GEO_4326 + ','
            'PROJECTION["Polar_Stereographic"],'
            f'PARAMETER["latitude_of_origin",{lat}],'
            f'PARAMETER["central_meridian",{lon}],'
            'PARAMETER["scale_factor",1],'
            'PARAMETER["false_easting",0],PARAMETER["false_northing",0],'
            'UNIT["metre",1]]')
    if code == 3035:
        return (
            'PROJCS["ETRS89-extended / LAEA Europe",GEOGCS["ETRS89",'
            'DATUM["European_Terrestrial_Reference_System_1989",'
            'SPHEROID["GRS 1980",6378137,298.257222101]],'
            'PRIMEM["Greenwich",0],'
            'UNIT["degree",0.0174532925199433]],'
            'PROJECTION["Lambert_Azimuthal_Equal_Area"],'
            'PARAMETER["latitude_of_center",52],'
            'PARAMETER["longitude_of_center",10],'
            'PARAMETER["false_easting",4321000],'
            'PARAMETER["false_northing",3210000],UNIT["metre",1]]')
    if code in (6931, 6932):
        lat = 90 if code == 6931 else -90
        nm = "North" if code == 6931 else "South"
        return (
            f'PROJCS["WGS 84 / NSIDC EASE-Grid 2.0 {nm}",'
            + _WKT_GEO_4326 + ','
            'PROJECTION["Lambert_Azimuthal_Equal_Area"],'
            f'PARAMETER["latitude_of_center",{lat}],'
            'PARAMETER["longitude_of_center",0],'
            'PARAMETER["false_easting",0],PARAMETER["false_northing",0],'
            'UNIT["metre",1]]')
    raise ValueError(f"unsupported EPSG:{code}")


def epsg_of(p) -> Optional[int]:
    """Best-effort inverse of :func:`from_epsg`: the EPSG code of a
    projection object (or WKT string), None when it is not one of the
    supported canonical forms (WGS84 geographic / WGS84 UTM zones)."""
    p = as_projection(p)
    # a nonzero TOWGS84 means the coordinates live on a shifted datum:
    # stamping them with a WGS84/NAD83 EPSG code would be a silent
    # metres-level datum mislabel
    tw = getattr(p, "towgs84", None)
    if tw and any(abs(v) > 1e-12 for v in tw):
        return None
    if (isinstance(p, AlbersEqualArea) and (p.lat1, p.lat2, p.lat0, p.lon0)
            == (29.5, 45.5, 23.0, -96.0)
            and p.false_easting == 0.0 and p.false_northing == 0.0
            and abs(p.a - _A_GRS80) < 1e-3
            and abs(p.f - _F_GRS80) < 1e-12):
        return 5070
    if (isinstance(p, LambertAzimuthalEqualArea)
            and (p.lat0, p.lon0) == (52.0, 10.0)
            and p.false_easting == 4321000.0
            and p.false_northing == 3210000.0
            and abs(p.a - _A_GRS80) < 1e-3
            and abs(p.f - _F_GRS80) < 1e-12):
        return 3035
    if abs(p.a - _A) > 1e-3 or abs(p.f - _F) > 1e-12:
        return None
    if getattr(p, "is_geographic", False):
        return 4326
    if (isinstance(p, PseudoMercator) and p.lon0 == 0.0
            and p.false_easting == 0.0 and p.false_northing == 0.0):
        return 3857
    if (isinstance(p, Mercator) and p.k0 == 1.0 and p.lon0 == 0.0
            and p.false_easting == 0.0 and p.false_northing == 0.0):
        return 3395
    if isinstance(p, PolarStereographic):
        key = (p.lat_ts, p.lon0, p.false_easting, p.false_northing)
        code = {(70.0, -45.0, 0.0, 0.0): 3413,
                (-70.0, 0.0, 0.0, 0.0): 3976,
                (-71.0, 0.0, 0.0, 0.0): 3031,
                (90.0, 0.0, 2000000.0, 2000000.0): 5041,
                (-90.0, 0.0, 2000000.0, 2000000.0): 5042}.get(key)
        if code in (5041, 5042) and not math.isclose(p.k0, 0.994):
            return None  # variant A at the pole but not the UPS scale
        return code
    if (isinstance(p, LambertAzimuthalEqualArea)
            and p.false_easting == 0.0 and p.false_northing == 0.0
            and p.lon0 == 0.0):
        return {90.0: 6931, -90.0: 6932}.get(p.lat0)
    if (isinstance(p, TransverseMercator) and p.k0 == 0.9996
            and p.false_easting == 500000.0 and p.lat0 == 0.0):
        zone = (p.lon0 + 183.0) / 6.0
        if zone == int(zone) and 1 <= int(zone) <= 60:
            if p.false_northing == 0.0:
                return 32600 + int(zone)
            if p.false_northing == 10000000.0:
                return 32700 + int(zone)
    return None


def as_projection(p):
    """Coerce WKT strings, EPSG ints, or projection objects to an object."""
    if isinstance(p, str):
        return from_wkt(p)
    if isinstance(p, (int, np.integer)):
        return from_epsg(p)
    return p


def transform(src, dst, x: ArrayLike, y: ArrayLike):
    """Map coordinates from ``src`` to ``dst`` (objects, WKT, or EPSG).

    When the two CRSs sit on different datums (different ellipsoid or
    TOWGS84 parameters), the geographic coordinates are carried through
    the WGS84 geocentric hub with the 7-parameter Helmert shifts — the
    gdal.Warp(dstSRS=...) behaviour for TOWGS84-bearing definitions."""
    src = as_projection(src)
    dst = as_projection(dst)
    lon, lat = src.inverse(x, y)
    if not _same_datum(src, dst):
        lon, lat = _shift_datum(lon, lat, src, dst)
    return dst.forward(lon, lat)


def transform_bounds(src, dst, bounds: Tuple[float, float, float, float],
                     densify: int = 21) -> Tuple[float, float, float, float]:
    """Transform a bbox by densifying its edges (a reprojected rectangle's
    envelope is larger than its reprojected corners)."""
    minx, miny, maxx, maxy = bounds
    t = np.linspace(0.0, 1.0, densify)
    xs = np.concatenate([minx + (maxx - minx) * t, np.full(densify, maxx),
                         maxx + (minx - maxx) * t, np.full(densify, minx)])
    ys = np.concatenate([np.full(densify, miny), miny + (maxy - miny) * t,
                         np.full(densify, maxy), maxy + (miny - maxy) * t])
    tx, ty = transform(src, dst, xs, ys)
    return float(tx.min()), float(ty.min()), float(tx.max()), float(ty.max())
