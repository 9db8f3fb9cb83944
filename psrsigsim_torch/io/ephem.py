"""Analytic solar-system ephemeris + timescales for pulsar phase prediction.

The reference delegates barycentering entirely to PINT (reference:
io/psrfits.py:116-181, utils/utils.py:342-348), which reads a JPL
development ephemeris (DE436 for the vendored NANOGrav par files).  No
ephemeris files exist in this environment, so by default this module
computes the observatory's solar-system-barycentric position from
closed-form series (below).  Users who have a real JPL kernel can point
``PSS_EPHEM=/path/to/de440s.bsp`` (or call :func:`set_ephemeris`) at it:
``observatory_ssb`` then evaluates the kernel's Chebyshev polynomials
(io/spk.py) — the same data path PINT/TEMPO use — and written PSRFITS
headers record the kernel name in EPHEM.  Analytic-model details:

- Earth heliocentric position: truncated VSOP87 series (the classical
  Meeus truncation) — ~arcsecond-level angular accuracy, which bounds the
  absolute Roemer-delay error at the few-millisecond level.
- Sun -> SSB offset: Keplerian mean elements for the eight planets
  (Standish 1800-2050 approximate elements), mass-weighted.  The offset
  itself is ~2-3 light-seconds; the element accuracy keeps its error well
  under a millisecond.
- Observatory geocentric position: ITRF coordinates rotated by GMST and
  IAU-1976 precession (polar motion / nutation neglected: < 2 us of
  delay).
- Timescales: UTC -> TT via the leap-second table, TT -> TDB via the
  standard two-term Fairhead & Bretagnon approximation (~30 us max
  error, i.e. well under the ephemeris error budget).

Accuracy statement (documented, deliberate): ABSOLUTE barycentric delays
carry a few-millisecond uncertainty versus a true JPL ephemeris, i.e. a
fraction of a turn of absolute phase for a millisecond pulsar.  The
DIFFERENTIAL error across a single observation span — what actually
matters for folding data against the generated polycos — is at the
microsecond level, because the ephemeris error drifts on annual/monthly
timescales.  Fitted polycos reproduce this model's own phase to < 1e-6
cycles (enforced by tests/test_timing.py).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "AU_LTS", "SUN_T", "tai_minus_utc", "tt_from_utc", "tdb_from_tt",
    "tdb_from_utc", "tdb_minus_utc_seconds", "earth_heliocentric",
    "sun_ssb_offset",
    "observatory_itrf", "observatory_ssb", "solve_kepler",
    "OBSERVATORIES", "UnknownObservatoryError", "register_observatory",
    "load_tempo_obsys", "set_ephemeris", "ephemeris_name",
    "EphemerisChangeWarning",
]

# -- constants ---------------------------------------------------------------

AU_LTS = 499.00478384  # astronomical unit in light-seconds
SUN_T = 4.925490947e-6  # GM_sun/c^3 in seconds (Shapiro/Einstein scale)
_DEG = np.pi / 180.0
# mean obliquity of the ecliptic at J2000 (IERS 2010: 84381.406 arcsec)
_EPS0 = 84381.406 / 3600.0 * _DEG
_MJD_J2000 = 51544.5  # MJD(TT) of J2000.0


# -- timescales --------------------------------------------------------------

# (first MJD of validity, TAI-UTC seconds) — complete leap-second table
# since 1972; the last leap second was 2017-01-01 (MJD 57754).
_LEAP_TABLE = np.array([
    (41317, 10), (41499, 11), (41683, 12), (42048, 13), (42413, 14),
    (42778, 15), (43144, 16), (43509, 17), (43874, 18), (44239, 19),
    (44786, 20), (45151, 21), (45516, 22), (46247, 23), (47161, 24),
    (47892, 25), (48257, 26), (48804, 27), (49169, 28), (49534, 29),
    (50083, 30), (50630, 31), (51179, 32), (53736, 33), (54832, 34),
    (56109, 35), (57204, 36), (57754, 37),
], dtype=np.float64)


def tai_minus_utc(mjd_utc):
    """TAI-UTC (seconds) at the given UTC MJD(s)."""
    mjd = np.asarray(mjd_utc, np.float64)
    idx = np.searchsorted(_LEAP_TABLE[:, 0], mjd, side="right") - 1
    idx = np.clip(idx, 0, len(_LEAP_TABLE) - 1)
    return _LEAP_TABLE[idx, 1]


def tt_from_utc(mjd_utc):
    """UTC MJD -> TT MJD (longdouble-preserving)."""
    mjd = np.asarray(mjd_utc)
    return mjd + (tai_minus_utc(mjd) + 32.184) / 86400.0


def tdb_from_tt(mjd_tt):
    """TT MJD -> TDB MJD via the two-term periodic approximation
    (max error ~30 us; negligible against the analytic-ephemeris budget)."""
    mjd = np.asarray(mjd_tt)
    d = np.asarray(mjd, np.float64) - _MJD_J2000
    g = (357.53 + 0.98560028 * d) * _DEG  # Earth mean anomaly
    dt = 0.001657 * np.sin(g) + 0.000014 * np.sin(2.0 * g)
    return mjd + dt / 86400.0


def tdb_from_utc(mjd_utc):
    return tdb_from_tt(tt_from_utc(mjd_utc))


def tdb_minus_utc_seconds(mjd_utc):
    """TDB-UTC offset in SECONDS, computed without the catastrophic
    cancellation of ``tdb_from_utc(t) - t`` (float64 MJD quantizes at
    ~0.6 us near MJD 56000, i.e. ~1e-4 cycles for a millisecond pulsar)."""
    mjd = np.asarray(mjd_utc, np.float64)
    tt_off = tai_minus_utc(mjd) + 32.184
    d = mjd + tt_off / 86400.0 - _MJD_J2000
    g = (357.53 + 0.98560028 * d) * _DEG
    return tt_off + 0.001657 * np.sin(g) + 0.000014 * np.sin(2.0 * g)


# -- VSOP87 Earth (truncated) ------------------------------------------------
# Series term format: (A, B, C) -> A*cos(B + C*t), t in Julian millennia
# (TDB) from J2000.  L/B in 1e-8 rad, R in 1e-8 AU.  This is the classical
# Meeus truncation of VSOP87D (ecliptic & equinox of date).

_L0 = np.array([
    (175347046.0, 0.0, 0.0),
    (3341656.0, 4.6692568, 6283.0758500),
    (34894.0, 4.62610, 12566.15170),
    (3497.0, 2.7441, 5753.3849),
    (3418.0, 2.8289, 3.5231),
    (3136.0, 3.6277, 77713.7715),
    (2676.0, 4.4181, 7860.4194),
    (2343.0, 6.1352, 3930.2097),
    (1324.0, 0.7425, 11506.7698),
    (1273.0, 2.0371, 529.6910),
    (1199.0, 1.1096, 1577.3435),
    (990.0, 5.233, 5884.927),
    (902.0, 2.045, 26.298),
    (857.0, 3.508, 398.149),
    (780.0, 1.179, 5223.694),
    (753.0, 2.533, 5507.553),
    (505.0, 4.583, 18849.228),
    (492.0, 4.205, 775.523),
    (357.0, 2.920, 0.067),
    (317.0, 5.849, 11790.629),
    (284.0, 1.899, 796.298),
    (271.0, 0.315, 10977.079),
    (243.0, 0.345, 5486.778),
    (206.0, 4.806, 2544.314),
    (205.0, 1.869, 5573.143),
    (202.0, 2.458, 6069.777),
    (156.0, 0.833, 213.299),
    (132.0, 3.411, 2942.463),
    (126.0, 1.083, 20.775),
    (115.0, 0.645, 0.980),
    (103.0, 0.636, 4694.003),
    (102.0, 0.976, 15720.839),
    (102.0, 4.267, 7.114),
    (99.0, 6.21, 2146.17),
    (98.0, 0.68, 155.42),
    (86.0, 5.98, 161000.69),
    (85.0, 1.30, 6275.96),
    (85.0, 3.67, 71430.70),
    (80.0, 1.81, 17260.15),
    (79.0, 3.04, 12036.46),
    (75.0, 1.76, 5088.63),
    (74.0, 3.50, 3154.69),
    (74.0, 4.68, 801.82),
    (70.0, 0.83, 9437.76),
    (62.0, 3.98, 8827.39),
    (61.0, 1.82, 7084.90),
    (57.0, 2.78, 6286.60),
    (56.0, 4.39, 14143.50),
    (56.0, 3.47, 6279.55),
    (52.0, 0.19, 12139.55),
    (52.0, 1.33, 1748.02),
    (51.0, 0.28, 5856.48),
    (49.0, 0.49, 1194.45),
    (41.0, 5.37, 8429.24),
    (41.0, 2.40, 19651.05),
    (39.0, 6.17, 10447.39),
    (37.0, 6.04, 10213.29),
    (37.0, 2.57, 1059.38),
    (36.0, 1.71, 2352.87),
    (36.0, 1.78, 6812.77),
    (33.0, 0.59, 17789.85),
    (30.0, 0.44, 83996.85),
    (30.0, 2.74, 1349.87),
    (25.0, 3.16, 4690.48),
], dtype=np.float64)

_L1 = np.array([
    (628331966747.0, 0.0, 0.0),
    (206059.0, 2.678235, 6283.075850),
    (4303.0, 2.6351, 12566.1517),
    (425.0, 1.590, 3.523),
    (119.0, 5.796, 26.298),
    (109.0, 2.966, 1577.344),
    (93.0, 2.59, 18849.23),
    (72.0, 1.14, 529.69),
    (68.0, 1.87, 398.15),
    (67.0, 4.41, 5507.55),
    (59.0, 2.89, 5223.69),
    (56.0, 2.17, 155.42),
    (45.0, 0.40, 796.30),
    (36.0, 0.47, 775.52),
    (29.0, 2.65, 7.11),
    (21.0, 5.34, 0.98),
    (19.0, 1.85, 5486.78),
    (19.0, 4.97, 213.30),
    (17.0, 2.99, 6275.96),
    (16.0, 0.03, 2544.31),
    (16.0, 1.43, 2146.17),
    (15.0, 1.21, 10977.08),
    (12.0, 2.83, 1748.02),
    (12.0, 3.26, 5088.63),
    (12.0, 5.27, 1194.45),
    (12.0, 2.08, 4694.00),
    (11.0, 0.77, 553.57),
    (10.0, 1.30, 6286.60),
    (10.0, 4.24, 1349.87),
    (9.0, 2.70, 242.73),
    (9.0, 5.64, 951.72),
    (8.0, 5.30, 2352.87),
    (6.0, 2.65, 9437.76),
    (6.0, 4.67, 4690.48),
], dtype=np.float64)

_L2 = np.array([
    (52919.0, 0.0, 0.0),
    (8720.0, 1.0721, 6283.0758),
    (309.0, 0.867, 12566.152),
    (27.0, 0.05, 3.52),
    (16.0, 5.19, 26.30),
    (16.0, 3.68, 155.42),
    (10.0, 0.76, 18849.23),
    (9.0, 2.06, 77713.77),
    (7.0, 0.83, 775.52),
    (5.0, 4.66, 1577.34),
    (4.0, 1.03, 7.11),
    (4.0, 3.44, 5573.14),
    (3.0, 5.14, 796.30),
    (3.0, 6.05, 5507.55),
    (3.0, 1.19, 242.73),
    (3.0, 6.12, 529.69),
    (3.0, 0.31, 398.15),
    (3.0, 2.28, 553.57),
    (2.0, 4.38, 5223.69),
    (2.0, 3.75, 0.98),
], dtype=np.float64)

_L3 = np.array([
    (289.0, 5.844, 6283.076),
    (35.0, 0.0, 0.0),
    (17.0, 5.49, 12566.15),
    (3.0, 5.20, 155.42),
    (1.0, 4.72, 3.52),
    (1.0, 5.30, 18849.23),
    (1.0, 5.97, 242.73),
], dtype=np.float64)

_B0 = np.array([
    (280.0, 3.199, 84334.662),
    (102.0, 5.422, 5507.553),
    (80.0, 3.88, 5223.69),
    (44.0, 3.70, 2352.87),
    (32.0, 4.00, 1577.34),
], dtype=np.float64)

_B1 = np.array([
    (9.0, 3.90, 5507.55),
    (6.0, 1.73, 5223.69),
], dtype=np.float64)

_R0 = np.array([
    (100013989.0, 0.0, 0.0),
    (1670700.0, 3.0984635, 6283.0758500),
    (13956.0, 3.05525, 12566.15170),
    (3084.0, 5.1985, 77713.7715),
    (1628.0, 1.1739, 5753.3849),
    (1576.0, 2.8469, 7860.4194),
    (925.0, 5.453, 11506.770),
    (542.0, 4.564, 3930.210),
    (472.0, 3.661, 5884.927),
    (346.0, 0.964, 5507.553),
    (329.0, 5.900, 5223.694),
    (307.0, 0.299, 5573.143),
    (243.0, 4.273, 11790.629),
    (212.0, 5.847, 1577.344),
    (186.0, 5.022, 10977.079),
    (175.0, 3.012, 18849.228),
    (110.0, 5.055, 5486.778),
    (98.0, 0.89, 6069.78),
    (86.0, 5.69, 15720.84),
    (86.0, 1.27, 161000.69),
    (65.0, 0.27, 17260.15),
    (63.0, 0.92, 529.69),
    (57.0, 2.01, 83996.85),
    (56.0, 5.24, 71430.70),
    (49.0, 3.25, 2544.31),
    (47.0, 2.58, 775.52),
    (45.0, 5.54, 9437.76),
    (43.0, 6.01, 6275.96),
    (39.0, 5.36, 4694.00),
    (38.0, 2.39, 8827.39),
    (37.0, 0.83, 19651.05),
    (37.0, 4.90, 12139.55),
    (36.0, 1.67, 12036.46),
    (35.0, 1.84, 2942.46),
    (33.0, 0.24, 7084.90),
    (32.0, 0.18, 5088.63),
    (32.0, 1.78, 398.15),
    (28.0, 1.21, 6286.60),
    (28.0, 1.90, 6279.55),
    (26.0, 4.59, 10447.39),
], dtype=np.float64)

_R1 = np.array([
    (103019.0, 1.107490, 6283.075850),
    (1721.0, 1.0644, 12566.1517),
    (702.0, 3.142, 0.0),
    (32.0, 1.02, 18849.23),
    (31.0, 2.84, 5507.55),
    (25.0, 1.32, 5223.69),
    (18.0, 1.42, 1577.34),
    (10.0, 5.91, 10977.08),
    (9.0, 1.42, 6275.96),
    (9.0, 0.27, 5486.78),
], dtype=np.float64)

_R2 = np.array([
    (4359.0, 5.7846, 6283.0758),
    (124.0, 5.579, 12566.152),
    (12.0, 3.14, 0.0),
    (9.0, 3.63, 77713.77),
    (6.0, 1.87, 5573.14),
    (3.0, 5.47, 18849.23),
], dtype=np.float64)

_R3 = np.array([
    (145.0, 4.273, 6283.076),
    (7.0, 3.92, 12566.15),
], dtype=np.float64)


def _series(t, terms):
    """Sum A*cos(B + C*t) over the rows of ``terms`` for millennia ``t``."""
    t = np.asarray(t, np.float64)[..., None]
    a, b, c = terms[:, 0], terms[:, 1], terms[:, 2]
    return np.sum(a * np.cos(b + c * t), axis=-1)


def earth_heliocentric(mjd_tdb):
    """Earth heliocentric ecliptic position — longitude (rad), latitude
    (rad), radius (AU) — referred to the **mean equinox of date**.

    Truncated VSOP87; compare Meeus ch. 32.  The 77713.77-frequency terms
    are the Earth's monthly motion about the Earth-Moon barycenter, i.e.
    this is the Earth itself, not the EMB — no separate lunar correction
    is applied."""
    t = (np.asarray(mjd_tdb, np.float64) - _MJD_J2000) / 365250.0
    lon = (_series(t, _L0) + t * (_series(t, _L1)
           + t * (_series(t, _L2) + t * _series(t, _L3)))) * 1e-8
    lat = (_series(t, _B0) + t * _series(t, _B1)) * 1e-8
    rad = (_series(t, _R0) + t * (_series(t, _R1)
           + t * (_series(t, _R2) + t * _series(t, _R3)))) * 1e-8
    return np.mod(lon, 2 * np.pi), lat, rad


# -- Standish mean Keplerian elements (valid 1800-2050) ----------------------
# (a AU, e, i deg, L deg, varpi deg, Omega deg) + per-Julian-century rates;
# reciprocal masses in solar units.  Used only for the Sun->SSB offset, so
# arcminute-level element accuracy keeps the delay error < 1 ms.

_PLANETS = {
    # name: (elements, rates, 1/mass)
    "mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350,
                 77.45779628, 48.33076593),
                (0.00000037, 0.00001906, -0.00594749, 149472.67411175,
                 0.16047689, -0.12534081), 6023600.0),
    "venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950,
               131.60246718, 76.67984255),
              (0.00000390, -0.00004107, -0.00078890, 58517.81538729,
               0.00268329, -0.27769418), 408523.71),
    "emb": ((1.00000261, 0.01671123, -0.00001531, 100.46457166,
             102.93768193, 0.0),
            (0.00000562, -0.00004392, -0.01294668, 35999.37244981,
             0.32327364, 0.0), 328900.56),
    "mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205,
              -23.94362959, 49.55953891),
             (0.00001847, 0.00007882, -0.00813131, 19140.30268499,
              0.44441088, -0.29257343), 3098708.0),
    "jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051,
                 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775,
                 0.21252668, 0.20469106), 1047.3486),
    "saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423,
                92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201,
                -0.41897216, -0.28867794), 3497.898),
    "uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451,
                170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785,
                0.40805281, 0.04240589), 22902.98),
    "neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969,
                 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325,
                 -0.32241464, -0.06124287), 19412.24),
}


def solve_kepler(M, e, iters=12):
    """Vectorized Newton solve of E - e*sin(E) = M (radians)."""
    M = np.asarray(M, np.float64)
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _planet_heliocentric(name, mjd_tdb):
    """Heliocentric position (AU) of a planet in the J2000 ecliptic frame."""
    el, rate, _ = _PLANETS[name]
    T = (np.asarray(mjd_tdb, np.float64) - _MJD_J2000) / 36525.0
    a = el[0] + rate[0] * T
    e = el[1] + rate[1] * T
    inc = (el[2] + rate[2] * T) * _DEG
    L = (el[3] + rate[3] * T) * _DEG
    varpi = (el[4] + rate[4] * T) * _DEG
    Om = (el[5] + rate[5] * T) * _DEG
    M = np.mod(L - varpi + np.pi, 2 * np.pi) - np.pi
    w = varpi - Om
    E = solve_kepler(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1.0 - e * e) * np.sin(E)
    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(Om), np.sin(Om)
    ci, si = np.cos(inc), np.sin(inc)
    x = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    y = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return np.stack([x, y, z], axis=-1)


def sun_ssb_offset(mjd_tdb):
    """Position of the Sun relative to the solar-system barycenter (AU,
    J2000 ecliptic frame): r_sun = -sum(m_p * r_p) / (M_sun + sum m_p)."""
    mjd = np.asarray(mjd_tdb, np.float64)
    num = np.zeros(mjd.shape + (3,))
    mtot = 1.0
    for name, (_, _, rmass) in _PLANETS.items():
        m = 1.0 / rmass
        num += m * _planet_heliocentric(name, mjd)
        mtot += m
    return -num / mtot


# -- frames ------------------------------------------------------------------

def _ecl_to_equ(v, eps=_EPS0):
    """Rotate ecliptic -> equatorial about the x-axis by obliquity eps."""
    v = np.asarray(v, np.float64)
    ce, se = np.cos(eps), np.sin(eps)
    return np.stack([v[..., 0],
                     ce * v[..., 1] - se * v[..., 2],
                     se * v[..., 1] + ce * v[..., 2]], axis=-1)


def _precession_lon(mjd_tdb):
    """Accumulated general precession in ecliptic longitude since J2000
    (radians); used to refer of-date VSOP longitudes to J2000."""
    T = (np.asarray(mjd_tdb, np.float64) - _MJD_J2000) / 36525.0
    return (5029.0966 * T + 1.11113 * T * T) / 3600.0 * _DEG


def _precession_matrix(mjd_tdb):
    """IAU-1976 precession matrix taking J2000 equatorial vectors to the
    mean equator/equinox of date."""
    T = (np.asarray(mjd_tdb, np.float64) - _MJD_J2000) / 36525.0
    arc = _DEG / 3600.0
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * arc
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * arc
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * arc

    cz, sz = np.cos(zeta), np.sin(zeta)
    cZ, sZ = np.cos(z), np.sin(z)
    ct, st = np.cos(theta), np.sin(theta)
    # P = Rz(-z) Ry(theta) Rz(-zeta)
    P = np.empty(np.shape(T) + (3, 3))
    P[..., 0, 0] = cZ * ct * cz - sZ * sz
    P[..., 0, 1] = -cZ * ct * sz - sZ * cz
    P[..., 0, 2] = -cZ * st
    P[..., 1, 0] = sZ * ct * cz + cZ * sz
    P[..., 1, 1] = -sZ * ct * sz + cZ * cz
    P[..., 1, 2] = -sZ * st
    P[..., 2, 0] = st * cz
    P[..., 2, 1] = -st * sz
    P[..., 2, 2] = ct
    return P


def _gmst_rad(mjd_ut):
    """Greenwich Mean Sidereal Time (radians); UTC stands in for UT1
    (|UT1-UTC| < 0.9 s -> < 2 us of geocentric-offset delay error)."""
    d = np.asarray(mjd_ut, np.float64) - 51544.5
    T = d / 36525.0
    gmst_deg = (280.46061837 + 360.98564736629 * d
                + 0.000387933 * T * T - T**3 / 38710000.0)
    return np.mod(gmst_deg, 360.0) * _DEG


# -- optional JPL ephemeris (SPK kernel) -------------------------------------

_EPHEM_KERNEL = None   # loaded SPKKernel, or False = explicitly disabled
_EPHEM_SOURCE = None   # path it was loaded from (for provenance)


def _same_source(a, b):
    """Whether two source strings name the same kernel FILE — relative
    vs absolute spellings of one path must neither re-read the kernel
    nor fire a replacement warning.  The stored ``_EPHEM_SOURCE`` keeps
    the caller's raw spelling (provenance, spawn-worker state)."""
    if a is None or b is None:
        return a == b
    import os as _os

    return (_os.path.realpath(_os.path.abspath(a))
            == _os.path.realpath(_os.path.abspath(b)))


class EphemerisChangeWarning(UserWarning):
    """A different SPK kernel replaced the one already active.

    The ephemeris switch is process-global (barycentering has no
    per-instance state): flipping it while another Simulation's kernel
    is active silently changes THAT instance's barycentering for every
    polyco built before it re-applies its own.  Resetting
    to the analytic model (``set_ephemeris(None)``) is the sanctioned
    cleanup and does not warn."""


def set_ephemeris(path, warn=True):
    """Use a JPL SPK kernel (e.g. ``de440s.bsp``) for Earth/Sun
    barycentric positions instead of the built-in analytic series.

    Pass ``None`` to return to the analytic model.  Equivalent to
    setting ``PSS_EPHEM=<path>`` before first use.  Absolute Roemer
    delays then carry JPL-ephemeris accuracy, matching what the
    reference gets from PINT (psrsigsim/io/psrfits.py:144-177).

    The switch is process-global: replacing a DIFFERENT active kernel
    emits :class:`EphemerisChangeWarning`, because any object configured
    against the old kernel now barycenters on the new one until it
    re-applies its own.  ``warn=False`` is for exactly those sanctioned
    re-applications (``Simulation``/the bulk exporter restoring their
    own stamped kernel) — a correct program interleaving two instances
    must not trip ``-W error`` while repairing the switch.
    """
    global _EPHEM_KERNEL, _EPHEM_SOURCE
    if path is None:
        _EPHEM_KERNEL, _EPHEM_SOURCE = False, None
        return None
    new_source = str(path)
    if _EPHEM_KERNEL not in (None, False) and _same_source(_EPHEM_SOURCE,
                                                           new_source):
        # idempotent re-application (Simulation re-applies at every
        # polyco-producing entry point): skip the kernel re-read/re-parse
        return _EPHEM_KERNEL
    # reaching here with an active kernel means the source DIFFERS (the
    # idempotent branch above returned otherwise), so this is the
    # replacement case — but warn only AFTER the new kernel loads: a bad
    # path must fail with the old kernel still active and no false
    # "replaced" message in the log
    replacing = (warn
                 and _EPHEM_KERNEL not in (None, False)
                 and _EPHEM_SOURCE is not None)
    old_source = _EPHEM_SOURCE
    from .spk import SPKKernel

    kernel = SPKKernel(path)
    if replacing:
        import warnings

        warnings.warn(
            f"set_ephemeris({new_source!r}) replaces the active kernel "
            f"{old_source!r}; the switch is process-global, so anything "
            "configured against the old kernel now barycenters on the new "
            "one until it re-applies its own",
            EphemerisChangeWarning, stacklevel=2)
    _EPHEM_KERNEL = kernel
    _EPHEM_SOURCE = new_source
    return _EPHEM_KERNEL


def ephemeris_name():
    """Provenance string for written headers: the loaded kernel's file
    name, or the analytic model's tag."""
    if _active_kernel() is not None:
        import os as _os

        return _os.path.splitext(_os.path.basename(_EPHEM_SOURCE))[0].upper()
    return "ANALYTIC-VSOP87"


def _active_kernel():
    global _EPHEM_KERNEL, _EPHEM_SOURCE
    if _EPHEM_KERNEL is None:
        import os as _os

        path = _os.environ.get("PSS_EPHEM")
        if path:
            from .spk import SPKKernel

            _EPHEM_KERNEL = SPKKernel(path)
            _EPHEM_SOURCE = path
        else:
            _EPHEM_KERNEL = False
    return _EPHEM_KERNEL or None


# -- observatories -----------------------------------------------------------

class UnknownObservatoryError(ValueError):
    """Site code has no ITRF entry; polyco generation must not guess."""


# ITRF geocentric coordinates (meters), standard TEMPO/tempo2 obsys values
# (~10-100 m accuracy -> <0.3 us of geometric delay; irrelevant at this
# error budget).  Only sites with well-published coordinates are baked in;
# anything else arrives via register_observatory / load_tempo_obsys /
# explicit xyz (below) and otherwise fails loudly.
_GBT = (882589.65, -4924872.32, 3943729.348)
_AO = (2390490.0, -5564764.0, 1994727.0)
_VLA = (-1601192.0, -5041981.4, 3554871.4)
_PARKES = (-4554231.5, 2816759.1, -3454036.3)
_JODRELL = (3822626.04, -154105.65, 5086486.04)
_NANCAY = (4324165.81, 165927.11, 4670132.83)
_EFFELSBERG = (4033949.5, 486989.4, 4900430.8)
_WSRT = (3828445.659, 445223.600, 5064921.568)
_GMRT = (1656342.30, 5797947.77, 2073243.16)
_MEERKAT = (5109360.133, 2006852.586, -3238948.127)
_LOFAR = (3826577.462, 461022.624, 5064892.526)
_SRT = (4865182.766, 791922.689, 4035137.174)
_FAST = (-1668557.0, 5506838.0, 2744934.0)
_CHIME = (-2059166.3, -3621302.9, 4814304.1)

OBSERVATORIES = {
    "1": _GBT, "gbt": _GBT, "gb": _GBT,
    "3": _AO, "ao": _AO, "arecibo": _AO,
    "6": _VLA, "vla": _VLA,
    "7": _PARKES, "pks": _PARKES, "parkes": _PARKES,
    "8": _JODRELL, "jb": _JODRELL, "jodrell": _JODRELL,
    "f": _NANCAY, "ncy": _NANCAY, "nancay": _NANCAY, "ncyobs": _NANCAY,
    "g": _EFFELSBERG, "eff": _EFFELSBERG, "effelsberg": _EFFELSBERG,
    "i": _WSRT, "wsrt": _WSRT, "we": _WSRT,
    "r": _GMRT, "gmrt": _GMRT,
    "m": _MEERKAT, "meerkat": _MEERKAT, "mk": _MEERKAT,
    "t": _LOFAR, "lofar": _LOFAR,
    "z": _SRT, "srt": _SRT, "sardinia": _SRT,
    "fast": _FAST,
    "chime": _CHIME,
    "coe": (0.0, 0.0, 0.0), "geocenter": (0.0, 0.0, 0.0),
}

BARYCENTRIC_SITES = frozenset({"@", "0", "bat", "ssb"})

# user-registered sites (register_observatory / load_tempo_obsys) checked
# after the built-in table, never shadowing it
_USER_OBSERVATORIES = {}


def register_observatory(name, xyz_m, *, aliases=()):
    """Register an observatory by ITRF geocentric ``(x, y, z)`` meters.

    The TEMPO-parity escape hatch for the site codes this module does not
    bake in (PINT/TEMPO resolve every obsys.dat entry; reference path:
    psrsigsim/io/psrfits.py:116-181 via PINT).  Names/aliases are
    case-insensitive.  See also :func:`load_tempo_obsys` to ingest a
    whole TEMPO ``obsys.dat``.
    """
    xyz = np.asarray(xyz_m, np.float64).reshape(3)
    if not np.all(np.isfinite(xyz)):
        raise ValueError(f"non-finite ITRF coordinates for {name!r}: {xyz}")
    r = float(np.linalg.norm(xyz))
    if not (0.0 <= r < 7e6):
        raise ValueError(
            f"implausible ITRF radius {r:.0f} m for {name!r} (expected "
            "geocentric meters, < 7000 km)")
    for key in (name, *aliases):
        _USER_OBSERVATORIES[str(key).strip().lower()] = tuple(xyz)


def load_tempo_obsys(path):
    """Ingest a TEMPO ``obsys.dat`` site table.

    Line format (TEMPO convention): three coordinates, an OPTIONAL
    geodetic flag as the 4th field (``1`` = geodetic, blank/``0`` =
    ITRF XYZ meters), then the site name (may contain spaces) and 1-2
    trailing short code fields.  Geodetic coordinates are ``ddmmss.ss``
    latitude, ``ddmmss.ss`` WEST-positive longitude, and elevation in
    meters, converted on a GRS80 ellipsoid.  Registers every parsed site
    (name with spaces joined by ``_``, plus the code fields) via
    :func:`register_observatory`; returns the number of sites loaded.
    Lines that do not parse are skipped — TEMPO's own reader is just as
    forgiving.
    """
    n = 0
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line or line.lstrip().startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            try:
                c1, c2, c3 = (float(parts[0]), float(parts[1]),
                              float(parts[2]))
            except ValueError:
                continue
            rest = parts[3:]
            # the geodetic flag, when present, is the 4th FIELD — never
            # part of the trailing code fields (the GBT line ends in the
            # site number "1", which must not flip it to geodetic)
            geodetic = rest[0] == "1"
            if rest[0] in ("0", "1"):
                rest = rest[1:]
            if not rest:
                continue
            # trailing 1-2 short tokens are TEMPO code fields; the rest
            # is the (possibly multi-word) site name
            aliases = []
            while len(rest) > 1 and len(rest[-1]) <= 3 and len(aliases) < 2:
                aliases.append(rest.pop())
            name = "_".join(rest)
            if geodetic:
                def dms(v):
                    sign = -1.0 if v < 0 else 1.0
                    v = abs(v)
                    d = int(v // 10000)
                    m = int((v - d * 10000) // 100)
                    s = v - d * 10000 - m * 100
                    return sign * (d + m / 60.0 + s / 3600.0)

                lat = np.radians(dms(c1))
                lon = np.radians(-dms(c2))  # TEMPO stores WEST longitude
                elev = c3
                a, finv = 6378137.0, 298.257222101  # GRS80
                e2 = (2.0 - 1.0 / finv) / finv
                N = a / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
                xyz = ((N + elev) * np.cos(lat) * np.cos(lon),
                       (N + elev) * np.cos(lat) * np.sin(lon),
                       (N * (1.0 - e2) + elev) * np.sin(lat))
            else:
                xyz = (c1, c2, c3)
            try:
                register_observatory(name, xyz, aliases=aliases)
                n += 1
            except ValueError:
                continue
    return n


def observatory_itrf(site):
    """ITRF xyz (meters) for a TEMPO site code / name, a registered site,
    or explicit coordinates.

    Explicit forms accepted anywhere a site is (par TZRSITE strings
    excepted — those are codes by format): a 3-sequence ``(x, y, z)`` in
    meters, or a string ``"xyz:X,Y,Z"``.
    """
    if not isinstance(site, str) and np.ndim(site) == 1 and len(site) == 3:
        return np.asarray(site, np.float64)
    key = str(site).strip().lower()
    if key.startswith("xyz:"):
        try:
            return np.asarray([float(v) for v in key[4:].split(",")],
                              np.float64).reshape(3)
        except ValueError:
            raise UnknownObservatoryError(
                f"malformed explicit site {site!r}; expected "
                "'xyz:X,Y,Z' in meters") from None
    try:
        return np.asarray(OBSERVATORIES[key], np.float64)
    except KeyError:
        pass
    try:
        return np.asarray(_USER_OBSERVATORIES[key], np.float64)
    except KeyError:
        raise UnknownObservatoryError(
            f"no ITRF coordinates for site code {site!r}; known codes: "
            f"{sorted(OBSERVATORIES)} plus barycentric "
            f"{sorted(BARYCENTRIC_SITES)}. Register it with "
            f"psrsigsim_torch.io.ephem.register_observatory(name, (x, y, z)) "
            f"or load a TEMPO table via load_tempo_obsys(path), or pass "
            f"'xyz:X,Y,Z'.") from None


def observatory_ssb(mjd_utc, site):
    """Barycentric position of the observatory and of the Sun.

    Args:
        mjd_utc: UTC MJD array.
        site: TEMPO site code (see :data:`OBSERVATORIES`).

    Returns:
        (r_obs, r_sun): observatory and Sun positions relative to the SSB
        in light-seconds, equatorial J2000 frame.
    """
    mjd_utc = np.asarray(mjd_utc, np.float64)
    mjd_tdb = np.asarray(tdb_from_utc(mjd_utc), np.float64)

    kernel = _active_kernel()
    if kernel is not None:
        # JPL-ephemeris path (SPK kernel via PSS_EPHEM / set_ephemeris):
        # positions in km, ICRF/J2000 equatorial — the same data path
        # PINT/TEMPO take, closing the analytic model's few-ms absolute
        # Roemer uncertainty
        from . import spk as _spk

        c_km_s = 299792.458
        et = (mjd_tdb - 51544.5) * 86400.0
        earth_lts = np.asarray(kernel.position(_spk.EARTH, et)) / c_km_s
        sun_lts = np.asarray(kernel.position(_spk.SUN, et)) / c_km_s
    else:
        lon, lat, rad = earth_heliocentric(mjd_tdb)
        lon = lon - _precession_lon(mjd_tdb)  # refer to J2000 equinox
        cb = np.cos(lat)
        earth_ecl = np.stack([rad * cb * np.cos(lon),
                              rad * cb * np.sin(lon),
                              rad * np.sin(lat)], axis=-1)
        sun_ecl = sun_ssb_offset(mjd_tdb)  # already J2000 ecliptic
        earth_lts = _ecl_to_equ(earth_ecl + sun_ecl) * AU_LTS
        sun_lts = _ecl_to_equ(sun_ecl) * AU_LTS

    geo = observatory_itrf(site) / 299792458.0  # light-seconds
    if np.any(geo != 0.0):
        g = _gmst_rad(mjd_utc)
        cg, sg = np.cos(g), np.sin(g)
        obs_date = np.stack([cg * geo[0] - sg * geo[1],
                             sg * geo[0] + cg * geo[1],
                             np.broadcast_to(geo[2], np.shape(g))], axis=-1)
        P = _precession_matrix(mjd_tdb)
        # date -> J2000 is the transpose
        obs_j2000 = np.einsum("...ji,...j->...i", P, obs_date)
    else:
        obs_j2000 = np.zeros(np.shape(mjd_utc) + (3,))

    return earth_lts + obs_j2000, sun_lts
