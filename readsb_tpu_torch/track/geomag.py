"""World Magnetic Model (WMM2020): magnetic declination.

Used to convert magnetic heading to true heading for the wind/temperature
derivation (reference geomag.c, used at track.c:3166-3217).

Coefficients are the NOAA WMM2020 release (public domain U.S. government
data, epoch 2020.0, degree/order 12).  The evaluation below is a standard
Schmidt semi-normalized spherical-harmonic synthesis written from the WMM
technical report — not a port of the reference's point-calculation code.
"""

from __future__ import annotations

import functools
import math

# (n, m, g, h, gdot, hdot) — WMM2020.COF, epoch 2020.0
WMM2020 = [
    (1, 0, -29404.5, 0.0, 6.7, 0.0), (1, 1, -1450.7, 4652.9, 7.7, -25.1),
    (2, 0, -2500.0, 0.0, -11.5, 0.0), (2, 1, 2982.0, -2991.6, -7.1, -30.2),
    (2, 2, 1676.8, -734.8, -2.2, -23.9), (3, 0, 1363.9, 0.0, 2.8, 0.0),
    (3, 1, -2381.0, -82.2, -6.2, 5.7), (3, 2, 1236.2, 241.8, 3.4, -1.0),
    (3, 3, 525.7, -542.9, -12.2, 1.1), (4, 0, 903.1, 0.0, -1.1, 0.0),
    (4, 1, 809.4, 282.0, -1.6, 0.2), (4, 2, 86.2, -158.4, -6.0, 6.9),
    (4, 3, -309.4, 199.8, 5.4, 3.7), (4, 4, 47.9, -350.1, -5.5, -5.6),
    (5, 0, -234.4, 0.0, -0.3, 0.0), (5, 1, 363.1, 47.7, 0.6, 0.1),
    (5, 2, 187.8, 208.4, -0.7, 2.5), (5, 3, -140.7, -121.3, 0.1, -0.9),
    (5, 4, -151.2, 32.2, 1.2, 3.0), (5, 5, 13.7, 99.1, 1.0, 0.5),
    (6, 0, 65.9, 0.0, -0.6, 0.0), (6, 1, 65.6, -19.1, -0.4, 0.1),
    (6, 2, 73.0, 25.0, 0.5, -1.8), (6, 3, -121.5, 52.7, 1.4, -1.4),
    (6, 4, -36.2, -64.4, -1.4, 0.9), (6, 5, 13.5, 9.0, 0.0, 0.1),
    (6, 6, -64.7, 68.1, 0.8, 1.0), (7, 0, 80.6, 0.0, -0.1, 0.0),
    (7, 1, -76.8, -51.4, -0.3, 0.5), (7, 2, -8.3, -16.8, -0.1, 0.6),
    (7, 3, 56.5, 2.3, 0.7, -0.7), (7, 4, 15.8, 23.5, 0.2, -0.2),
    (7, 5, 6.4, -2.2, -0.5, -1.2), (7, 6, -7.2, -27.2, -0.8, 0.2),
    (7, 7, 9.8, -1.9, 1.0, 0.3), (8, 0, 23.6, 0.0, -0.1, 0.0),
    (8, 1, 9.8, 8.4, 0.1, -0.3), (8, 2, -17.5, -15.3, -0.1, 0.7),
    (8, 3, -0.4, 12.8, 0.5, -0.2), (8, 4, -21.1, -11.8, -0.1, 0.5),
    (8, 5, 15.3, 14.9, 0.4, -0.3), (8, 6, 13.7, 3.6, 0.5, -0.5),
    (8, 7, -16.5, -6.9, 0.0, 0.4), (8, 8, -0.3, 2.8, 0.4, 0.1),
    (9, 0, 5.0, 0.0, -0.1, 0.0), (9, 1, 8.2, -23.3, -0.2, -0.3),
    (9, 2, 2.9, 11.1, 0.0, 0.2), (9, 3, -1.4, 9.8, 0.4, -0.4),
    (9, 4, -1.1, -5.1, -0.3, 0.4), (9, 5, -13.3, -6.2, 0.0, 0.1),
    (9, 6, 1.1, 7.8, 0.3, 0.0), (9, 7, 8.9, 0.4, 0.0, -0.2),
    (9, 8, -9.3, -1.5, 0.0, 0.5), (9, 9, -11.9, 9.7, -0.4, 0.2),
    (10, 0, -1.9, 0.0, 0.0, 0.0), (10, 1, -6.2, 3.4, 0.0, 0.0),
    (10, 2, -0.1, -0.2, 0.0, 0.1), (10, 3, 1.7, 3.5, 0.2, -0.3),
    (10, 4, -0.9, 4.8, -0.1, 0.1), (10, 5, 0.6, -8.6, -0.2, -0.2),
    (10, 6, -0.9, -0.1, 0.0, 0.1), (10, 7, 1.9, -4.2, -0.1, 0.0),
    (10, 8, 1.4, -3.4, -0.2, -0.1), (10, 9, -2.4, -0.1, -0.1, 0.2),
    (10, 10, -3.9, -8.8, 0.0, 0.0), (11, 0, 3.0, 0.0, 0.0, 0.0),
    (11, 1, -1.4, 0.0, -0.1, 0.0), (11, 2, -2.5, 2.6, 0.0, 0.1),
    (11, 3, 2.4, -0.5, 0.0, 0.0), (11, 4, -0.9, -0.4, 0.0, 0.2),
    (11, 5, 0.3, 0.6, -0.1, 0.0), (11, 6, -0.7, -0.2, 0.0, 0.0),
    (11, 7, -0.1, -1.7, 0.0, 0.1), (11, 8, 1.4, -1.6, -0.1, 0.0),
    (11, 9, -0.6, -3.0, -0.1, -0.1), (11, 10, 0.2, -2.0, -0.1, 0.0),
    (11, 11, 3.1, -2.6, -0.1, 0.0), (12, 0, -2.0, 0.0, 0.0, 0.0),
    (12, 1, -0.1, -1.2, 0.0, 0.0), (12, 2, 0.5, 0.5, 0.0, 0.0),
    (12, 3, 1.3, 1.3, 0.0, -0.1), (12, 4, -1.2, -1.8, 0.0, 0.1),
    (12, 5, 0.7, 0.1, 0.0, 0.0), (12, 6, 0.3, 0.7, 0.0, 0.0),
    (12, 7, 0.5, -0.1, 0.0, 0.0), (12, 8, -0.2, 0.6, 0.0, 0.1),
    (12, 9, -0.5, 0.2, 0.0, 0.0), (12, 10, 0.1, -0.9, 0.0, 0.0),
    (12, 11, -1.1, 0.0, 0.0, 0.0), (12, 12, -0.3, 0.5, -0.1, -0.1),
]

EPOCH = 2020.0
MAXDEG = 12
A_WGS84 = 6378.137  # km
B_WGS84 = 6356.7523142
RE = 6371.2  # geomagnetic reference radius, km


@functools.lru_cache(maxsize=None)
def _schmidt_norm():
    """Schmidt semi-normalization factors snorm[n][m]."""
    s = [[0.0] * (MAXDEG + 1) for _ in range(MAXDEG + 1)]
    s[0][0] = 1.0
    for n in range(1, MAXDEG + 1):
        s[n][0] = s[n - 1][0] * (2 * n - 1) / n
        for m in range(1, n + 1):
            s[n][m] = s[n][m - 1] * math.sqrt(
                (n - m + 1) * (2 if m == 1 else 1) / (n + m)
            )
    return s


@functools.lru_cache(maxsize=None)
def _coeff_grid(year: float):
    dt = year - EPOCH
    g = [[0.0] * (MAXDEG + 1) for _ in range(MAXDEG + 1)]
    h = [[0.0] * (MAXDEG + 1) for _ in range(MAXDEG + 1)]
    s = _schmidt_norm()
    for n, m, gg, hh, gd, hd in WMM2020:
        g[n][m] = (gg + dt * gd) * s[n][m]
        h[n][m] = (hh + dt * hd) * s[n][m]
    return g, h


def field(lat_deg: float, lon_deg: float, alt_km: float = 0.0, year: float = 2025.0):
    """(north, east, down) field components in nT at geodetic position."""
    g, h = _coeff_grid(round(year * 4) / 4)  # cache-friendly quarter-years
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)

    # geodetic -> geocentric (spherical) conversion
    slat, clat = math.sin(lat), math.cos(lat)
    a2, b2 = A_WGS84**2, B_WGS84**2
    rho2 = a2 * clat * clat + b2 * slat * slat
    rho = math.sqrt(rho2)
    r = math.sqrt(alt_km * (alt_km + 2 * rho) + (a2 * a2 * clat * clat + b2 * b2 * slat * slat) / rho2)
    cd = (alt_km + rho) / r
    sd = (a2 - b2) / rho * slat * clat / r
    slat_c = slat * cd - clat * sd
    clat_c = clat * cd + slat * sd

    theta = math.acos(max(-1.0, min(1.0, slat_c)))  # geocentric colatitude
    ct, st = math.cos(theta), math.sin(theta)
    st = max(st, 1e-10)

    # associated Legendre (Schmidt semi-normalized via precomputed factors)
    p = [[0.0] * (MAXDEG + 2) for _ in range(MAXDEG + 2)]
    dp = [[0.0] * (MAXDEG + 2) for _ in range(MAXDEG + 2)]
    p[0][0] = 1.0
    dp[0][0] = 0.0
    for n in range(1, MAXDEG + 1):
        for m in range(0, n + 1):
            if n == m:
                p[n][m] = st * p[n - 1][m - 1]
                dp[n][m] = st * dp[n - 1][m - 1] + ct * p[n - 1][m - 1]
            elif n == 1 or m == n - 1:
                p[n][m] = ct * p[n - 1][m]
                dp[n][m] = ct * dp[n - 1][m] - st * p[n - 1][m]
            else:
                k = ((n - 1) ** 2 - m * m) / ((2 * n - 1) * (2 * n - 3))
                p[n][m] = ct * p[n - 1][m] - k * p[n - 2][m]
                dp[n][m] = ct * dp[n - 1][m] - st * p[n - 1][m] - k * dp[n - 2][m]

    # note: this recursion generates *un-normalized* P with the K-recursion
    # of the WMM report; the Schmidt factors are folded into g/h above.
    cosm = [math.cos(m * lon) for m in range(MAXDEG + 1)]
    sinm = [math.sin(m * lon) for m in range(MAXDEG + 1)]

    # X = (1/r) dV/dtheta (north), Y = (1/(r sin)) dV/dphi (east),
    # Z = (n+1)(RE/r)^{n+2} sum (down);  B = -grad V conventions of the
    # WMM report resolve to these signs.
    bn = be = bd = 0.0
    ar = RE / r
    arpow = ar * ar
    for n in range(1, MAXDEG + 1):
        arpow *= ar
        for m in range(0, n + 1):
            gc, hc = g[n][m], h[n][m]
            tcos, tsin = cosm[m], sinm[m]
            bn += arpow * (gc * tcos + hc * tsin) * dp[n][m]
            be += arpow * m * (gc * tsin - hc * tcos) * p[n][m] / st
            bd += -arpow * (n + 1) * (gc * tcos + hc * tsin) * p[n][m]

    # rotate from geocentric spherical to the geodetic frame
    north = bn * cd - bd * sd
    down = bn * sd + bd * cd
    return north, be, down


def declination(lat_deg: float, lon_deg: float, alt_km: float = 0.0, year: float = 2025.0) -> float:
    """Magnetic declination in degrees east of true north."""
    north, east, down = field(lat_deg, lon_deg, alt_km, year)
    return math.degrees(math.atan2(east, north))
