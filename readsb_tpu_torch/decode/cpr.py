"""Compact Position Reporting (CPR) codecs.

Pure math.  Scalar host versions, used by the tracker's per-message
path; the vectorized device codec is ROADMAP item 9.
Semantics mirror the reference (cpr.c): NL table thresholds, quadrant
selection for surface decode, and the relative-decode half-cell checks.
"""

from __future__ import annotations

import math
from typing import Optional

_NL_BOUNDS = [
    (10.47047130, 59), (14.82817437, 58), (18.18626357, 57), (21.02939493, 56),
    (23.54504487, 55), (25.82924707, 54), (27.93898710, 53), (29.91135686, 52),
    (31.77209708, 51), (33.53993436, 50), (35.22899598, 49), (36.85025108, 48),
    (38.41241892, 47), (39.92256684, 46), (41.38651832, 45), (42.80914012, 44),
    (44.19454951, 43), (45.54626723, 42), (46.86733252, 41), (48.16039128, 40),
    (49.42776439, 39), (50.67150166, 38), (51.89342469, 37), (53.09516153, 36),
    (54.27817472, 35), (55.44378444, 34), (56.59318756, 33), (57.72747354, 32),
    (58.84763776, 31), (59.95459277, 30), (61.04917774, 29), (62.13216659, 28),
    (63.20427479, 27), (64.26616523, 26), (65.31845310, 25), (66.36171008, 24),
    (67.39646774, 23), (68.42322022, 22), (69.44242631, 21), (70.45451075, 20),
    (71.45986473, 19), (72.45884545, 18), (73.45177442, 17), (74.43893416, 16),
    (75.42056257, 15), (76.39684391, 14), (77.36789461, 13), (78.33374083, 12),
    (79.29428225, 11), (80.24923213, 10), (81.19801349, 9), (82.13956981, 8),
    (83.07199445, 7), (83.99173563, 6), (84.89166191, 5), (85.75541621, 4),
    (86.53536998, 3), (87.00000000, 2),
]


def nl(lat: float) -> int:
    """Number of longitude zones at this latitude (cpr.c:79-146)."""
    if lat < 0:
        lat = -lat
    for bound, val in _NL_BOUNDS:
        if lat < bound:
            return val
    return 1


def _n_func(lat: float, fflag: int) -> int:
    n = nl(lat) - (1 if fflag else 0)
    return max(n, 1)


def _dlon(lat: float, fflag: int, surface: bool) -> float:
    return (90.0 if surface else 360.0) / _n_func(lat, fflag)


def _mod(a: int, b: int) -> int:
    res = a % b
    return res + b if res < 0 else res


def _mod_f(a: float, b: float) -> float:
    res = math.fmod(a, b)
    return res + b if res < 0 else res


def decode_airborne(
    even_lat: int, even_lon: int, odd_lat: int, odd_lon: int, fflag: int
) -> Optional[tuple[float, float]]:
    """Global airborne decode; None on zone mismatch / bad data (cpr.c:170)."""
    dlat0 = 360.0 / 60.0
    dlat1 = 360.0 / 59.0

    j = int(math.floor(((59 * even_lat - 60 * odd_lat) / 131072) + 0.5))
    rlat0 = dlat0 * (_mod(j, 60) + even_lat / 131072)
    rlat1 = dlat1 * (_mod(j, 59) + odd_lat / 131072)
    if rlat0 >= 270:
        rlat0 -= 360
    if rlat1 >= 270:
        rlat1 -= 360
    if not (-90 <= rlat0 <= 90) or not (-90 <= rlat1 <= 90):
        return None
    if nl(rlat0) != nl(rlat1):
        return None

    if fflag:
        ni = _n_func(rlat1, 1)
        m = int(math.floor((((even_lon * (nl(rlat1) - 1)) - (odd_lon * nl(rlat1))) / 131072.0) + 0.5))
        rlon = _dlon(rlat1, 1, False) * (_mod(m, ni) + odd_lon / 131072)
        rlat = rlat1
    else:
        ni = _n_func(rlat0, 0)
        m = int(math.floor((((even_lon * (nl(rlat0) - 1)) - (odd_lon * nl(rlat0))) / 131072) + 0.5))
        rlon = _dlon(rlat0, 0, False) * (_mod(m, ni) + even_lon / 131072)
        rlat = rlat0

    rlon -= math.floor((rlon + 180) / 360) * 360
    return rlat, rlon


def decode_surface(
    reflat: float, reflon: float,
    even_lat: int, even_lon: int, odd_lat: int, odd_lon: int, fflag: int,
) -> Optional[tuple[float, float]]:
    """Global surface decode with reference-quadrant selection (cpr.c:223)."""
    dlat0 = 90.0 / 60.0
    dlat1 = 90.0 / 59.0

    j = int(math.floor(((59 * even_lat - 60 * odd_lat) / 131072) + 0.5))
    rlat0 = dlat0 * (_mod(j, 60) + even_lat / 131072)
    rlat1 = dlat1 * (_mod(j, 59) + odd_lat / 131072)

    if rlat0 == 0:
        if reflat < -45:
            rlat0 = -90
        elif reflat > 45:
            rlat0 = 90
    elif (rlat0 - reflat) > 45:
        rlat0 -= 90
    if rlat1 == 0:
        if reflat < -45:
            rlat1 = -90
        elif reflat > 45:
            rlat1 = 90
    elif (rlat1 - reflat) > 45:
        rlat1 -= 90

    if not (-90 <= rlat0 <= 90) or not (-90 <= rlat1 <= 90):
        return None
    if nl(rlat0) != nl(rlat1):
        return None

    if fflag:
        ni = _n_func(rlat1, 1)
        m = int(math.floor((((even_lon * (nl(rlat1) - 1)) - (odd_lon * nl(rlat1))) / 131072.0) + 0.5))
        rlon = _dlon(rlat1, 1, True) * (_mod(m, ni) + odd_lon / 131072)
        rlat = rlat1
    else:
        ni = _n_func(rlat0, 0)
        m = int(math.floor((((even_lon * (nl(rlat0) - 1)) - (odd_lon * nl(rlat0))) / 131072) + 0.5))
        rlon = _dlon(rlat0, 0, True) * (_mod(m, ni) + even_lon / 131072)
        rlat = rlat0

    rlon += math.floor((reflon - rlon + 45) / 90) * 90
    rlon -= math.floor((rlon + 180) / 360) * 360
    return rlat, rlon


def decode_relative(
    reflat: float, reflon: float, cprlat: int, cprlon: int, fflag: int, surface: bool
) -> Optional[tuple[float, float]]:
    """Single-frame decode relative to a known position (cpr.c:331)."""
    frac_lat = cprlat / 131072.0
    frac_lon = cprlon / 131072.0
    dlat = (90.0 if surface else 360.0) / (59.0 if fflag else 60.0)

    j = int(math.floor(reflat / dlat) + math.floor(0.5 + _mod_f(reflat, dlat) / dlat - frac_lat))
    rlat = dlat * (j + frac_lat)
    if rlat >= 270:
        rlat -= 360
    if not (-90 <= rlat <= 90):
        return None
    if abs(rlat - reflat) > dlat / 2:
        return None

    dlon = _dlon(rlat, fflag, surface)
    m = int(math.floor(reflon / dlon) + math.floor(0.5 + _mod_f(reflon, dlon) / dlon - frac_lon))
    rlon = dlon * (m + frac_lon)
    if rlon > 180:
        rlon -= 360
    if abs(rlon - reflon) > dlon / 2:
        return None
    return rlat, rlon


def encode_cpr(lat: float, lon: float, odd: int, surface: bool = False) -> tuple[int, int]:
    """Encode a position into 17-bit CPR lat/lon fields.

    Used to synthesize DF18 from UAT MDBs (the inverse of the decoders
    above; matches uat2esnt.c:217-239 — surface scales by 2^19 and
    truncates to 17 bits, airborne scales by 2^17).
    """
    nb_pow = 1 << 19 if surface else 1 << 17
    dlat = 360.0 / (59 if odd else 60)
    yz = int(math.floor(nb_pow * _mod_f(lat, dlat) / dlat + 0.5))
    rlat = dlat * (yz / nb_pow + math.floor(lat / dlat))
    dlon = 360.0 / _n_func(rlat, odd)
    xz = int(math.floor(nb_pow * _mod_f(lon, dlon) / dlon + 0.5))
    return yz & 0x1FFFF, xz & 0x1FFFF
