"""Device CPR decode in exact int32, all three modes: global airborne
(cpr.c:170-221), global surface with reference-quadrant selection
(cpr.c:223-319), and relative (cpr.c:331-386).

The hard part of a CPR decode -- latitude index resolution, NL zone
lookup, zone agreement, longitude index -- is exact integer lattice math
once reformulated:

  X  = 59*elat - 60*olat                   (|X| < 2^23, int32)
  j  = floor(X/131072 + 1/2) = (2X + 131072) >> 18   (arith shift floors)
  rlat0 = 6*K0/131072        with K0 = 131072*(j mod 60) + elat
  rlat1 = 45*K1/(59*16384)   with K1 = 131072*(j mod 59) + olat
  (both numerators < 2^29: every compare below is exact in int32)

The >=270 wrap, the [-90, 90] range check and the NL table lookup become
integer threshold compares: bound b on rlat0 maps to K0 < ceil(b*131072/6),
on rlat1 to K1 < ceil(b*59*16384/45) -- precomputed per denominator.
The longitude index m = floor((elon*(nl-1) - olon*nl)/131072 + 1/2) is
the same shift trick.

The cores return the integer DECISIONS (ok, nl, ni, j, m) as torch
tensors on the device of their inputs; converting to degrees is a
two-multiply f64 map the host applies to numpy arrays with the
reference's exact expressions (so the float results are bit-identical
with the scalar chain).  At exact cell boundaries (measure-zero inputs
where rlat lands on 270 or an NL bound) the exact integer compare can
disagree with the reference's double-rounded f64 compare; real CPR
traffic never sits on these boundaries.

readsb_tpu's ops/cpr_device.py in torch: the cores are torch ops on an
explicit device (the device of their inputs; the constant tables are
placed there), and the constant builders and the f64 maps are copied.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..decode.cpr import _NL_BOUNDS

_Q0 = 131072  # rlat0 denominator scale (per 6 deg)
_WRAP0 = 60 * 131072  # 360 deg in K0 units
_HI0 = 45 * 131072  # 270 deg in K0 units
_R0 = 15 * 131072  # 90 deg in K0 units
_WRAP1 = 59 * 131072  # 360 deg in K1 units
_HI1 = 59 * 131072 * 3 // 4  # 270 deg (exact: divisible by 4)
_R1 = 59 * 131072 // 4  # 90 deg (exact)


@functools.lru_cache(maxsize=None)
def _nl_thresholds() -> tuple[np.ndarray, np.ndarray]:
    """Integer NL thresholds for the K0 and K1 numerators.

    nl(lat) = 59 - #{i : |lat| >= bound_i}; |rlat0| < b <=> |K0| < b*131072/6
    and |rlat1| < b <=> |K1|*45 < b*59*16384.  ceil() in f64 is exact to
    well under one integer step at these magnitudes.
    """
    import math

    b = np.array([bound for bound, _ in _NL_BOUNDS])
    t0 = np.array([math.ceil(x * 131072 / 6) for x in b], np.int32)
    t1 = np.array([math.ceil(x * 59 * 16384 / 45) for x in b], np.int32)
    return t0, t1


def _mod(a, b):
    r = a % b
    return torch.where(r < 0, r + b, r)


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """A constant table of this module as an int32 tensor on `device`."""
    if name == "t":
        return torch.from_numpy(np.stack(_nl_thresholds())).to(device)
    if name == "s":
        return torch.from_numpy(np.stack(_nl_thresholds_surface())).to(device)
    return torch.from_numpy(_relative_mode_consts()[name]).to(device)


def _nl(a: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """59 - #{bounds <= a}: the NL zone of integer latitude numerators."""
    return 59 - (a[..., None] >= thresholds).sum(-1, dtype=torch.int32)


def _lon_index(elon, olon, nl0, nl1, f):
    """The longitude half shared by both global cores."""
    nlv = torch.where(f != 0, nl1, nl0)
    ni = torch.clamp(nlv - f, min=1)
    mnum = elon * (nlv - 1) - olon * nlv
    m = (2 * mnum + _Q0) >> 18
    return nlv, ni, _mod(m, ni)


def _i32(*xs):
    return [x.to(torch.int32) for x in xs]


def decode_airborne_core(elat, elon, olat, olon, fflag):
    """Exact-int airborne global CPR core (cpr.c:170-221).

    Inputs: integer tensors on one device (17-bit CPR values; fflag
    bool/int).  Returns a dict of int32 tensors on that device: ok (bool),
    j (zone index), nl, ni, m (longitude index), k_lat.  Degrees come from
    the host map `airborne_latlon_f64` below.  The device arena calls it
    inside its update rounds.
    """
    elat, olat, elon, olon, f = _i32(elat, olat, elon, olon, fflag)

    x = 59 * elat - 60 * olat
    j = (2 * x + _Q0) >> 18
    k0 = _Q0 * _mod(j, 60) + elat
    k1 = _Q0 * _mod(j, 59) + olat
    k0 = torch.where(k0 >= _HI0, k0 - _WRAP0, k0)
    k1 = torch.where(k1 >= _HI1, k1 - _WRAP1, k1)
    ok = (k0.abs() <= _R0) & (k1.abs() <= _R1)

    t = _table("t", k0.device)
    nl0 = _nl(k0.abs(), t[0])
    nl1 = _nl(k1.abs(), t[1])
    ok &= nl0 == nl1

    nlv, ni, mm = _lon_index(elon, olon, nl0, nl1, f)
    return {
        "ok": ok,
        "j": j,
        "nl": nlv,
        "ni": ni,
        "m": mm,
        "k_lat": torch.where(f != 0, k1, k0),
    }


def airborne_latlon_f64(dev: dict, elat, elon, olat, olon, fflag):
    """Host f64 map from the device's integer decisions to degrees,
    using the reference's exact float expressions (cpr.c:183-218) so the
    results are bit-identical with decode_airborne/decode_airborne_vec.
    Inputs/outputs numpy: pass the cores' outputs as `.cpu().numpy()`."""
    j = np.asarray(dev["j"]).astype(np.int64)
    ni = np.asarray(dev["ni"]).astype(np.int64)
    nlv = np.asarray(dev["nl"]).astype(np.int64)
    mm = np.asarray(dev["m"]).astype(np.int64)
    f = np.asarray(fflag).astype(bool)
    elat = np.asarray(elat, np.float64)
    olat = np.asarray(olat, np.float64)
    elon = np.asarray(elon, np.float64)
    olon = np.asarray(olon, np.float64)

    dlat0 = 360.0 / 60.0
    dlat1 = 360.0 / 59.0
    rlat0 = dlat0 * (np.mod(j, 60) + elat / 131072)
    rlat1 = dlat1 * (np.mod(j, 59) + olat / 131072)
    rlat0 = np.where(rlat0 >= 270, rlat0 - 360, rlat0)
    rlat1 = np.where(rlat1 >= 270, rlat1 - 360, rlat1)
    rlat = np.where(f, rlat1, rlat0)

    dlon = 360.0 / ni
    rlon = dlon * (mm + np.where(f, olon, elon) / 131072)
    rlon -= np.floor((rlon + 180) / 360) * 360
    return rlat, rlon


# ---------------------------------------------------------------------------
# Surface global decode (cpr.c:223-319): same integer lattice at the 90-deg
# scale, plus the reference-quadrant selection.  The quadrant compares
# against reflat become host-precomputed integer thresholds (reflat is a
# runtime scalar); the reflon longitude-quadrant shift is part of the host
# f64 output map, exactly as the reference computes it.
# ---------------------------------------------------------------------------

_S_WRAP0 = 60 * 131072  # 90 deg in K0 units at the surface scale
_S_WRAP1 = 59 * 131072


@functools.lru_cache(maxsize=None)
def _nl_thresholds_surface() -> tuple[np.ndarray, np.ndarray]:
    """Integer NL thresholds for the surface-scale numerators.

    rlat0 = 1.5*K0/131072: |rlat0| >= b <=> |K0| >= ceil(b*262144/3)
    rlat1 = (90/59)*K1/131072: |rlat1| >= b <=> |K1| >= ceil(b*59*131072/90)
    (integer numerators, so >= against the ceil'd threshold is exact up to
    the f64 rounding of the threshold itself — measure-zero, as airborne).
    """
    import math

    b = np.array([bound for bound, _ in _NL_BOUNDS])
    t0 = np.array([math.ceil(x * 262144 / 3) for x in b], np.int64)
    t1 = np.array([math.ceil(x * 59 * 131072 / 90) for x in b], np.int64)
    return t0.astype(np.int32), t1.astype(np.int32)


def surface_quadrant_consts(reflat: float) -> dict:
    """Host-side integer thresholds for the quadrant selection at a given
    reference latitude (runtime scalar): pass to decode_surface_core."""
    import math

    return {
        "zneg": int(reflat < -45.0),
        "zpos": int(reflat > 45.0),
        # (rl0 - reflat) > 45 <=> 3*K0 > (45+reflat)*262144
        "t0": int(math.floor((45.0 + reflat) * 262144.0)),
        # (rl1 - reflat) > 45 <=> 45*K1 > (45+reflat)*59*65536 (scaled /2)
        "t1": int(math.floor((45.0 + reflat) * 59.0 * 65536.0)),
    }


def decode_surface_core(elat, elon, olat, olon, fflag, zneg, zpos, t0, t1):
    """Exact-int surface global CPR core (cpr.c:223-319).

    zneg/zpos/t0/t1: the surface_quadrant_consts values (Python ints).
    Returns the same decision dict as the airborne core; the degrees come
    from `surface_latlon_f64`."""
    elat, olat, elon, olon, f = _i32(elat, olat, elon, olon, fflag)

    x = 59 * elat - 60 * olat
    j = (2 * x + _Q0) >> 18
    k0 = _Q0 * _mod(j, 60) + elat
    k1 = _Q0 * _mod(j, 59) + olat

    # quadrant selection (quad(), cpr.c:239-258): zero latitude snaps to
    # the reference's hemisphere pole-side; otherwise a result more than
    # 45 deg north of the reference shifts one 90-deg quadrant south
    def quad(k, wrap, t, tscale_k):
        zero = k == 0
        if zneg:
            k = torch.where(zero, -wrap, k)
        if zpos:
            k = torch.where(zero, wrap, k)
        shift = (~zero) & (tscale_k > t)
        return torch.where(shift, k - wrap, k)

    k0 = quad(k0, _S_WRAP0, t0, 3 * k0)
    k1 = quad(k1, _S_WRAP1, t1, 45 * k1)
    ok = (k0.abs() <= _S_WRAP0) & (k1.abs() <= _S_WRAP1)

    s = _table("s", k0.device)
    nl0 = _nl(k0.abs(), s[0])
    nl1 = _nl(k1.abs(), s[1])
    ok &= nl0 == nl1

    nlv, ni, mm = _lon_index(elon, olon, nl0, nl1, f)
    return {"ok": ok, "j": j, "nl": nlv, "ni": ni, "m": mm}


def surface_latlon_f64(dev, reflat, reflon, elat, elon, olat, olon, fflag):
    """Host f64 map for the surface decisions, using the reference's exact
    float expressions incl. the zero/45-deg quadrant rules and the
    longitude reference-quadrant shift (cpr.c:239-317)."""
    j = np.asarray(dev["j"]).astype(np.int64)
    ni = np.asarray(dev["ni"]).astype(np.int64)
    mm = np.asarray(dev["m"]).astype(np.int64)
    f = np.asarray(fflag).astype(bool)
    elat = np.asarray(elat, np.float64)
    olat = np.asarray(olat, np.float64)
    elon = np.asarray(elon, np.float64)
    olon = np.asarray(olon, np.float64)

    dlat0 = 90.0 / 60.0
    dlat1 = 90.0 / 59.0
    rlat0 = dlat0 * (np.mod(j, 60) + elat / 131072)
    rlat1 = dlat1 * (np.mod(j, 59) + olat / 131072)

    def quad(rl):
        zero = rl == 0
        rl = np.where(zero & (reflat < -45), -90.0, rl)
        rl = np.where(zero & (reflat > 45), 90.0, rl)
        rl = np.where(~zero & ((rl - reflat) > 45), rl - 90, rl)
        return rl

    rlat = np.where(f, quad(rlat1), quad(rlat0))
    dlon = 90.0 / ni
    rlon = dlon * (mm + np.where(f, olon, elon) / 131072)
    rlon += np.floor((reflon - rlon + 45) / 90) * 90
    rlon -= np.floor((rlon + 180) / 360) * 360
    return rlat, rlon


# ---------------------------------------------------------------------------
# Relative decode (cpr.c:331-386): single-frame decode against a known
# reference position.  The zone index j = floor(ref/dzone) + floor(0.5 +
# mod(ref,dzone)/dzone - cpr/131072) splits into a host integer J0 plus a
# device floor-divide once the host folds the reference fraction into
# B = floor(131072*(1 + 2*mod(ref,dzone)/dzone)):
#     floor(0.5 + A - c/131072) = floor((B - 2c)/262144)
# (exact because the numerator's fractional part can never push an
# integer quotient over a boundary).  The longitude zone width depends on
# the decoded NL, so the host consts become ni-indexed tables (ni<=59)
# the device gathers from.  All four (surface, fflag) latitude scales
# reuse the NL threshold tables above.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _relative_mode_consts() -> dict:
    """reflat-independent per-(surface, fflag) integer constants:
    270/360/90 degrees in K units (K = 131072*j + cpr, rlat = dlat*K/131072)
    and the stacked NL threshold tables."""
    t0, t1 = _nl_thresholds()
    s0, s1 = _nl_thresholds_surface()
    nlt = np.stack(
        [np.stack([t0, t1]), np.stack([s0, s1])]
    ).astype(np.int32)  # [surface, fflag, 59]
    # dlat = (90 if s else 360)/(59 if f else 60); X deg <=> X/dlat*131072
    hi270 = np.array(
        [[45 * 131072, 59 * 131072 * 3 // 4], [180 * 131072, 3 * 59 * 131072]],
        np.int32,
    )
    wrap360 = np.array(
        [[60 * 131072, 59 * 131072], [240 * 131072, 4 * 59 * 131072]],
        np.int32,
    )
    r90 = np.array(
        [[15 * 131072, 59 * 131072 // 4], [60 * 131072, 59 * 131072]],
        np.int32,
    )
    return {"nlt": nlt, "hi270": hi270, "wrap360": wrap360, "r90": r90}


def relative_consts(reflat: float, reflon: float) -> dict:
    """Host-side reference-position tables for decode_relative_core.

    Latitude: per (surface, fflag).  Longitude: per (surface, ni) with
    ni in 1..59 (index 0 unused).  j0/b encode the zone-index split, and
    thi/tlo the |r - ref| > dzone/2 rejection (2K > floor(thi) or
    2K < ceil(tlo), exact against integer 2K)."""
    import math

    def fmodp(a, b):
        r = math.fmod(a, b)
        return r + b if r < 0 else r

    def tables(ref, dzones):
        j0 = np.zeros(dzones.shape, np.int32)
        b = np.zeros(dzones.shape, np.int32)
        thi = np.zeros(dzones.shape, np.int32)
        tlo = np.zeros(dzones.shape, np.int32)
        for idx in np.ndindex(dzones.shape):
            d = float(dzones[idx])
            j0[idx] = math.floor(ref / d)
            b[idx] = math.floor(131072.0 * (1.0 + 2.0 * fmodp(ref, d) / d))
            thi[idx] = math.floor(131072.0 * (2.0 * ref / d + 1.0))
            tlo[idx] = math.ceil(131072.0 * (2.0 * ref / d - 1.0))
        return j0, b, thi, tlo

    dlat = np.array([[6.0, 360.0 / 59.0], [1.5, 90.0 / 59.0]])
    j0lat, blat, thilat, tlolat = tables(reflat, dlat)

    ni = np.arange(60, dtype=np.float64)
    ni[0] = 1.0  # unused slot
    dlon = np.stack([360.0 / ni, 90.0 / ni])  # [surface, ni]
    j0lon, blon, thilon, tlolon = tables(reflon, dlon)
    return {
        "j0lat": j0lat, "blat": blat, "thilat": thilat, "tlolat": tlolat,
        "j0lon": j0lon, "blon": blon, "thilon": thilon, "tlolon": tlolon,
    }


def decode_relative_core(clat, clon, fflag, surface, c: dict):
    """Exact-int relative CPR core (cpr.c:331-386).

    clat/clon 17-bit CPR fields; fflag/surface int per row; c the
    relative_consts dict as int32 tensors on the inputs' device
    (`relative_consts_on`).  Returns ok, j, ni, m -- degrees come from
    `relative_latlon_f64` (which replays the reference's f64 expressions
    incl. the 270/180-degree wraps)."""
    clat, clon, f, s = _i32(clat, clon, fflag, surface)
    fl, sl = f.long(), s.long()

    def sel(tab):
        return tab[sl, fl]

    j = sel(c["j0lat"]) + torch.div(sel(c["blat"]) - 2 * clat, 262144, rounding_mode="floor")
    k = 131072 * j + clat
    kw = torch.where(k >= sel(_table("hi270", k.device)), k - sel(_table("wrap360", k.device)), k)
    ok = kw.abs() <= sel(_table("r90", k.device))
    ok &= (2 * kw <= sel(c["thilat"])) & (2 * kw >= sel(c["tlolat"]))

    nlv = _nl(kw.abs(), _table("nlt", k.device)[sl, fl])  # (rows, 59) thresholds
    ni = torch.clamp(nlv - f, min=1)
    nil = ni.long()

    def sel_ni(tab):
        return tab[sl, nil]

    m = sel_ni(c["j0lon"]) + torch.div(sel_ni(c["blon"]) - 2 * clon, 262144, rounding_mode="floor")
    kl = 131072 * m + clon
    # rlon > 180 <=> KL > 180*ni*131072/(90 or 360); wrap by 360 in KL units
    wr_hi = torch.where(s != 0, 262144 * ni, 65536 * ni)
    wr_360 = torch.where(s != 0, 524288 * ni, 131072 * ni)
    klw = torch.where(kl > wr_hi, kl - wr_360, kl)
    ok &= (2 * klw <= sel_ni(c["thilon"])) & (2 * klw >= sel_ni(c["tlolon"]))
    return {"ok": ok, "j": j, "ni": ni, "m": m}


def relative_consts_on(c: dict, device) -> dict:
    """relative_consts tables as int32 tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in c.items()}


def make_decode_relative_device(reflat: float, reflon: float, device="cuda"):
    """Relative decoder bound to one reference position, its tables on
    `device`."""
    c = relative_consts_on(relative_consts(reflat, reflon), torch.device(device))

    def run(clat, clon, fflag, surface):
        return decode_relative_core(clat, clon, fflag, surface, c)

    return run


def relative_latlon_f64(dev, clat, clon, fflag, surface):
    """Host f64 map for the relative decisions (cpr.c:351-385 formulas)."""
    j = np.asarray(dev["j"]).astype(np.int64)
    ni = np.asarray(dev["ni"]).astype(np.int64)
    m = np.asarray(dev["m"]).astype(np.int64)
    f = np.asarray(fflag).astype(np.int64)
    s = np.asarray(surface).astype(bool)
    clat = np.asarray(clat, np.float64)
    clon = np.asarray(clon, np.float64)

    dlat = np.where(s, 90.0, 360.0) / np.where(f != 0, 59.0, 60.0)
    rlat = dlat * (j + clat / 131072)
    rlat = np.where(rlat >= 270, rlat - 360, rlat)
    dlon = np.where(s, 90.0, 360.0) / ni
    rlon = dlon * (m + clon / 131072)
    rlon = np.where(rlon > 180, rlon - 360, rlon)
    return rlat, rlon
