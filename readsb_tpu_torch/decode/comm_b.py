"""Comm-B BDS register inference (DF20/21 MB field).

The requested register is unknown, so every candidate decoder scores the
payload on plausibility and the unambiguous best wins (comm_b.c:52-86).
Scoring constants and range checks mirror the reference exactly —
including its quirks (e.g. BDS4,4's integer-division wind direction and
the pressure branch that rejects plausible pressure) — so that a readsb
user sees identical Comm-B behavior.
"""

from __future__ import annotations

import math

from .ais import AIS_CHARSET, is_valid_callsign_char

# commb_format values
UNKNOWN = "unknown"
AMBIGUOUS = "ambiguous"
EMPTY_RESPONSE = "empty"
DATALINK_CAPS = "BDS1,0"
GICB_CAPS = "BDS1,7"
AIRCRAFT_IDENT = "BDS2,0"
ACAS_RA = "BDS3,0"
VERTICAL_INTENT = "BDS4,0"
TRACK_TURN = "BDS5,0"
HEADING_SPEED = "BDS6,0"
METEOROLOGICAL_ROUTINE = "BDS4,4"


def _getbits(msg: bytes, first1: int, last1: int) -> int:
    v = 0
    for b in range(first1 - 1, last1):
        v = (v << 1) | ((msg[b >> 3] >> (7 - (b & 7))) & 1)
    return v


def _getbit(msg: bytes, b1: int) -> int:
    b = b1 - 1
    return (msg[b >> 3] >> (7 - (b & 7))) & 1


def _empty(mm, mb, store):
    if any(mb):
        return 0
    if store:
        mm.commb_format = EMPTY_RESPONSE
    return 56


def _bds10(mm, mb, store):
    if mb[0] != 0x10:
        return 0
    if _getbits(mb, 10, 14) != 0:
        return 0
    if store:
        mm.commb_format = DATALINK_CAPS
    return 56


def _bds17(mm, mb, store):
    if _getbits(mb, 25, 56) != 0:
        return 0
    score = 1 if _getbit(mb, 7) else -2
    for b in (10, 11, 12, 13, 14, 20, 21, 22):
        if _getbit(mb, b):
            score -= 2
    b15 = [_getbit(mb, i) for i in (1, 2, 3, 4, 5)]
    if all(b15):
        score += 5
        if _getbit(mb, 6):
            score += 1
    elif not any(b15) and not _getbit(mb, 6):
        score += 1
    else:
        score -= 12
    if _getbit(mb, 16) and _getbit(mb, 24):
        score += 2
        if _getbit(mb, 9):
            score += 1
    elif not _getbit(mb, 16) and not _getbit(mb, 24) and not _getbit(mb, 9):
        score += 1
    else:
        score -= 6
    if store:
        mm.commb_format = GICB_CAPS
    return score


def _bds20(mm, mb, store):
    if mb[0] != 0x20:
        return 0
    cs = "".join(AIS_CHARSET[_getbits(mb, 9 + 6 * i, 14 + 6 * i)] for i in range(8))
    score = 8
    for c in cs:
        if is_valid_callsign_char(c):
            score += 6
        else:
            return 0
    if store:
        mm.commb_format = AIRCRAFT_IDENT
        mm.callsign = cs
        mm.callsign_valid = True
    return score


def _bds30(mm, mb, store):
    if mb[0] != 0x30:
        return 0
    if store:
        mm.commb_format = ACAS_RA
        mm.acas_ra_valid = True
    return 56


def _bds40(mm, mb, store):
    mcp_valid = _getbit(mb, 1)
    mcp_raw = _getbits(mb, 2, 13)
    fms_valid = _getbit(mb, 14)
    fms_raw = _getbits(mb, 15, 26)
    baro_valid = _getbit(mb, 27)
    baro_raw = _getbits(mb, 28, 39)
    reserved_1 = _getbits(mb, 40, 47)
    mode_valid = _getbit(mb, 48)
    mode_raw = _getbits(mb, 49, 51)
    reserved_2 = _getbits(mb, 52, 53)
    source_valid = _getbit(mb, 54)
    source_raw = _getbits(mb, 55, 56)

    if not (mcp_valid or fms_valid or baro_valid or mode_valid or source_valid):
        return 0
    score = 0
    mcp_alt = 0
    if mcp_valid and mcp_raw != 0:
        mcp_alt = mcp_raw * 16
        if 1000 <= mcp_alt <= 50000:
            score += 13
        else:
            return 0
    elif not mcp_valid and mcp_raw == 0:
        score += 1
    else:
        return 0
    fms_alt = 0
    if fms_valid and fms_raw != 0:
        fms_alt = fms_raw * 16
        if 1000 <= fms_alt <= 50000:
            score += 13
        else:
            return 0
    elif not fms_valid and fms_raw == 0:
        score += 1
    else:
        return 0
    baro_setting = 0.0
    if baro_valid and baro_raw != 0:
        baro_setting = 800 + baro_raw * 0.1
        if 900 <= baro_setting <= 1100:
            score += 13
        else:
            return 0
    elif not baro_valid and baro_raw == 0:
        score += 1
    else:
        return 0
    if reserved_1 != 0:
        return 0
    if mode_valid:
        score += 4
    elif mode_raw == 0:
        score += 1
    else:
        return 0
    if reserved_2 != 0:
        return 0
    if source_valid:
        score += 3
    elif source_raw == 0:
        score += 1
    else:
        return 0
    if mcp_valid and fms_valid and mcp_alt != fms_alt:
        score -= 4
    if mcp_valid:
        r = mcp_alt % 500
        if not (r < 16 or r > 484):
            score -= 4
    if fms_valid:
        r = fms_alt % 500
        if not (r < 16 or r > 484):
            score -= 4
    if store:
        from .fields import (
            NAV_ALT_AIRCRAFT,
            NAV_ALT_FMS,
            NAV_ALT_INVALID,
            NAV_ALT_MCP,
            NAV_ALT_UNKNOWN,
            NAV_MODE_ALT_HOLD,
            NAV_MODE_APPROACH,
            NAV_MODE_VNAV,
        )

        mm.commb_format = VERTICAL_INTENT
        if mcp_valid:
            mm.nav_mcp_altitude = mcp_alt
        if fms_valid:
            mm.nav_fms_altitude = fms_alt
        if baro_valid:
            mm.nav_qnh = baro_setting
        if mode_valid:
            mm.nav_modes = (
                (NAV_MODE_VNAV if mode_raw & 4 else 0)
                | (NAV_MODE_ALT_HOLD if mode_raw & 2 else 0)
                | (NAV_MODE_APPROACH if mode_raw & 1 else 0)
            )
        if source_valid:
            mm.nav_altitude_source = {
                0: NAV_ALT_UNKNOWN,
                1: NAV_ALT_AIRCRAFT,
                2: NAV_ALT_MCP,
                3: NAV_ALT_FMS,
            }.get(source_raw, NAV_ALT_INVALID)
        else:
            mm.nav_altitude_source = NAV_ALT_INVALID
    return score


def _bds50(mm, mb, store):
    roll_valid = _getbit(mb, 1)
    roll_sign = _getbit(mb, 2)
    roll_raw = _getbits(mb, 3, 11)
    track_valid = _getbit(mb, 12)
    track_sign = _getbit(mb, 13)
    track_raw = _getbits(mb, 14, 23)
    gs_valid = _getbit(mb, 24)
    gs_raw = _getbits(mb, 25, 34)
    track_rate_valid = _getbit(mb, 35)
    track_rate_sign = _getbit(mb, 36)
    track_rate_raw = _getbits(mb, 37, 45)
    tas_valid = _getbit(mb, 46)
    tas_raw = _getbits(mb, 47, 56)

    if not (roll_valid and track_valid and gs_valid and tas_valid):
        return 0
    score = 0
    roll = roll_raw * 45.0 / 256.0 - (90.0 if roll_sign else 0.0)
    if -40 <= roll < 40:
        score += 11
    else:
        return 0
    track = track_raw * 90.0 / 512.0 + (180.0 if track_sign else 0.0)
    score += 12
    # gs_valid is guaranteed set here; gs_raw == 0 is rejected (comm_b.c:577-589)
    gs = gs_raw * 2
    if gs_raw == 0:
        return 0
    if 50 <= gs <= 700:
        score += 11
    else:
        return 0
    track_rate = track_rate_raw * 8.0 / 256.0 - (16.0 if track_rate_sign else 0.0)
    if track_rate_valid:
        if -10.0 <= track_rate <= 10.0:
            score += 11
        else:
            return 0
    elif track_rate_raw == 0 and not track_rate_sign:
        score += 1
    else:
        return 0
    tas = tas_raw * 2
    if tas_raw != 0:
        if 50 <= tas <= 700:
            score += 11
        else:
            return 0
    else:
        return 0
    # reference compares the *valid flags* (a quirk): delta of flags never >150
    if roll_valid and tas > 0 and track_rate_valid:
        turn_rate = 68625 * math.tan(roll * math.pi / 180.0) / (tas * 20 * math.pi)
        if abs(turn_rate - track_rate) > 2.0:
            score -= 6
    if store:
        from .fields import HeadingType

        mm.commb_format = TRACK_TURN
        mm.roll = roll
        mm.heading = track
        mm.heading_type = HeadingType.GROUND_TRACK
        mm.gs_v0 = mm.gs_v2 = mm.gs_selected = float(gs)
        if track_rate_valid:
            mm.track_rate = track_rate
        mm.tas = tas
    return score


def _bds60(mm, mb, store):
    heading_valid = _getbit(mb, 1)
    heading_sign = _getbit(mb, 2)
    heading_raw = _getbits(mb, 3, 12)
    ias_valid = _getbit(mb, 13)
    ias_raw = _getbits(mb, 14, 23)
    mach_valid = _getbit(mb, 24)
    mach_raw = _getbits(mb, 25, 34)
    baro_rate_valid = _getbit(mb, 35)
    baro_rate_sign = _getbit(mb, 36)
    baro_rate_raw = _getbits(mb, 37, 45)
    inertial_rate_valid = _getbit(mb, 46)
    inertial_rate_sign = _getbit(mb, 47)
    inertial_rate_raw = _getbits(mb, 48, 56)

    if not heading_valid or not ias_valid or not mach_valid or (
        not baro_rate_valid and not inertial_rate_valid
    ):
        return 0
    score = 0
    heading = heading_raw * 90.0 / 512.0 + (180.0 if heading_sign else 0.0)
    score += 12
    ias = ias_raw
    if ias_raw != 0:
        if 50 <= ias <= 700:
            score += 11
        else:
            return 0
    else:
        return 0
    mach = mach_raw * 2.048 / 512
    if mach_raw != 0:
        if 0.1 <= mach <= 0.9:
            score += 11
        else:
            return 0
    else:
        return 0
    baro_rate = 0
    if baro_rate_valid:
        baro_rate = baro_rate_raw * 32 - (16384 if baro_rate_sign else 0)
        if -6000 <= baro_rate <= 6000:
            score += 11
        else:
            return 0
    elif baro_rate_raw == 0:
        score += 1
    else:
        return 0
    inertial_rate = 0
    if inertial_rate_valid:
        inertial_rate = inertial_rate_raw * 32 - (16384 if inertial_rate_sign else 0)
        if -6000 <= inertial_rate <= 6000:
            score += 11
        else:
            return 0
    elif inertial_rate_raw == 0:
        score += 1
    else:
        return 0
    if baro_rate_valid and inertial_rate_valid:
        if abs(baro_rate - inertial_rate) > 2000:
            score -= 12
    if store:
        from .fields import HeadingType

        mm.commb_format = HEADING_SPEED
        mm.heading = heading
        mm.heading_type = HeadingType.MAGNETIC
        mm.ias = ias
        mm.mach = mach
        if baro_rate_valid:
            mm.baro_rate = baro_rate
        if inertial_rate_valid:
            mm.geom_rate = inertial_rate
    return score


def _bds44(mm, mb, store):
    source = _getbits(mb, 1, 4)
    wind_valid = _getbit(mb, 5)
    wind_speed_raw = _getbits(mb, 6, 14)
    wind_direction_raw = _getbits(mb, 15, 23)
    temperature_sign = _getbit(mb, 24)
    sat_raw = _getbits(mb, 25, 34)
    pressure_valid = _getbit(mb, 35)
    static_pressure_raw = _getbits(mb, 36, 46)
    turbulence_valid = _getbit(mb, 47)
    turbulence_raw = _getbits(mb, 48, 49)
    humidity_valid = _getbit(mb, 50)
    humidity_raw = _getbits(mb, 51, 56)

    score = 0
    if not (0 <= source <= 6):
        return 0
    score += 4
    wind_speed = 0
    # reference quirk: wind_direction uses integer division (180/256)==0
    wind_direction = wind_direction_raw * (180 // 256)
    if wind_valid:
        wind_speed = wind_speed_raw
        if 0 <= wind_speed <= 511:
            score += 9
        else:
            return 0
        if 0 <= wind_direction <= 360:
            score += 9
        else:
            return 0
    elif wind_speed == 0:
        score += 2
    if temperature_sign:
        temperature = (sat_raw - 1024) * 0.25
    else:
        temperature = sat_raw * 0.25
    if -128 <= temperature <= 128:
        score += 10
    else:
        return 0
    if pressure_valid:
        # reference quirk: plausible pressure *rejects* the candidate
        if 0 <= static_pressure_raw <= 2048:
            return 0
    else:
        score += 1
    if turbulence_valid:
        if 0 <= turbulence_raw <= 3:
            score += 2
        else:
            return 0
    else:
        score += 1
    humidity = 0.0
    if humidity_valid:
        humidity = humidity_raw * (100.0 / 64)
        if 0 <= humidity <= 100:
            score += 6
        else:
            return 0
    else:
        score += 1
    if store:
        mm.commb_format = METEOROLOGICAL_ROUTINE
        if wind_valid:
            mm.wind_speed = float(wind_speed)
            mm.wind_dir = float(wind_direction)
        mm.oat = temperature
        if humidity_valid:
            mm.humidity = humidity
    return score


_DECODERS = (_empty, _bds10, _bds20, _bds30, _bds17, _bds40, _bds50, _bds60, _bds44)


def decode(mm) -> None:
    """Infer and decode the BDS register of mm.MB (comm_b.c:52-86)."""
    mm.commb_format = UNKNOWN
    if mm.DR != 0 or mm.UM != 0 or mm.correctedbits > 0:
        return
    mb = mm.MB
    best_score = 0
    best = None
    ambiguous = False
    for dec in _DECODERS:
        s = dec(mm, mb, False)
        if s > best_score:
            best_score = s
            best = dec
            ambiguous = False
        elif s == best_score:
            ambiguous = True
    if best is not None:
        if ambiguous:
            mm.commb_format = AMBIGUOUS
        else:
            best(mm, mb, True)
