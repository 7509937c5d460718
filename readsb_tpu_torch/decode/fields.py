"""Full Mode-S / ADS-B field decoding: RawFrame -> ModesMessage.

Host-side control-plane decode of the (already CRC-validated) frames the
device pipeline emits — the long tail of per-DF field extraction.  The
semantics mirror the reference decoder so downstream consumers (tracker,
SBS/JSON writers) see identical values:

- altitude codes AC12/AC13 incl. Gillham (mode_s.c:110-178, mode_ac.c)
- squawk ID13 (mode_s.c:83-100)
- extended squitter dispatch (mode_s.c:1454-1555) with all metype
  handlers (ident 806, surface pos 979, airborne pos 1016, velocity 871,
  test 1103, aircraft status 1116, target status 1140, opstatus 1334)
- DF18 CF / DF17 CA handling, IMF addresses (mode_s.c:846-869)
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

from ..constants import HEX_UNKNOWN
from .ais import AIS_CHARSET
from .score import RawFrame

INVALID_ALTITUDE = -9999 * 100  # sentinel (absent from real data)
MODES_NON_ICAO_ADDRESS = 1 << 24


class Source(enum.IntEnum):
    """Data source priority lattice (readsb.h:160-173, ascending)."""

    INVALID = 0
    INDIRECT = 1
    MODE_AC = 2
    SBS = 3
    MLAT = 4
    MODE_S = 5
    JAERO = 6
    MODE_S_CHECKED = 7
    TISB = 8
    ADSR = 9
    ADSB = 10
    PRIO = 11


class AddrType(enum.IntEnum):
    """Address type in decreasing confidence (readsb.h addrtype_t order)."""

    ADSB_ICAO = 0
    ADSB_ICAO_NT = 1
    ADSR_ICAO = 2
    TISB_ICAO = 3
    JAERO = 4
    MLAT = 5
    OTHER = 6
    MODE_S = 7
    ADSB_OTHER = 8
    ADSR_OTHER = 9
    TISB_TRACKFILE = 10
    TISB_OTHER = 11
    MODE_AC = 12
    UNKNOWN = 13


class AirGround(enum.IntEnum):
    INVALID = 0
    GROUND = 1
    AIRBORNE = 2
    UNCERTAIN = 3


class HeadingType(enum.IntEnum):
    INVALID = 0
    GROUND_TRACK = 1
    TRUE = 2
    MAGNETIC = 3
    MAGNETIC_OR_TRUE = 4
    TRACK_OR_HEADING = 5


class CprType(enum.IntEnum):
    NONE = 0
    SURFACE = 1
    AIRBORNE = 2
    COARSE = 3


class SilType(enum.IntEnum):
    INVALID = 0
    UNKNOWN = 1
    PER_SAMPLE = 2
    PER_HOUR = 3


# nav_modes bitmask
NAV_MODE_AUTOPILOT = 1
NAV_MODE_VNAV = 2
NAV_MODE_ALT_HOLD = 4
NAV_MODE_APPROACH = 8
NAV_MODE_LNAV = 16
NAV_MODE_TCAS = 32

NAV_ALT_INVALID = 0
NAV_ALT_UNKNOWN = 1
NAV_ALT_AIRCRAFT = 2
NAV_ALT_MCP = 3
NAV_ALT_FMS = 4


def getbits(msg: bytes, first1: int, last1: int) -> int:
    """Bits [first1..last1], 1-based, MSB first (matches the reference)."""
    v = 0
    for b in range(first1 - 1, last1):
        v = (v << 1) | ((msg[b >> 3] >> (7 - (b & 7))) & 1)
    return v


def getbit(msg: bytes, b1: int) -> int:
    b = b1 - 1
    return (msg[b >> 3] >> (7 - (b & 7))) & 1


# ---------------------------------------------------------------------------
# Altitude / squawk codecs
# ---------------------------------------------------------------------------


def decode_id13(id13: int) -> int:
    """13-bit interleaved field -> hex-coded octal squawk (mode_s.c:83)."""
    h = 0
    if id13 & 0x1000: h |= 0x0010  # C1
    if id13 & 0x0800: h |= 0x1000  # A1
    if id13 & 0x0400: h |= 0x0020  # C2
    if id13 & 0x0200: h |= 0x2000  # A2
    if id13 & 0x0100: h |= 0x0040  # C4
    if id13 & 0x0080: h |= 0x4000  # A4
    if id13 & 0x0020: h |= 0x0100  # B1
    if id13 & 0x0010: h |= 0x0001  # D1/Q
    if id13 & 0x0008: h |= 0x0200  # B2
    if id13 & 0x0004: h |= 0x0002  # D2
    if id13 & 0x0002: h |= 0x0400  # B4
    if id13 & 0x0001: h |= 0x0004  # D4
    return h


def mode_a_to_mode_c(mode_a: int) -> Optional[int]:
    """Gillham code -> 100ft units (mode_ac.c internalModeAToModeC)."""
    five_hundreds = 0
    one_hundreds = 0
    if (mode_a & 0xFFFF8889) != 0 or (mode_a & 0x000000F0) == 0:
        return None
    if mode_a & 0x0010: one_hundreds ^= 0x007  # C1
    if mode_a & 0x0020: one_hundreds ^= 0x003  # C2
    if mode_a & 0x0040: one_hundreds ^= 0x001  # C4
    if (one_hundreds & 5) == 5:
        one_hundreds ^= 2
    if one_hundreds > 5:
        return None
    if mode_a & 0x0002: five_hundreds ^= 0x0FF  # D2
    if mode_a & 0x0004: five_hundreds ^= 0x07F  # D4
    if mode_a & 0x1000: five_hundreds ^= 0x03F  # A1
    if mode_a & 0x2000: five_hundreds ^= 0x01F  # A2
    if mode_a & 0x4000: five_hundreds ^= 0x00F  # A4
    if mode_a & 0x0100: five_hundreds ^= 0x007  # B1
    if mode_a & 0x0200: five_hundreds ^= 0x003  # B2
    if mode_a & 0x0400: five_hundreds ^= 0x001  # B4
    if five_hundreds & 1:
        one_hundreds = 6 - one_hundreds
    n = five_hundreds * 5 + one_hundreds - 13
    if n < -12:
        return None
    return n


def decode_ac13(ac13: int) -> tuple[Optional[int], str, int]:
    """(altitude_ft, unit, q_bit) from the 13-bit AC field (mode_s.c:110)."""
    m_bit = ac13 & 0x0040
    q_bit = 1 if (ac13 & 0x0010) else 0
    if m_bit:
        return None, "m", q_bit
    if q_bit:
        n = ((ac13 & 0x1F80) >> 2) | ((ac13 & 0x0020) >> 1) | (ac13 & 0x000F)
        return n * 25 - 1000, "ft", q_bit
    n = mode_a_to_mode_c(decode_id13(ac13))
    if n is None:
        return None, "ft", q_bit
    return 100 * n, "ft", q_bit


def decode_ac12(ac12: int) -> tuple[Optional[int], str, int]:
    """(altitude_ft, unit, q_bit) from the 12-bit AC field (mode_s.c:148)."""
    q_bit = 1 if (ac12 & 0x10) else 0
    if q_bit:
        n = ((ac12 & 0x0FE0) >> 1) | (ac12 & 0x000F)
        return n * 25 - 1000, "ft", q_bit
    n13 = ((ac12 & 0x0FC0) << 1) | (ac12 & 0x003F)
    n = mode_a_to_mode_c(decode_id13(n13))
    if n is None:
        return None, "ft", q_bit
    return 100 * n, "ft", q_bit


def squawk_hex_to_dec(hx: int) -> int:
    return ((hx >> 12) & 7) * 1000 + ((hx >> 8) & 7) * 100 + ((hx >> 4) & 7) * 10 + (hx & 7)


def decode_movement_v0(movement: int) -> float:
    if movement >= 125: return 0.0
    if movement == 124: return 180.0
    if movement >= 109: return 100 + (movement - 109 + 0.5) * 5
    if movement >= 94: return 70 + (movement - 94 + 0.5) * 2
    if movement >= 39: return 15 + (movement - 39 + 0.5) * 1
    if movement >= 13: return 2 + (movement - 13 + 0.5) * 0.50
    if movement >= 9: return 1 + (movement - 9 + 0.5) * 0.25
    if movement >= 2: return 0.125 + (movement - 2 + 0.5) * 0.125
    return 0.0


def decode_movement_v2(movement: int) -> float:
    if movement >= 125: return 0.0
    if movement == 124: return 180.0
    if movement >= 109: return 100 + (movement - 109 + 0.5) * 5
    if movement >= 94: return 70 + (movement - 94 + 0.5) * 2
    if movement >= 39: return 15 + (movement - 39 + 0.5) * 1
    if movement >= 13: return 2 + (movement - 13 + 0.5) * 0.50
    if movement >= 9: return 1 + (movement - 9 + 0.5) * 0.25
    if movement >= 3: return 0.125 + (movement - 3 + 0.5) * 0.875 / 6
    if movement >= 2: return 0.125 / 2
    return 0.0


# ---------------------------------------------------------------------------
# The decoded message record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModesMessage:
    """Decoded message (the analog of the reference's struct modesMessage)."""

    msg: bytes = b""
    msgbits: int = 0
    msgtype: int = 0
    timestamp: int = 0  # 12 MHz
    sys_timestamp_ms: int = 0
    addr: int = HEX_UNKNOWN
    maybe_addr: int = HEX_UNKNOWN
    addrtype: AddrType = AddrType.UNKNOWN
    source: Source = Source.INVALID
    receiver_id: int = 0
    score: int = 0
    correctedbits: int = 0
    crc: int = 0
    iid: int = 0
    signal_level: float = 0.0
    remote: bool = False
    garbage: bool = False
    duplicate: bool = False
    duplicate_checked: bool = False
    pos_ignore: bool = False
    in_disc_cache: bool = False
    reduce_forward: bool = False

    # decoded fields (None = not present)
    airground: AirGround = AirGround.UNCERTAIN
    baro_alt: Optional[int] = None
    baro_alt_unit: str = "ft"
    geom_alt: Optional[int] = None
    geom_alt_unit: str = "ft"
    alt_q_bit: int = 0
    geom_delta: Optional[int] = None
    squawk_hex: Optional[int] = None  # 0x1200-style hex-coded octal
    callsign: Optional[str] = None
    callsign_valid: bool = False
    category: Optional[int] = None
    metype: int = 0
    mesub: int = 0
    gs_v0: Optional[float] = None
    gs_v2: Optional[float] = None
    gs_selected: Optional[float] = None
    ias: Optional[int] = None
    tas: Optional[int] = None
    mach: Optional[float] = None
    heading: Optional[float] = None
    heading_type: HeadingType = HeadingType.INVALID
    track_rate: Optional[float] = None
    roll: Optional[float] = None
    baro_rate: Optional[int] = None
    geom_rate: Optional[int] = None
    cpr_valid: bool = False
    cpr_odd: int = 0
    cpr_lat: int = 0
    cpr_lon: int = 0
    cpr_type: CprType = CprType.NONE
    cpr_decoded: bool = False
    sbs_pos_valid: bool = False  # position arrived pre-decoded (SBS/ASTERIX)
    decoded_lat: float = 0.0
    decoded_lon: float = 0.0
    decoded_nic: int = 0
    decoded_rc: float = 0.0
    alert: Optional[bool] = None
    spi: Optional[bool] = None
    emergency: Optional[int] = None
    # nav (intent) fields
    nav_qnh: Optional[float] = None
    nav_mcp_altitude: Optional[int] = None
    nav_fms_altitude: Optional[int] = None
    nav_heading: Optional[float] = None
    nav_heading_type: HeadingType = HeadingType.INVALID
    nav_modes: Optional[int] = None
    nav_altitude_source: int = NAV_ALT_INVALID
    # accuracy
    nic_a: Optional[int] = None
    nic_b: Optional[int] = None
    nic_c: Optional[int] = None
    nic_baro: Optional[int] = None
    nac_p: Optional[int] = None
    nac_v: Optional[int] = None
    sil: Optional[int] = None
    sil_type: SilType = SilType.INVALID
    gva: Optional[int] = None
    sda: Optional[int] = None
    # opstatus
    opstatus_valid: bool = False
    adsb_version: Optional[int] = None
    opstatus_hrd: HeadingType = HeadingType.TRUE
    opstatus_tah: HeadingType = HeadingType.GROUND_TRACK
    # meteo (from Comm-B BDS 4,4 / 5,0 / 6,0)
    wind_speed: Optional[float] = None
    wind_dir: Optional[float] = None
    oat: Optional[float] = None
    # status decode extras
    acas_ra_valid: bool = False
    spi_valid: bool = False
    alert_valid: bool = False
    # raw subfields
    CA: int = 0
    CC: int = 0
    CF: int = 0
    DR: int = 0
    FS: int = 0
    KE: int = 0
    ND: int = 0
    RI: int = 0
    SL: int = 0
    UM: int = 0
    VS: int = 0
    AC: int = 0
    ID: int = 0
    MB: bytes = b""
    ME: bytes = b""
    MV: bytes = b""


def _set_imf(mm: ModesMessage) -> None:
    mm.addr |= MODES_NON_ICAO_ADDRESS
    if mm.addrtype in (AddrType.ADSB_ICAO, AddrType.ADSB_ICAO_NT):
        mm.addrtype = AddrType.ADSB_OTHER
    elif mm.addrtype == AddrType.TISB_ICAO:
        mm.addrtype = AddrType.TISB_TRACKFILE
    elif mm.addrtype == AddrType.ADSR_ICAO:
        mm.addrtype = AddrType.ADSR_OTHER


def _decode_es_ident(mm: ModesMessage, me: bytes) -> None:
    mm.mesub = getbits(me, 6, 8)
    cs = "".join(
        AIS_CHARSET[getbits(me, 9 + 6 * i, 14 + 6 * i)] for i in range(8)
    )
    mm.callsign = cs
    mm.callsign_valid = all(
        ("A" <= c <= "Z") or ("-" <= c <= "9") or c in " @" for c in cs
    )
    mm.category = ((0x0E - mm.metype) << 4) | mm.mesub


def _decode_es_velocity(mm: ModesMessage, me: bytes, check_imf: bool) -> None:
    mm.mesub = getbits(me, 6, 8)
    if mm.mesub < 1 or mm.mesub > 4:
        return
    if check_imf and getbit(me, 9):
        _set_imf(mm)
    mm.nac_v = getbits(me, 11, 13)
    if mm.mesub in (1, 2):
        ew_raw = getbits(me, 15, 24)
        ns_raw = getbits(me, 26, 35)
        if ew_raw and ns_raw:
            scale = 4 if mm.mesub == 2 else 1
            ew_vel = (ew_raw - 1) * (-1 if getbit(me, 14) else 1) * scale
            ns_vel = (ns_raw - 1) * (-1 if getbit(me, 25) else 1) * scale
            import numpy as np

            gs = float(np.float32(math.sqrt(ns_vel * ns_vel + ew_vel * ew_vel + 0.5)))
            mm.gs_v0 = mm.gs_v2 = mm.gs_selected = gs
            if gs > 0:
                trk = math.atan2(ew_vel, ns_vel) * 180.0 / math.pi
                if trk < 0:
                    trk += 360
                mm.heading = trk
                mm.heading_type = HeadingType.GROUND_TRACK
    elif mm.mesub in (3, 4):
        if getbit(me, 14):
            mm.heading = getbits(me, 15, 24) * 360.0 / 1024.0
            mm.heading_type = HeadingType.MAGNETIC_OR_TRUE
        airspeed = getbits(me, 26, 35)
        if airspeed:
            speed = (airspeed - 1) * (4 if mm.mesub == 4 else 1)
            if getbit(me, 25):
                mm.tas = speed
            else:
                mm.ias = speed
    vr = getbits(me, 38, 46)
    if vr:
        rate = (vr - 1) * (-64 if getbit(me, 37) else 64)
        if getbit(me, 36):
            mm.baro_rate = rate
        else:
            mm.geom_rate = rate
    raw_delta = getbits(me, 50, 56)
    if raw_delta:
        mm.geom_delta = (raw_delta - 1) * (-25 if getbit(me, 49) else 25)


def _decode_es_surface(mm: ModesMessage, me: bytes, check_imf: bool) -> None:
    mm.airground = AirGround.GROUND
    mm.cpr_valid = True
    mm.cpr_type = CprType.SURFACE
    movement = getbits(me, 6, 12)
    if 0 < movement < 125:
        mm.gs_v0 = decode_movement_v0(movement)
        mm.gs_v2 = decode_movement_v2(movement)
        mm.gs_selected = mm.gs_v0
    if getbit(me, 13):
        mm.heading = getbits(me, 14, 20) * 360.0 / 128.0
        mm.heading_type = HeadingType.TRACK_OR_HEADING
    if check_imf and getbit(me, 21):
        _set_imf(mm)
    mm.cpr_odd = getbit(me, 22)
    mm.cpr_lat = getbits(me, 23, 39)
    mm.cpr_lon = getbits(me, 40, 56)


def _decode_es_airborne(mm: ModesMessage, me: bytes, check_imf: bool) -> None:
    ss = getbits(me, 6, 7)
    if ss == 0:
        mm.alert_valid = mm.spi_valid = True
        mm.alert = mm.spi = False
    elif ss in (1, 2):
        mm.alert_valid = True
        mm.alert = True
    elif ss == 3:
        mm.alert_valid = mm.spi_valid = True
        mm.alert = False
        mm.spi = True
    if check_imf:
        if getbit(me, 8):
            _set_imf(mm)
    else:
        mm.nic_b = getbit(me, 8)
    ac12 = getbits(me, 9, 20)
    if mm.metype != 0:
        mm.cpr_lat = getbits(me, 23, 39)
        mm.cpr_lon = getbits(me, 40, 56)
        if ac12 == 0 and mm.cpr_lon == 0 and (mm.cpr_lat & 0x0FFF) == 0 and mm.metype == 15:
            pass  # known corrupt pattern (mode_s.c:1068)
        else:
            mm.cpr_valid = True
            mm.cpr_type = CprType.AIRBORNE
            mm.cpr_odd = getbit(me, 22)
    if ac12 and mm.airground != AirGround.GROUND:
        alt, unit, q = decode_ac12(ac12)
        if alt is not None:
            mm.alt_q_bit = q
            if mm.metype in (20, 21, 22):
                mm.geom_alt = alt
                mm.geom_alt_unit = unit
            else:
                mm.baro_alt = alt
                mm.baro_alt_unit = unit


def _decode_es_test(mm: ModesMessage, me: bytes) -> None:
    mm.mesub = getbits(me, 6, 8)
    if mm.mesub == 7:
        id13 = getbits(me, 9, 21)
        if id13:
            mm.squawk_hex = decode_id13(id13)


def _decode_es_aircraft_status(mm: ModesMessage, me: bytes, check_imf: bool) -> None:
    mm.mesub = getbits(me, 6, 8)
    if mm.mesub == 1:
        mm.emergency = getbits(me, 9, 11)
        id13 = getbits(me, 12, 24)
        if id13:
            mm.squawk_hex = decode_id13(id13)
        if check_imf and getbit(me, 56):
            _set_imf(mm)
    elif mm.mesub == 2:
        mm.acas_ra_valid = True


def _decode_es_target_status(mm: ModesMessage, me: bytes, check_imf: bool) -> None:
    mm.mesub = getbits(me, 6, 7)
    if check_imf and getbit(me, 51):
        _set_imf(mm)
    if mm.mesub == 0 and getbit(me, 11) == 0:  # V1
        vsrc = getbits(me, 8, 9)
        mm.nav_altitude_source = {1: NAV_ALT_MCP, 2: NAV_ALT_AIRCRAFT, 3: NAV_ALT_FMS}.get(
            vsrc, NAV_ALT_INVALID
        )
        vmode = getbits(me, 14, 15)
        nav_modes = 0
        modes_valid = False
        if vmode == 1:
            modes_valid = True
            nav_modes |= NAV_MODE_VNAV if mm.nav_altitude_source == NAV_ALT_FMS else NAV_MODE_AUTOPILOT
        elif vmode == 2:
            modes_valid = True
            if mm.nav_altitude_source == NAV_ALT_FMS:
                nav_modes |= NAV_MODE_VNAV
            elif mm.nav_altitude_source == NAV_ALT_AIRCRAFT:
                nav_modes |= NAV_MODE_ALT_HOLD
            else:
                nav_modes |= NAV_MODE_AUTOPILOT
        alt = -1000 + 100 * getbits(me, 16, 25)
        if mm.nav_altitude_source == NAV_ALT_MCP:
            mm.nav_mcp_altitude = alt
        elif mm.nav_altitude_source == NAV_ALT_FMS:
            mm.nav_fms_altitude = alt
        h_source = getbits(me, 26, 27)
        if h_source != 0:
            mm.nav_heading = float(getbits(me, 28, 36))
            mm.nav_heading_type = (
                HeadingType.GROUND_TRACK if getbit(me, 37) else HeadingType.MAGNETIC_OR_TRUE
            )
        hmode = getbits(me, 38, 39)
        if hmode in (1, 2):
            modes_valid = True
            nav_modes |= NAV_MODE_LNAV if h_source == 3 else NAV_MODE_AUTOPILOT
        mm.nac_p = getbits(me, 40, 43)
        mm.nic_baro = getbit(me, 44)
        mm.sil = getbits(me, 45, 46)
        mm.sil_type = SilType.UNKNOWN
        tcas = getbits(me, 52, 53)
        if tcas == 1:
            modes_valid = True
        elif tcas in (2, 3):
            modes_valid = True
            nav_modes |= NAV_MODE_TCAS
        elif tcas == 0:
            nav_modes |= NAV_MODE_TCAS
        if modes_valid:
            mm.nav_modes = nav_modes
        mm.emergency = getbits(me, 54, 56)
    elif mm.mesub == 1:  # V2
        is_fms = getbit(me, 9)
        alt_bits = getbits(me, 10, 20)
        if alt_bits:
            if is_fms:
                mm.nav_fms_altitude = (alt_bits - 1) * 32
            else:
                mm.nav_mcp_altitude = (alt_bits - 1) * 32
        baro_bits = getbits(me, 21, 29)
        if baro_bits:
            mm.nav_qnh = 800.0 + (baro_bits - 1) * 0.8
        if getbit(me, 30):
            mm.nav_heading = getbits(me, 31, 39) * 180.0 / 256.0
            mm.nav_heading_type = HeadingType.MAGNETIC_OR_TRUE
        mm.nac_p = getbits(me, 40, 43)
        mm.nic_baro = getbit(me, 44)
        mm.sil = getbits(me, 45, 46)
        mm.sil_type = SilType.UNKNOWN
        if getbit(me, 47):
            mm.nav_modes = (
                (NAV_MODE_AUTOPILOT if getbit(me, 48) else 0)
                | (NAV_MODE_VNAV if getbit(me, 49) else 0)
                | (NAV_MODE_ALT_HOLD if getbit(me, 50) else 0)
                | (NAV_MODE_APPROACH if getbit(me, 52) else 0)
                | (NAV_MODE_TCAS if getbit(me, 53) else 0)
                | (NAV_MODE_LNAV if getbit(me, 54) else 0)
            )


def _decode_es_opstatus(mm: ModesMessage, me: bytes, check_imf: bool) -> None:
    mm.mesub = getbits(me, 6, 8)
    if check_imf and getbit(me, 56):
        _set_imf(mm)
    if mm.mesub in (0, 1):
        mm.opstatus_valid = True
        mm.adsb_version = getbits(me, 41, 43)
        v = mm.adsb_version
        if v in (1, 2):
            mm.nic_a = getbit(me, 44)
            mm.nac_p = getbits(me, 45, 48)
            mm.sil = getbits(me, 51, 52)
            mm.sil_type = SilType.UNKNOWN if v == 1 else (
                SilType.PER_SAMPLE if getbit(me, 55) else SilType.PER_HOUR
            )
            mm.opstatus_hrd = HeadingType.MAGNETIC if getbit(me, 54) else HeadingType.TRUE
            if mm.mesub == 0:
                mm.nic_baro = getbit(me, 53)
                if v == 2:
                    mm.gva = getbits(me, 49, 50)
            else:
                mm.opstatus_tah = mm.opstatus_hrd if getbit(me, 53) else HeadingType.GROUND_TRACK
            if v == 2:
                if getbits(me, 25, 26) == 0:
                    mm.sda = getbits(me, 31, 32)
                if mm.mesub == 1 and getbits(me, 9, 10) == 0:
                    mm.nac_v = getbits(me, 17, 19)
                    mm.nic_c = getbit(me, 20)


def _decode_extended_squitter(mm: ModesMessage) -> None:
    me = mm.ME
    metype = mm.metype = getbits(me, 1, 5)
    check_imf = False

    if mm.msgtype == 18:
        cf = mm.CF
        if cf == 0:
            mm.addrtype = AddrType.ADSB_ICAO_NT
        elif cf == 1:
            mm.addrtype = AddrType.ADSB_OTHER
            mm.addr |= MODES_NON_ICAO_ADDRESS
        elif cf == 2:
            mm.source = Source.TISB
            mm.addrtype = AddrType.TISB_ICAO
            check_imf = True
        elif cf == 3:
            mm.source = Source.TISB
            mm.addrtype = AddrType.TISB_ICAO
            if getbit(me, 1):
                _set_imf(mm)
            return
        elif cf == 5:
            mm.addrtype = AddrType.TISB_OTHER
            mm.source = Source.TISB
            mm.addr |= MODES_NON_ICAO_ADDRESS
        elif cf == 6:
            mm.addrtype = AddrType.ADSR_ICAO
            mm.source = Source.ADSR
            check_imf = True
        else:
            mm.addrtype = AddrType.UNKNOWN
            mm.addr |= MODES_NON_ICAO_ADDRESS
            return

    if metype in (1, 2, 3, 4):
        _decode_es_ident(mm, me)
    elif metype == 19:
        _decode_es_velocity(mm, me, check_imf)
    elif metype in (5, 6, 7, 8):
        _decode_es_surface(mm, me, check_imf)
    elif metype == 0 or (9 <= metype <= 18) or metype in (20, 21, 22):
        _decode_es_airborne(mm, me, check_imf)
    elif metype == 23:
        _decode_es_test(mm, me)
    elif metype == 28:
        _decode_es_aircraft_status(mm, me, check_imf)
    elif metype == 29:
        _decode_es_target_status(mm, me, check_imf)
    elif metype == 31:
        _decode_es_opstatus(mm, me, check_imf)


def decode_frame(frame: RawFrame, epoch_ms: int = 0) -> ModesMessage:
    """RawFrame (accepted by the demod finalizer) -> fully decoded message."""
    msg = frame.msg
    mm = ModesMessage(
        msg=msg,
        msgbits=frame.msgbits,
        msgtype=msg[0] >> 3,
        timestamp=frame.timestamp,
        sys_timestamp_ms=epoch_ms + frame.timestamp // 12000,
        score=frame.score,
        correctedbits=frame.correctedbits,
        addr=frame.addr,
        iid=frame.iid,
        signal_level=frame.signal_power,
    )
    mt = mm.msgtype

    # mm.crc semantics (mode_s.c:455-470): DF11/17/18 carry the syndrome
    # (zero iff the frame checked clean; the exact pre-fix syndrome is not
    # retained here — only crc == 0 is consumed, by updateAltitude's
    # implicit-trust rule); DF0/4/5/16/20/21 carry the residual (= address)
    if mt in (17, 18):
        mm.crc = 0 if frame.correctedbits == 0 else 1
    elif mt == 11:
        mm.crc = frame.iid if frame.correctedbits == 0 else 1
    else:
        mm.crc = frame.addr & 0xFFFFFF

    # source/addrtype by DF (CRC stage already validated acceptance)
    if mt in (0, 4, 5, 16, 20, 21) or 24 <= mt <= 31:
        mm.source = Source.MODE_S
        mm.addrtype = AddrType.MODE_S
    elif mt == 11:
        mm.source = Source.MODE_S_CHECKED
        mm.addrtype = AddrType.MODE_S
    elif mt in (17, 18):
        mm.source = Source.ADSB
        mm.addrtype = AddrType.ADSB_ICAO

    # AC altitude
    if mt in (0, 4, 16, 20):
        mm.AC = getbits(msg, 20, 32)
        if mm.AC:
            alt, unit, q = decode_ac13(mm.AC)
            if alt is not None:
                mm.alt_q_bit = q
                mm.baro_alt = alt
                mm.baro_alt_unit = unit

    # CA
    if mt in (11, 17):
        mm.CA = getbits(msg, 6, 8)
        mm.airground = {
            0: AirGround.UNCERTAIN,
            4: AirGround.GROUND,
            5: AirGround.AIRBORNE,
            6: AirGround.UNCERTAIN,
            7: AirGround.UNCERTAIN,
        }.get(mm.CA, AirGround.UNCERTAIN)

    if mt == 0:
        mm.CC = getbit(msg, 7)
    if mt == 18:
        mm.CF = getbits(msg, 6, 8)
    if mt in (4, 5, 20, 21):
        mm.DR = getbits(msg, 9, 13)
        mm.FS = getbits(msg, 6, 8)
        mm.alert_valid = True
        mm.spi_valid = True
        fs = mm.FS
        if fs == 0:
            mm.airground = AirGround.UNCERTAIN
        elif fs == 1:
            mm.airground = AirGround.GROUND
        elif fs == 2:
            mm.airground = AirGround.UNCERTAIN
            mm.alert = True
        elif fs == 3:
            mm.airground = AirGround.GROUND
            mm.alert = True
        elif fs == 4:
            mm.airground = AirGround.UNCERTAIN
            mm.alert = True
            mm.spi = True
        elif fs == 5:
            mm.airground = AirGround.UNCERTAIN
            mm.spi = True
        else:
            mm.spi_valid = False
            mm.alert_valid = False
        mm.UM = getbits(msg, 14, 19)
        if mm.alert is None:
            mm.alert = False
        if mm.spi is None:
            mm.spi = False

    if mt in (5, 21):
        mm.ID = getbits(msg, 20, 32)
        if mm.ID:
            mm.squawk_hex = decode_id13(mm.ID)

    if mt in (20, 21):
        mm.MB = msg[4:11]
        from . import comm_b

        comm_b.decode(mm)

    if mt in (17, 18):
        mm.ME = msg[4:11]
        _decode_extended_squitter(mm)

    if mt == 16:
        mm.MV = msg[4:11]
        if mm.MV[0] == 0x30:
            mm.acas_ra_valid = True

    if mt in (0, 16):
        mm.RI = getbits(msg, 14, 17)
        mm.SL = getbits(msg, 9, 11)
        mm.VS = getbit(msg, 6)
        mm.airground = AirGround.GROUND if mm.VS else AirGround.UNCERTAIN

    return mm
