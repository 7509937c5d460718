"""UAT (978 MHz) downlink ingest: decode + re-encode as synthetic DF18.

The reference vendors dump978's decoder and a DF18 re-encoder
(`uat2esnt/uat_decode.c`, `uat2esnt/uat2esnt.c`) and feeds dump978 raw
text lines through it (`decodeUatMessage`, net_io.c:4334-4371). Each UAT
ADS-B "message data block" (MDB) is unpacked (HDR/SV/MS/AUXSV sections,
uat_decode.c:25-455) and re-emitted as up to four synthetic DF18
extended squitters (surface position, airborne position even+odd,
velocity, ident/squawk; uat2esnt.c:274-687) which then flow through the
normal Mode-S decode path with a magic timestamp marking them as UAT.

This implementation is host control-plane code: UAT feeds are a few
messages per second, so plain-int bit packing is the right tool (the
Mode-S hot path stays on device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, Optional

import numpy as np

from ..decode.cpr import encode_cpr
from ..ops import crc as crc_ops

# dump978 frame sizes (uat2esnt/uat.h:23-31)
SHORT_FRAME_DATA_BYTES = 18
LONG_FRAME_DATA_BYTES = 34

# 6-byte pseudo-timestamp marking synthetic UAT messages on the raw wire
# (uat2esnt.c:660; == readsb.h:345 MAGIC_UAT_TIMESTAMP)
from ..constants import MAGIC_UAT_TIMESTAMP  # noqa: E402

_BASE40 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ  .."
_AIS_CHARSET = "@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_ !\"#$%&'()*+,-./0123456789:;<=>?"

# airground_state values (uat_decode.h:34)
AG_SUBSONIC, AG_SUPERSONIC, AG_GROUND, AG_RESERVED = 0, 1, 2, 3
# altitude types
ALT_INVALID, ALT_BARO, ALT_GEO = 0, 1, 2
# track types
TT_INVALID, TT_TRACK, TT_MAG_HEADING, TT_TRUE_HEADING = 0, 1, 2, 3
# callsign content
CS_INVALID, CS_CALLSIGN, CS_SQUAWK = 0, 1, 2
# address qualifiers (uat_decode.h:31)
AQ_ADSB_ICAO, AQ_NATIONAL, AQ_TISB_ICAO, AQ_TISB_OTHER, AQ_VEHICLE = 0, 1, 2, 3, 4


@dataclasses.dataclass
class UatMdb:
    """Decoded UAT ADS-B message data block (uat_decode.h:40-130)."""

    mdb_type: int = 0
    address_qualifier: int = 0
    address: int = 0

    has_sv: bool = False
    has_ms: bool = False
    has_auxsv: bool = False

    position_valid: bool = False
    lat: float = 0.0
    lon: float = 0.0
    altitude_type: int = ALT_INVALID
    altitude: int = 0
    nic: int = 0
    airground_state: int = AG_RESERVED

    ns_vel_valid: bool = False
    ns_vel: int = 0
    ew_vel_valid: bool = False
    ew_vel: int = 0
    track_type: int = TT_INVALID
    track: int = 0
    speed_valid: bool = False
    speed: int = 0
    vert_rate_source: int = ALT_INVALID
    vert_rate: int = 0

    dimensions_valid: bool = False
    length_m: float = 0.0
    width_m: float = 0.0
    position_offset: bool = False
    utc_coupled: bool = False
    tisb_site_id: int = 0

    emitter_category: int = 0
    callsign_type: int = CS_INVALID
    callsign: str = ""
    emergency_status: int = 0
    uat_version: int = 0
    sil: int = 0
    transmit_mso: int = 0
    nac_p: int = 0
    nac_v: int = 0
    nic_baro: int = 0

    sec_altitude_type: int = ALT_INVALID
    sec_altitude: int = 0


_DIM_WIDTHS = [11.5, 23, 28.5, 34, 33, 38, 39.5, 45, 45, 52, 59.5, 67, 72.5, 80, 80, 90]


def _decode_sv(f: bytes, m: UatMdb) -> None:
    """State vector section (uat_decode.c:58-172)."""
    m.has_sv = True
    m.nic = f[11] & 15

    raw_lat = (f[4] << 15) | (f[5] << 7) | (f[6] >> 1)
    raw_lon = ((f[6] & 1) << 23) | (f[7] << 15) | (f[8] << 7) | (f[9] >> 1)
    if m.nic != 0 or raw_lat != 0 or raw_lon != 0:
        m.position_valid = True
        m.lat = raw_lat * 360.0 / 16777216.0
        if m.lat > 90:
            m.lat -= 180
        m.lon = raw_lon * 360.0 / 16777216.0
        if m.lon > 180:
            m.lon -= 360

    raw_alt = (f[10] << 4) | ((f[11] & 0xF0) >> 4)
    if raw_alt != 0:
        m.altitude_type = ALT_GEO if (f[9] & 1) else ALT_BARO
        m.altitude = (raw_alt - 1) * 25 - 1000

    m.airground_state = (f[12] >> 6) & 0x03
    if m.airground_state in (AG_SUBSONIC, AG_SUPERSONIC):
        raw_ns = ((f[12] & 0x1F) << 6) | ((f[13] & 0xFC) >> 2)
        if (raw_ns & 0x3FF) != 0:
            m.ns_vel_valid = True
            m.ns_vel = (raw_ns & 0x3FF) - 1
            if raw_ns & 0x400:
                m.ns_vel = -m.ns_vel
            if m.airground_state == AG_SUPERSONIC:
                m.ns_vel *= 4
        raw_ew = ((f[13] & 0x03) << 9) | (f[14] << 1) | ((f[15] & 0x80) >> 7)
        if (raw_ew & 0x3FF) != 0:
            m.ew_vel_valid = True
            m.ew_vel = (raw_ew & 0x3FF) - 1
            if raw_ew & 0x400:
                m.ew_vel = -m.ew_vel
            if m.airground_state == AG_SUPERSONIC:
                m.ew_vel *= 4
        if m.ns_vel_valid and m.ew_vel_valid:
            if m.ns_vel != 0 or m.ew_vel != 0:
                m.track_type = TT_TRACK
                m.track = int(360 + 90 - math.atan2(m.ns_vel, m.ew_vel) * 180 / math.pi) % 360
            m.speed_valid = True
            m.speed = int(math.sqrt(m.ns_vel * m.ns_vel + m.ew_vel * m.ew_vel))
        raw_vvel = ((f[15] & 0x7F) << 4) | ((f[16] & 0xF0) >> 4)
        if (raw_vvel & 0x1FF) != 0:
            m.vert_rate_source = ALT_BARO if (raw_vvel & 0x400) else ALT_GEO
            m.vert_rate = ((raw_vvel & 0x1FF) - 1) * 64
            if raw_vvel & 0x200:
                m.vert_rate = -m.vert_rate
    elif m.airground_state == AG_GROUND:
        raw_gs = ((f[12] & 0x1F) << 6) | ((f[13] & 0xFC) >> 2)
        if raw_gs != 0:
            m.speed_valid = True
            m.speed = (raw_gs & 0x3FF) - 1
        raw_track = ((f[13] & 0x03) << 9) | (f[14] << 1) | ((f[15] & 0x80) >> 7)
        tt = (raw_track & 0x0600) >> 9
        if tt == 1:
            m.track_type = TT_TRACK
        elif tt == 2:
            m.track_type = TT_MAG_HEADING
        elif tt == 3:
            m.track_type = TT_TRUE_HEADING
        if m.track_type != TT_INVALID:
            m.track = (raw_track & 0x1FF) * 360 // 512
        m.dimensions_valid = True
        m.length_m = 15 + 10 * ((f[15] & 0x38) >> 3)
        m.width_m = _DIM_WIDTHS[(f[15] & 0x78) >> 3]
        m.position_offset = bool(f[15] & 0x04)

    if (f[0] & 7) in (2, 3):  # TIS-B site id present for TIS-B addresses
        m.utc_coupled = False
        m.tisb_site_id = f[16] & 0x0F
    else:
        m.utc_coupled = bool(f[16] & 0x08)
        m.tisb_site_id = 0


def _decode_ms(f: bytes, m: UatMdb) -> None:
    """Mode-status section: base-40 callsign + quality (uat_decode.c:271-313)."""
    m.has_ms = True
    v = (f[17] << 8) | f[18]
    m.emitter_category = (v // 1600) % 40
    cs = [_BASE40[(v // 40) % 40], _BASE40[v % 40]]
    v = (f[19] << 8) | f[20]
    cs += [_BASE40[(v // 1600) % 40], _BASE40[(v // 40) % 40], _BASE40[v % 40]]
    v = (f[21] << 8) | f[22]
    cs += [_BASE40[(v // 1600) % 40], _BASE40[(v // 40) % 40], _BASE40[v % 40]]
    m.callsign = "".join(cs).rstrip()
    m.emergency_status = (f[23] >> 5) & 7
    m.uat_version = (f[23] >> 2) & 7
    m.sil = f[23] & 3
    m.transmit_mso = (f[24] >> 2) & 0x3F
    m.nac_p = (f[25] >> 4) & 15
    m.nac_v = (f[25] >> 1) & 7
    m.nic_baro = f[25] & 1
    if m.callsign:
        m.callsign_type = CS_CALLSIGN if (f[26] & 0x02) else CS_SQUAWK


def _decode_auxsv(f: bytes, m: UatMdb) -> None:
    """Auxiliary SV: secondary altitude (uat_decode.c:405-415)."""
    m.has_auxsv = True
    raw_alt = (f[29] << 4) | ((f[30] & 0xF0) >> 4)
    if raw_alt != 0:
        m.sec_altitude = (raw_alt - 1) * 25 - 1000
        m.sec_altitude_type = ALT_BARO if (f[9] & 1) else ALT_GEO
    else:
        m.sec_altitude_type = ALT_INVALID


def decode_adsb_mdb(frame: bytes) -> UatMdb:
    """Dispatch on MDB type (uat_decode.c:445-484)."""
    m = UatMdb()
    m.mdb_type = (frame[0] >> 3) & 0x1F
    m.address_qualifier = frame[0] & 0x07
    m.address = (frame[1] << 16) | (frame[2] << 8) | frame[3]
    t = m.mdb_type
    if t in (0, 4, 7, 8, 9, 10):
        _decode_sv(frame, m)
    elif t == 1:
        _decode_sv(frame, m)
        _decode_ms(frame, m)
        _decode_auxsv(frame, m)
    elif t in (2, 5, 6):
        _decode_sv(frame, m)
        _decode_auxsv(frame, m)
    elif t == 3:
        _decode_sv(frame, m)
        _decode_ms(frame, m)
    return m


# ---------------------------------------------------------------------------
# DF18 synthesis
# ---------------------------------------------------------------------------


def _setbits(frame: bytearray, base: int, first: int, last: int, value: int) -> None:
    """Set bits [first..last] (1-indexed, MSB-first) of frame[base:]."""
    nbits = last - first + 1
    for i in range(nbits):
        bit = first + i  # 1-indexed position
        byte = base + (bit - 1) // 8
        shift = 7 - ((bit - 1) % 8)
        if (value >> (nbits - 1 - i)) & 1:
            frame[byte] |= 1 << shift
        else:
            frame[byte] &= ~(1 << shift)


def _encode_altitude_ac12(ft: int) -> int:
    """25 ft AC12 with Q bit (uat2esnt.c:70-79)."""
    i = (ft + 1000) // 25
    i = max(0, min(i, 0x7FF))
    return (i & 0x000F) | 0x0010 | ((i & 0x07F0) << 1)


def _encode_movement(kt: int) -> int:
    """7-bit surface movement field (uat2esnt.c:81-98)."""
    if kt > 175:
        return 124
    if kt > 100:
        return (kt - 100) // 5 + 108
    if kt > 70:
        return (kt - 70) // 2 + 93
    if kt > 15:
        return (kt - 15) + 38
    if kt > 2:
        return (kt - 2) * 2 + 11
    if kt == 2:
        return 12
    if kt == 1:
        return 8
    return 1


def _encode_air_speed(kt: int, supersonic: bool) -> int:
    sign = 0x0400 if kt < 0 else 0
    kt = abs(kt)
    if supersonic:
        kt //= 4
    return min(kt + 1, 1023) | sign


def _encode_vert_rate(rate: int) -> int:
    sign = 0x200 if rate < 0 else 0
    return min(abs(rate) // 64 + 1, 511) | sign


def _encode_cf(m: UatMdb) -> int:
    """DF18 CF field by address qualifier (uat2esnt.c:242-257)."""
    if m.address_qualifier == AQ_ADSB_ICAO:
        return 6  # ADS-B rebroadcast (ADS-R)
    if m.address_qualifier in (AQ_TISB_ICAO, AQ_TISB_OTHER):
        return 2  # fine TIS-B
    return 1  # non-ICAO addressing


def _encode_imf(m: UatMdb) -> int:
    return 0 if m.address_qualifier in (AQ_ADSB_ICAO, AQ_TISB_ICAO) else 1


def _finish(frame: bytearray) -> bytes:
    """Append CRC-24 parity so the frame has syndrome 0."""
    frame[11] = frame[12] = frame[13] = 0
    rem = crc_ops.checksum(bytes(frame), 112)
    frame[11] = (rem >> 16) & 0xFF
    frame[12] = (rem >> 8) & 0xFF
    frame[13] = rem & 0xFF
    return bytes(frame)


def _df18_header(m: UatMdb) -> bytearray:
    frame = bytearray(14)
    _setbits(frame, 0, 1, 5, 18)
    _setbits(frame, 0, 6, 8, _encode_cf(m))
    _setbits(frame, 0, 9, 32, m.address)
    return frame


def _send_altitude_only(m: UatMdb) -> bytes:
    """TC=0 baro altitude, no position (uat2esnt.c:274-304)."""
    if m.altitude_type == ALT_BARO:
        raw_alt = _encode_altitude_ac12(m.altitude)
    elif m.sec_altitude_type == ALT_BARO:
        raw_alt = _encode_altitude_ac12(m.sec_altitude)
    else:
        raw_alt = 0
    frame = _df18_header(m)
    _setbits(frame, 4, 1, 5, 0)
    _setbits(frame, 4, 8, 8, _encode_imf(m))
    _setbits(frame, 4, 9, 20, raw_alt)
    return _finish(frame)


def _send_surface_position(m: UatMdb) -> List[bytes]:
    """TC=8 surface position, even+odd pair (uat2esnt.c:306-349)."""
    out = []
    frame = _df18_header(m)
    _setbits(frame, 4, 1, 5, 8)
    if m.speed_valid:
        _setbits(frame, 4, 6, 12, _encode_movement(m.speed))
    if m.track_type == TT_TRACK:
        _setbits(frame, 4, 13, 13, 1)
        _setbits(frame, 4, 14, 20, m.track * 128 // 360)
    _setbits(frame, 4, 21, 21, _encode_imf(m))
    for odd in (0, 1):
        _setbits(frame, 4, 22, 22, odd)
        _setbits(frame, 4, 23, 39, encode_cpr(m.lat, m.lon, odd, surface=True)[0])
        _setbits(frame, 4, 40, 56, encode_cpr(m.lat, m.lon, odd, surface=True)[1])
        out.append(_finish(bytearray(frame)))
    return out


def _send_air_position(m: UatMdb) -> List[bytes]:
    """TC=18/22 airborne position, even+odd pair (uat2esnt.c:350-403)."""
    if not m.position_valid:
        return [_send_altitude_only(m)]
    frame = _df18_header(m)
    if m.altitude_type == ALT_GEO:
        _setbits(frame, 4, 1, 5, 22)
        raw_alt = _encode_altitude_ac12(m.altitude)
    else:
        _setbits(frame, 4, 1, 5, 18)
        raw_alt = _encode_altitude_ac12(m.altitude) if m.altitude_type == ALT_BARO else 0
    _setbits(frame, 4, 8, 8, _encode_imf(m))
    _setbits(frame, 4, 9, 20, raw_alt)
    out = []
    for odd in (0, 1):
        _setbits(frame, 4, 22, 22, odd)
        yz, xz = encode_cpr(m.lat, m.lon, odd, surface=False)
        _setbits(frame, 4, 23, 39, yz)
        _setbits(frame, 4, 40, 56, xz)
        out.append(_finish(bytearray(frame)))
    return out


def _send_air_velocity(m: UatMdb) -> List[bytes]:
    """TC=19 airborne velocity (uat2esnt.c:405-488)."""
    if not m.ew_vel_valid and not m.ns_vel_valid and m.vert_rate_source == ALT_INVALID:
        return []
    supersonic = m.airground_state == AG_SUPERSONIC
    frame = _df18_header(m)
    _setbits(frame, 4, 1, 5, 19)
    _setbits(frame, 4, 6, 8, 2 if supersonic else 1)
    _setbits(frame, 4, 9, 9, _encode_imf(m))
    if m.ew_vel_valid:
        _setbits(frame, 4, 14, 24, _encode_air_speed(m.ew_vel, supersonic))
    if m.ns_vel_valid:
        _setbits(frame, 4, 25, 35, _encode_air_speed(m.ns_vel, supersonic))
    if m.vert_rate_source in (ALT_BARO, ALT_GEO):
        _setbits(frame, 4, 36, 36, 0 if m.vert_rate_source == ALT_BARO else 1)
        _setbits(frame, 4, 37, 46, _encode_vert_rate(m.vert_rate))
    if m.altitude_type != ALT_INVALID and m.sec_altitude_type != ALT_INVALID:
        if m.altitude < m.sec_altitude:
            delta = m.sec_altitude - m.altitude
            sign = 0 if m.altitude_type == ALT_BARO else 1
        else:
            delta = m.altitude - m.sec_altitude
            sign = 1 if m.altitude_type == ALT_BARO else 0
        delta = min(delta // 25 + 1, 127)
        _setbits(frame, 4, 49, 49, sign)
        _setbits(frame, 4, 50, 56, delta)
    return [_finish(frame)]


_SQUAWK_EMERGENCY = {"7500": 5, "7600": 4, "7700": 1}


def _encode_gillham_squawk(squawk: str) -> int:
    """4-digit octal squawk → 13-bit interleaved ID field (uat2esnt.c:509-531)."""
    try:
        s = int(squawk, 16)
    except ValueError:
        s = 0
    e = 0
    if s & 0x1000:
        e |= 0x0800
    if s & 0x2000:
        e |= 0x0200
    if s & 0x4000:
        e |= 0x0080
    if s & 0x0100:
        e |= 0x0020
    if s & 0x0200:
        e |= 0x0008
    if s & 0x0400:
        e |= 0x0002
    if s & 0x0010:
        e |= 0x1000
    if s & 0x0020:
        e |= 0x0400
    if s & 0x0040:
        e |= 0x0100
    if s & 0x0001:
        e |= 0x0010
    if s & 0x0002:
        e |= 0x0004
    if s & 0x0004:
        e |= 0x0001
    return e


def _send_identity(m: UatMdb) -> List[bytes]:
    """TC=1..4 ident or TC=28 emergency/squawk (uat2esnt.c:543-650)."""
    if m.callsign_type == CS_CALLSIGN:
        if _encode_imf(m):
            return []  # not sent with non-ICAO addresses
        frame = _df18_header(m)
        cat = m.emitter_category
        if cat <= 7:
            _setbits(frame, 4, 1, 5, 4)
            _setbits(frame, 4, 6, 8, cat & 7)
        elif cat <= 15:
            _setbits(frame, 4, 1, 5, 3)
            _setbits(frame, 4, 6, 8, cat & 7)
        elif cat <= 23:
            _setbits(frame, 4, 1, 5, 2)
            _setbits(frame, 4, 6, 8, cat & 7)
        elif cat <= 31:
            _setbits(frame, 4, 1, 5, 1)
            _setbits(frame, 4, 6, 8, cat & 7)
        else:
            _setbits(frame, 4, 1, 5, 4)
        cs = (m.callsign + "        ")[:8]
        for i, ch in enumerate(cs):
            code = _AIS_CHARSET.find(ch)
            if code < 0:
                code = 32
            _setbits(frame, 4, 9 + 6 * i, 14 + 6 * i, code)
        return [_finish(frame)]
    if m.callsign_type == CS_SQUAWK:
        frame = _df18_header(m)
        _setbits(frame, 4, 1, 5, 28)
        _setbits(frame, 4, 6, 8, 1)
        _setbits(frame, 4, 9, 11, _SQUAWK_EMERGENCY.get(m.callsign, 0))
        _setbits(frame, 4, 12, 24, _encode_gillham_squawk(m.callsign))
        _setbits(frame, 4, 56, 56, _encode_imf(m))
        return [_finish(frame)]
    return []


def mdb_to_esnt(m: UatMdb, use_tisb: bool = True) -> List[bytes]:
    """Synthesize the DF18 frame set for one MDB (generate_esnt, uat2esnt.c:679-697)."""
    if not m.address:
        return []
    if m.address_qualifier in (AQ_TISB_ICAO, AQ_TISB_OTHER) and not use_tisb:
        return []
    # all other qualifiers (self-assigned, vehicles, beacons) are forwarded
    # with CF=1/IMF=1 — should_send() returns 1 by default (uat2esnt.c)
    out: List[bytes] = []
    if m.airground_state == AG_GROUND and m.position_valid:
        out += _send_surface_position(m)
    if m.airground_state in (AG_SUBSONIC, AG_SUPERSONIC):
        out += _send_air_position(m)
        out += _send_air_velocity(m)
    out += _send_identity(m)
    return out


def signal_byte_from_rssi(rssi_db: float) -> int:
    """dump978 rssi (dB) → beast-style amplitude byte (uat2esnt.c:681-689)."""
    ss_w = 10.0 ** (rssi_db / 10.0)
    sig = round(math.sqrt(ss_w) * 255.0)
    if ss_w > 0 and sig < 1:
        sig = 1
    return min(sig, 255)


def convert_line(line: bytes) -> tuple[List[bytes], int]:
    """One dump978 raw text line → (DF18 frames, signal byte).

    Lines look like `-A3BFE0C18...;rs=3;rssi=-12.3;` — `-` marks downlink
    frames, `+` uplink (ignored); uat2esnt.c:197-258.
    """
    line = line.strip()
    if not line.startswith(b"-"):
        return [], 0
    body = line[1:]
    semi = body.find(b";")
    hexpart = body[:semi] if semi >= 0 else body
    rssi = 0.0
    if semi >= 0:
        for kv in body[semi + 1 :].split(b";"):
            if kv.startswith(b"rssi="):
                try:
                    rssi = float(kv[5:])
                except ValueError:
                    pass
            elif kv.startswith(b"ss="):
                try:
                    rssi = float(kv[3:])
                except ValueError:
                    pass
    return _convert_hex(hexpart), signal_byte_from_rssi(rssi)


def _convert_hex(hexpart: bytes) -> List[bytes]:
    try:
        frame = bytes.fromhex(hexpart.decode())
    except ValueError:
        return []
    if len(frame) < SHORT_FRAME_DATA_BYTES:
        return []
    # the reference decodes into a fixed oversized buffer, so a short
    # (18-byte) frame whose MDB-type bits claim a long layout reads zero
    # padding instead of raising; replicate with explicit padding
    if len(frame) < LONG_FRAME_DATA_BYTES:
        frame = frame + bytes(LONG_FRAME_DATA_BYTES - len(frame))
    m = decode_adsb_mdb(frame)
    return mdb_to_esnt(m)


def format_esnt_line(frame: bytes, signal: int) -> bytes:
    """`<TTTTTTTTTTTTSS<hex>;` raw line with the UAT magic timestamp."""
    return (
        b"<"
        + format(MAGIC_UAT_TIMESTAMP, "012X").encode()
        + format(signal & 0xFF, "02X").encode()
        + frame.hex().upper().encode()
        + b";\n"
    )
