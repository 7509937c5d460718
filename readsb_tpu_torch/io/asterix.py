"""ASTERIX CAT021 (ADS-B target reports) encode/decode.

Wire behavior mirrors the reference (net_io.c:2416-2951 encoder,
net_io.c:1922-2415 decoder): frames are CAT byte + 16-bit length +
variable-length FSPEC + UAP items.  The encoder emits the same item set
and scalings as the reference so downstream ASTERIX consumers are
interchangeable:

  I021/010 SAC/SIC            I021/040 target report descriptor
  I021/130 position 1e-23deg  I021/150 air speed (IAS/Mach)
  I021/151 TAS                I021/080 target address
  I021/073 time of position   I021/075 time of velocity
  I021/140 geometric height   I021/090 quality indicators
  I021/210 MOPS version       I021/070 mode 3/A code
  I021/230 roll               I021/145 flight level (/25 ft)
  I021/152 magnetic heading   I021/200 target status
  I021/155 baro vertical rate I021/157 geom vertical rate
  I021/160 ground vector      I021/077 time of report
  I021/170 target ident (AIS) I021/020 emitter category
  I021/220 met (wind/temp)    I021/146 selected altitude
  I021/400 receiver ID
"""

from __future__ import annotations

import math
import time
from typing import Iterator, Optional

from ..decode.ais import AIS_CHARSET
from ..decode.fields import (
    AddrType,
    AirGround,
    HeadingType,
    MODES_NON_ICAO_ADDRESS,
    ModesMessage,
    SilType,
    Source,
)


def _char_to_ais(ch: str) -> int:
    i = AIS_CHARSET.find(ch)
    return i if i >= 0 else 32


def _read_fspec(data: bytes, pos: int) -> tuple[list[int], int]:
    """Variable-length FSPEC: FX bit (lsb) continues."""
    out = []
    while pos < len(data):
        b = data[pos]
        out.append(b)
        pos += 1
        if not (b & 1):
            break
    return out, pos


def _ts_of_day(ms_since_epoch: int) -> int:
    """Time of day in 1/128 s units (the encoder's 0.128/ms factor)."""
    midnight = (ms_since_epoch // 86400000) * 86400000
    return int((ms_since_epoch - midnight) * 0.128)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode_cat21(mm: ModesMessage, now_ms: Optional[int] = None,
                 baro_alt_hint: Optional[int] = None) -> bytes:
    """modesSendAsterixOutput (net_io.c:2416-2944)."""
    if now_ms is None:
        now_ms = int(time.time() * 1000)
    fspec = [0] * 7
    b = bytearray()

    # I021/010
    fspec[0] |= 1 << 7
    b += bytes([0, 1])

    # I021/040 target report descriptor
    fspec[0] |= 1 << 6
    trd0 = 0
    trd1 = 0
    if mm.addr & MODES_NON_ICAO_ADDRESS:
        trd0 |= 3 << 5
    elif mm.addrtype in (AddrType.ADSB_OTHER, AddrType.TISB_OTHER, AddrType.ADSR_OTHER):
        trd0 |= 2 << 5
    if mm.alt_q_bit == 0:
        trd0 |= 1 << 3
    if mm.airground == AirGround.GROUND:
        trd1 |= 1 << 6
    if trd1:
        trd0 |= 1
        b += bytes([trd0, trd1])
    else:
        b += bytes([trd0])

    has_pos = mm.cpr_decoded or mm.sbs_pos_valid
    if has_pos:
        fspec[0] |= 1 << 2
        lat = int(mm.decoded_lat / (180 / 2**23))
        lon = int(mm.decoded_lon / (180 / 2**23))
        if lat < 0:
            lat += 0x1000000
        if lon < 0:
            lon += 0x1000000
        b += lat.to_bytes(3, "big") + lon.to_bytes(3, "big")

    # I021/150 air speed
    if mm.ias is not None or mm.mach is not None:
        fspec[1] |= 1 << 6
        if mm.mach is not None:
            val = (1 << 15) | (int(mm.mach * 1000) & 0x7FFF)
        else:
            val = int((mm.ias / 3600.0) * 2**14) & 0x7FFF
        b += val.to_bytes(2, "big")

    # I021/151 TAS
    if mm.tas is not None:
        fspec[1] |= 1 << 5
        b += (mm.tas & 0x7FFF).to_bytes(2, "big")

    # I021/080 target address
    fspec[1] |= 1 << 4
    b += (mm.addr & 0xFFFFFF).to_bytes(3, "big")

    # I021/073 time of message reception of position
    if has_pos:
        fspec[1] |= 1 << 3
        b += (_ts_of_day(mm.sys_timestamp_ms or now_ms) & 0xFFFFFF).to_bytes(3, "big")

    gs_vector = (
        mm.gs_selected is not None and mm.heading is not None
        and mm.heading_type == HeadingType.GROUND_TRACK
    )
    # I021/075 time of message reception of velocity
    if gs_vector:
        fspec[1] |= 1 << 1
        b += (_ts_of_day(mm.sys_timestamp_ms or now_ms) & 0xFFFFFF).to_bytes(3, "big")

    # I021/140 geometric height
    if mm.geom_alt is not None:
        fspec[2] |= 1 << 6
        alt = int(mm.geom_alt / 6.25) & 0xFFFF
        b += alt.to_bytes(2, "big")
    elif mm.geom_delta is not None and baro_alt_hint is not None:
        fspec[2] |= 1 << 6
        alt = int((baro_alt_hint + mm.geom_delta) / 6.25) & 0xFFFF
        b += alt.to_bytes(2, "big")

    # I021/090 quality indicators
    fspec[2] |= 1 << 5
    q0 = q1 = q2 = 0
    if mm.nac_v is not None:
        q0 |= (mm.nac_v & 7) << 5
    if mm.cpr_decoded:
        q0 |= (mm.decoded_nic & 0xF) << 1
    if mm.nic_baro is not None:
        q1 |= (mm.nic_baro & 1) << 7
    if mm.sil is not None and mm.sil_type != SilType.INVALID:
        q1 |= (mm.sil & 3) << 5
    if mm.nac_p is not None:
        q1 |= (mm.nac_p & 0xF) << 1
    if mm.sil_type == SilType.PER_SAMPLE:
        q2 |= 1 << 5
    if mm.sda is not None:
        q2 |= (mm.sda & 3) << 3
    if mm.gva is not None:
        q2 |= (mm.gva & 3) << 1
    if q2:
        q1 |= 1
    if q1:
        q0 |= 1
        b.append(q0)
        if q2:
            b.append(q1)
            b.append(q2)
        else:
            b.append(q1)
    else:
        b.append(q0)

    # I021/210 MOPS version
    if mm.opstatus_valid:
        fspec[2] |= 1 << 4
        if mm.source == Source.ADSB or mm.addrtype in (AddrType.ADSB_ICAO, AddrType.ADSB_OTHER):
            v = 2
        elif mm.source == Source.ADSR or mm.addrtype in (AddrType.ADSR_ICAO, AddrType.ADSR_OTHER):
            v = 1
        else:
            v = 0
        b.append(v | ((mm.adsb_version or 0) << 3))

    # I021/070 mode 3/A
    if mm.squawk_hex is not None:
        fspec[2] |= 1 << 3
        s = mm.squawk_hex
        b0 = ((s & 0x7000) >> 11) | ((s & 0x0400) >> 10)
        b1 = ((s & 0x0300) >> 2) | ((s & 0x0070) >> 1) | (s & 0x0007)
        b += bytes([b0, b1])

    # I021/230 roll
    if mm.roll is not None:
        fspec[2] |= 1 << 2
        b += (int(mm.roll * 100) & 0xFFFF).to_bytes(2, "big")

    # I021/145 flight level
    if mm.baro_alt is not None:
        fspec[2] |= 1 << 1
        b += (int(mm.baro_alt / 25) & 0xFFFF).to_bytes(2, "big")

    # I021/152 magnetic heading
    if mm.heading is not None and mm.heading_type == HeadingType.MAGNETIC:
        fspec[3] |= 1 << 7
        b += (int(mm.heading * 182.0444) & 0xFFFF).to_bytes(2, "big")

    # I021/200 target status
    if mm.spi_valid or mm.alert_valid or mm.emergency is not None or mm.nav_modes is not None:
        fspec[3] |= 1 << 6
        ts = 0
        if mm.nav_modes is not None and (mm.nav_modes & 0b10):
            ts |= 1 << 6
        if mm.emergency is not None:
            ts |= (mm.emergency & 7) << 2
        if mm.alert_valid and mm.alert is not None:
            ts |= 1 if mm.alert else 0
        elif mm.spi_valid and mm.spi:
            ts |= 3
        b.append(ts)

    # I021/155 / I021/157 vertical rates (6.25 fpm LSB)
    if mm.baro_rate is not None:
        fspec[3] |= 1 << 5
        v = (int(mm.baro_rate / 3.125) >> 1) & 0x7FFF
        b += v.to_bytes(2, "big")
    if mm.geom_rate is not None:
        fspec[3] |= 1 << 4
        v = (int(mm.geom_rate / 3.125) >> 1) & 0x7FFF
        b += v.to_bytes(2, "big")

    # I021/160 airborne ground vector
    if gs_vector:
        fspec[3] |= 1 << 3
        gs = int(mm.gs_selected * 4.5511) & 0x7FFF
        trk = int(mm.heading * (2**16 / 360.0)) & 0xFFFF
        b += gs.to_bytes(2, "big") + trk.to_bytes(2, "big")

    # I021/077 time of report transmission
    fspec[3] |= 1 << 1
    b += (_ts_of_day(now_ms) & 0xFFFFFF).to_bytes(3, "big")

    # I021/170 target identification
    if mm.callsign_valid and mm.callsign:
        fspec[4] |= 1 << 7
        cs = (mm.callsign + " " * 8)[:8]
        enc = 0
        for ch in cs:
            enc = (enc << 6) | (_char_to_ais(ch) & 0x3F)
        b += enc.to_bytes(6, "big")

    # I021/020 emitter category
    if mm.category is not None:
        fspec[4] |= 1 << 6
        tc = 0x0E - ((mm.category & 0x1F0) >> 4)
        ca = mm.category & 7
        ecat = 0
        if ca:
            table = {
                (2, 1): 20, (2, 3): 21, (2, 4): 22, (2, 5): 22, (2, 6): 22, (2, 7): 22,
                (3, 1): 11, (3, 2): 12, (3, 3): 16, (3, 4): 15, (3, 6): 13, (3, 7): 14,
                (4, 1): 1, (4, 2): 2, (4, 3): 3, (4, 4): 4, (4, 5): 5, (4, 6): 6, (4, 7): 10,
            }
            ecat = table.get((tc, ca), 0)
        b.append(ecat)

    # I021/220 met information
    if mm.wind_speed is not None or mm.oat is not None:
        fspec[4] |= 1 << 5
        sub = 0
        if mm.wind_speed is not None:
            sub |= 0xC0
        if mm.oat is not None:
            sub |= 0x20
        b.append(sub)
        if mm.wind_speed is not None:
            b += (int(mm.wind_speed) & 0xFFFF).to_bytes(2, "big")
            b += (int(mm.wind_dir or 0) & 0xFFFF).to_bytes(2, "big")
        if mm.oat is not None:
            b += (int(mm.oat * 4) & 0xFFFF).to_bytes(2, "big")

    # I021/146 selected altitude
    if mm.nav_fms_altitude is not None or mm.nav_mcp_altitude is not None:
        fspec[4] |= 1 << 4
        if mm.nav_mcp_altitude is not None:
            alt = mm.nav_mcp_altitude
            hdr = 0xC0
        else:
            alt = mm.nav_fms_altitude
            hdr = 0xE0
        alt //= 25
        b += bytes([hdr | ((alt & 0x1F00) >> 8), alt & 0xFF])

    # I021/400 receiver ID
    if mm.receiver_id:
        fspec[5] |= 1 << 2
        b.append(mm.receiver_id & 0xFF)

    # FX chain
    fspec_len = 1
    for i in range(5, -1, -1):
        if fspec[i + 1]:
            fspec[i] |= 1
            fspec_len += 1

    msg_len = len(b) + 3 + fspec_len
    return bytes([21, (msg_len >> 8) & 0xFF, msg_len & 0xFF]) + bytes(fspec[:fspec_len]) + bytes(b)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def decode_cat21(frame: bytes, now_ms: int = 0) -> Optional[ModesMessage]:
    """decodeAsterixMessage (net_io.c:1922-2415), CAT021 branch."""
    if len(frame) < 4 or frame[0] != 21:
        return None
    data = frame
    fspec, pos = _read_fspec(data, 3)
    while len(fspec) < 7:
        fspec.append(0)
    if not (fspec[1] & 0x10):
        return None  # no target address

    mm = ModesMessage()
    mm.source = Source.INDIRECT
    mm.remote = True
    mm.sys_timestamp_ms = now_ms

    def take(n: int) -> bytes:
        nonlocal pos
        out = data[pos:pos + n]
        pos += n
        return out

    def read_time() -> int:
        raw = int.from_bytes(take(3), "big")
        midnight = (now_ms // 86400000) * 86400000 if now_ms else 0
        return midnight + int(raw / 0.128)

    addrtype = 3
    if fspec[0] & 0x80:
        take(2)  # I021/010
    if fspec[0] & 0x40:  # I021/040
        trd, pos = _read_fspec(data, pos)
        addrtype = (trd[0] & 0xE0) >> 5
        if not (trd[0] & 0x18):
            mm.alt_q_bit = 1
        mm.airground = AirGround.GROUND if (len(trd) > 1 and trd[1] & 0x40) else AirGround.AIRBORNE
    if fspec[0] & 0x20:
        take(2)  # track number
    if fspec[0] & 0x10:
        take(1)  # service id
    if fspec[0] & 0x08:  # I021/071 time of applicability
        mm.sys_timestamp_ms = read_time()
    if fspec[0] & 0x04:  # I021/130 position
        lat = int.from_bytes(take(3), "big")
        lon = int.from_bytes(take(3), "big")
        if lat >= 0x800000:
            lat -= 0x1000000
        if lon >= 0x800000:
            lon -= 0x1000000
        latitude = lat * (180 / 2**23)
        longitude = lon * (180 / 2**23)
        if -90 <= latitude <= 90 and -180 <= longitude <= 180:
            mm.sbs_pos_valid = True
            mm.decoded_lat = latitude
            mm.decoded_lon = longitude
    if fspec[0] & 0x02:  # I021/131 high-res position
        lat = int.from_bytes(take(4), "big", signed=False)
        lon = int.from_bytes(take(4), "big", signed=False)
        if lat >= 0x80000000:
            lat -= 0x100000000
        if lon >= 0x80000000:
            lon -= 0x100000000
        latitude = lat * (180 / 2**30)
        longitude = lon * (180 / 2**30)
        if -90 <= latitude <= 90 and -180 <= longitude <= 180:
            mm.sbs_pos_valid = True
            mm.decoded_lat = latitude
            mm.decoded_lon = longitude
    if fspec[1] & 0x80:  # I021/072 time of applicability for velocity
        take(3)
    if fspec[1] & 0x40:  # I021/150 air speed
        raw = int.from_bytes(take(2), "big")
        if raw & 0x8000:
            mm.mach = (raw & 0x7FFF) * 0.001
        else:
            mm.ias = int((raw & 0x7FFF) * 2**-14 * 3600)
    if fspec[1] & 0x20:  # I021/151 TAS
        raw = int.from_bytes(take(2), "big")
        if not (raw & 0x8000):
            mm.tas = raw
    # I021/080 target address (mandatory per our gate)
    mm.addr = int.from_bytes(take(3), "big") & 0xFFFFFF
    if addrtype == 3:
        mm.addr |= MODES_NON_ICAO_ADDRESS
        mm.addrtype = AddrType.ADSB_OTHER
    else:
        mm.addrtype = AddrType.ADSB_ICAO
    if fspec[1] & 0x08:  # I021/073
        ts = read_time()
        if mm.sbs_pos_valid:
            mm.sys_timestamp_ms = ts
        if fspec[1] & 0x04:  # I021/074 high precision
            take(4)
    elif fspec[1] & 0x04:
        take(4)
    if fspec[1] & 0x02:  # I021/075 time of velocity
        take(3)

    if fspec[2] & 0x80:  # I021/076
        take(4)
    if fspec[2] & 0x40:  # I021/140 geometric height
        raw = int.from_bytes(take(2), "big", signed=True)
        mm.geom_alt = int(raw * 6.25)
    if fspec[2] & 0x20:  # I021/090 quality
        q, pos = _read_fspec(data, pos)
        if q:
            mm.nac_v = (q[0] & 0xE0) >> 5
            mm.decoded_nic = (q[0] & 0x1E) >> 1
        if len(q) > 1:
            mm.nic_baro = (q[1] & 0x80) >> 7
            mm.sil = (q[1] & 0x60) >> 5
            mm.nac_p = (q[1] & 0x1E) >> 1
        if len(q) > 2:
            mm.sil_type = SilType.PER_SAMPLE if q[2] & 0x20 else SilType.PER_HOUR
            mm.sda = (q[2] & 0x18) >> 3
            mm.gva = (q[2] & 0x06) >> 1
    if fspec[2] & 0x10:  # I021/210 MOPS
        v = take(1)[0]
        mm.opstatus_valid = True
        mm.adsb_version = (v >> 3) & 7
    if fspec[2] & 0x08:  # I021/070 mode 3/A
        raw = int.from_bytes(take(2), "big")
        s = (
            ((raw & 0x0E00) << 3) | ((raw & 0x0100) << 2)
            | ((raw & 0x00C0) << 2) | ((raw & 0x0038) << 1) | (raw & 0x0007)
        )
        mm.squawk_hex = s
    if fspec[2] & 0x04:  # I021/230 roll
        mm.roll = int.from_bytes(take(2), "big", signed=True) / 100.0
    if fspec[2] & 0x02:  # I021/145 flight level
        mm.baro_alt = int.from_bytes(take(2), "big", signed=True) * 25

    if fspec[3] & 0x80:  # I021/152 magnetic heading
        mm.heading = int.from_bytes(take(2), "big") / 182.0444
        mm.heading_type = HeadingType.MAGNETIC
    if fspec[3] & 0x40:  # I021/200 target status
        ts = take(1)[0]
        mm.emergency = (ts >> 2) & 7
        lowbits = ts & 3
        if lowbits == 3:
            mm.spi = True
            mm.spi_valid = True
        elif lowbits:
            mm.alert = True
            mm.alert_valid = True
    if fspec[3] & 0x20:  # I021/155 baro rate
        raw = int.from_bytes(take(2), "big")
        v = raw & 0x7FFF
        if v >= 0x4000:
            v -= 0x8000
        mm.baro_rate = int(v * 6.25)
    if fspec[3] & 0x10:  # I021/157 geom rate
        raw = int.from_bytes(take(2), "big")
        v = raw & 0x7FFF
        if v >= 0x4000:
            v -= 0x8000
        mm.geom_rate = int(v * 6.25)
    if fspec[3] & 0x08:  # I021/160 ground vector
        gs_raw = int.from_bytes(take(2), "big") & 0x7FFF
        trk_raw = int.from_bytes(take(2), "big")
        mm.gs_selected = mm.gs_v0 = gs_raw / 4.5511
        mm.heading = trk_raw * (360.0 / 2**16)
        mm.heading_type = HeadingType.GROUND_TRACK
    if fspec[3] & 0x04:  # I021/165 track angle rate
        take(2)
    if fspec[3] & 0x02:  # I021/077 time of report
        take(3)

    if fspec[4] & 0x80:  # I021/170 ident
        enc = int.from_bytes(take(6), "big")
        cs = "".join(AIS_CHARSET[(enc >> (6 * (7 - i))) & 0x3F] for i in range(8))
        mm.callsign = cs.strip()
        mm.callsign_valid = bool(mm.callsign)
    if fspec[4] & 0x40:  # I021/020 emitter category
        take(1)
    if fspec[4] & 0x20:  # I021/220 met
        sub = take(1)[0]
        if sub & 0x80:  # wind speed
            mm.wind_speed = float(int.from_bytes(take(2), "big"))
        if sub & 0x40:  # wind direction
            mm.wind_dir = float(int.from_bytes(take(2), "big"))
        if sub & 0x20:  # temperature
            mm.oat = int.from_bytes(take(2), "big", signed=True) / 4.0
        if sub & 0x10:  # turbulence
            take(1)
    if fspec[4] & 0x10:  # I021/146 selected altitude
        raw = int.from_bytes(take(2), "big")
        alt = raw & 0x1FFF
        if alt >= 0x1000:
            alt -= 0x2000
        if (raw & 0x6000) == 0x6000:
            mm.nav_fms_altitude = alt * 25
        else:
            mm.nav_mcp_altitude = alt * 25
    return mm


class AsterixDeframer:
    """CAT+LEN16 block framing of an ASTERIX TCP stream."""

    def __init__(self):
        self._buf = b""

    def feed(self, data: bytes) -> Iterator[bytes]:
        self._buf += data
        while len(self._buf) >= 3:
            ln = (self._buf[1] << 8) | self._buf[2]
            if ln < 3:
                self._buf = self._buf[1:]
                continue
            if len(self._buf) < ln:
                return
            yield self._buf[:ln]
            self._buf = self._buf[ln:]
