"""SBS / BaseStation CSV wire format (output and input).

Output mirrors modesSendSBSOutput (net_io.c:3184-3406): `MSG,<type>,...`
22-field CSV lines.  Input mirrors decodeSbsLine (net_io.c:2952-3183).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from ..decode.fields import AirGround, HeadingType, ModesMessage, Source
from ..decode.fields import squawk_hex_to_dec


def _sbs_msg_type(mm: ModesMessage) -> Optional[int]:
    mt = mm.msgtype
    if mt in (4, 20):
        return 5
    if mt in (5, 21):
        return 6
    if mt in (0, 16):
        return 7
    if mt == 11:
        return 8
    if mt in (17, 18):
        me = mm.metype
        if 1 <= me <= 4:
            return 1
        if 5 <= me <= 8:
            return 2
        if 9 <= me <= 18:
            return 3
        if me == 19:
            return 4
        return None
    return None


def _fmt_time(ms: int) -> str:
    t = time.gmtime(ms // 1000)
    return "%04d/%02d/%02d,%02d:%02d:%02d.%03d" % (
        t.tm_year, t.tm_mon, t.tm_mday, t.tm_hour, t.tm_min, t.tm_sec, ms % 1000
    )


def encode_line(mm: ModesMessage, geom_delta: Optional[int] = None,
                now_ms: Optional[int] = None,
                use_gnss: bool = False) -> Optional[bytes]:
    """One SBS output line for a decoded message, or None if not mapped.

    use_gnss (--gnss): altitude/vertical-rate fields prefer GNSS (HAE)
    values, suffixed 'H' (net_io.c:3275-3330)."""
    if mm.addr & (1 << 24):
        return None  # suppress non-ICAO
    msg_type = _sbs_msg_type(mm)
    if msg_type is None:
        return None
    now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
    f: list[str] = []
    f.append(f"MSG,{msg_type},1,1,{mm.addr:06X},1")
    f.append(_fmt_time(mm.sys_timestamp_ms))
    f.append(_fmt_time(now_ms))
    f.append(mm.callsign if (mm.callsign and mm.callsign_valid) else "")
    if use_gnss:
        if mm.geom_alt is not None:
            f.append("%dH" % mm.geom_alt)
        elif mm.baro_alt is not None and geom_delta is not None:
            f.append("%dH" % (mm.baro_alt + geom_delta))
        elif mm.baro_alt is not None:
            f.append(str(mm.baro_alt))
        else:
            f.append("")
    elif mm.baro_alt is not None:
        f.append(str(mm.baro_alt))
    elif mm.geom_alt is not None and geom_delta is not None:
        f.append(str(mm.geom_alt - geom_delta))
    else:
        f.append("")
    f.append("%.0f" % mm.gs_selected if mm.gs_selected is not None else "")
    if mm.heading is not None and mm.heading_type == HeadingType.GROUND_TRACK:
        f.append("%.0f" % mm.heading)
    else:
        f.append("")
    if mm.cpr_decoded:
        f.append("%1.6f" % mm.decoded_lat)
        f.append("%1.6f" % mm.decoded_lon)
    else:
        f.append("")
        f.append("")
    if use_gnss:
        if mm.geom_rate is not None:
            f.append("%dH" % mm.geom_rate)
        elif mm.baro_rate is not None:
            f.append(str(mm.baro_rate))
        else:
            f.append("")
    elif mm.baro_rate is not None:
        f.append(str(mm.baro_rate))
    elif mm.geom_rate is not None:
        f.append(str(mm.geom_rate))
    else:
        f.append("")
    f.append("%04d" % squawk_hex_to_dec(mm.squawk_hex) if mm.squawk_hex is not None else "")
    if mm.alert is not None and mm.alert_valid:
        f.append("-1" if mm.alert else "0")
    else:
        f.append("")
    if mm.squawk_hex is not None:
        f.append("-1" if mm.squawk_hex in (0x7500, 0x7600, 0x7700) else "0")
    else:
        f.append("")
    if mm.spi is not None and mm.spi_valid:
        f.append("-1" if mm.spi else "0")
    else:
        f.append("")
    if mm.airground == AirGround.GROUND:
        f.append("-1")
    elif mm.airground == AirGround.AIRBORNE:
        f.append("0")
    else:
        f.append("")
    return (",".join(f) + "\r\n").encode()


@dataclasses.dataclass
class SbsLine:
    addr: int
    msg_type: int
    callsign: Optional[str] = None
    altitude: Optional[int] = None
    gs: Optional[float] = None
    track: Optional[float] = None
    lat: Optional[float] = None
    lon: Optional[float] = None
    vr: Optional[int] = None
    squawk_dec: Optional[int] = None
    alert: Optional[bool] = None
    emergency: Optional[bool] = None
    spi: Optional[bool] = None
    on_ground: Optional[bool] = None


class SbsDeframer:
    """SBS input line parser (decodeSbsLine, net_io.c:2952-3183)."""

    def __init__(self):
        self._buf = b""
        self.lines_bad = 0

    def feed(self, data: bytes):
        self._buf += data
        *lines, self._buf = self._buf.split(b"\n")
        for raw in lines:
            line = raw.strip().decode("ascii", "replace")
            if not line.startswith("MSG,"):
                continue
            parts = line.split(",")
            if len(parts) < 11:
                self.lines_bad += 1
                continue
            parts += [""] * (22 - len(parts))
            try:
                out = SbsLine(addr=int(parts[4], 16), msg_type=int(parts[1]))
                if parts[10].strip():
                    out.callsign = parts[10].strip()
                if parts[11].strip():
                    out.altitude = int(parts[11].rstrip("H"))
                if parts[12].strip():
                    out.gs = float(parts[12])
                if parts[13].strip():
                    out.track = float(parts[13])
                if parts[14].strip() and parts[15].strip():
                    out.lat = float(parts[14])
                    out.lon = float(parts[15])
                if parts[16].strip():
                    out.vr = int(parts[16].rstrip("H"))
                if parts[17].strip():
                    out.squawk_dec = int(parts[17])
                if parts[18].strip():
                    out.alert = parts[18].strip() == "-1"
                if parts[19].strip():
                    out.emergency = parts[19].strip() == "-1"
                if parts[20].strip():
                    out.spi = parts[20].strip() == "-1"
                if parts[21].strip():
                    out.on_ground = parts[21].strip() == "-1"
                yield out
            except ValueError:
                self.lines_bad += 1
