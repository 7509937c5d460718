"""aircraft.json and related JSON snapshot writers.

Produces the public JSON contract of the reference (README-json.md:30-121,
writer json_out.c:631-845): same field names, formats, and presence rules
so tar1090 and downstream consumers work unchanged.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
from typing import Optional

from ..decode.fields import AddrType, AirGround, SilType, Source
from ..track.tracker import (
    SECONDS,
    TRACK_EXPIRE,
    Aircraft,
    Tracker,
)

ADDRTYPE_STRINGS = {
    AddrType.ADSB_ICAO: "adsb_icao",
    AddrType.ADSB_ICAO_NT: "adsb_icao_nt",
    AddrType.ADSR_ICAO: "adsr_icao",
    AddrType.TISB_ICAO: "tisb_icao",
    AddrType.JAERO: "adsc",
    AddrType.MLAT: "mlat",
    AddrType.OTHER: "other",
    AddrType.MODE_S: "mode_s",
    AddrType.ADSB_OTHER: "adsb_other",
    AddrType.ADSR_OTHER: "adsr_other",
    AddrType.TISB_TRACKFILE: "tisb_trackfile",
    AddrType.TISB_OTHER: "tisb_other",
    AddrType.MODE_AC: "mode_ac",
    AddrType.UNKNOWN: "unknown",
}

EMERGENCY_STRINGS = ["none", "general", "lifeguard", "minfuel", "nordo", "unlawful", "downed", "reserved"]
SIL_TYPE_STRINGS = {
    int(SilType.UNKNOWN): "unknown",
    int(SilType.PER_HOUR): "perhour",
    int(SilType.PER_SAMPLE): "persample",
    int(SilType.INVALID): "invalid",
}
NAV_MODE_NAMES = [
    (1, "autopilot"), (2, "vnav"), (4, "althold"), (8, "approach"), (16, "lnav"), (32, "tcas"),
]


def _rnd(x: float, digits: int) -> float:
    return float(f"{x:.{digits}f}")


def aircraft_dict(tracker: Tracker, a: Aircraft, now: int) -> dict:
    """One aircraft object (sprintAircraftObject printMode 0)."""
    o: dict = {}
    non_icao = a.addr & (1 << 24)
    o["hex"] = ("~%06x" % (a.addr & 0xFFFFFF)) if non_icao else ("%06x" % a.addr)
    o["type"] = ADDRTYPE_STRINGS.get(a.addrtype, "unknown")
    if a.callsign_valid.valid(now):
        o["flight"] = a.callsign
    if a.registration:
        o["r"] = a.registration
    if a.type_code:
        o["t"] = a.type_code
    if a.db_flags:
        o["dbFlags"] = a.db_flags
    if a.airground_valid.valid(now) and a.airground == AirGround.GROUND:
        o["alt_baro"] = "ground"
    elif a.baro_alt_valid.valid(now) and a.baro_alt is not None:
        o["alt_baro"] = a.baro_alt
    if a.geom_alt_valid.valid(now) and a.geom_alt is not None:
        o["alt_geom"] = a.geom_alt
    if a.gs_valid.valid(now) and a.gs is not None:
        o["gs"] = _rnd(a.gs, 1)
    if a.ias_valid.valid(now) and a.ias is not None:
        o["ias"] = a.ias
    if a.tas_valid.valid(now) and a.tas is not None:
        o["tas"] = a.tas
    if a.mach_valid.valid(now) and a.mach is not None:
        o["mach"] = _rnd(a.mach, 3)
    if a.wind_valid.valid(now) and a.wind_speed is not None and (
        a.wind_alt is None or a.baro_alt is None or abs(a.wind_alt - a.baro_alt) < 500
    ):
        o["wd"] = round(a.wind_dir or 0)
        o["ws"] = round(a.wind_speed)
    if a.oat_valid.valid(now) and a.oat is not None:
        o["oat"] = round(a.oat)
    if a.track_valid.valid(now) and a.track is not None:
        o["track"] = _rnd(a.track, 2)
    if a.track_rate_valid.valid(now) and a.track_rate is not None:
        o["track_rate"] = _rnd(a.track_rate, 2)
    if a.roll_valid.valid(now) and a.roll is not None:
        o["roll"] = _rnd(a.roll, 2)
    if a.mag_heading_valid.valid(now) and a.mag_heading is not None:
        o["mag_heading"] = _rnd(a.mag_heading, 2)
    if a.true_heading_valid.valid(now) and a.true_heading is not None:
        o["true_heading"] = _rnd(a.true_heading, 2)
    if a.baro_rate_valid.valid(now) and a.baro_rate is not None:
        o["baro_rate"] = a.baro_rate
    if a.geom_rate_valid.valid(now) and a.geom_rate is not None:
        o["geom_rate"] = a.geom_rate
    if a.squawk_valid.valid(now) and a.squawk is not None:
        o["squawk"] = "%04x" % a.squawk
    if a.emergency_valid.valid(now) and a.emergency is not None:
        o["emergency"] = EMERGENCY_STRINGS[min(a.emergency, 7)]
    if a.category:
        o["category"] = "%02X" % a.category
    if a.nav_qnh_valid.valid(now) and a.nav_qnh is not None:
        o["nav_qnh"] = _rnd(a.nav_qnh, 1)
    if a.nav_altitude_mcp_valid.valid(now) and a.nav_altitude_mcp is not None:
        o["nav_altitude_mcp"] = a.nav_altitude_mcp
    if a.nav_altitude_fms_valid.valid(now) and a.nav_altitude_fms is not None:
        o["nav_altitude_fms"] = a.nav_altitude_fms
    if a.nav_heading_valid.valid(now) and a.nav_heading is not None:
        o["nav_heading"] = _rnd(a.nav_heading, 2)
    if a.nav_modes_valid.valid(now) and a.nav_modes is not None:
        o["nav_modes"] = [name for bit, name in NAV_MODE_NAMES if a.nav_modes & bit]
    if tracker.pos_reliable(a) and a.seen_pos:
        o["lat"] = _rnd(a.lat, 6)
        o["lon"] = _rnd(a.lon, 6)
        o["nic"] = a.pos_nic
        o["rc"] = int(a.pos_rc)
        o["seen_pos"] = _rnd(max(0, now - a.seen_pos) / 1000.0, 3)
    if a.adsb_version >= 0:
        o["version"] = a.adsb_version
    if a.nic_baro_valid.valid(now):
        o["nic_baro"] = a.nic_baro
    if a.acas_ra and a.acas_ra_valid.age(now) < 15 * 1000:
        from .acas import json_record

        o["acas_ra"] = json_record(a.addr, a.acas_ra, None, None, now)
    if a.nac_p_valid.valid(now):
        o["nac_p"] = a.nac_p
    if a.nac_v_valid.valid(now):
        o["nac_v"] = a.nac_v
    if a.sil_valid.valid(now):
        o["sil"] = a.sil
    if a.sil_type != int(SilType.INVALID):
        o["sil_type"] = SIL_TYPE_STRINGS.get(a.sil_type, "invalid")
    if a.gva_valid.valid(now):
        o["gva"] = a.gva
    if a.sda_valid.valid(now):
        o["sda"] = a.sda
    if a.alert_valid.valid(now):
        o["alert"] = int(a.alert)
    if a.spi_valid.valid(now):
        o["spi"] = int(a.spi)

    # mlat / tisb field lists (append_flags): which fields came from there
    o["mlat"] = _source_flags(a, now, Source.MLAT)
    o["tisb"] = _source_flags(a, now, Source.TISB)
    o["messages"] = a.messages
    o["seen"] = _rnd(max(0, now - a.seen) / 1000.0, 1)
    o["rssi"] = _rnd(a.rssi(), 1)
    return o


def _source_flags(a: Aircraft, now: int, source: Source) -> list[str]:
    out = []
    checks = [
        ("altitude", a.baro_alt_valid), ("alt_geom", a.geom_alt_valid),
        ("gs", a.gs_valid), ("ias", a.ias_valid), ("tas", a.tas_valid),
        ("mach", a.mach_valid), ("track", a.track_valid),
        ("track_rate", a.track_rate_valid), ("roll", a.roll_valid),
        ("mag_heading", a.mag_heading_valid), ("true_heading", a.true_heading_valid),
        ("baro_rate", a.baro_rate_valid), ("geom_rate", a.geom_rate_valid),
        ("squawk", a.squawk_valid), ("emergency", a.emergency_valid),
        ("nav_qnh", a.nav_qnh_valid), ("nav_altitude_mcp", a.nav_altitude_mcp_valid),
        ("nav_altitude_fms", a.nav_altitude_fms_valid),
        ("nav_heading", a.nav_heading_valid),
        ("nav_modes", a.nav_modes_valid), ("lat", a.position_valid),
        ("lon", a.position_valid), ("nic", a.position_valid),
        ("rc", a.position_valid), ("nic_baro", a.nic_baro_valid),
        ("nac_p", a.nac_p_valid), ("nac_v", a.nac_v_valid),
        ("sil", a.sil_valid), ("sil_type", a.sil_valid),
        ("gva", a.gva_valid), ("sda", a.sda_valid),
    ]
    for name, v in checks:
        if v.valid(now) and v.source == source:
            out.append(name)
    return out


def generate_aircraft_json(tracker: Tracker, now: int, messages: Optional[int] = None) -> dict:
    """The aircraft.json document (generateAircraftJson, json_out.c:1321)."""
    return {
        "now": round(now / 1000.0, 1),
        "messages": messages if messages is not None else tracker.messages_total,
        "aircraft": [
            aircraft_dict(tracker, a, now)
            for a in tracker.aircraft.values()
            if now < a.seen + TRACK_EXPIRE + 30 * SECONDS
        ],
    }


def write_json_atomic(obj: dict, path: str, gzip_level: int = 0) -> None:
    """tmpfile + rename, optional gzip (writeJsonTo, json_out.c:1970)."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        data = json.dumps(obj, separators=(",", ":")).encode()
        if gzip_level:
            data = gzip.compress(data, gzip_level)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def generate_receiver_json(
    refresh_ms: int = 1000, lat: Optional[float] = None, lon: Optional[float] = None,
    version: str = "readsb-tpu",
) -> dict:
    """receiver.json (json_out.c:1848)."""
    o = {
        "refresh": refresh_ms,
        "history": 0,
        "version": version,
    }
    if lat is not None:
        o["lat"] = round(lat, 2)
        o["lon"] = round(lon, 2)
    return o


def aircraft_json_bytes_from_api(snap, messages: int) -> bytes:
    """aircraft.json assembled from the API snapshot's prebuilt fragments
    (apiGenerateAircraftJson, api.c:2027-2100): when the API is enabled,
    the per-aircraft JSON objects are rendered once per apiUpdate and the
    json writer only byte-joins them — the reference's design for not
    paying the render twice per tick."""
    head = json.dumps(
        {"now": round(snap.now / 1000.0, 1), "messages": messages},
        separators=(",", ":"),
    )[:-1].encode() + b',"aircraft":['
    return head + b",".join(snap.frag) + b"]}"


def write_bytes_atomic(data: bytes, path: str, gzip_level: int = 0) -> None:
    """tmpfile + rename for pre-rendered bytes."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        if gzip_level:
            data = gzip.compress(data, gzip_level)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
