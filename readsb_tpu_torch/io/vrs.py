"""Virtual Radar Server (VRS) format JSON output.

Reference: generateVRS (json_out.c:2059-2246), periodically broadcast to
vrs_out clients (net_io.c:5563-5576) every --net-vrs-interval seconds.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..track.tracker import Tracker

from ..decode.fields import Source, AirGround

NON_ICAO = 1 << 24


def generate_vrs(tracker: "Tracker", now: int, reduced: bool = False) -> bytes:
    """One `{"acList":[...]}` snapshot of recently-seen aircraft."""
    ac_list = []
    for a in tracker.aircraft.values():
        if now > a.seen + 10_000:
            continue
        if a.addr & NON_ICAO:
            continue
        o: dict = {"Icao": "%06X" % (a.addr & 0xFFFFFF)}
        if a.position_valid.valid(now):
            o["Lat"] = round(a.lat, 6)
            o["Long"] = round(a.lon, 6)
        if a.baro_alt is not None and a.baro_alt_valid.valid(now):
            o["Alt"] = a.baro_alt
        if a.geom_rate is not None and a.geom_rate_valid.valid(now):
            o["Vsi"] = a.geom_rate
        elif a.baro_rate is not None and a.baro_rate_valid.valid(now):
            o["Vsi"] = a.baro_rate
        if a.track is not None and a.track_valid.valid(now):
            o["Trak"] = round(a.track, 1)
        elif a.mag_heading is not None and a.mag_heading_valid.valid(now):
            o["Trak"] = round(a.mag_heading, 1)
        elif a.true_heading is not None and a.true_heading_valid.valid(now):
            o["Trak"] = round(a.true_heading, 1)
        if a.gs is not None and a.gs_valid.valid(now):
            o["Spd"] = round(a.gs, 1)
        elif a.ias is not None and a.ias_valid.valid(now):
            o["Spd"] = a.ias
        elif a.tas is not None and a.tas_valid.valid(now):
            o["Spd"] = a.tas
        if a.geom_alt is not None and a.geom_alt_valid.valid(now):
            o["GAlt"] = a.geom_alt
        o["Gnd"] = bool(a.airground == AirGround.GROUND and a.airground_valid.valid(now))
        if a.squawk is not None and a.squawk_valid.valid(now):
            o["Sqk"] = "%04x" % a.squawk
        if a.nav_altitude_mcp is not None and a.nav_altitude_mcp_valid.valid(now):
            o["TAlt"] = a.nav_altitude_mcp
        elif a.nav_altitude_fms is not None and a.nav_altitude_fms_valid.valid(now):
            o["TAlt"] = a.nav_altitude_fms
        src = a.position_valid.source
        if src == Source.MLAT:
            o["Mlat"] = True
        elif src == Source.TISB:
            o["Tisb"] = True
        elif src == Source.JAERO:
            o["Sat"] = True
        if not reduced:
            if a.callsign and a.callsign_valid.age(now) < 300_000:
                o["Call"] = a.callsign.strip()
            if a.registration:
                o["Reg"] = a.registration
            if a.type_code:
                o["Type"] = a.type_code
            if a.category is not None and a.category_valid.valid(now):
                o["Species"] = a.category
            sig = a.rssi()
            if sig > -49.5:
                o["Sig"] = round(sig, 1)
        ac_list.append(o)
    return json.dumps({"acList": ac_list, "totalAc": len(ac_list)}, separators=(",", ":")).encode() + b"\n"
