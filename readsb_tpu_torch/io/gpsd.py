"""gpsd JSON input for moving receivers.

Reference: handle_gpsd (net_io.c:3609-3717) — filter class TPV lines,
plausibility-check lat/lon, update the receiver's own location.  On
connect the client sends `?WATCH={"enable":true,"json":true};`
(net_io.c:506).
"""

from __future__ import annotations

import json
from typing import Optional

WATCH_COMMAND = b'?WATCH={"enable":true,"json":true};\n'


def parse_tpv_line(line: bytes) -> Optional[tuple[float, float, Optional[float]]]:
    """Return (lat, lon, alt_m or None) for a plausible TPV fix, else None."""
    try:
        obj = json.loads(line)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(obj, dict) or obj.get("class") != "TPV":
        return None
    lat = obj.get("lat")
    lon = obj.get("lon")
    if not isinstance(lat, (int, float)) or not isinstance(lon, (int, float)):
        return None
    if not (-89.9 <= lat <= 89.9) or not (-180 <= lon <= 180):
        return None
    if abs(lat) < 0.1 and abs(lon) < 0.1:
        return None
    alt = obj.get("alt")
    if not isinstance(alt, (int, float)):
        alt = None
    return float(lat), float(lon), alt
