"""binCraft: the 112-byte packed little-endian aircraft record.

Wire-compatible with the reference (aircraft.h:50-179, toBinCraft
aircraft.c:174-326), consumed by tar1090's JS as Int32Array — the layout
must stay byte-identical.  Written as aircraft.binCraft.zst and per-tile
globe_NNNN.binCraft.zst snapshots.

A copy of readsb_tpu's `io/bincraft.py`.  `write_bincraft_zst` compresses
with the port's zstd codec (`io/zstd.py`) in place of the `zstandard`
package, and writes zlib to a `.zlib` file where that codec does not
load, as readsb_tpu does without `zstandard`.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional

from ..decode.fields import AirGround, SilType
from ..track.tracker import TRACK_EXPIRE, Aircraft, Tracker
from . import zstd

RECORD_BYTES = 112


def _q(value: Optional[float], scale: float, lo: int, hi: int) -> int:
    if value is None:
        return 0
    v = int(round(value * scale))
    return max(lo, min(hi, v))


def to_bincraft(tracker: Tracker, a: Aircraft, now: int) -> bytes:
    """Pack one aircraft (quantization mirrors toBinCraft)."""
    v = lambda val: val.valid(now)  # noqa: E731
    pos_ok = tracker.pos_reliable(a) and a.seen_pos > 0

    callsign_valid = v(a.callsign_valid)
    cs = (a.callsign + "\x00" * 8)[:8] if callsign_valid else "\x00" * 8

    flags1 = 0  # byte 72: sil(2) gva(2) sda(2) nic_a(1) nic_c(1)
    flags1 |= (a.sil & 3)
    flags1 |= (a.gva & 3) << 2
    flags1 |= (a.sda & 3) << 4
    flags1 |= (a.nic_a & 1) << 6
    flags1 |= (a.nic_c & 1) << 7
    flags2 = 0  # byte 73
    flags2 |= (a.nic_baro & 1)
    flags2 |= int(a.alert) << 1
    flags2 |= int(a.spi) << 2
    flags2 |= int(callsign_valid) << 3
    flags2 |= int(v(a.baro_alt_valid) and a.baro_alt is not None) << 4
    flags2 |= int(v(a.geom_alt_valid) and a.geom_alt is not None) << 5
    flags2 |= int(pos_ok) << 6
    flags2 |= int(v(a.gs_valid) and a.gs is not None) << 7
    flags3 = 0  # byte 74
    flags3 |= int(v(a.ias_valid) and a.ias is not None)
    flags3 |= int(v(a.tas_valid) and a.tas is not None) << 1
    flags3 |= int(v(a.mach_valid) and a.mach is not None) << 2
    flags3 |= int(v(a.track_valid) and a.track is not None) << 3
    flags3 |= int(v(a.track_rate_valid) and a.track_rate is not None) << 4
    flags3 |= int(v(a.roll_valid) and a.roll is not None) << 5
    flags3 |= int(v(a.mag_heading_valid) and a.mag_heading is not None) << 6
    flags3 |= int(v(a.true_heading_valid) and a.true_heading is not None) << 7
    flags4 = 0  # byte 75
    flags4 |= int(v(a.baro_rate_valid) and a.baro_rate is not None)
    flags4 |= int(v(a.geom_rate_valid) and a.geom_rate is not None) << 1
    flags4 |= 0 << 2  # nic_a_valid (tracked via opstatus presence)
    flags4 |= 0 << 3  # nic_c_valid
    flags4 |= int(v(a.nic_baro_valid)) << 4
    flags4 |= int(v(a.nac_p_valid)) << 5
    flags4 |= int(v(a.nac_v_valid)) << 6
    flags4 |= int(v(a.sil_valid)) << 7
    flags5 = 0  # byte 76
    flags5 |= int(v(a.gva_valid))
    flags5 |= int(v(a.sda_valid)) << 1
    flags5 |= int(v(a.squawk_valid) and a.squawk is not None) << 2
    flags5 |= int(v(a.emergency_valid) and a.emergency is not None) << 3
    flags5 |= int(v(a.spi_valid)) << 4
    flags5 |= int(v(a.nav_qnh_valid) and a.nav_qnh is not None) << 5
    flags5 |= int(v(a.nav_altitude_mcp_valid) and a.nav_altitude_mcp is not None) << 6
    flags5 |= int(v(a.nav_altitude_fms_valid) and a.nav_altitude_fms is not None) << 7
    flags6 = 0  # byte 77
    flags6 |= int(a.nav_altitude_src != 0)
    flags6 |= int(v(a.nav_heading_valid) and a.nav_heading is not None) << 1
    flags6 |= int(v(a.nav_modes_valid) and a.nav_modes is not None) << 2
    flags6 |= int(v(a.alert_valid)) << 3
    wind_ok = v(a.wind_valid) and a.wind_speed is not None and (
        a.wind_alt is None or a.baro_alt is None or abs(a.wind_alt - a.baro_alt) < 500
    )
    flags6 |= int(wind_ok) << 4
    temp_ok = v(a.oat_valid) and a.oat is not None
    flags6 |= int(temp_ok) << 5

    byte66 = (a.nav_modes or 0) & 0xFF
    byte67 = ((a.emergency or 0) & 0xF) | ((int(a.addrtype) & 0xF) << 4)
    byte68 = (int(a.airground) if v(a.airground_valid) else 0) & 0xF
    byte68 |= (a.nav_altitude_src & 0xF) << 4
    byte69 = (a.sil_type & 0xF) | ((a.adsb_version if a.adsb_version >= 0 else 15) << 4 & 0xF0)
    byte70 = 0xFF  # adsr/tisb versions unset
    byte71 = ((a.nac_p & 0xF)) | ((a.nac_v & 0xF) << 4)

    sig = a.rssi()
    signal8 = int(max(0, min(255, (sig + 50) * 255 / 50))) if sig > -49.4 else 0

    return struct.pack(
        "<Ii ii hhhh HHhh Hhhh hhhh hhhh HHHH",
        a.addr,
        int(round((now - a.seen) / 100.0)),
        _q(a.lon if pos_ok else 0, 1e6, -(1 << 31), (1 << 31) - 1),
        _q(a.lat if pos_ok else 0, 1e6, -(1 << 31), (1 << 31) - 1),
        _q(a.baro_rate, 1 / 8.0, -32768, 32767),
        _q(a.geom_rate, 1 / 8.0, -32768, 32767),
        _q(a.baro_alt, 1 / 25.0, -32768, 32767),
        _q(a.geom_alt, 1 / 25.0, -32768, 32767),
        _q(a.nav_altitude_mcp, 1 / 4.0, 0, 65535),
        _q(a.nav_altitude_fms, 1 / 4.0, 0, 65535),
        _q(a.nav_qnh, 10.0, -32768, 32767),
        _q(a.nav_heading, 90.0, -32768, 32767),
        (a.squawk or 0) & 0xFFFF,
        _q(a.gs, 10.0, -32768, 32767),
        _q(a.mach, 1000.0, -32768, 32767),
        _q(a.roll, 100.0, -32768, 32767),
        _q(a.track, 90.0, -32768, 32767),
        _q(a.track_rate, 100.0, -32768, 32767),
        _q(a.mag_heading, 90.0, -32768, 32767),
        _q(a.true_heading, 90.0, -32768, 32767),
        _q(a.wind_dir if wind_ok else 0, 1.0, -32768, 32767),
        _q(a.wind_speed if wind_ok else 0, 1.0, -32768, 32767),
        _q(a.oat if temp_ok else 0, 1.0, -32768, 32767),
        _q(a.oat if temp_ok else 0, 1.0, -32768, 32767),  # tat ~ oat placeholder
        (a.tas or 0) & 0xFFFF,
        (a.ias or 0) & 0xFFFF,
        int(a.pos_rc) & 0xFFFF,
        min(a.messages, 65535),
    ) + bytes(
        [
            (a.category or 0) & 0xFF,
            a.pos_nic & 0xFF,
            byte66, byte67, byte68, byte69, byte70, byte71,
            flags1, flags2, flags3, flags4, flags5, flags6,
        ]
    ) + cs.encode("latin1") + struct.pack(
        "<H", a.db_flags & 0xFFFF
    ) + (a.type_code + "\x00" * 4)[:4].encode("latin1") + (
        (a.registration + "\x00" * 12)[:12].encode("latin1")
    ) + bytes([1, signal8, 0, 0]) + struct.pack(
        "<i", int(round((now - a.seen_pos) / 100.0)) if a.seen_pos else 0
    )


HEADER_BYTES = 112  # first element carries globals (json_out.c:1017-1105)


def generate_bincraft(tracker: Tracker, now: int, *, elem_size: int = RECORD_BYTES) -> bytes:
    """aircraft.binCraft full snapshot: header element + one per aircraft."""
    aircraft = [a for a in tracker.aircraft.values() if now < a.seen + TRACK_EXPIRE]
    header = struct.pack(
        "<QIIIIHHHH",
        now,  # u64 timestamp ms
        elem_size,
        len(aircraft),
        0,  # globe index
        0,  # south/west/north/east packed elsewhere; zeros for full set
        0, 0, 0, 0,
    )
    header += b"\x00" * (elem_size - len(header))
    parts = [header]
    for a in aircraft:
        rec = to_bincraft(tracker, a, now)
        assert len(rec) == RECORD_BYTES, len(rec)
        parts.append(rec)
    return b"".join(parts)


def write_bincraft_zst(tracker: Tracker, path: str, now: int) -> None:
    data = generate_bincraft(tracker, now)
    if zstd.available():
        comp = zstd.compress(data, 3)
    else:
        comp = zlib.compress(data, 6)
        path = path.replace(".zst", ".zlib")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(comp)
    os.rename(tmp, path)
