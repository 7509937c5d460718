"""History outputs: trace JSON files, globe tile snapshots, heatmaps.

The filesystem contract follows the reference so tar1090 consumes the
output unchanged:
- traces/<last2hex>/trace_full_<hex>.json and trace_recent_<hex>.json
  (traceWrite, globe_index.c:459-782; 2-level sharded dirs)
- globe_NNNN.binCraft.zst per occupied globe tile
  (generateGlobeBin, json_out.c:1106-1217; globeBinEntryPoint readsb.c:677)
- heatmap/<HH>.bin.ttf: gzip'd fixed binary heatEntry records with
  slice index + "special sauce" timestamp separators
  (handleHeatmap, globe_index.c:3118-3339; format globe_index.h:80-90)

A copy of readsb_tpu's `io/history.py`; the globe tiles are compressed by
the port's zstd codec (`io/zstd.py`) in place of the `zstandard` package.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
import time

from ..track import globe as globe_mod
from . import zstd
from ..track.traces import (
    _ALT_FACTOR,
    _GS_FACTOR,
    MINUTES,
    SECONDS,
    State,
    mark_legs,
    trace_json,
)
from ..track.tracker import TRACK_EXPIRE, Tracker

TRACE_RECENT_POINTS = 142


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".readsb_tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.rename(tmp, path)


# ---------------------------------------------------------------------------
# Trace files
# ---------------------------------------------------------------------------


TRACE_WRITES = {"recent": 0, "full": 0, "perm": 0, "cycle_ms": 0}


def write_traces(tracker: Tracker, outdir: str, now: int,
                 full_interval_ms: int = 60 * SECONDS,
                 time_budget_s: float | None = 0.05,
                 cursor: int = 0, hist_only: int = 0) -> tuple[int, int]:
    """traceWrite sweep: write trace_recent (always when dirty) and
    trace_full (mark_legs applied) per aircraft with history.

    time_budget_s bounds one sweep's wall time and `cursor` (last addr
    handled, returned for the next call) rotates the start point — the
    reference's time-sliced tracePool writer splits the aircraft buckets
    into parts and walks one part per periodic tick so every aircraft is
    revisited within a bounded cycle (readsb.c:975-1114,1015-1021);
    the rotating cursor gives the same full-rotation fairness: aircraft
    left dirty are picked up by subsequent ticks, so a 10k-aircraft
    store never stalls the loop and the tail never starves.

    Returns (written, new_cursor).
    """
    import time as _time

    deadline = _time.monotonic() + time_budget_s if time_budget_s else None
    written = 0
    tdir = os.path.join(outdir, "traces")
    os.makedirs(tdir, exist_ok=True)
    addrs = sorted(tracker.aircraft.keys())
    order = [x for x in addrs if x > cursor] + [x for x in addrs if x <= cursor]
    new_cursor = cursor
    for addr in order:
        a = tracker.aircraft.get(addr)
        if a is None:
            continue
        tr = getattr(a, "trace", None)
        if tr is None or len(tr) == 0 or not tr.dirty:
            new_cursor = addr
            continue
        if deadline is not None and _time.monotonic() > deadline and written:
            break  # stay dirty; resume here next tick
        new_cursor = addr
        tr.dirty = False
        hexid = f"{a.addr & 0xFFFFFF:06x}"
        shard = os.path.join(tdir, hexid[-2:])
        os.makedirs(shard, exist_ok=True)

        # incremental render: cold chunks come from the per-chunk rows
        # cache (traceCache analog, json_out.c:1501-1726); only warm
        # chunks + live points reassemble, leg-mark and render per write
        from ..track.traces import render_full_cached, trace_rows

        rows_cold, warm_states, reference_ts = render_full_cached(tr, now)
        mark_legs(warm_states)

        # --json-trace-hist-only mask: 1 skips recent, 2 skips full
        # (globe_index.c:494-546); globe-history archiving is unaffected
        if not hist_only & 1:
            if len(warm_states) >= TRACE_RECENT_POINTS:
                recent = warm_states[-TRACE_RECENT_POINTS:]
            else:
                # the fallback decompresses cold states that never passed
                # through mark_legs above — leg-mark the whole reassembled
                # list (as the pre-cache code did) before slicing so
                # trace_recent keeps its leg annotations
                full = tr.full()
                mark_legs(full)
                recent = full[-TRACE_RECENT_POINTS:]
            doc = trace_json(a, recent, now)
            _atomic_write(
                os.path.join(shard, f"trace_recent_{hexid}.json"),
                gzip.compress(json.dumps(doc, separators=(",", ":")).encode(), 5),
            )
            TRACE_WRITES["recent"] += 1
        if not hist_only & 2:
            doc_full = trace_json(a, [], now, reference_ts=reference_ts)
            doc_full["trace"] = rows_cold + trace_rows(warm_states, reference_ts)
            _atomic_write(
                os.path.join(shard, f"trace_full_{hexid}.json"),
                gzip.compress(json.dumps(doc_full, separators=(",", ":")).encode(), 5),
            )
            TRACE_WRITES["full"] += 1
        written += 1
    return written, new_cursor


# ---------------------------------------------------------------------------
# Globe tile binCraft snapshots
# ---------------------------------------------------------------------------


def write_globe_bincraft(tracker: Tracker, outdir: str, now: int) -> int:
    """One globe_NNNN.binCraft.zst per occupied tile."""
    from .bincraft import RECORD_BYTES, to_bincraft

    tiles: dict[int, list] = {}
    for a in tracker.aircraft.values():
        if now >= a.seen + TRACK_EXPIRE or not a.seen_pos:
            continue
        idx = getattr(a, "globe_index", -1)
        if idx < 0:
            idx = globe_mod.globe_index(a.lat, a.lon)
        tiles.setdefault(idx, []).append(a)

    n = 0
    for idx, aircraft in tiles.items():
        header = struct.pack(
            "<QIIIIHHHH", now, RECORD_BYTES, len(aircraft), idx, 0, 0, 0, 0, 0
        )
        header += b"\x00" * (RECORD_BYTES - len(header))
        parts = [header] + [to_bincraft(tracker, a, now) for a in aircraft]
        _atomic_write(
            os.path.join(outdir, f"globe_{idx:04d}.binCraft.zst"),
            zstd.compress(b"".join(parts), 3),
        )
        n += 1
    return n


# ---------------------------------------------------------------------------
# Heatmap
# ---------------------------------------------------------------------------

HEAT_ENTRY = struct.Struct("<iiihh")  # hex, lat, lon, alt, gs (packed, 16 B)


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def _heat_point(addr: int, st: State) -> bytes:
    addrtype_5bits = st.addrtype & 0x1F
    if st.on_ground:
        alt = -123
    elif st.baro_alt is not None:
        alt = int(round(st.baro_alt / (_ALT_FACTOR * 25.0)))
    elif st.geom_alt is not None:
        alt = int(round(st.geom_alt / (_ALT_FACTOR * 25.0)))
    else:
        alt = 0
    gs = int(round(st.gs / _GS_FACTOR * 10.0)) if st.gs is not None else -1
    return HEAT_ENTRY.pack(
        _i32(addr | (addrtype_5bits << 27)),
        st.lat, st.lon,
        max(-32768, min(32767, alt)), max(-32768, min(32767, gs)),
    )


def _heat_info(addr: int, squawk_hex: int, callsign: str) -> bytes:
    s = squawk_hex
    d = (s & 0xF) + 10 * ((s & 0xF0) >> 4) + 100 * ((s & 0xF00) >> 8) + 1000 * ((s & 0xF000) >> 12)
    cs = (callsign + " " * 8)[:8].encode("latin1", "replace")
    return struct.pack("<ii", _i32(addr), (1 << 30) | d) + cs


def write_heatmap(tracker: Tracker, base_dir: str, start_ms: int, end_ms: int,
                  interval_ms: int = 30 * SECONDS) -> str:
    """Write one half-hour heatmap file covering [start_ms, end_ms).

    Layout (globe_index.c:3220-3341): a num_slices index of heatEntries
    whose .hex is the entry offset of each slice, then per slice a
    "special sauce" separator entry (hex 0xe7f7c9d, lat/lon = 64-bit
    slice timestamp, alt = interval) followed by that slice's points and
    callsign/squawk info entries.
    """
    num_slices = (end_ms - start_ms) // interval_ms
    slices: list[list[bytes]] = [[] for _ in range(num_slices)]

    callsign_interval = max(interval_ms, 1 * MINUTES)
    for a in tracker.aircraft.values():
        tr = getattr(a, "trace", None)
        if tr is None or len(tr) == 0:
            continue
        addr = a.addr
        nxt = start_ms
        slice_i = 0
        next_callsign = start_ms
        last_cs = None
        last_squawk = None
        for st in tr.since(start_ms):
            if st.timestamp > end_ms:
                break
            if st.all is not None:
                cs = st.all.get("flight", "")
                sq = st.all.get("squawk")
                if st.timestamp >= next_callsign or cs != last_cs or sq != last_squawk:
                    next_callsign = st.timestamp + callsign_interval
                    last_cs, last_squawk = cs, sq
                    si = min(slice_i, num_slices - 1)
                    slices[si].append(
                        _heat_info(addr, int(sq, 16) if sq else 0, cs or "")
                    )
            if st.timestamp < nxt:
                continue
            if st.baro_alt is None and st.geom_alt is None:
                continue
            while st.timestamp > nxt + interval_ms and slice_i < num_slices - 1:
                nxt += interval_ms
                slice_i += 1
            si = min(slice_i, num_slices - 1)
            slices[si].append(_heat_point(addr & 0xFFFFFF, st))
            nxt += interval_ms
            slice_i += 1
            if slice_i >= num_slices:
                break

    # assemble: index + per-slice special sauce + entries
    body = []
    offsets = []
    count = 0
    for i in range(num_slices):
        offsets.append(count + num_slices)
        ts = start_ms + i * interval_ms
        body.append(HEAT_ENTRY.pack(
            0xE7F7C9D, _i32(ts >> 32), _i32(ts), min(32767, interval_ms), 0
        ))
        count += 1
        for e in slices[i]:
            body.append(e)
            count += 1
    index = b"".join(HEAT_ENTRY.pack(off, 0, 0, 0, 0) for off in offsets)

    utc = time.gmtime((start_ms) / 1000)
    date_dir = os.path.join(base_dir, time.strftime("%Y-%m-%d", utc))
    heat_dir = os.path.join(date_dir, "heatmap")
    os.makedirs(heat_dir, exist_ok=True)
    half_hour = utc.tm_hour * 2 + utc.tm_min // 30
    path = os.path.join(heat_dir, f"{half_hour:02d}.bin.ttf")
    _atomic_write(path, gzip.compress(index + b"".join(body), 9))
    return path
