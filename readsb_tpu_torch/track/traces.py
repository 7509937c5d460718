"""Per-aircraft position history ("traces").

Re-expresses the reference's trace machinery (globe_index.c:2286-2655
traceAdd, track.c:3218-3330 to_state/to_state_all, globe_index.c:1016-1477
mark_legs, json_out.c:1395-1505 sprintTracePoint):

- each committed point is a quantized `State` (lat/lon 1e-6 deg, gs x10,
  track x100, alt /6.25, rate /8, roll x100, 12-bit IAS) — the same
  quantization as the reference's packed 24-byte struct state so the JSON
  output decodes to identical values
- every SFOUR-th committed point carries a full `all` snapshot
  (callsign/squawk/nav/accuracy fields), the state_all analog
- a one-point *position buffer* smooths the decision logic: points are
  provisionally buffered and either upgraded to committed or replaced,
  exactly following traceAdd's save_state/save_state_no_buf/no_save_state
  flow
- older history is frozen into zstd-compressed chunks (stateChunks)
- mark_legs segments the trace into flight legs by major climb/descent
  analysis with threshold = mean_altitude/3 clamped to [200, 2500] ft

A copy of readsb_tpu's `track/traces.py`.  Two things differ:

- zstd is the port's own codec (`io/zstd.py`, libzstd through ctypes) in
  place of the `zstandard` package;
- every chunk is read back through `load_chunk`, whose unpickler maps
  readsb_tpu's `State` to this module's.  A trace restored from a state
  directory that readsb_tpu wrote holds chunks pickled with readsb_tpu's
  class; a bare `pickle.loads` would import readsb_tpu to read them.  Any
  other readsb_tpu module is refused.
"""

from __future__ import annotations

import bisect
import dataclasses
import io
import math
import pickle
import weakref
from typing import Optional

from ..io import zstd

MS = 1
SECONDS = 1000
MINUTES = 60 * SECONDS

SFOUR = 4
TRACE_RECENT_POINTS = 142  # traceRecentPoints analog (readsb.h)
CHUNK_POINTS = 256  # committed points per compressed chunk

_GS_FACTOR = 10.0
_TRACK_FACTOR = 100.0
_ALT_FACTOR = 1 / 6.25
_RATE_FACTOR = 1 / 8.0
_ROLL_FACTOR = 100.0


class _ChunkUnpickler(pickle.Unpickler):
    """Reads a chunk of this module's States or of readsb_tpu's, never
    importing readsb_tpu."""

    def find_class(self, module: str, name: str):
        if module == "readsb_tpu.track.traces":
            module = __name__
        elif module.split(".")[0] == "readsb_tpu":
            raise pickle.UnpicklingError(f"{module}.{name} is no trace class")
        return super().find_class(module, name)


def load_chunk(blob: bytes) -> list:
    """The States of one zstd(pickle(list[State])) chunk."""
    return _ChunkUnpickler(io.BytesIO(zstd.decompress(blob))).load()


def _freeze(states: list) -> bytes:
    return zstd.compress(pickle.dumps(states, protocol=4), 3)


def _greatcircle(lat0, lon0, lat1, lon1) -> float:
    lat0, lon0, lat1, lon1 = map(math.radians, (lat0, lon0, lat1, lon1))
    dlat, dlon = lat1 - lat0, lon1 - lon0
    a = math.sin(dlat / 2) ** 2 + math.cos(lat0) * math.cos(lat1) * math.sin(dlon / 2) ** 2
    return 6371e3 * 2 * math.asin(min(1.0, math.sqrt(a)))


@dataclasses.dataclass
class State:
    """Quantized trace point (struct state analog, track.h:132-168)."""

    timestamp: int = 0  # ms
    lat: int = 0  # 1e-6 deg
    lon: int = 0
    on_ground: bool = False
    stale: bool = False
    leg_marker: bool = False
    gs: Optional[int] = None  # x10 kt
    track: Optional[int] = None  # x100 deg
    baro_alt: Optional[int] = None  # /6.25 ft
    baro_rate: Optional[int] = None  # /8 fpm
    geom_alt: Optional[int] = None
    geom_rate: Optional[int] = None
    ias: Optional[int] = None
    roll: Optional[int] = None  # x100 deg
    addrtype: int = 0
    receiver_id: int = 0
    all: Optional[dict] = None  # state_all snapshot on every SFOUR-th point


def _q(v: float, factor: float) -> int:
    return int(round(v * factor))


def to_state(a, now: int, on_ground: bool, track: Optional[float], stale: bool) -> State:
    """to_state (track.c:3218-3279): quantize the aircraft's current state."""
    st = State(
        timestamp=now,
        lat=int(round(a.lat * 1e6)),
        lon=int(round(a.lon * 1e6)),
        on_ground=on_ground,
        stale=stale,
        addrtype=int(a.addrtype),
    )
    if a.gs is not None and a.gs_valid.valid(now):
        st.gs = _q(a.gs, _GS_FACTOR)
    if track is not None and track > -1:
        st.track = _q(track, _TRACK_FACTOR)
    if a.baro_alt is not None and a.baro_alt_valid.valid(now):
        st.baro_alt = _q(a.baro_alt, _ALT_FACTOR)
    if a.baro_rate is not None and a.baro_rate_valid.valid(now):
        st.baro_rate = _q(a.baro_rate, _RATE_FACTOR)
    if a.geom_alt is not None and a.geom_alt_valid.valid(now):
        st.geom_alt = _q(a.geom_alt, _ALT_FACTOR)
    if a.geom_rate is not None and a.geom_rate_valid.valid(now):
        st.geom_rate = _q(a.geom_rate, _RATE_FACTOR)
    if a.ias is not None and a.ias_valid.valid(now):
        st.ias = int(a.ias)
    if a.roll is not None and a.roll_valid.valid(now):
        st.roll = _q(a.roll, _ROLL_FACTOR)
    return st


def to_state_all(a, now: int) -> dict:
    """to_state_all (track.c:3281-3330): the full-field snapshot carried by
    every SFOUR-th point; only valid fields are stored."""
    d: dict = {}
    if a.callsign and a.callsign_valid.valid(now):
        d["flight"] = a.callsign
    if a.squawk is not None and a.squawk_valid.valid(now):
        d["squawk"] = f"{a.squawk:04x}"
    if a.category is not None:
        d["category"] = f"{a.category:02X}"
    if a.nav_qnh is not None and a.nav_qnh_valid.valid(now):
        d["nav_qnh"] = round(a.nav_qnh, 1)
    if a.nav_altitude_mcp is not None and a.nav_altitude_mcp_valid.valid(now):
        d["nav_altitude_mcp"] = a.nav_altitude_mcp
    if a.nav_altitude_fms is not None and a.nav_altitude_fms_valid.valid(now):
        d["nav_altitude_fms"] = a.nav_altitude_fms
    if a.nav_heading is not None and a.nav_heading_valid.valid(now):
        d["nav_heading"] = round(a.nav_heading, 2)
    if a.tas is not None and a.tas_valid.valid(now):
        d["tas"] = a.tas
    if a.mach is not None and a.mach_valid.valid(now):
        d["mach"] = round(a.mach, 3)
    if a.track_rate is not None and a.track_rate_valid.valid(now):
        d["track_rate"] = round(a.track_rate, 2)
    if a.mag_heading is not None and a.mag_heading_valid.valid(now):
        d["mag_heading"] = round(a.mag_heading, 2)
    if a.true_heading is not None and a.true_heading_valid.valid(now):
        d["true_heading"] = round(a.true_heading, 2)
    if a.wind_speed is not None and a.wind_valid.valid(now):
        d["ws"] = int(round(a.wind_speed))
        d["wd"] = int(round(a.wind_dir or 0))
    if a.oat is not None and a.oat_valid.valid(now):
        d["oat"] = int(round(a.oat))
    if a.emergency is not None and a.emergency_valid.valid(now):
        d["emergency"] = a.emergency
    d["type"] = int(a.addrtype)
    if a.adsb_version >= 0:
        d["version"] = a.adsb_version
    if a.nac_p:
        d["nac_p"] = a.nac_p
    if a.nac_v:
        d["nac_v"] = a.nac_v
    if a.sil:
        d["sil"] = a.sil
    d["alert"] = 1 if a.alert else 0
    d["spi"] = 1 if a.spi else 0
    return d


class Trace:
    """Committed + buffered trace of one aircraft."""

    __slots__ = ("points", "chunks", "chunk_meta", "buffered", "len_total",
                 "dirty", "next_marker", "__weakref__")

    def __init__(self):
        self.points: list[State] = []
        self.chunks: list[bytes] = []  # zstd(pickle(list[State]))
        self.chunk_meta: list[tuple[int, int, int]] = []  # (n, ts_first, ts_last)
        self.buffered: Optional[State] = None
        self.len_total = 0
        self.dirty = False
        self.next_marker = 0  # committed index counter for SFOUR snapshots

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self.len_total

    def last(self) -> Optional[State]:
        return self.points[-1] if self.points else None

    def full(self) -> list[State]:
        """Reassemble the complete trace (reassembleTrace analog)."""
        out: list[State] = []
        for blob in self.chunks:
            out.extend(load_chunk(blob))
        out.extend(self.points)
        return out

    def since(self, ts: int) -> list[State]:
        """Points with timestamp >= ts (skips chunks entirely older)."""
        out: list[State] = []
        for blob, (_n, _first, last_ts) in zip(self.chunks, self.chunk_meta):
            if last_ts < ts:
                continue
            out.extend(s for s in load_chunk(blob) if s.timestamp >= ts)
        i = bisect.bisect_left([s.timestamp for s in self.points], ts)
        out.extend(self.points[i:])
        return out

    def _commit(self, st: State) -> None:
        self.points.append(st)
        self.len_total += 1
        self.dirty = True
        if len(self.points) > CHUNK_POINTS + TRACE_RECENT_POINTS:
            frozen = self.points[:CHUNK_POINTS]
            self.points = self.points[CHUNK_POINTS:]
            self.chunks.append(_freeze(frozen))
            self.chunk_meta.append(
                (len(frozen), frozen[0].timestamp, frozen[-1].timestamp)
            )

    def prune(self, keep_after_ts: int) -> None:
        """tracePrune: drop chunks fully before keep_after_ts."""
        while self.chunk_meta and self.chunk_meta[0][2] < keep_after_ts:
            self.len_total -= self.chunk_meta[0][0]
            self.chunks.pop(0)
            self.chunk_meta.pop(0)

    def delete_range(self, ts_from: int, ts_to: int) -> int:
        """Remove points in [ts_from, ts_to] ms — the cmd.sock deleteTrace
        command (handleCommandSocket, net_io.c:3725-3740).  Chunks
        overlapping the window are rewritten."""
        removed = 0
        new_chunks, new_meta = [], []
        for blob, (n, first, last_ts) in zip(self.chunks, self.chunk_meta):
            if last_ts < ts_from or first > ts_to:
                new_chunks.append(blob)
                new_meta.append((n, first, last_ts))
                continue
            pts = [s for s in load_chunk(blob)
                   if not (ts_from <= s.timestamp <= ts_to)]
            removed += n - len(pts)
            if pts:
                new_chunks.append(_freeze(pts))
                new_meta.append((len(pts), pts[0].timestamp, pts[-1].timestamp))
        self.chunks, self.chunk_meta = new_chunks, new_meta
        before = len(self.points)
        self.points = [s for s in self.points
                       if not (ts_from <= s.timestamp <= ts_to)]
        removed += before - len(self.points)
        self.len_total -= removed
        self.dirty = True
        return removed

    # ------------------------------------------------------------------

    def add(self, a, now: int, stale: bool = False,
            json_trace_interval: int = 8 * SECONDS, recursed: bool = False) -> bool:
        """traceAdd (globe_index.c:2286-2655): decide whether the current
        position deserves a committed point, a buffered provisional point,
        or nothing. Returns True when a point was committed."""
        from ..decode.fields import AirGround, Source

        save_state_no_buf = False

        max_elapsed = json_trace_interval
        min_elapsed = min(250, max_elapsed // 4)
        turn_density = 5.0
        max_speed_diff = 5.0

        alt = a.baro_alt
        alt_valid = a.baro_alt is not None and a.baro_alt_valid.valid(now)
        if alt_valid and a.baro_alt > 10000:
            max_speed_diff *= 2

        pos_source = a.position_valid.source
        if max_elapsed > 5 * SECONDS and pos_source == Source.MLAT:
            min_elapsed = 1500
            max_elapsed = max(max_elapsed // 2, 5 * SECONDS)
        if a.squawk == 0x7777 and a.squawk_valid.source != Source.INVALID:
            min_elapsed = max_elapsed

        on_ground = False
        track = a.track if (
            a.track is not None and a.track_valid.valid(now)
            and a.track_valid.source != Source.MLAT
        ) else None

        ag_valid = a.airground_valid.valid(now)
        if ag_valid and a.airground == AirGround.GROUND:
            on_ground = True
            track = a.true_heading if (
                a.true_heading is not None and a.true_heading_valid.valid(now)
            ) else None

        if max_elapsed > 5 * SECONDS and pos_source != Source.MLAT and track is None:
            max_elapsed = max(max_elapsed // 4, 5 * SECONDS)

        last = self.last()
        if last is None:
            st = to_state(a, now, on_ground, track, stale)
            self.buffered = None
            self._commit_with_snapshot(st, a, now)
            return True

        elapsed = max(0, now - last.timestamp)
        buffered = self.buffered
        elapsed_buffered = (buffered.timestamp - last.timestamp) if buffered else 0
        if elapsed_buffered < 0:
            buffered = self.buffered = None
            elapsed_buffered = 0

        new_lat = int(round(a.lat * 1e6))
        new_lon = int(round(a.lon * 1e6))
        duplicate = elapsed < 1 * SECONDS and new_lat == last.lat and new_lon == last.lon

        alt_diff = 0
        if last.baro_alt is not None and alt_valid:
            alt_diff = abs(a.baro_alt - int(last.baro_alt / _ALT_FACTOR))

        speed_diff = 0.0
        if (a.gs is not None and a.gs_valid.valid(now) and last.gs is not None
                and a.gs_valid.source != Source.MLAT):
            speed_diff = abs(last.gs / _GS_FACTOR - a.gs)

        baro_rate_diff = 0.0
        if (a.baro_rate is not None and a.baro_rate_valid.valid(now)
                and last.baro_rate is not None and a.baro_rate_valid.source != Source.MLAT):
            baro_rate_diff = abs(last.baro_rate / _RATE_FACTOR - a.baro_rate)

        if not ag_valid and not alt_valid:
            on_ground = last.on_ground
        if on_ground:
            track = a.true_heading if (
                a.true_heading is not None and a.true_heading_valid.valid(now)
            ) else None

        track_diff = 0.0
        if last.track is not None and track is not None:
            d = (track - last.track / _TRACK_FACTOR + 180.0) % 360.0 - 180.0
            track_diff = abs(d)

        distance = _greatcircle(last.lat / 1e6, last.lon / 1e6, a.lat, a.lon)

        def decide() -> str:
            nonlocal save_state_no_buf
            if speed_diff >= max_speed_diff:
                if buffered is not None and last.gs == buffered.gs:
                    save_state_no_buf = True
                else:
                    return "save"
            if baro_rate_diff >= 450:
                return "save"
            if on_ground != last.on_ground:
                return "save"
            if elapsed > 10 * max_elapsed:
                return "save"
            if alt_valid and last.baro_alt is None:
                return "save"
            if alt_diff > 0:
                if alt <= 7000:
                    max_diff = 200 if (buffered is not None and last.baro_alt == buffered.baro_alt) else 100
                elif alt <= 12000:
                    max_diff = 200
                else:
                    max_diff = 400
                if alt_diff >= max_diff:
                    if alt_diff == max_diff or (buffered is not None and last.baro_alt == buffered.baro_alt):
                        save_state_no_buf = True
                    else:
                        return "save"
                base = 800
                if alt <= 7000:
                    base = 125
                elif alt <= 12000:
                    base = 250
                too_long = (max_elapsed / 4) * base / max(1.0, float(alt_diff))
                if alt_diff >= 25 and elapsed > too_long:
                    save_state_no_buf = True
            if elapsed < min_elapsed:
                return "none"
            if a.squawk == 0x7700:
                return "save"
            if not on_ground and elapsed > max_elapsed:
                return "save"
            if stale:
                return "save"
            if on_ground:
                if elapsed > 4 * max_elapsed:
                    return "save"
                if distance > 10 and elapsed > max_elapsed:
                    return "save"
                if (a.gs or 0) > 5 and elapsed > max_elapsed / 2:
                    return "save"
                if distance * track_diff > 130:
                    return "save"
                if distance > 50:
                    return "save"
            if track_diff > 0.5 and (elapsed / 1000.0 * track_diff * turn_density > 100.0):
                return "save"
            if save_state_no_buf:
                return "save_no_buf"
            return "none"

        outcome = decide()

        if outcome == "save":
            # prefer committing the buffered position for a better picture
            # of the change (globe_index.c:2577-2590)
            if not recursed and buffered is not None and (
                elapsed > max_elapsed or 2 * elapsed_buffered > elapsed or elapsed_buffered > 2700
            ):
                self._commit_with_snapshot(buffered, a, now)
                self.buffered = None
                self.add(a, now, stale, json_trace_interval, recursed=True)
                return True
            pos_used = True
        elif outcome == "save_no_buf":
            pos_used = True
        else:
            pos_used = False

        if duplicate:
            return False

        st = to_state(a, now, on_ground, track, stale)
        if pos_used:
            self._commit_with_snapshot(st, a, now)
            self.buffered = None
            return True
        self.buffered = st
        return False

    def _commit_with_snapshot(self, st: State, a, now: int) -> None:
        """Every SFOUR-th committed point carries the full snapshot
        (fourState layout, track.h:251-257)."""
        if self.next_marker % SFOUR == 0 and st.all is None:
            st.all = to_state_all(a, now)
        self.next_marker += 1
        self._commit(st)


# ---------------------------------------------------------------------------
# mark_legs (globe_index.c:1016-1477)
# ---------------------------------------------------------------------------


def mark_legs(states: list[State], start: int = 0) -> int:
    """Segment a trace into flight legs; sets State.leg_marker.
    Returns the number of legs marked."""
    if len(states) < 20:
        return 0
    start = max(0, start)

    def altitude_of(st: State, last_air: list) -> tuple[int, bool]:
        alt_valid = st.baro_alt is not None
        alt = int(st.baro_alt / _ALT_FACTOR) if alt_valid else 0
        if not alt_valid and st.geom_alt is not None:
            alt_valid = True
            alt = int(st.geom_alt / _ALT_FACTOR)
        return alt, alt_valid

    # pass 1: average altitude -> threshold
    last_five = [0] * 5
    st0 = states[start]
    if st0.baro_alt is not None:
        last_five = [int(st0.baro_alt / _ALT_FACTOR)] * 5
    five_pos = 0
    last_air_alt = None
    total = 0.0
    count = 0
    step = SFOUR if len(states) <= 256 * SFOUR else 4 * SFOUR
    for i in range(start - (start % SFOUR), len(states), step):
        st = states[i]
        alt, alt_valid = altitude_of(st, last_five)
        if st.on_ground or not alt_valid:
            if last_air_alt is None:
                last_air_alt = sum(last_five) // 5
            alt = last_air_alt
        else:
            last_air_alt = None
            last_five[five_pos] = alt
            five_pos = (five_pos + 1) % 5
        total += alt
        count += 1
    threshold = int(total / (count * 3)) if count else 200
    threshold = min(2500, max(200, threshold))

    # pass 2: major climb/descent tracking
    high, low = 0, 100000
    major_climb = major_descent = 0
    major_climb_index = major_descent_index = 0
    last_high = last_low = 0
    last_low_index = 0
    last_airborne = last_ground = 0
    last_ground_index = first_ground_index = 0
    first_ground = 0
    last_5min_gap_index = -1
    was_ground = False
    legs = 0

    last_air_alt = None
    last_five = [int(st0.baro_alt / _ALT_FACTOR)] * 5 if st0.baro_alt is not None else [0] * 5
    five_pos = 0

    start = max(1, start)
    prev_i = start - 1
    prev = states[prev_i]
    for index in range(start, len(states)):
        p, p_i = prev, prev_i
        st = states[index]
        elapsed = st.timestamp - p.timestamp
        if elapsed < 5 * SECONDS:
            continue
        prev, prev_i = st, index

        if elapsed > 5 * MINUTES:
            last_5min_gap_index = index

        alt, alt_valid = altitude_of(st, last_five)
        on_ground = st.on_ground
        if on_ground or not alt_valid:
            if last_air_alt is None:
                last_air_alt = sum(last_five) // 5
            alt = last_air_alt
        else:
            last_air_alt = None
            last_five[five_pos] = alt
            five_pos = (five_pos + 1) % 5

        if on_ground or was_ground:
            if st.timestamp > last_ground + 5 * MINUTES:
                first_ground = st.timestamp
                first_ground_index = index
            last_ground = st.timestamp
            last_ground_index = index
        else:
            last_airborne = st.timestamp

        if was_ground:
            low = high = alt
        if alt >= high:
            high = alt
        if (not on_ground and major_descent and last_ground >= major_descent
                and last_ground > first_ground + 1 * MINUTES
                and st.timestamp > last_ground + 15 * SECONDS
                and high - low > 200):
            high = low + threshold + 1
            last_high = st.timestamp
            last_low = last_ground
            last_low_index = last_ground_index
        if alt <= low:
            low = alt
        if abs(low - alt) < threshold // 3:
            last_low = st.timestamp
            last_low_index = index
        if abs(high - alt) < threshold // 3:
            last_high = st.timestamp

        if high - low > threshold:
            if last_high > last_low:
                if major_climb <= major_descent:
                    bla = min(len(states) - 1, last_low_index + 3)
                    major_climb = states[bla].timestamp
                    major_climb_index = bla
                low = high - threshold * 9 // 10
            elif last_low > last_high:
                k = max(0, last_low_index - 3)
                while k > 0:
                    s2 = states[k]
                    if s2.baro_alt is not None and not s2.on_ground:
                        break
                    k -= 1
                major_descent = states[k].timestamp
                major_descent_index = k
                high = low + threshold * 9 // 10

        leg_now = bool(
            (major_descent and (on_ground or was_ground) and elapsed > 25 * MINUTES)
            or (major_descent and on_ground and st.timestamp > last_airborne + 45 * MINUTES)
        )
        leg_float = False
        if major_climb and major_descent and major_climb > major_descent + 12 * MINUTES:
            if last_5min_gap_index >= 0 and last_5min_gap_index >= major_descent_index:
                gs = states[last_5min_gap_index]
                galt = gs.baro_alt / _ALT_FACTOR if gs.baro_alt is not None else None
                if gs.on_ground or galt is None or galt < 20000:
                    leg_float = True
        if (major_climb and major_descent and major_climb > major_descent + 1 * MINUTES
                and last_ground >= major_descent and last_ground > first_ground + 1 * MINUTES):
            leg_float = True

        if leg_float or leg_now:
            new_leg = None
            if leg_now:
                new_leg = st
                for k in range(p_i + 1, index):
                    if states[k].timestamp > states[k - 1].timestamp + 5 * MINUTES:
                        new_leg = states[k]
                        break
            elif major_descent_index + 1 == major_climb_index:
                new_leg = states[major_climb_index]
            else:
                for i2 in range(major_climb_index, major_descent_index, -1):
                    if states[i2].timestamp > states[i2 - 1].timestamp + 5 * MINUTES:
                        new_leg = states[i2]
                        break
                if new_leg is None:
                    if last_ground > major_descent:
                        half = first_ground + (last_ground - first_ground) // 2
                        for i2 in range(first_ground_index + 1, last_ground_index + 1):
                            if states[i2].timestamp > half:
                                new_leg = states[i2]
                                break
                    else:
                        half = major_descent + (major_climb - major_descent) // 2
                        for i2 in range(major_descent_index + 1, major_climb_index):
                            if states[i2].timestamp > half:
                                new_leg = states[i2]
                                break
            if new_leg is not None:
                new_leg.leg_marker = True
                legs += 1
            major_climb = major_descent = 0
            major_climb_index = major_descent_index = 0
            low += threshold
            high -= threshold
            if new_leg is not None and new_leg.on_ground:
                high, low = 0, 100000

        was_ground = on_ground
    return legs


# ---------------------------------------------------------------------------
# Trace JSON rows (sprintTracePoint, json_out.c:1395-1505)
# ---------------------------------------------------------------------------

_ADDRTYPE_SHORT = {
    0: "adsb_icao", 1: "adsb_icao_nt", 2: "adsr_icao", 3: "tisb_icao",
    4: "adsc", 5: "mlat", 6: "other", 7: "mode_s", 8: "adsb_other",
    9: "adsr_other", 10: "tisb_trackfile", 11: "tisb_other", 12: "mode_ac",
    13: "unknown",
}


def trace_rows(states: list[State], reference_ts: int) -> list[list]:
    """[[dt, lat, lon, alt|"ground"|null, gs, track, flags, baro_rate,
    aircraft|null, source-type, alt_geom, geom_rate, ias, roll], ...]"""
    rows = []
    for st in states:
        baro_alt = int(st.baro_alt / _ALT_FACTOR) if st.baro_alt is not None else None
        geom_alt = int(st.geom_alt / _ALT_FACTOR) if st.geom_alt is not None else None
        baro_rate = int(st.baro_rate / _RATE_FACTOR) if st.baro_rate is not None else None
        geom_rate = int(st.geom_rate / _RATE_FACTOR) if st.geom_rate is not None else None

        altitude, altitude_geom = baro_alt, False
        if altitude is None and geom_alt is not None:
            altitude, altitude_geom = geom_alt, True
        rate, rate_geom = baro_rate, False
        if rate is None and geom_rate is not None:
            rate, rate_geom = geom_rate, True

        bitfield = (
            (8 if altitude_geom else 0) | (4 if rate_geom else 0)
            | (2 if st.leg_marker else 0) | (1 if st.stale else 0)
        )
        rows.append([
            round((st.timestamp - reference_ts) / 1000.0, 2),
            st.lat / 1e6,
            st.lon / 1e6,
            "ground" if st.on_ground else altitude,
            round(st.gs / _GS_FACTOR, 1) if st.gs is not None else None,
            round(st.track / _TRACK_FACTOR, 1) if st.track is not None else None,
            bitfield,
            rate,
            st.all if st.all else None,
            _ADDRTYPE_SHORT.get(st.addrtype, "unknown"),
            geom_alt,
            geom_rate,
            st.ias,
            round(st.roll / _ROLL_FACTOR, 1) if st.roll is not None else None,
        ])
    return rows


def trace_json(a, states: list[State], now: int, reference_ts: int = 0) -> dict:
    """generateTraceJson (json_out.c:1727-1847)."""
    from ..decode.fields import MODES_NON_ICAO_ADDRESS

    doc: dict = {}
    addr = a.addr
    doc["icao"] = ("~%06x" % (addr & 0xFFFFFF)) if addr & MODES_NON_ICAO_ADDRESS else (
        "%06x" % addr
    )
    if a.registration:
        doc["r"] = a.registration
    if a.type_code:
        doc["t"] = a.type_code
    if a.registration or a.type_code or a.db_flags:
        doc["dbFlags"] = a.db_flags
    desc = getattr(a, "type_long", "")
    if desc:
        doc["desc"] = desc
    first = states[0].timestamp if states else now
    if not reference_ts or first < reference_ts:
        reference_ts = first
    doc["timestamp"] = round(reference_ts / 1000.0, 3)
    doc["trace"] = trace_rows(states, reference_ts)
    return doc


# ---------------------------------------------------------------------------
# Incremental trace-render cache (traceCache, json_out.c:1501-1726)
# ---------------------------------------------------------------------------
#
# The reference caches rendered JSON fragments so a trace write only
# renders what changed.  Here the cached unit is the per-chunk rows list
# (chunks are immutable once frozen): a chunk whose last point is older
# than TRACE_CACHE_COLD_MS renders once per (chunk, reference_ts) and is
# reused until pruned.  Leg markers inside a cold cached chunk are
# computed per segment rather than over the whole reassembled history
# (the reference recomputes legs globally each write, globe_index.c:1016);
# a leg boundary that falls exactly on a cold-chunk edge may therefore
# differ until the neighbouring data also goes cold — the flag is
# advisory display metadata, and freezing it is what makes 10k-aircraft
# sweeps affordable in Python.

TRACE_CACHE_COLD_MS = 30 * 60 * 1000
_RENDER_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def render_cache_memory() -> int:
    """Rough bytes held by the render cache (readsb_trace_cache_memory)."""
    total = 0
    for cache in _RENDER_CACHE.values():
        for _ref, rows in cache.values():
            total += 64 * len(rows)
    return total


def render_full_cached(tr: Trace, now: int) -> tuple[list, list, int]:
    """(rows_cold, warm_states, reference_ts): cold chunks from the cache,
    warm chunks + live points reassembled for fresh rendering; the caller
    runs mark_legs over warm_states and appends trace_rows of them."""
    metas = list(tr.chunk_meta)
    reference_ts = (
        metas[0][1] if metas else (tr.points[0].timestamp if tr.points else now)
    )
    cache = _RENDER_CACHE.get(tr)
    if cache is None:
        cache = {}
        _RENDER_CACHE[tr] = cache
    # drop entries for pruned chunks
    live = set(metas)
    for k in [k for k in cache if k not in live]:
        del cache[k]

    cold_limit = now - TRACE_CACHE_COLD_MS
    rows_cold: list = []
    warm_states: list[State] = []
    for blob, meta in zip(tr.chunks, tr.chunk_meta):
        if meta[2] <= cold_limit and not warm_states:
            ent = cache.get(meta)
            if ent is None or ent[0] != reference_ts:
                states = load_chunk(blob)
                mark_legs(states)
                ent = (reference_ts, trace_rows(states, reference_ts))
                cache[meta] = ent
            rows_cold.extend(ent[1])
        else:
            # once a warm chunk appears, everything after is fresh too
            warm_states.extend(load_chunk(blob))
    warm_states.extend(tr.points)
    return rows_cold, warm_states, reference_ts
