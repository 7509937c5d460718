"""Polar range histogram + actual-range outline.

Reference: Modes.rangeDirs[RANGEDIRS_IVALS=64][RANGEDIRS_BUCKETS=360]
(readsb.h:327-328,878), updated per reliable position in
update_range_histogram (track.c:252-300): time is split into 64
intervals of range_outline_duration/63 each; per (interval, bearing
degree) the farthest position (distance, lat, lon, alt) is kept, and a
jump of >50 nmi beyond the 24h per-direction record from a
not-yet-reliable position is rejected.  outline.json is the per-degree
max over all intervals (generateOutlineJson, json_out.c:1931-1968).
`save` / `load` persist the table as rangeDirs.gz beside the state blobs,
in readsb_tpu's layout.

Structure-of-arrays numpy tables: the sweep over 64x360 is a vectorized
reduction rather than a scalar loop.
"""

from __future__ import annotations

import gzip
import json
import struct

import numpy as np

IVALS = 64
BUCKETS = 360
NMI = 1852.0


class RangeOutline:
    def __init__(self, duration_ms: int = 24 * 3600 * 1000):
        self.duration_ms = duration_ms
        self.distance = np.zeros((IVALS, BUCKETS), dtype=np.float32)  # meters
        self.lat = np.zeros((IVALS, BUCKETS), dtype=np.float32)
        self.lon = np.zeros((IVALS, BUCKETS), dtype=np.float32)
        self.alt = np.zeros((IVALS, BUCKETS), dtype=np.int32)
        self.last_ival = -1

    def update(
        self,
        now: int,
        distance_m: float,
        direction_deg: float,
        lat: float,
        lon: float,
        alt: int,
        reliable: bool,
        json_reliable: int = 1,
    ) -> None:
        b = int(round(direction_deg)) % BUCKETS
        ival = (now * (IVALS - 1) // self.duration_ms) % IVALS
        if ival != self.last_ival:
            self.distance[ival] = 0
            self.lat[ival] = 0
            self.lon[ival] = 0
            self.alt[ival] = 0
            self.last_ival = ival
        if distance_m > self.distance[ival, b] and not reliable:
            # unproven positions may only extend a direction's 24h record
            # by 50 nmi (track.c:272-284)
            direction_max = float(self.distance[:, b].max()) + 50.0 * NMI
            if distance_m > direction_max and json_reliable > 0:
                return
        if distance_m > self.distance[ival, b]:
            self.distance[ival, b] = distance_m
            self.lat[ival, b] = lat
            self.lon[ival, b] = lon
            self.alt[ival, b] = alt

    def outline_json(self) -> bytes:
        """`{"actualRange":{"last24h":{"points":[[lat,lon,alt],...]}}}`."""
        best = self.distance.argmax(axis=0)
        cols = np.arange(BUCKETS)
        lat = self.lat[best, cols]
        lon = self.lon[best, cols]
        alt = self.alt[best, cols]
        mask = (lat != 0) | (lon != 0)
        points = [
            [round(float(lat[i]), 4), round(float(lon[i]), 4), int(alt[i])]
            for i in cols[mask]
        ]
        return json.dumps(
            {"actualRange": {"last24h": {"points": points}}}, separators=(",", ":")
        ).encode()

    # -- persistence (rangeDirs.gz analog; own little-endian layout) --

    _MAGIC = b"RTPU-RANGEDIRS1\n"

    def save(self, path: str) -> None:
        with gzip.open(path, "wb") as f:
            f.write(self._MAGIC)
            f.write(struct.pack("<iq", self.last_ival, self.duration_ms))
            for arr in (self.distance, self.lat, self.lon, self.alt):
                f.write(arr.tobytes())

    def load(self, path: str) -> bool:
        try:
            with gzip.open(path, "rb") as f:
                if f.read(len(self._MAGIC)) != self._MAGIC:
                    return False
                self.last_ival, self.duration_ms = struct.unpack("<iq", f.read(12))
                n = IVALS * BUCKETS
                self.distance = np.frombuffer(f.read(4 * n), dtype=np.float32).reshape(IVALS, BUCKETS).copy()
                self.lat = np.frombuffer(f.read(4 * n), dtype=np.float32).reshape(IVALS, BUCKETS).copy()
                self.lon = np.frombuffer(f.read(4 * n), dtype=np.float32).reshape(IVALS, BUCKETS).copy()
                self.alt = np.frombuffer(f.read(4 * n), dtype=np.int32).reshape(IVALS, BUCKETS).copy()
            return True
        except (OSError, struct.error, ValueError):
            return False
