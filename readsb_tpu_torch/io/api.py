"""/re-api query endpoint: HTTP/1.1-subset server over a query snapshot.

Query grammar mirrors the reference (README-json.md:122-202, parseFetch
api.c:1081-1357): ?circle=lat,lon,radius_nmi  ?closest=lat,lon,radius
?box=latS,latN,lonW,lonE  ?all  ?all_with_pos  ?find_hex=h1,h2  ?find_callsign=
?find_reg=  ?find_type=  with &filter_squawk / &above_alt_baro /
&below_alt_baro / &filter_with_pos / &filter_callsign_prefix /
&filter_callsign_exact / &filter_mil / &filter_interesting / &filter_pia /
&filter_ladd (OR-combined dbFlag filters, api.c:133-146) / &jv2 /
&binCraft (+&zstd) modifiers, and ?status health check.  Responses carry
now / resultCount / ptime; circle/closest add per-aircraft dst (nmi), dir.

Queries never touch the live aircraft dict: a double-buffered snapshot
(apiUpdate, api.c:859-938) holds lat-sorted numpy columns, hex/callsign/
reg/type indexes, pre-rendered JSON fragments, and binCraft records; the
app's periodic loop rebuilds it and swaps the reference atomically.
Box queries bisect the sorted latitude column; circle queries run a
vectorized haversine over the position subset.

A copy of readsb_tpu's API server.  `&binCraft&zstd` compresses with the
port's zstd codec (`io/zstd.py`) at readsb_tpu's level.
"""

from __future__ import annotations

import asyncio
import json
import math
import struct
import time
from typing import Optional
from urllib.parse import parse_qsl, urlsplit

import numpy as np

from ..track.tracker import TRACK_EXPIRE, bearing, greatcircle
from .json_out import aircraft_dict

BINCRAFT_VERSION = 20240218


class ApiSnapshot:
    """Immutable query snapshot of the aircraft store (api.c:859-938)."""

    def __init__(self, tracker, now: int):
        self.now = now
        entries = []  # (sort_lat, a)
        for a in tracker.aircraft.values():
            if now >= a.seen + TRACK_EXPIRE:
                continue
            has_pos = bool(a.seen_pos and tracker.pos_reliable(a))
            entries.append((a.lat if has_pos else 1e9, has_pos, a))
        entries.sort(key=lambda e: e[0])

        n = len(entries)
        self.lat = np.full(n, 1e9)
        self.lon = np.zeros(n)
        self.alt_baro = np.full(n, -(1 << 30), np.int64)
        self.addr = np.zeros(n, np.uint32)
        self.db_flags = np.zeros(n, np.int64)
        self.squawk = np.full(n, -1, np.int64)
        self.has_pos = np.zeros(n, bool)
        self.frag: list[bytes] = []
        self.bin: list[bytes] = []
        self.by_hex: dict[int, int] = {}
        self.by_callsign: dict[str, list[int]] = {}
        self.by_reg: dict[str, list[int]] = {}
        self.by_type: dict[str, list[int]] = {}
        self.callsigns: list[str] = []
        self.n_pos = 0

        from .bincraft import to_bincraft

        for i, (_slat, has_pos, a) in enumerate(entries):
            if has_pos:
                self.lat[i] = a.lat
                self.lon[i] = a.lon
                self.has_pos[i] = True
                self.n_pos += 1
            if isinstance(a.baro_alt, int):
                self.alt_baro[i] = a.baro_alt
            self.addr[i] = a.addr & 0xFFFFFF
            self.db_flags[i] = a.db_flags
            if a.squawk is not None:
                self.squawk[i] = a.squawk
            self.by_hex[a.addr & 0xFFFFFF] = i
            cs = a.callsign.strip().upper()
            self.callsigns.append(cs)
            if cs:
                self.by_callsign.setdefault(cs, []).append(i)
            if a.registration:
                self.by_reg.setdefault(a.registration.upper(), []).append(i)
            if a.type_code:
                self.by_type.setdefault(a.type_code.upper(), []).append(i)
            self.frag.append(
                json.dumps(
                    aircraft_dict(tracker, a, now), separators=(",", ":")
                ).encode()
            )
            self.bin.append(to_bincraft(tracker, a, now))
        self.elem_size = len(self.bin[0]) if self.bin else 112

    # -- query primitives ------------------------------------------------

    def box(self, lat_s, lat_n, lon_w, lon_e) -> np.ndarray:
        lo = int(np.searchsorted(self.lat, lat_s, side="left"))
        hi = int(np.searchsorted(self.lat, lat_n, side="right"))
        idx = np.arange(lo, hi)
        if len(idx) == 0:
            return idx
        lon = self.lon[idx]
        keep = self.has_pos[idx] & (lon >= lon_w) & (lon <= lon_e)
        return idx[keep]

    def circle(self, lat, lon, radius_m) -> tuple[np.ndarray, np.ndarray]:
        idx = np.nonzero(self.has_pos)[0]
        if len(idx) == 0:
            return idx, np.zeros(0)
        la0, lo0 = math.radians(lat), math.radians(lon)
        la = np.radians(self.lat[idx])
        lo = np.radians(self.lon[idx])
        h = (
            np.sin((la - la0) / 2) ** 2
            + math.cos(la0) * np.cos(la) * np.sin((lo - lo0) / 2) ** 2
        )
        d = 6371e3 * 2 * np.arcsin(np.minimum(1.0, np.sqrt(h)))
        keep = d <= radius_m
        idx, d = idx[keep], d[keep]
        order = np.argsort(d, kind="stable")
        return idx[order], d[order]


def _bincraft_header(now_ms: int, elem_size: int, ac_count_pos: int, box) -> bytes:
    """Response header element (apiReq binCraft branch, api.c:609-660)."""
    south, north, west, east = -90, 90, -180, 180
    if box is not None:
        south, north, west, east = (int(round(v)) for v in box)
    h = struct.pack(
        "<qIIIhhhhI",
        now_ms, elem_size, ac_count_pos, 0,
        south, west, north, east, BINCRAFT_VERSION,
    )
    return h + b"\x00" * (elem_size - len(h))


class ApiServer:
    def __init__(self, app):
        self.app = app
        self.server: Optional[asyncio.AbstractServer] = None
        self.snapshot: Optional[ApiSnapshot] = None
        self._last_update = 0.0
        # --api-shutdown-delay: existing queries drain, new ones get 503
        self.draining = False
        self.request_count = 0  # readsb_api_request_count (stats.c:798)

    MAX_TARGET = 16384  # request-line cap (apiReadRequest bounds its buffer)

    async def listen(self, port: int, host: str = "0.0.0.0") -> None:
        self.server = await asyncio.start_server(self.handle, host, port)

    async def listen_unix(self, path: str) -> None:
        """Unix-socket listener (--net-api-port with a path; api.c:1967
        supports both TCP ports and unix sockets)."""
        import os

        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self.server = await asyncio.start_unix_server(self.handle, path)

    def update(self, now: int) -> None:
        """Rebuild + atomically swap the snapshot (apiUpdate)."""
        self.snapshot = ApiSnapshot(self.app.tracker, now)
        self._last_update = time.time()

    def _fresh_snapshot(self) -> ApiSnapshot:
        # the periodic loop rebuilds each tick; a request never rebuilds
        # synchronously (the latency spike api.c's double buffer avoids) —
        # it serves the existing snapshot, building only the very first one
        if self.snapshot is None:
            self.update(self.app.now_ms())
        return self.snapshot

    async def handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                if len(line) > self.MAX_TARGET:
                    writer.write(
                        b"HTTP/1.1 413 Payload Too Large\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n\r\n"
                    )
                    await writer.drain()
                    return
                parts = line.decode("latin1").split()
                if len(parts) < 2:
                    return
                target = parts[1]
                while True:
                    h = await reader.readline()
                    if not h or h in (b"\r\n", b"\n"):
                        break
                if self.draining:
                    body, status, ctype = (
                        b'{"error":"shutting down"}', "503 Service Unavailable",
                        "application/json",
                    )
                else:
                    body, status, ctype = self.respond(target)
                head = (
                    f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\nConnection: keep-alive\r\n\r\n"
                )
                writer.write(head.encode() + body)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # ------------------------------------------------------------------

    def respond(self, target: str) -> tuple[bytes, str, str]:
        self.request_count += 1
        t0 = time.perf_counter()
        split = urlsplit(target)
        qs = split.query or (
            split.path.lstrip("/?")
            if "=" in split.path
            or split.path.strip("/?") in ("all", "all_with_pos", "status")
            else ""
        )
        q = dict(parse_qsl(qs, keep_blank_values=True))

        if "status" in q:
            return b'{"status": "ok"}', "200 OK", "application/json"

        snap = self._fresh_snapshot()
        now = snap.now
        idx: Optional[np.ndarray] = None
        dists = None
        is_circle = False
        circle_ref = None
        box_vals = None

        try:
            if "all" in q:
                idx = np.arange(len(snap.frag))
            elif "all_with_pos" in q:
                idx = np.nonzero(snap.has_pos)[0]
            elif "box" in q:
                lat_s, lat_n, lon_w, lon_e = map(float, q["box"].split(","))
                box_vals = (lat_s, lat_n, lon_w, lon_e)
                idx = snap.box(lat_s, lat_n, lon_w, lon_e)
            elif "circle" in q or "closest" in q:
                key = "circle" if "circle" in q else "closest"
                lat, lon, radius = map(float, q[key].split(","))
                is_circle = True
                circle_ref = (lat, lon)
                idx, d = snap.circle(lat, lon, radius * 1852.0)
                if key == "closest":
                    idx, d = idx[:1], d[:1]
                dists = d
            elif "find_hex" in q or "hexlist" in q:
                hexes = (q.get("find_hex") or q.get("hexlist")).split(",")[:1000]
                rows = []
                for h in hexes:
                    try:
                        i = snap.by_hex.get(int(h.strip().lstrip("~"), 16))
                    except ValueError:
                        continue
                    if i is not None:
                        rows.append(i)
                idx = np.array(sorted(set(rows)), dtype=int)
            elif "find_callsign" in q:
                rows = []
                for c in q["find_callsign"].split(","):
                    rows += snap.by_callsign.get(c.strip().upper(), [])
                idx = np.array(sorted(set(rows)), dtype=int)
            elif "find_reg" in q:
                rows = []
                for c in q["find_reg"].split(","):
                    rows += snap.by_reg.get(c.strip().upper(), [])
                idx = np.array(sorted(set(rows)), dtype=int)
            elif "find_type" in q:
                rows = []
                for c in q["find_type"].split(","):
                    rows += snap.by_type.get(c.strip().upper(), [])
                idx = np.array(sorted(set(rows)), dtype=int)
            else:
                return b'{"error": "query not understood"}', "400 Bad Request", "application/json"
        except (ValueError, KeyError):
            return b'{"error": "bad query"}', "400 Bad Request", "application/json"

        # modifiers (all vectorized over the snapshot columns)
        def keep(mask: np.ndarray):
            nonlocal idx, dists
            idx = idx[mask]
            if dists is not None:
                dists = dists[mask]

        if "filter_squawk" in q and q["filter_squawk"]:
            try:
                keep(snap.squawk[idx] == int(q["filter_squawk"], 16))
            except ValueError:
                pass
        if "filter_with_pos" in q:
            keep(snap.has_pos[idx])
        if "filter_callsign_prefix" in q and q["filter_callsign_prefix"]:
            pref = q["filter_callsign_prefix"].upper()
            keep(np.array([snap.callsigns[i].startswith(pref) for i in idx], bool))
        if "filter_callsign_exact" in q and q["filter_callsign_exact"]:
            want = q["filter_callsign_exact"].strip().upper()
            keep(np.array([snap.callsigns[i] == want for i in idx], bool))
        if "above_alt_baro" in q and q["above_alt_baro"]:
            try:
                keep(snap.alt_baro[idx] >= int(q["above_alt_baro"]))
            except ValueError:
                pass
        if "below_alt_baro" in q and q["below_alt_baro"]:
            try:
                lim = int(q["below_alt_baro"])
                keep((snap.alt_baro[idx] <= lim) & (snap.alt_baro[idx] > -(1 << 30)))
            except ValueError:
                pass
        # OR-combined dbFlag filters (api.c:133-146)
        db_mask = 0
        for name, bit in (
            ("filter_mil", 1), ("filter_interesting", 2),
            ("filter_pia", 4), ("filter_ladd", 8),
        ):
            if name in q:
                db_mask |= bit
        if db_mask:
            keep((snap.db_flags[idx] & db_mask) != 0)

        ptime = (time.perf_counter() - t0) * 1000.0

        if "binCraft" in q:
            payload = _bincraft_header(now, snap.elem_size, snap.n_pos, box_vals)
            payload += b"".join(snap.bin[i] for i in idx)
            ctype = "application/octet-stream"
            if "zstd" in q:
                from . import zstd

                payload = zstd.compress(payload, 1)
                ctype = "application/zstd"
            return payload, "200 OK", ctype

        parts = []
        for row, i in enumerate(idx):
            frag = snap.frag[i]
            if is_circle:
                d = float(dists[row]) if dists is not None else greatcircle(
                    circle_ref[0], circle_ref[1], snap.lat[i], snap.lon[i]
                )
                extra = ',"dst":%.3f,"dir":%.1f}' % (
                    d / 1852.0,
                    bearing(circle_ref[0], circle_ref[1], snap.lat[i], snap.lon[i]),
                )
                frag = frag[:-1] + extra.encode()
            parts.append(frag)

        if "jv2" in q:
            doc = b'{"ac":[' + b",".join(parts) + (
                '],"msg":"No error","now":%d,"total":%d,"ctime":%d,"ptime":%d}'
                % (now, len(parts), now, round(ptime))
            ).encode()
        else:
            doc = b'{"now":%.3f,"aircraft":[' % (now / 1000.0) + b",".join(parts) + (
                '],"resultCount":%d,"ptime":%.3f}' % (len(parts), ptime)
            ).encode()
        return doc, "200 OK", "application/json"
