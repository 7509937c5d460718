"""Per-feeder receiver quality DB (analog of the reference's receiver.c).

Tracks, per receiverId (the 64-bit feeder identity carried by Beast 0xE3
prefixes / --net-receiver-id), a lat/lon extent box grown from reliable
ADS-B positions, good/bad counters, and quarantine timeouts:

- receiverPositionReceived (receiver.c:141-246): reliable airborne ADS-B
  positions grow the extent box; positions > 800 km from the box center
  are RANGE_BAD and flag the receiver's extent as suspect unless several
  distinct aircraft agree
- receiverGetReference (receiver.c:247-290): the box center serves as the
  reference position for local/relative CPR of remote receivers, once
  >= 100 positions were seen and the extent is sane
- receiverBad / receiverCheckBad (receiver.c:320-351): feeders producing
  repeated implausible positions are quarantined for 12 s ("garbage")
- receiverTimeout (receiver.c:79-115): drop receivers idle > 24 h and
  decay oversized extent boxes
- receivers.json (receiver.c:352-409)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

MS = 1
SECONDS = 1000
MINUTES = 60 * SECONDS
HOURS = 60 * MINUTES

RECEIVER_MAX_RANGE = 800e3  # meters (receiver.c:3)
RECEIVER_BAD_AIRCRAFT = 3

RANGE_GOOD = 0
RANGE_BAD = 1
RANGE_UNCLEAR = 2


def _greatcircle(lat0, lon0, lat1, lon1) -> float:
    lat0, lon0, lat1, lon1 = map(math.radians, (lat0, lon0, lat1, lon1))
    dlat, dlon = lat1 - lat0, lon1 - lon0
    a = math.sin(dlat / 2) ** 2 + math.cos(lat0) * math.cos(lat1) * math.sin(dlon / 2) ** 2
    return 6371e3 * 2 * math.asin(min(1.0, math.sqrt(a)))


@dataclasses.dataclass
class Receiver:
    id: int
    first_seen: int = 0
    last_seen: int = 0
    position_counter: int = 0
    lat_min: float = 0.0
    lat_max: float = 0.0
    lon_min: float = 0.0
    lon_max: float = 0.0
    good_counter: int = 0
    bad_counter: float = 0.0
    timed_out_counter: int = 0
    timed_out_until: int = 0
    bad_extent: int = 0  # ts when the extent became suspect, 0 = fine
    bad_aircraft: list = dataclasses.field(default_factory=list)  # [(addr, ts)]

    @property
    def lat(self) -> float:
        return self.lat_min + (self.lat_max - self.lat_min) / 2

    @property
    def lon(self) -> float:
        return self.lon_min + (self.lon_max - self.lon_min) / 2


class ReceiverStore:
    def __init__(self, position_persistence: int = 4, lenient: bool = False):
        self.receivers: dict[int, Receiver] = {}
        self.position_persistence = position_persistence
        # viewadsb / receiver-focus mode lowers the thresholds (receiver.c:146,271)
        self.reliability_required = (
            min(2, position_persistence) if lenient else position_persistence * 3 // 4
        )
        self.position_counter_required = 4 if lenient else 100

    def get(self, rid: int) -> Optional[Receiver]:
        return self.receivers.get(rid)

    def get_or_create(self, rid: int, now: int) -> Receiver:
        r = self.receivers.get(rid)
        if r is None:
            r = Receiver(id=rid, first_seen=now, last_seen=now)
            self.receivers[rid] = r
        return r

    # ------------------------------------------------------------------

    def position_received(self, aircraft, mm, lat: float, lon: float, now: int) -> int:
        """receiverPositionReceived (receiver.c:141-246)."""
        from ..decode.fields import CprType, Source

        need = self.reliability_required
        no_modify = (
            mm.source != Source.ADSB
            or mm.cpr_type == CprType.SURFACE
            or aircraft.pos_reliable_odd < need
            or aircraft.pos_reliable_even < need
        )
        return self.position_received_row(
            mm.receiver_id, aircraft.addr, no_modify, lat, lon, now
        )

    def position_received_row(
        self, rid: int, addr: int, no_modify: bool,
        lat: float, lon: float, now: int,
    ) -> int:
        """Row-level receiverPositionReceived core (receiver.c:141-246) —
        shared by the dict tracker and the columnar BulkTracker (which
        computes no_modify from its columns)."""
        if rid == 0 or lat > 85.0 or lat < -85.0 or lon < -179.9 or lon > 179.9:
            return RANGE_UNCLEAR

        r = self.receivers.get(rid)
        if r is None or r.position_counter == 0:
            if no_modify:
                return RANGE_UNCLEAR
            r = self.get_or_create(rid, now)
            r.lat_min = r.lat_max = lat
            r.lon_min = r.lon_max = lon

        distance = _greatcircle(r.lat, r.lon, lat, lon)

        if not no_modify:
            if distance < RECEIVER_MAX_RANGE:
                r.lat_min = min(r.lat_min, lat)
                r.lat_max = max(r.lat_max, lat)
                r.lon_min = min(r.lon_min, lon)
                r.lon_max = max(r.lon_max, lon)
                r.good_counter += 1
                r.bad_counter = max(0.0, r.bad_counter - 0.5)

            if not r.bad_extent and distance > RECEIVER_MAX_RANGE:
                # require several distinct aircraft to agree before
                # distrusting the whole extent (receiver.c:200-230)
                bad_extent = True
                for ad0, _ts in r.bad_aircraft:
                    if ad0 == addr:
                        bad_extent = False
                        break
                if bad_extent:
                    r.bad_aircraft = [
                        (ad, ts) for ad, ts in r.bad_aircraft if now - ts <= 3 * MINUTES
                    ]
                    if len(r.bad_aircraft) < RECEIVER_BAD_AIRCRAFT:
                        r.bad_aircraft.append((addr, now))
                        bad_extent = False
                if bad_extent:
                    r.bad_extent = now

            r.position_counter += 1
            r.last_seen = now

        if distance > RECEIVER_MAX_RANGE:
            return RANGE_BAD
        return RANGE_GOOD

    def position_received_cols(self, rids, addrs, no_modify, lat, lon, now):
        """Columnar receiverPositionReceived over one round of rows.

        Verdicts are computed against each feeder's round-entry box center
        and box updates are applied per feeder at round end — the same
        ordering looseness the reference's decodePool threads have.  A
        feeder whose box is not yet established falls back to the serial
        row path (seeding is genuinely order-dependent).  Established
        feeders are handled fully vectorized: one haversine over all rows
        and sorted-group reductions per feeder.  Returns an int verdict
        array (RANGE_GOOD/BAD/UNCLEAR)."""
        import numpy as np

        n = len(rids)
        verdict = np.full(n, RANGE_UNCLEAR, np.int64)
        ok = (
            (rids != 0)
            & (lat <= 85.0) & (lat >= -85.0)
            & (lon >= -179.9) & (lon <= 179.9)
        )
        if not ok.any():
            return verdict
        idx = np.nonzero(ok)[0]
        uniq, inv = np.unique(rids[idx], return_inverse=True)
        recs = [self.receivers.get(int(u)) for u in uniq]
        est = np.array(
            [r is not None and r.position_counter > 0 for r in recs]
        )

        # seeding feeders: serial per row (order-dependent by design)
        for u in np.nonzero(~est)[0]:
            for k in idx[inv == u]:
                verdict[k] = self.position_received_row(
                    int(rids[k]), int(addrs[k]), bool(no_modify[k]),
                    float(lat[k]), float(lon[k]), int(now[k]),
                )
        if not est.any():
            return verdict

        sel = est[inv]
        rows = idx[sel]
        g = inv[sel]  # feeder group per row (index into uniq/recs)
        clat = np.array([r.lat if r is not None else 0.0 for r in recs])
        clon = np.array([r.lon if r is not None else 0.0 for r in recs])
        la0 = np.radians(clat[g])
        lo0 = np.radians(clon[g])
        la1 = np.radians(lat[rows])
        lo1 = np.radians(lon[rows])
        h = (
            np.sin((la1 - la0) / 2) ** 2
            + np.cos(la0) * np.cos(la1) * np.sin((lo1 - lo0) / 2) ** 2
        )
        d = 6371e3 * 2 * np.arcsin(np.minimum(1.0, np.sqrt(h)))
        verdict[rows] = np.where(d > RECEIVER_MAX_RANGE, RANGE_BAD, RANGE_GOOD)

        mod = ~no_modify[rows]
        if not mod.any():
            return verdict
        within = mod & (d < RECEIVER_MAX_RANGE)
        # per-feeder aggregation via sort + reduceat
        order = np.argsort(g, kind="stable")
        gs = g[order]
        bounds = np.nonzero(np.r_[True, gs[1:] != gs[:-1]])[0]
        for base, u in zip(bounds, gs[bounds]):
            end = bounds[bounds > base]
            end = int(end[0]) if len(end) else len(gs)
            rr = order[base:end]
            r = recs[u]
            w = within[rr]
            if w.any():
                rw = rows[rr[w]]
                r.lat_min = min(r.lat_min, float(lat[rw].min()))
                r.lat_max = max(r.lat_max, float(lat[rw].max()))
                r.lon_min = min(r.lon_min, float(lon[rw].min()))
                r.lon_max = max(r.lon_max, float(lon[rw].max()))
                cnt = int(w.sum())
                r.good_counter += cnt
                r.bad_counter = max(0.0, r.bad_counter - 0.5 * cnt)
            far = mod[rr] & (d[rr] > RECEIVER_MAX_RANGE)
            if far.any() and not r.bad_extent:
                for k in rows[rr[far]]:
                    bad_extent = True
                    for ad0, _ts in r.bad_aircraft:
                        if ad0 == int(addrs[k]):
                            bad_extent = False
                            break
                    if bad_extent:
                        nk = int(now[k])
                        r.bad_aircraft = [
                            (ad, ts) for ad, ts in r.bad_aircraft
                            if nk - ts <= 3 * MINUTES
                        ]
                        if len(r.bad_aircraft) < RECEIVER_BAD_AIRCRAFT:
                            r.bad_aircraft.append((int(addrs[k]), nk))
                            bad_extent = False
                    if bad_extent:
                        r.bad_extent = int(now[k])
                        break
            nmod = int(mod[rr].sum())
            if nmod:
                r.position_counter += nmod
                r.last_seen = int(now[rows[rr[mod[rr]]]].max())
        return verdict

    def get_reference(self, rid: int) -> Optional[tuple[float, float]]:
        """receiverGetReference (receiver.c:247-290)."""
        r = self.receivers.get(rid)
        if r is None:
            return None
        if r.position_counter < self.position_counter_required or r.bad_extent:
            return None
        return r.lat, r.lon

    # ------------------------------------------------------------------

    def check_bad(self, rid: int, now: int) -> bool:
        """receiverCheckBad: is this feeder currently quarantined?"""
        r = self.receivers.get(rid)
        return r is not None and now < r.timed_out_until

    def bad(self, rid: int, addr: int, now: int) -> Optional[Receiver]:
        """receiverBad (receiver.c:320-351): count an implausible position,
        quarantine after ~6 within the window."""
        r = self.get_or_create(rid, now)
        timeout = 12 * SECONDS
        if now + (timeout * 2 // 3) > r.timed_out_until:
            r.last_seen = now
            r.bad_counter += 1
            if r.bad_counter > 5.99:
                r.timed_out_counter += 1
                r.timed_out_until = now + timeout
                r.good_counter = 0
                r.bad_counter = 0.0
            return r
        return None

    # ------------------------------------------------------------------

    def maintenance(self, now: int, interval_ms: int = 10 * SECONDS) -> int:
        """receiverTimeout + extent decay (receiver.c:60-115)."""
        decay = 0.005 * interval_ms / SECONDS
        dead = []
        for rid, r in self.receivers.items():
            if now > r.last_seen + 24 * HOURS or (
                r.bad_extent and now > r.bad_extent + 30 * MINUTES
            ):
                dead.append(rid)
                continue
            if r.lat_max - r.lat_min > 10:
                r.lat_max -= decay
                r.lat_min += decay
            if r.lon_max - r.lon_min > 10:
                r.lon_max -= decay
                r.lon_min += decay
        for rid in dead:
            del self.receivers[rid]
        return len(dead)

    # ------------------------------------------------------------------

    def receivers_json(self, now: int) -> dict:
        """generateReceiversJson (receiver.c:352-409): rows of
        [id, posRate, timeoutsPerHour, latMin, latMax, lonMin, lonMax,
        badExtent, lat, lon]."""
        rows = []
        for r in self.receivers.values():
            elapsed = (r.last_seen - r.first_seen) / 1000.0 + 1.0
            rows.append([
                f"{r.id:016x}",
                round(r.position_counter / elapsed, 2),
                round(r.timed_out_counter * 3600.0 / elapsed, 2),
                round(r.lat_min, 2), round(r.lat_max, 2),
                round(r.lon_min, 2), round(r.lon_max, 2),
                1 if r.bad_extent else 0,
                round(r.lat, 2), round(r.lon, 2),
            ])
        return {"now": now / 1000.0, "receivers": rows}
