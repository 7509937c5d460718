"""Columnar bulk tracker: the aggregator-scale ingest path (arena v2).

The dict tracker (tracker.py) is the semantic oracle but tops out around
30k msgs/s — per-message Python.  This module processes whole drained
batches as numpy columns:

  slot mapping    vectorized (sorted-address translate + np.searchsorted)
  sequencing      messages grouped by slot; round r applies the r-th
                  message of every slot simultaneously, so per-slot order
                  is exactly serial while the work is vectorized across
                  slots (the batch analog of the reference's decodePool
                  with staged locks, net_io.c:5365-5474)
  field accepts   accept_data lattice (track.c:128-221) as masked stores
  position chain  CPR pair accept -> global/surface/local decode ->
                  speed check -> set position, ported column-for-column
                  from tracker.py (itself a faithful port of
                  track.c:312-1385); float math in f64 numpy — CPR needs
                  double precision, which TPUs lack natively; this is the
                  deliberate host half of the arena split (arena.py keeps
                  the device SoA for plain lattice fields)

Equivalence: tests/test_bulk.py replays a capture through both paths and
diffs every tracked column (positions, reliability, NIC/Rc, CPR state,
counters) exactly.

v3 scope = full aggregator parity: batches carrying a `receiver_id`
column (and remote=True) run the CPR network duplicate cache
(track.c:312-349), the per-feeder receiver-quality DB
(receiverPositionReceived / receiverBad, receiver.c:141-246,320-351) and
the cross-feeder speed-check rules; `receiver_lat=None` selects
multi-receiver (aggregator) operation, where surface CPR references come
from the feeder extent boxes.  Covered message shapes are those of
decode/batch.py; anything else should take the scalar path.

A copy of readsb_tpu's columnar tracker, unchanged; the port's dict
tracker and receiver store are its oracle and its helpers.
"""

from __future__ import annotations

import numpy as np

from ..decode.fields import AirGround, Source
from .tracker import (
    CPR_MAX_INTERVAL,
    MINUTES,
    POS_RELIABLE_TIMEOUT,
    SECONDS,
    TRACK_EXPIRE,
    TRACK_EXPIRE_LONG,
    TRACK_STALE,
    compute_nic,
    compute_rc,
)

_INVALID = int(Source.INVALID)
KT2MS = 1852.0 / 3600.0

_NL_BOUNDS_ARR = None


def _nl_bounds():
    global _NL_BOUNDS_ARR
    if _NL_BOUNDS_ARR is None:
        from ..decode.cpr import _NL_BOUNDS

        _NL_BOUNDS_ARR = (
            np.array([b for b, _ in _NL_BOUNDS]),
            np.array([v for _, v in _NL_BOUNDS] + [1], dtype=np.int64),
        )
    return _NL_BOUNDS_ARR


def nl_vec(lat: np.ndarray) -> np.ndarray:
    bounds, vals = _nl_bounds()
    return vals[np.searchsorted(bounds, np.abs(lat), side="right")]


def greatcircle_vec(lat0, lon0, lat1, lon1):
    la0, lo0, la1, lo1 = map(np.radians, (lat0, lon0, lat1, lon1))
    dlat = la1 - la0
    dlon = lo1 - lo0
    a = np.sin(dlat / 2) ** 2 + np.cos(la0) * np.cos(la1) * np.sin(dlon / 2) ** 2
    return 6371e3 * 2 * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def bearing_vec(lat0, lon0, lat1, lon1):
    la0, lo0, la1, lo1 = map(np.radians, (lat0, lon0, lat1, lon1))
    y = np.sin(lo1 - lo0) * np.cos(la1)
    x = np.cos(la0) * np.sin(la1) - np.sin(la0) * np.cos(la1) * np.cos(lo1 - lo0)
    return (np.degrees(np.arctan2(y, x)) + 360.0) % 360.0


def _mod(a, b):
    r = np.mod(a, b)
    return r  # np.mod already yields non-negative for positive b


def decode_airborne_vec(elat, elon, olat, olon, fflag):
    """Vectorized global airborne CPR decode (cpr.c:170; cpr.py port).

    Returns (lat, lon, ok)."""
    dlat0 = 360.0 / 60.0
    dlat1 = 360.0 / 59.0
    j = np.floor(((59 * elat - 60 * olat) / 131072) + 0.5)
    rlat0 = dlat0 * (_mod(j, 60) + elat / 131072)
    rlat1 = dlat1 * (_mod(j, 59) + olat / 131072)
    rlat0 = np.where(rlat0 >= 270, rlat0 - 360, rlat0)
    rlat1 = np.where(rlat1 >= 270, rlat1 - 360, rlat1)
    ok = (
        (rlat0 >= -90) & (rlat0 <= 90) & (rlat1 >= -90) & (rlat1 <= 90)
    )
    nl0 = nl_vec(rlat0)
    nl1 = nl_vec(rlat1)
    ok &= nl0 == nl1
    nlv = np.where(fflag, nl1, nl0)
    rlat = np.where(fflag, rlat1, rlat0)
    ni = np.maximum(nlv - np.where(fflag, 1, 0), 1)
    m = np.floor((((elon * (nlv - 1)) - (olon * nlv)) / 131072.0) + 0.5)
    dlon = 360.0 / ni
    rlon = dlon * (_mod(m, ni) + np.where(fflag, olon, elon) / 131072)
    rlon -= np.floor((rlon + 180) / 360) * 360
    return rlat, rlon, ok


def decode_surface_vec(reflat, reflon, elat, elon, olat, olon, fflag):
    """Vectorized global surface decode (cpr.c:223)."""
    dlat0 = 90.0 / 60.0
    dlat1 = 90.0 / 59.0
    j = np.floor(((59 * elat - 60 * olat) / 131072) + 0.5)
    rlat0 = dlat0 * (_mod(j, 60) + elat / 131072)
    rlat1 = dlat1 * (_mod(j, 59) + olat / 131072)

    def quad(rl):
        zero = rl == 0
        rl = np.where(zero & (reflat < -45), -90.0, rl)
        rl = np.where(zero & (reflat > 45), 90.0, rl)
        rl = np.where(~zero & ((rl - reflat) > 45), rl - 90, rl)
        return rl

    rlat0 = quad(rlat0)
    rlat1 = quad(rlat1)
    ok = (rlat0 >= -90) & (rlat0 <= 90) & (rlat1 >= -90) & (rlat1 <= 90)
    nl0 = nl_vec(rlat0)
    nl1 = nl_vec(rlat1)
    ok &= nl0 == nl1
    nlv = np.where(fflag, nl1, nl0)
    rlat = np.where(fflag, rlat1, rlat0)
    ni = np.maximum(nlv - np.where(fflag, 1, 0), 1)
    m = np.floor((((elon * (nlv - 1)) - (olon * nlv)) / 131072.0) + 0.5)
    dlon = 90.0 / ni
    rlon = dlon * (_mod(m, ni) + np.where(fflag, olon, elon) / 131072)
    rlon += np.floor((reflon - rlon + 45) / 90) * 90
    rlon -= np.floor((rlon + 180) / 360) * 360
    return rlat, rlon, ok


def decode_relative_vec(reflat, reflon, cprlat, cprlon, fflag, surface):
    """Vectorized relative decode (cpr.c:331)."""
    frac_lat = cprlat / 131072.0
    frac_lon = cprlon / 131072.0
    dlat = np.where(surface, 90.0, 360.0) / np.where(fflag, 59.0, 60.0)
    j = np.floor(reflat / dlat) + np.floor(
        0.5 + np.mod(reflat, dlat) / dlat - frac_lat
    )
    rlat = dlat * (j + frac_lat)
    rlat = np.where(rlat >= 270, rlat - 360, rlat)
    ok = (rlat >= -90) & (rlat <= 90) & (np.abs(rlat - reflat) <= dlat / 2)
    safe_lat = np.where(ok, rlat, 0.0)
    ni = np.maximum(nl_vec(safe_lat) - np.where(fflag, 1, 0), 1)
    dlon = np.where(surface, 90.0, 360.0) / ni
    m = np.floor(reflon / dlon) + np.floor(
        0.5 + np.mod(reflon, dlon) / dlon - frac_lon
    )
    rlon = dlon * (m + frac_lon)
    rlon = np.where(rlon > 180, rlon - 360, rlon)
    ok &= np.abs(rlon - reflon) <= dlon / 2
    return rlat, rlon, ok


def _nicrc_v0():
    """nic/rc lookup for (metype, nic_b) at version 0 (no opstatus)."""
    nic = np.zeros((32, 2), np.int64)
    rc = np.zeros((32, 2))
    for mt in range(32):
        for nb in range(2):
            nic[mt, nb] = compute_nic(mt, 0, 0, nb, 0)
            rc[mt, nb] = compute_rc(mt, 0, 0, nb, 0)
    return nic, rc


_NIC_V0, _RC_V0 = _nicrc_v0()


class _Cols:
    """Growable SoA column set."""

    def __init__(self, cap: int):
        self.cap = cap
        z = np.zeros
        self.addr = z(cap, np.int64)
        self.seen = z(cap, np.int64)
        self.messages = z(cap, np.int64)
        # accept-lattice fields: (value, ts, src)
        for f in ("gs", "tas", "ias", "track", "th"):
            setattr(self, f, z(cap))
            setattr(self, f + "_ts", np.full(cap, -(1 << 60), np.int64))
            setattr(self, f + "_src", np.full(cap, _INVALID, np.int64))
        self.alt = z(cap, np.int64)
        self.alt_ts = np.full(cap, -(1 << 60), np.int64)
        self.alt_src = np.full(cap, _INVALID, np.int64)
        self.alt_reliable = z(cap, np.int64)  # updateAltitude score (track.c:1709)
        # baro_alt ever assigned (dict baro_alt is not None) — alt_src alone
        # can't express this since score exhaustion invalidates the source
        # while the stale value is retained (track.c:1793-1800)
        self.alt_set = z(cap, bool)
        for f in ("baro_rate", "geom_rate"):
            setattr(self, f, z(cap, np.int64))
            setattr(self, f + "_ts", np.full(cap, -(1 << 60), np.int64))
            setattr(self, f + "_src", np.full(cap, _INVALID, np.int64))
        # last-8 signal-power ring (tracker signal_ring; json rssi)
        self.sig_ring = z((cap, 8))
        self.sig_n = z(cap, np.int64)
        # squawk + double-confirmation tentative (track.c:2071-2092); -1 = unset
        self.squawk = np.full(cap, -1, np.int64)
        self.squawk_ts = np.full(cap, -(1 << 60), np.int64)
        self.squawk_src = np.full(cap, _INVALID, np.int64)
        self.squawk_tent = np.full(cap, -1, np.int64)
        # ms timestamp of the last tentative change (track.c squawkTentativeChanged)
        self.squawk_tent_ts = np.full(cap, -(1 << 60), np.int64)
        self.cs = z((cap, 8), np.uint8)
        self.cs_ts = np.full(cap, -(1 << 60), np.int64)
        self.cs_src = np.full(cap, _INVALID, np.int64)
        self.ag = np.full(cap, int(AirGround.INVALID), np.int64)
        self.ag_ts = np.full(cap, -(1 << 60), np.int64)
        self.ag_src = np.full(cap, _INVALID, np.int64)
        # position state
        self.lat = z(cap)
        self.lon = z(cap)
        self.seen_pos = z(cap, np.int64)
        self.pv_ts = np.full(cap, -(1 << 60), np.int64)
        self.pv_src = np.full(cap, _INVALID, np.int64)
        self.pv_last = np.full(cap, _INVALID, np.int64)
        self.rel_odd = z(cap)
        self.rel_even = z(cap)
        self.pos_surface = z(cap, bool)
        self.pos_nic = z(cap, np.int64)
        self.pos_rc = z(cap)
        self.gs_last_pos = z(cap)
        self.prev_lat = z(cap)
        self.prev_lon = z(cap)
        self.prev_ts = z(cap, np.int64)
        self.su = z(cap, np.int64)  # speed_unreliable
        self.tu = z(cap, np.int64)  # track_unreliable
        self.seen_pos_global = z(cap, np.int64)
        self.allow_ac_rel = z(cap, bool)
        self.surf_allow = z(cap, bool)
        self.lat_rel = z(cap)
        self.lon_rel = z(cap)
        self.last_override_ts = z(cap, np.int64)
        # CPR pairs: index 0 = even, 1 = odd
        self.c_lat = z((cap, 2), np.int64)
        self.c_lon = z((cap, 2), np.int64)
        self.c_surf = z((cap, 2), bool)
        self.c_nic = z((cap, 2), np.int64)
        self.c_rc = z((cap, 2))
        self.c_ts = np.full((cap, 2), -(1 << 60), np.int64)
        self.c_src = np.full((cap, 2), _INVALID, np.int64)
        # discard cache ring (track.h DISCARD_CACHE=4): ts, cpr_lat, cpr_lon
        self.dc_ts = np.full((cap, 4), -(1 << 60), np.int64)
        self.dc_lat = z((cap, 4), np.int64)
        self.dc_lon = z((cap, 4), np.int64)
        self.dc_rid = z((cap, 4), np.uint64)
        self.dc_n = z(cap, np.int64)
        self.dc_i = z(cap, np.int64)
        # CPR network-duplicate cache ring (track.h CPR_CACHE=4,
        # track.c:312-349): ts, cpr_lat, cpr_lon, receiverId
        self.cc_ts = np.full((cap, 4), -(1 << 60), np.int64)
        self.cc_lat = z((cap, 4), np.int64)
        self.cc_lon = z((cap, 4), np.int64)
        self.cc_rid = z((cap, 4), np.uint64)
        self.cc_n = z(cap, np.int64)
        self.cc_i = z(cap, np.int64)
        # feeder of the last accepted position (lastPosReceiverId)
        self.last_rid = z(cap, np.uint64)

    def grow(self, newcap: int):
        old = self.cap
        for k, v in list(self.__dict__.items()):
            if isinstance(v, np.ndarray):
                shape = (newcap,) + v.shape[1:]
                nv = np.zeros(shape, v.dtype)
                if v.dtype == np.int64 and k.endswith(("_ts", "pv_ts")):
                    nv[:] = -(1 << 60)
                if k.endswith("_src") or k in ("pv_src", "pv_last"):
                    nv[:] = _INVALID
                if k in ("squawk", "squawk_tent"):
                    nv[:] = -1
                nv[:old] = v
                self.__dict__[k] = nv
        self.cap = newcap


class BulkTracker:
    def __init__(
        self,
        receiver_lat: float | None,
        receiver_lon: float | None,
        max_range_km: float = 450 * 1.852,
        json_reliable: int = 1,
        capacity: int = 1 << 14,
        receivers=None,
    ):
        # receiver_lat=None selects aggregator (multi-receiver) operation:
        # no receiver-relative local CPR / max-range gating; surface CPR
        # references and plausibility heuristics come from the per-feeder
        # ReceiverStore instead (receiver.c:141-290)
        self.receiver_lat = receiver_lat
        self.receiver_lon = receiver_lon
        if receivers is None:
            from .receiver import ReceiverStore

            receivers = ReceiverStore()
        self.receivers = receivers
        self.max_range_m = max_range_km * 1000
        self.json_reliable = json_reliable
        self.cols = _Cols(capacity)
        self.n_slots = 0
        self._sorted_addr = np.zeros(0, np.int64)
        self._sorted_slot = np.zeros(0, np.int64)
        # counters (mirror tracker)
        self.cpr_surface = 0
        self.cpr_airborne = 0
        self.cpr_global_ok = 0
        self.cpr_global_bad = 0
        self.cpr_global_skipped = 0
        self.cpr_local_ok = 0
        self.cpr_local_skipped = 0
        self.cpr_global_speed_checks = 0
        self.cpr_local_speed_checks = 0
        self.messages_total = 0

    # ------------------------------------------------------------------

    def _slots_for(self, addrs: np.ndarray) -> np.ndarray:
        uniq = np.unique(addrs)
        if len(self._sorted_addr):
            pos = np.searchsorted(self._sorted_addr, uniq)
            pos = np.minimum(pos, len(self._sorted_addr) - 1)
            new = uniq[self._sorted_addr[pos] != uniq]
        else:
            new = uniq
        if len(new):
            need = self.n_slots + len(new)
            if need > self.cols.cap:
                self.cols.grow(max(need, self.cols.cap * 2))
            sl = np.arange(self.n_slots, need)
            self.cols.addr[sl] = new
            self.n_slots = need
            all_addr = np.concatenate([self._sorted_addr, new])
            all_slot = np.concatenate([self._sorted_slot, sl])
            order = np.argsort(all_addr, kind="stable")
            self._sorted_addr = all_addr[order]
            self._sorted_slot = all_slot[order]
        return self._sorted_slot[np.searchsorted(self._sorted_addr, addrs)]

    def _accept_cols(self, ts_col, src_col, s, m_src, now):
        """accept_data lattice over slots s (track.c:128-221)."""
        cur_src = src_col[s]
        cur_ts = ts_col[s]
        ok = (m_src != _INVALID) & (now >= cur_ts)
        ok &= ~((m_src < cur_src) & (now < cur_ts + TRACK_STALE))
        return ok

    def update_batch(self, cols: dict) -> None:
        """Apply one decoded batch (decode/batch.py columns)."""
        n = len(cols["addr"])
        if n == 0:
            return
        self.messages_total += n
        slots = self._slots_for(cols["addr"])
        order = np.argsort(slots, kind="stable")
        sslots = slots[order]
        first = np.searchsorted(sslots, sslots)
        rank = np.arange(n) - first
        nrounds = int(rank.max()) + 1 if n else 0
        for r in range(nrounds):
            rows = order[rank == r]
            self._round(rows, slots[rows], cols)

    # ------------------------------------------------------------------

    def _round(self, rows: np.ndarray, s: np.ndarray, mc: dict) -> None:
        c = self.cols
        now = mc["ts"][rows]
        src = mc["source"][rows]
        c.seen[s] = now
        c.messages[s] += 1

        psrc = np.where(src == int(Source.PRIO), int(Source.ADSB), src)

        sigv = mc.get("signal")
        if sigv is not None:
            sm = sigv[rows] > 0
            i = s[sm]
            c.sig_ring[i, c.sig_n[i] & 7] = sigv[rows][sm]
            c.sig_n[i] += 1

        def accept(field, valid_mask, values):
            ok = valid_mask & self._accept_cols(
                getattr(c, field + "_ts"), getattr(c, field + "_src"), s, src, now
            )
            i = s[ok]
            getattr(c, field)[i] = values[ok]
            getattr(c, field + "_ts")[i] = now[ok]
            getattr(c, field + "_src")[i] = psrc[ok]
            return ok

        accept("gs", mc["gs_valid"][rows], mc["gs"][rows])
        accept("track", mc["track_valid"][rows], mc["track"][rows])
        self._alt_update(rows, s, mc)
        if "baro_rate_valid" in mc:
            accept("baro_rate", mc["baro_rate_valid"][rows], mc["baro_rate"][rows])
            accept("geom_rate", mc["geom_rate_valid"][rows], mc["geom_rate"][rows])
        self._squawk_update(rows, s, mc)
        ag = mc.get("airground")
        if ag is not None:
            agr = ag[rows]
            ok = accept(
                "ag",
                (agr != int(AirGround.INVALID)) & (agr != int(AirGround.UNCERTAIN)),
                agr,
            )
            # UNCERTAIN only fills an INVALID slot (tracker.py:580-584)
            un = (agr == int(AirGround.UNCERTAIN)) & (c.ag_src[s] == _INVALID)
            c.ag[s[un]] = int(AirGround.UNCERTAIN)
        csm = mc["callsign_valid"][rows]
        if csm.any():
            ok = csm & self._accept_cols(c.cs_ts, c.cs_src, s, src, now)
            i = s[ok]
            c.cs[i] = mc["callsign"][rows[ok]]
            c.cs_ts[i] = now[ok]
            c.cs_src[i] = psrc[ok]

        pos = mc["cpr_valid"][rows]
        if pos.any():
            self._positions(rows[pos], s[pos], mc)

    def _alt_update(self, rows, s, mc):
        """Columnar updateAltitude (track.c:1709-1813), mirroring
        tracker._update_altitude row-for-row (one message per slot per
        round, so the serial logic vectorizes directly).  The modeC_hit
        reset and aggregator score tweaks are out of bulk scope."""
        c = self.cols
        valid = mc["alt_valid"][rows]
        if not valid.any():
            return
        rows = rows[valid]
        s = s[valid]
        now = mc["ts"][rows]
        src = mc["source"][rows]
        # pre-gate (track.c:2059-2068): lower-priority sources run the
        # outlier logic only once the held altitude goes stale
        cur_src0 = c.alt_src[s]
        age0 = np.maximum(0, now - c.alt_ts[s])
        pregate = (
            (src >= cur_src0)
            | (
                (age0 > 10 * SECONDS)
                & (cur_src0 != int(Source.JAERO))
                & (cur_src0 != int(Source.SBS))
            )
            | (age0 > 30 * SECONDS)
        )
        if not pregate.any():
            return
        rows = rows[pregate]
        s = s[pregate]
        now = now[pregate]
        src = src[pregate]
        psrc = np.where(src == int(Source.PRIO), int(Source.ADSB), src)
        alt = mc["alt"][rows]
        q_bit = mc["alt_q"][rows] if "alt_q" in mc else np.zeros(len(rows), bool)
        old = np.where(c.alt_set[s], c.alt[s], 0)  # dict baro_alt None -> 0

        delta = alt - old
        big = np.abs(delta) >= 300
        age_alt = np.maximum(0, now - c.alt_ts[s])
        # C trunc division (values fit f64 exactly at these magnitudes)
        fpm = np.fix(delta * 600 / (np.abs(np.fix(age_alt / 100)) + 10)).astype(
            np.int64
        )
        fpm = np.where(big, fpm, 0)

        def vcol(name):
            return (getattr(c, name + "_src")[s] != _INVALID) & (
                now < getattr(c, name + "_ts")[s] + TRACK_EXPIRE
            )

        age_gr = np.maximum(0, now - c.geom_rate_ts[s])
        age_br = np.maximum(0, now - c.baro_rate_ts[s])
        use_gr = vcol("geom_rate") & (age_gr < age_br)
        use_br = ~use_gr & vcol("baro_rate")
        slack_gr = 1500 + np.minimum(11000, age_gr // 2)
        slack_br = 1500 + np.minimum(11000, age_br // 2)
        min_fpm = np.where(
            use_gr, c.geom_rate[s] - slack_gr,
            np.where(use_br, c.baro_rate[s] - slack_br, -12500),
        )
        max_fpm = np.where(
            use_gr, c.geom_rate[s] + slack_gr,
            np.where(use_br, c.baro_rate[s] + slack_br, 12500),
        )
        # reliability decay on big jumps
        alt_fresh = vcol("alt") & (age_alt < 30 * SECONDS)
        decayed = np.where(
            alt_fresh,
            np.minimum(20 - 20 * age_alt // (30 * SECONDS), c.alt_reliable[s]),
            0,
        )
        c.alt_reliable[s] = np.where(big, decayed, c.alt_reliable[s])

        rel = c.alt_reliable[s]
        # implicit-trust scores (track.c:1746-1753): clean-CRC high-priority
        # sources rate max reliable; MLAT rates half
        crc0 = (
            mc["crc_zero"][rows]
            if "crc_zero" in mc
            else np.zeros(len(rows), bool)
        )
        good_crc = np.where(
            crc0 & ((src >= int(Source.JAERO)) | (src == int(Source.SBS))), 20, 0
        ).astype(np.int64)
        good_crc = np.where(src == int(Source.MLAT), 9, good_crc)
        qbad = (old > 50175) & q_bit & (rel > 5)
        # the q-bit branch zeroes good_crc and takes the discard path
        # (track.c:1756-1760)
        good_crc = np.where(qbad, 0, good_crc)
        accept_m = ~qbad & (
            (good_crc >= rel)
            | (src > c.alt_src[s])
            | (rel <= 0)
            | (np.abs(delta) < 300)
            | ((fpm > min_fpm) & (fpm < max_fpm))
        )
        discard_m = ~accept_m
        newrel = rel - (good_crc + 1)
        c.alt_reliable[s[discard_m]] = newrel[discard_m]
        # discard epilogue (track.c:1793-1800): clamp exhausted scores at 0
        # and invalidate the stale altitude (unless positioned via JAERO)
        exhausted = discard_m & (newrel <= 0)
        i = s[exhausted]
        c.alt_reliable[i] = 0
        inval = exhausted & (c.pv_src[s] != int(Source.JAERO))
        c.alt_src[s[inval]] = _INVALID

        latt = accept_m & self._accept_cols(c.alt_ts, c.alt_src, s, src, now)
        i = s[latt]
        c.alt_reliable[i] = np.maximum(
            0, np.minimum(20, rel[latt] + good_crc[latt] + 1)
        )
        c.alt[i] = alt[latt]
        c.alt_set[i] = True
        c.alt_ts[i] = now[latt]
        c.alt_src[i] = psrc[latt]

    def _squawk_update(self, rows, s, mc):
        """Columnar squawk double-confirmation (track.c:2071-2092).

        JAERO accepts immediately; otherwise the tentative value must have
        held unchanged for >750 ms.  The tentative is not cleared on confirm.
        (The reference's `now - a->seen < 15 s` tentative-change guard is
        always true because a->seen was set to now earlier in the same
        update, so it is elided here.)
        """
        c = self.cols
        valid = mc["squawk_valid"][rows]
        if not valid.any():
            return
        rows = rows[valid]
        s = s[valid]
        now = mc["ts"][rows]
        src = mc["source"][rows]
        psrc = np.where(src == int(Source.PRIO), int(Source.ADSB), src)
        sq = mc["squawk"][rows]
        tent = c.squawk_tent[s]
        tent_ts = c.squawk_tent_ts[s]
        will = self._accept_cols(c.squawk_ts, c.squawk_src, s, src, now)

        change_tent = (tent != sq) & will
        confirm = (src == int(Source.JAERO)) | (
            (tent == sq) & (now - tent_ts > 750)
        )
        m1 = confirm & will
        i = s[m1]
        c.squawk[i] = sq[m1]
        c.squawk_ts[i] = now[m1]
        c.squawk_src[i] = psrc[m1]

        j = s[change_tent]
        c.squawk_tent[j] = sq[change_tent]
        c.squawk_tent_ts[j] = now[change_tent]

    # ------------------------------------------------------------------

    def _positions(self, rows, s, mc):
        c = self.cols
        now = mc["ts"][rows]
        src = mc["source"][rows]
        odd = mc["cpr_odd"][rows]
        surf = mc["cpr_surface"][rows]
        clat = mc["cpr_lat"][rows]
        clon = mc["cpr_lon"][rows]
        metype = mc["metype"][rows]
        nic_b = mc["nic_b"][rows]
        par = odd.astype(np.int64)
        other = 1 - par
        rids = mc["receiver_id"][rows] if "receiver_id" in mc else None
        remote = bool(mc.get("remote")) and rids is not None

        # CPR network duplicate: the same raw CPR from a *different*
        # receiver within 2 s (cpr_duplicate_check, track.c:312-349)
        netdup = np.zeros(len(rows), bool)
        if remote:
            netdup = (
                (now[:, None] - c.cc_ts[s] < 2 * SECONDS)
                & (c.cc_lat[s] == clat[:, None])
                & (c.cc_lon[s] == clon[:, None])
                & (c.cc_rid[s] != rids[:, None])
            ).any(axis=1)
            ins = ~netdup
            if ins.any():
                i = s[ins]
                full = c.cc_n[i] >= 4
                slot4 = np.where(full, (c.cc_i[i] + 1) % 4, c.cc_n[i])
                c.cc_i[i] = np.where(full, slot4, c.cc_i[i])
                c.cc_n[i] = np.minimum(c.cc_n[i] + ~full, 4)
                c.cc_ts[i, slot4] = now[ins]
                c.cc_lat[i, slot4] = clat[ins]
                c.cc_lon[i, slot4] = clon[ins]
                c.cc_rid[i, slot4] = rids[ins]

        self.cpr_surface += int(surf.sum())
        self.cpr_airborne += int((~surf).sum())

        # pair store + NIC/Rc at accept (tracker._update_position head)
        c.c_lat[s, par] = clat
        c.c_lon[s, par] = clon
        c.c_surf[s, par] = surf
        p_nic = _NIC_V0[metype, nic_b]
        p_rc = _RC_V0[metype, nic_b]
        c.c_nic[s, par] = p_nic
        c.c_rc[s, par] = p_rc
        ok = self._accept_cols_pair(s, par, src, now)
        i = ok
        c.c_ts[s[i], par[i]] = now[i]
        c.c_src[s[i], par[i]] = src[i]

        # global decode eligibility
        o_ts = c.c_ts[s, other]
        o_src = c.c_src[s, other]
        o_surf = c.c_surf[s, other]
        p_ts = c.c_ts[s, par]
        glob = (
            (o_src != _INVALID)
            & (now < o_ts + TRACK_EXPIRE)
            & (np.abs(p_ts - o_ts) <= CPR_MAX_INTERVAL)
            & (o_surf == surf)
        )
        self.cpr_global_skipped += int((~glob).sum())

        elat = c.c_lat[s, 0].astype(np.float64)
        elon = c.c_lon[s, 0].astype(np.float64)
        olat = c.c_lat[s, 1].astype(np.float64)
        olon = c.c_lon[s, 1].astype(np.float64)

        g_lat = np.zeros(len(rows))
        g_lon = np.zeros(len(rows))
        g_ok = np.zeros(len(rows), bool)
        if glob.any():
            if (~surf).any():
                air_lat, air_lon, air_ok = decode_airborne_vec(
                    elat, elon, olat, olon, odd
                )
                g_lat, g_lon, g_ok = air_lat, air_lon, glob & air_ok
            if surf.any():
                # surface global reference chain (track.c:759-777): user
                # location, else the feeder's extent-box center, else the
                # aircraft's own reliable position
                if self.receiver_lat is not None:
                    sref_lat = np.full(len(rows), self.receiver_lat)
                    sref_lon = np.full(len(rows), self.receiver_lon)
                    sref_ok = np.ones(len(rows), bool)
                else:
                    sref_lat = np.zeros(len(rows))
                    sref_lon = np.zeros(len(rows))
                    sref_ok = np.zeros(len(rows), bool)
                    if rids is not None:
                        for rid in np.unique(rids[surf]):
                            ref = self.receivers.get_reference(int(rid))
                            if ref is not None:
                                msk = surf & (rids == rid)
                                sref_lat[msk] = ref[0]
                                sref_lon[msk] = ref[1]
                                sref_ok |= msk
                    fb = surf & ~sref_ok & (c.seen_pos[s] > 0) & c.surf_allow[s]
                    sref_lat = np.where(fb, c.lat_rel[s], sref_lat)
                    sref_lon = np.where(fb, c.lon_rel[s], sref_lon)
                    sref_ok |= fb
                su_lat, su_lon, su_ok = decode_surface_vec(
                    sref_lat, sref_lon, elat, elon, olat, olon, odd
                )
                # surface decodes >450 km from the reference are rejected
                sdist = greatcircle_vec(sref_lat, sref_lon, su_lat, su_lon)
                su_ok = su_ok & sref_ok & (sdist <= 450e3)
                if (~surf).any():
                    g_lat = np.where(surf, su_lat, g_lat)
                    g_lon = np.where(surf, su_lon, g_lon)
                    g_ok = glob & np.where(surf, su_ok, g_ok)
                else:
                    g_lat, g_lon, g_ok = su_lat, su_lon, glob & su_ok
            self.cpr_global_bad += int((glob & ~g_ok).sum())

        used_global = g_ok
        # decoded nic/rc for global: worse of the halves
        d_nic = np.minimum(c.c_nic[s, 0], c.c_nic[s, 1])
        d_rc = np.maximum(c.c_rc[s, 0], c.c_rc[s, 1])

        # local decode for the rest (tracker._do_local_cpr)
        loc_try = ~g_ok
        ac_rel = (
            loc_try
            & (now < c.seen_pos_global[s] + 10 * MINUTES)
            & c.allow_ac_rel[s]
        )
        # receiver-relative: only airborne, only with a configured receiver
        # location, and only if max_range < 360 NM (track.c:882-905)
        if (
            self.receiver_lat is None
            or self.max_range_m == 0
            or self.max_range_m >= 1852 * 360
        ):
            rec_rel = np.zeros(len(rows), bool)
            rec_limit = 0.0
        else:
            rec_rel = loc_try & ~ac_rel & ~surf
            rec_limit = (
                self.max_range_m
                if self.max_range_m <= 1852 * 180
                else 1852 * 360 - self.max_range_m
            )
        rlat0 = self.receiver_lat if self.receiver_lat is not None else 0.0
        rlon0 = self.receiver_lon if self.receiver_lon is not None else 0.0
        ref_lat = np.where(ac_rel, c.lat[s], rlat0)
        ref_lon = np.where(ac_rel, c.lon[s], rlon0)
        range_limit = np.where(ac_rel, 1852.0 * 100, rec_limit)
        l_lat, l_lon, l_ok = decode_relative_vec(ref_lat, ref_lon, clat, clon, odd, surf)
        l_ok &= ac_rel | rec_rel
        ldist = greatcircle_vec(ref_lat, ref_lon, l_lat, l_lon)
        l_ok &= ldist <= range_limit
        if self.receiver_lat is not None and self.max_range_m > 0:
            rdist = greatcircle_vec(rlat0, rlon0, l_lat, l_lon)
            l_ok &= rdist <= self.max_range_m
        self.cpr_local_ok += int(l_ok.sum())
        self.cpr_local_skipped += int((loc_try & ~l_ok).sum())
        self.cpr_global_ok += int(g_ok.sum())

        # local nic/rc: the pair just received, clamped by previous pos
        l_nic = p_nic.copy()
        l_rc = p_rc.copy()
        clamp = ac_rel & (c.pos_nic[s] < l_nic)
        l_nic[clamp] = c.pos_nic[s][clamp]
        clamp2 = ac_rel & (c.pos_rc[s] < l_rc)
        l_rc[clamp2] = c.pos_rc[s][clamp2]

        have = g_ok | l_ok
        lat = np.where(g_ok, g_lat, l_lat)
        lon = np.where(g_ok, g_lon, l_lon)
        d_nic = np.where(g_ok, d_nic, l_nic)
        d_rc = np.where(g_ok, d_rc, l_rc)

        if not have.any():
            return
        self._speed_and_set(
            rows, s, mc, have, lat, lon, used_global, d_nic, d_rc,
            now, src, odd, surf, clat, clon, rids, netdup,
        )

    def _accept_cols_pair(self, s, par, m_src, now):
        cur_src = self.cols.c_src[s, par]
        cur_ts = self.cols.c_ts[s, par]
        ok = (m_src != _INVALID) & (now >= cur_ts)
        ok &= ~((m_src < cur_src) & (now < cur_ts + TRACK_STALE))
        return ok

    # ------------------------------------------------------------------

    def _speed_and_set(
        self, rows, s, mc, have, lat, lon, from_global, d_nic, d_rc,
        now, src, odd, surf_msg, clat, clon, rids=None, netdup=None,
    ):
        """speed check + set position, columnar (track.c:423-736, 968+)."""
        c = self.cols
        m = have  # active mask over this round's position rows
        elapsed = np.maximum(0, now - c.pv_ts[s])

        # duplicate check (track.c:350-377); the CPR network duplicate
        # (netdup) takes the same early path as a decoded-position dup
        dup = m & (now <= c.seen_pos[s] + 2 * SECONDS) & (
            (c.lat[s] == lat) & (c.lon[s] == lon)
        )
        dup |= m & ~dup & (now <= c.prev_ts[s] + 2 * SECONDS) & (
            (c.prev_lat[s] == lat) & (c.prev_lon[s] == lon)
        )
        if netdup is not None:
            dup |= m & netdup
        pos_ignore = dup.copy()

        # disc cache membership (track.c:390-421); on the local path every
        # rid is zero so the receiverId leg degenerates to a pure age check
        rid_arr = rids if rids is not None else np.zeros(len(rows), np.uint64)
        in_dc = m & (
            (
                (now[:, None] - c.dc_ts[s] < 4 * SECONDS)
                & (c.dc_lat[s] == clat[:, None])
                & (c.dc_lon[s] == clon[:, None])
            ).any(axis=1)
            | (
                (now[:, None] - c.dc_ts[s] < 300)
                & (c.dc_rid[s] == rid_arr[:, None])
            ).any(axis=1)
        )

        surface = (
            (c.ag_src[s] != _INVALID)
            & (now < c.ag_ts[s] + TRACK_EXPIRE)
            & (c.ag[s] == int(AirGround.GROUND))
            & c.pos_surface[s]
            & surf_msg
        )

        bogus = (
            (lat < -90) | (lat > 90) | (lon < -180) | (lon > 180)
            | ((np.abs(lat) < 0.01) & (np.abs(lon) < 0.01))
        )
        reliable = self._pos_reliable(s)
        override = np.zeros(len(rows), bool)
        if self.json_reliable == -1:
            override |= m
        prio = src == int(Source.PRIO)
        override |= m & prio
        ign2 = bogus | ((clat == 0) & (clon == 0)) | (
            ((clat == 0) | (clon == 0))
            & ((c.pv_src[s] < int(Source.TISB)) | ~reliable)
        )
        undecided = m & ~override & ~pos_ignore
        pos_ignore |= undecided & ign2
        undecided &= ~ign2
        ov2 = (c.rel_odd[s] < 0.01) | (c.rel_even[s] < 0.01)
        ov2 |= (now - c.pv_ts[s]) > POS_RELIABLE_TIMEOUT
        ov2 |= (src > c.pv_src[s]) & (src > c.pv_last[s])
        ov2 |= (src > c.pv_src[s]) & (c.pv_src[s] == int(Source.INDIRECT))
        ov2 |= (src <= int(Source.MLAT)) & (elapsed > 45 * SECONDS)
        override |= undecided & ov2
        override &= ~in_dc

        # speed estimate
        gs_ok = (c.gs_src[s] != _INVALID) & (now < c.gs_ts[s] + TRACK_EXPIRE)
        speed = np.full(len(rows), -1.0)
        gsv = np.maximum(c.gs_last_pos[s], c.gs[s])
        gsv = gsv + 3 * np.maximum(0, now - c.gs_ts[s]) / 1000.0 + 3 * elapsed / 1000.0
        speed = np.where(gs_ok, gsv, speed)
        tas_ok = ~gs_ok & (c.tas_src[s] != _INVALID) & (now < c.tas_ts[s] + TRACK_EXPIRE)
        speed = np.where(tas_ok, c.tas[s] * 4 / 3, speed)
        ias_ok = (
            ~gs_ok & ~tas_ok
            & (c.ias_src[s] != _INVALID) & (now < c.ias_ts[s] + TRACK_EXPIRE)
        )
        speed = np.where(ias_ok, c.ias[s] * 2, speed)
        transmitted_speed = speed.copy()

        old_lat = c.lat[s]
        old_lon = c.lon[s]
        distance = greatcircle_vec(old_lat, old_lon, lat, lon)
        distance = np.where(c.seen_pos[s] == 0, 0.0, distance)

        track_max_age = 5 * SECONDS
        tr_age = np.maximum(0, now - c.track_ts[s])
        th_age = np.maximum(0, now - c.th_ts[s])
        track = np.full(len(rows), -1.0)
        track_age = np.full(len(rows), -1, np.int64)
        use_tr = tr_age < track_max_age
        track = np.where(use_tr, c.track[s], track)
        track_age = np.where(use_tr, tr_age, track_age)
        use_th = ~use_tr & (th_age < track_max_age)
        track = np.where(use_th, c.th[s], track)
        track_age = np.where(use_th, th_age, track_age)

        calc_track = bearing_vec(old_lat, old_lon, lat, lon)
        track_diff = np.full(len(rows), -1.0)
        td_ok = (
            (distance > 2.5)
            & (src != int(Source.MLAT))
            & (track > -1)
            & (elapsed < 7 * SECONDS)
        )
        td = np.abs(np.mod(track - calc_track + 180.0, 360.0) - 180.0)
        track_diff = np.where(td_ok, td, track_diff)

        mm_tu = np.zeros(len(rows), np.int64)
        mm_tu = np.where((track_diff > 70.0) & (speed > 10), 1, mm_tu)
        mm_tu = np.where((track_diff <= 70.0) & (track_diff > -1), -1, mm_tu)

        track_diff = np.where(reliable, track_diff, -1.0)
        speed = np.where(
            (speed < 0) | (c.su[s] > 8), np.where(surface, 120.0, 900.0), speed
        )

        rng = np.full(len(rows), -1.0)
        tb_ok = (speed > 10) & (track_diff > -1) & (c.tu[s] < 8)
        track_bonus = speed * (90.0 - track_diff) / 90.0
        track_bonus *= np.where(surface, 0.9, 1.0) * (
            1.0 - track_age / track_max_age
        )
        slow = c.gs[s] < 10  # a.gs or 0.0 (value, irrespective of validity)
        tb = np.where(slow, np.maximum(0.0, track_bonus), track_bonus)
        sp2 = speed + np.where(slow, 2.0, 0.0) + tb
        new_ignore = tb_ok & (track_diff > 160)
        pos_ignore |= new_ignore  # pos_old
        sp2 = np.where(tb_ok, sp2, speed * 1.3)
        rng = rng + np.where(tb_ok & (sp2 > 40) & (track_diff < 10), 2e3, 0.0)
        speed = sp2

        rng += np.where(surface, 10.0, 30.0)
        # same TCP packet, same feeder (track.c:~1274): the rid equality is
        # trivially true on the single-feeder/local path (both zero)
        same_rid = (
            c.last_rid[s] == rids if rids is not None
            else np.ones(len(rows), bool)
        )
        rng += np.where(
            (elapsed < 2) & same_rid & (src > int(Source.MLAT)), 500.0, 0.0
        )
        speed = np.minimum(speed, 2000.0)
        is_mlat = src == int(Source.MLAT)
        speed = np.where(is_mlat, speed * 1.4 + 50, speed)
        rng = np.where(is_mlat, rng + 250, rng)

        mm_su = np.zeros(len(rows), np.int64)
        cond = (distance > 2.5) & ((track_diff < 70) | (track_diff == -1))
        within = distance <= rng + (elapsed + 50.0) / 1000.0 * transmitted_speed * KT2MS
        beyond = distance > rng + (elapsed + 400.0) / 1000.0 * transmitted_speed * KT2MS
        mm_su = np.where(transmitted_speed < 0, -1,
                         np.where(cond & within, -1, np.where(cond & beyond, 1, 0)))

        rng += (elapsed + 200.0) / 1000.0 * speed * KT2MS
        inrange = distance <= rng

        # no going backwards against good track info across feeders
        # (track.c:1295-1303); needs a different feeder than the last
        # accepted position, so it never fires on the single-feeder path
        if rids is not None:
            back = (
                ~surface
                & (c.gs[s] > 10)
                & (track_diff > 135)
                & (elapsed < 2 * SECONDS)
                & (np.maximum(0, now - c.track_ts[s]) < 2 * SECONDS)
                & (c.last_rid[s] != rids)
            )
            inrange &= ~back

        # aggregator receiver-quality DB (receiver.c:141-246,320-351):
        # every plausible (or duplicate) position feeds the per-feeder
        # extent box; RANGE_BAD positions defeat the override and count
        # toward feeder quarantine
        rex = np.zeros(len(rows), bool)
        if self.receiver_lat is None and rids is not None:
            cand = m & (dup | inrange | override)
            if cand.any():
                from .receiver import RANGE_BAD

                need = self.receivers.reliability_required
                no_mod = (
                    (src != int(Source.ADSB))
                    | surf_msg
                    | (c.rel_odd[s] < need)
                    | (c.rel_even[s] < need)
                )
                addrs = c.addr[s]
                recv = self.receivers
                verdict = recv.position_received_cols(
                    np.where(cand, rids, np.uint64(0)),
                    addrs, no_mod, lat, lon, now,
                )
                rex = (verdict == RANGE_BAD) & ~dup
                for k in np.nonzero(rex)[0]:
                    recv.bad(int(rids[k]), int(addrs[k]), int(now[k]))

        upd = m & ~pos_ignore
        c.su[s[upd]] = np.clip(c.su[s] + mm_su, 0, 16)[upd]
        c.tu[s[upd]] = np.clip(c.tu[s] + mm_tu, 0, 16)[upd]

        late = override & ~inrange
        c.last_override_ts[s[m & late]] = now[m & late]
        inrange |= override
        inrange &= ~rex
        pos_ignore |= rex
        passed = m & (dup | inrange)

        # --- position_bad for failures (tracker._update_position tail) -----
        fail = m & ~passed
        self.cpr_global_speed_checks += int((fail & from_global).sum())
        self.cpr_local_speed_checks += int((fail & ~from_global).sum())
        punish = fail & ~(
            (src < c.pv_src[s]) | in_dc | pos_ignore
        )
        if punish.any():
            i = s[punish]
            # disc cache insert
            full = c.dc_n[i] >= 4
            slot4 = np.where(full, (c.dc_i[i] + 1) % 4, c.dc_n[i])
            c.dc_i[i] = np.where(full, slot4, c.dc_i[i])
            c.dc_n[i] = np.minimum(c.dc_n[i] + ~full, 4)
            c.dc_ts[i, slot4] = now[punish]
            c.dc_lat[i, slot4] = clat[punish]
            c.dc_lon[i, slot4] = clon[punish]
            c.dc_rid[i, slot4] = rid_arr[punish]
            c.rel_odd[i] -= 0.26
            c.rel_even[i] -= 0.26
            rst = punish & ((c.rel_odd[s] < 0.1) | (c.rel_even[s] < 0.1))
            j = s[rst]
            c.rel_odd[j] = 0.0
            c.rel_even[j] = 0.0
            c.c_src[j] = _INVALID
            # re-accept the CPR just received
            pj = odd[rst].astype(np.int64)
            c.c_lat[j, pj] = clat[rst]
            c.c_lon[j, pj] = clon[rst]
            c.c_surf[j, pj] = surf_msg[rst]
            c.c_ts[j, pj] = now[rst]
            c.c_src[j, pj] = src[rst]

        # --- set position ---------------------------------------------------
        go = passed & ~pos_ignore & ~dup
        # inferior-source near-duplicate (tracker._set_position head)
        neardup = go & (c.seen_pos[s] > 0) & (
            now < c.seen_pos[s] + 10 * MINUTES
        ) & (src < c.pv_last[s]) & (greatcircle_vec(c.lat[s], c.lon[s], lat, lon) < 20)
        go &= ~neardup
        acc = go & self._accept_cols(c.pv_ts, c.pv_src, s, src, now)
        i = s[acc]
        c.prev_lat[i] = c.lat[i]
        c.prev_lon[i] = c.lon[i]
        c.prev_ts[i] = c.seen_pos[i]
        c.lat[i] = lat[acc]
        c.lon[i] = lon[acc]
        c.seen_pos[i] = now[acc]
        c.pos_surface[i] = surf_msg[acc]
        c.gs_last_pos[i] = c.gs[i]
        c.pos_nic[i] = d_nic[acc]
        c.pos_rc[i] = d_rc[acc]
        c.pv_ts[i] = now[acc]
        psrc = np.where(src == int(Source.PRIO), int(Source.ADSB), src)
        c.pv_src[i] = psrc[acc]
        c.pv_last[i] = psrc[acc]
        if rids is not None:
            c.last_rid[i] = rids[acc]  # lastPosReceiverId (track.c:1166)

        fg = acc & from_global
        c.seen_pos_global[s[fg]] = now[fg]
        c.allow_ac_rel[s[fg]] = True
        po = acc & odd
        pe = acc & ~odd
        c.rel_odd[s[po]] = np.minimum(c.rel_odd[s[po]] + 1.0, 4.0)
        c.rel_even[s[pe]] = np.minimum(c.rel_even[s[pe]] + 1.0, 4.0)
        fgo = fg & odd
        fge = fg & ~odd
        c.rel_even[s[fgo]] = np.minimum(c.rel_even[s[fgo]] + 0.5, 4.0)
        c.rel_odd[s[fge]] = np.minimum(c.rel_odd[s[fge]] + 0.5, 4.0)
        rel2 = acc & self._pos_reliable(s)
        j = s[rel2]
        c.lat_rel[j] = lat[rel2]
        c.lon_rel[j] = lon[rel2]
        c.surf_allow[j] = True

    def _pos_reliable(self, s):
        c = self.cols
        if self.json_reliable <= 0:
            return c.pv_src[s] != _INVALID
        passthrough = np.isin(
            c.pv_src[s],
            [int(Source.JAERO), int(Source.MLAT), int(Source.INDIRECT), int(Source.SBS)],
        )
        need = float(self.json_reliable)
        return passthrough | ((c.rel_odd[s] >= need) & (c.rel_even[s] >= need))

    # ------------------------------------------------------------------

    def sweep(self, now: int) -> None:
        """Staleness/expiry of every tracked column (trackRemoveStale)."""
        c = self.cols
        n = self.n_slots
        for f in ("gs", "tas", "ias", "track", "th", "alt", "cs", "ag"):
            ts = getattr(c, f + "_ts")[:n]
            srcc = getattr(c, f + "_src")[:n]
            srcc[(srcc != _INVALID) & (now >= ts + TRACK_EXPIRE)] = _INVALID
        expired = (c.pv_src[:n] != _INVALID) & (
            now >= c.pv_ts[:n] + TRACK_EXPIRE_LONG
        )
        c.pv_src[:n][expired] = _INVALID
        for par in (0, 1):
            cexp = (c.c_src[:n, par] != _INVALID) & (
                now >= c.c_ts[:n, par] + TRACK_EXPIRE
            )
            c.c_src[:n, par][cexp] = _INVALID
