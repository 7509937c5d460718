"""Columnar network drain: the production aggregator ingest path.

The reference's decodePool (net_io.c:5365-5474) is its production path:
N threads decode frames under staged decode/track/output locks.  Here one
drain batch flows through numpy columns end to end:

  frames -> checksum_batch -> accept_columns (decode/netaccept.py)
         -> decode_columns (decode/batch.py) -> BulkTracker.update_batch

Messages whose shape the columnar decoder does not cover (Comm-B, target
state, opstatus, ...) additionally pass through the scalar
decode_frame -> Tracker.update for their exotic fields; `materialize`
then syncs the authoritative columnar state into the dict Aircraft
objects each tick so every serving surface (aircraft.json, binCraft,
API, traces, outline) keeps reading the same store it always did.

Field ownership: the columns own seen/messages and the covered field
groups (position chain, baro alt, gs, track, rates, squawk, callsign,
airground); sync overwrites a dict field only when the column timestamp
is newer, so scalar-path sources (e.g. TIS-B via DF18 CF variants) are
never clobbered by stale column state.

A copy of readsb_tpu's drain.  One part differs: `materialize_arena` reads
the port's arena (int64 times, only the assigned slots read back) and
drains its device CPR fixes each tick.  As in readsb_tpu, history traces
take their points in `materialize` from the columnar tracker's positions;
`materialize_arena` adds none.
"""

from __future__ import annotations

import time

import numpy as np

from ..decode.fields import AirGround, Source, decode_frame
from ..decode.netaccept import accept_columns
from ..decode.score import RawFrame
from ..ops import crc as crc_ops
from ..track.tracker import Validity


def make_bulk(app):
    from ..track.bulk import BulkTracker

    # --lat/--lon configured: single-receiver mode (receiver-relative CPR,
    # max-range gate).  Without them: aggregator (multi-receiver) mode —
    # feeder extent boxes provide references and plausibility heuristics.
    return BulkTracker(
        app.args.lat, app.args.lon,
        max_range_km=app.args.max_range * 1.852,
        json_reliable=app.tracker.json_reliable,
        receivers=app.tracker.receivers,
    )


def drain_bulk(app, q: list) -> None:
    """Columnar drain of a BeastFrame list (raw/other per-frame inputs)."""
    m = len(q)
    now_default = app.now_ms()
    # columnar intake: one C-speed join + per-length-class scatter instead
    # of a per-frame numpy copy loop
    payload = np.frombuffer(b"".join(bf.msg[:14] for bf in q), np.uint8)
    lens = np.fromiter((min(len(bf.msg), 14) for bf in q), np.int64, m)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    msgs = np.zeros((m, 14), dtype=np.uint8)
    for ln in np.unique(lens):
        rows_l = np.nonzero(lens == ln)[0]
        idx = starts[rows_l][:, None] + np.arange(ln)[None, :]
        msgs[rows_l, : int(ln)] = payload[idx]
    ts = np.fromiter(
        (bf.synthetic_ms or now_default for bf in q), np.int64, m
    )
    rts = np.fromiter((bf.timestamp for bf in q), np.int64, m)
    rids = np.fromiter((bf.receiver_id for bf in q), np.uint64, m)
    sig = np.fromiter((bf.signal_level for bf in q), np.float64, m)
    ingest_columns(app, msgs, ts, rts, rids, sig)


def drain_cols(app, batches: list[dict]) -> None:
    """Columnar drain of ColumnarDeframer batches (native beast inputs)."""
    now_default = app.now_ms()
    msgs = np.concatenate([b["msgs"] for b in batches])
    keep = np.isin(
        np.concatenate([b["mlen"] for b in batches]), (7, 14)
    )
    synth = np.concatenate([b["synth"] for b in batches])
    ts = np.where(synth > 0, synth, now_default)
    rts = np.concatenate([b["ts"] for b in batches])
    rids = np.concatenate([b["rid"] for b in batches])
    sb = np.concatenate([b["sig"] for b in batches]).astype(np.float64) / 255.0
    sig = sb * sb  # signal_byte -> power (BeastFrame.signal_level)
    ingest_columns(
        app, msgs[keep], ts[keep], rts[keep], rids[keep], sig[keep]
    )


def ingest_columns(app, msgs, ts, rts, rids, sig) -> None:
    """Shared columnar accept -> decode -> track half of the drain."""
    from ..io import beast as beast_io
    from ..io import raw as raw_io

    t0 = time.perf_counter()
    m = len(msgs)
    if m == 0:
        return
    now_default = app.now_ms()
    syn112 = crc_ops.checksum_batch(msgs, 112)
    syn56 = crc_ops.checksum_batch(np.ascontiguousarray(msgs[:, :7]), 56)
    scorer = app._net_scorer()
    acc = accept_columns(scorer, msgs, syn112, syn56)
    res = acc["result"]

    # receiver quarantine (net_io.c:3943-3961), checked once per feeder
    ok = res == 0
    garbage = np.zeros(m, bool)
    for rid in np.unique(rids[ok]):
        if rid and app.tracker.receivers.check_bad(int(rid), int(now_default)):
            garbage |= rids == rid
    ok &= ~garbage
    rows = np.nonzero(ok)[0]
    app.messages += len(rows)
    app.remote_modes += len(rows)

    fixed = acc["msgs"]
    if app.out_garbage.clients:
        for i in np.nonzero(garbage & (res == 0))[0]:
            nb = int(acc["msgbits"][i]) // 8
            app.out_garbage.send(
                beast_io.encode_frame(bytes(fixed[i][:nb]), int(rts[i]), float(sig[i]))
            )

    # per-message wire forwarding straight from bytes (only when clients
    # are attached; SBS/json-position lanes need decoded fields and are
    # served by the scalar path — documented bulk-mode scope)
    if app.out_raw.clients or app.out_beast.clients:
        verbatim = app.args.net_verbatim
        for i in rows:
            nb = int(acc["msgbits"][i]) // 8
            mb = bytes(fixed[i][:nb])
            if app.out_raw.clients and (acc["corrected"][i] < 2 or verbatim):
                app.out_raw.send(raw_io.encode_line(mb, int(rts[i]) or None))
            if app.out_beast.clients:
                app.out_beast.send(
                    beast_io.encode_frame(mb, int(rts[i]), float(sig[i]))
                )

    # columnar decode + track for ALL accepted rows (uncovered rows still
    # update seen/messages through the column store)
    from ..decode.batch import decode_columns

    cols = decode_columns(
        fixed[rows], ts[rows], acc["addr"][rows], acc["corrected"][rows]
    )
    cols["signal"] = sig[rows]
    cols["receiver_id"] = rids[rows].astype(np.uint64)
    cols["remote"] = True  # network ingest: CPR duplicate cache active
    app.bulk.update_batch(cols)
    if app.arena is not None:
        # --device-arena: the same batch updates the device SoA store
        app.arena.update_cols(cols)

    # exotic-shape rows take the scalar field decoder for their extra
    # fields; covered fields they also set are reconciled by materialize
    sc_rows = rows[~cols["covered"]]
    for i in sc_rows:
        nb = int(acc["msgbits"][i]) // 8
        frame = RawFrame(
            msg=bytes(fixed[i][:nb]), msgbits=int(acc["msgbits"][i]),
            timestamp=int(rts[i]), score=0, phase=0,
            correctedbits=int(acc["corrected"][i]), addr=int(acc["addr"][i]),
            signal_power=float(sig[i]), iid=int(acc["iid"][i]),
        )
        mm = decode_frame(frame, epoch_ms=0)
        mm.sys_timestamp_ms = int(ts[i])
        mm.remote = True
        mm.receiver_id = int(rids[i])
        app.tracker.update(mm)

    for ad in acc["learned"]:
        scorer.icao.add(int(ad))
    app.stats_collector.cpu["net"] += (time.perf_counter() - t0) * 1e3


_GROUPS = (
    # (column prefix, aircraft value attr, aircraft validity attr)
    ("gs", "gs", "gs_valid"),
    ("track", "track", "track_valid"),
    ("baro_rate", "baro_rate", "baro_rate_valid"),
    ("geom_rate", "geom_rate", "geom_rate_valid"),
)


def materialize(app, now: int) -> None:
    """Sync the columnar store into the dict Aircraft views (per tick).

    The active set is extracted column-wise with one .tolist() per column
    (vectorized numpy->python) and the per-slot loop touches plain python
    values only — ~10x faster than per-element array indexing at
    aggregator fleet sizes.
    """
    bulk = app.bulk
    tr = app.tracker
    c = bulk.cols
    n = bulk.n_slots
    last = getattr(app, "_bulk_sync_ts", -1)
    act = np.nonzero(c.seen[:n] > last)[0]
    if len(act) == 0:
        return
    app._bulk_sync_ts = int(c.seen[:n].max())
    SRC = _SRC_MEMBERS
    INV = int(Source.INVALID)

    def col(name):
        return getattr(c, name)[act].tolist()

    addr_l, seen_l, msgs_l = col("addr"), col("seen"), col("messages")
    sign_l = col("sig_n")
    sigring = c.sig_ring[act]
    g = {
        pref: (col(pref), col(pref + "_ts"), col(pref + "_src"))
        for pref, _, _ in _GROUPS
    }
    alt_l, alt_ts_l, alt_src_l = col("alt"), col("alt_ts"), col("alt_src")
    rel_l = col("alt_reliable")
    sq_l, sq_ts_l, sq_src_l = col("squawk"), col("squawk_ts"), col("squawk_src")
    sqt_l = col("squawk_tent")
    sqtt_l = col("squawk_tent_ts")
    cs_b = c.cs[act]
    cs_ts_l, cs_src_l = col("cs_ts"), col("cs_src")
    ag_l, ag_ts_l, ag_src_l = col("ag"), col("ag_ts"), col("ag_src")
    pv_ts_l, pv_src_l, pv_last_l = col("pv_ts"), col("pv_src"), col("pv_last")
    lat_l, lon_l = col("lat"), col("lon")
    seen_pos_l = col("seen_pos")
    psurf_l, pnic_l, prc_l = col("pos_surface"), col("pos_nic"), col("pos_rc")
    gslp_l = col("gs_last_pos")
    rodd_l, reven_l = col("rel_odd"), col("rel_even")
    lrid_l = col("last_rid")

    from ..track import globe as globe_mod
    from ..track.tracker import TRACK_STALE, bearing, greatcircle

    ag_members = {m.value: m for m in AirGround}
    for k in range(len(act)):
        a = tr.get_or_create(addr_l[k], seen_l[k])
        a.seen = seen_l[k]
        a.messages = msgs_l[k]
        ns = sign_l[k]
        if ns:
            a.signal_ring = [
                float(sigring[k, j & 7]) for j in range(max(0, ns - 8), ns)
            ]
        for pref, vattr, valattr in _GROUPS:
            vals, tss, srcs = g[pref]
            if srcs[k] != INV:
                v: Validity = getattr(a, valattr)
                if tss[k] > v.updated:
                    setattr(a, vattr, vals[k])
                    v.updated = tss[k]
                    v.source = v.last_source = SRC[srcs[k]]
        if alt_src_l[k] != INV and alt_ts_l[k] > a.baro_alt_valid.updated:
            a.baro_alt = alt_l[k]
            a.alt_reliable = rel_l[k]
            v = a.baro_alt_valid
            v.updated = alt_ts_l[k]
            v.source = v.last_source = SRC[alt_src_l[k]]
        if sq_src_l[k] != INV and sq_ts_l[k] > a.squawk_valid.updated:
            a.squawk = sq_l[k] if sq_l[k] >= 0 else None
            v = a.squawk_valid
            v.updated = sq_ts_l[k]
            v.source = v.last_source = SRC[sq_src_l[k]]
        if sqt_l[k] >= 0 and sqtt_l[k] > a.squawk_tentative_changed:
            a.squawk_tentative = sqt_l[k]
            a.squawk_tentative_changed = sqtt_l[k]
        if cs_src_l[k] != INV and cs_ts_l[k] > a.callsign_valid.updated:
            a.callsign = bytes(cs_b[k]).decode("latin1").rstrip("\x00").rstrip()
            v = a.callsign_valid
            v.updated = cs_ts_l[k]
            v.source = v.last_source = SRC[cs_src_l[k]]
        if ag_src_l[k] != INV and ag_ts_l[k] > a.airground_valid.updated:
            a.airground = ag_members[ag_l[k]]
            v = a.airground_valid
            v.updated = ag_ts_l[k]
            v.source = v.last_source = SRC[ag_src_l[k]]

        # position chain (+ serving-layer side effects the scalar setter did)
        if pv_src_l[k] != INV and pv_ts_l[k] > a.position_valid.updated:
            prev_seen_pos = a.seen_pos
            a.prev_lat, a.prev_lon = a.lat or 0.0, a.lon or 0.0
            a.prev_pos_time = a.seen_pos
            a.lat = lat_l[k]
            a.lon = lon_l[k]
            a.seen_pos = seen_pos_l[k]
            a.pos_surface = psurf_l[k]
            a.pos_nic = pnic_l[k]
            a.pos_rc = prc_l[k]
            a.gs_last_pos = gslp_l[k]
            a.pos_reliable_odd = rodd_l[k]
            a.pos_reliable_even = reven_l[k]
            a.receiver_id = lrid_l[k]  # lastPosReceiverId
            v = a.position_valid
            v.updated = pv_ts_l[k]
            v.source = SRC[pv_src_l[k]]
            v.last_source = SRC[pv_last_l[k]] if pv_last_l[k] != INV else v.source
            a.globe_index = globe_mod.globe_index(a.lat, a.lon)
            if tr.receiver_lat is not None:
                dist = greatcircle(tr.receiver_lat, tr.receiver_lon, a.lat, a.lon)
                tr.outline.update(
                    a.seen_pos, dist,
                    bearing(tr.receiver_lat, tr.receiver_lon, a.lat, a.lon),
                    a.lat, a.lon,
                    a.baro_alt if a.baro_alt is not None else (a.geom_alt or 0),
                    reliable=a.pos_reliable_odd >= 2 and a.pos_reliable_even >= 2,
                    json_reliable=tr.json_reliable,
                )
                tr.distance_max = max(tr.distance_max, dist)
                tr.distance_min = min(tr.distance_min, dist)
            if tr.keep_traces:
                if a.trace is None:
                    from ..track.traces import Trace

                    a.trace = Trace()
                stale = bool(prev_seen_pos) and a.seen_pos > prev_seen_pos + 2 * TRACK_STALE
                a.trace.add(a, a.seen_pos, stale=stale,
                            json_trace_interval=tr.json_trace_interval)


_SRC_MEMBERS = {int(m): m for m in Source}


def materialize_arena(app, now: int) -> None:
    """--device-arena: overlay arena-owned fields from the device SoA
    onto the serving tracker, then drain the arena's device CPR fixes.

    The arena implements the same accept lattice / altitude / squawk
    semantics as the columnar host tracker, so the overlay is
    value-identical with the bulk sync -- the point is that the
    authoritative store for these fields lives ON DEVICE in this mode.
    Only the assigned slots are gathered on the device and read back.
    The time fields are int64 epoch ms, so the overlay compares in the
    dict tracker's time base (readsb_tpu's int32 times never fire it on
    epoch time).  The popped `cpr_decodes` go nowhere else: the serving
    output stays readsb_tpu's."""
    from ..track.arena import FIELD_IDX, INT_FIELDS

    arena = app.arena
    tr = app.tracker
    addrs, st = arena.read_slots()
    SRC = _SRC_MEMBERS
    for k, addr in enumerate(addrs):
        if st["icao"][k] < 0:
            continue
        seen = int(st["seen"][k])
        a = tr.get_or_create(addr, seen)
        if seen > a.seen:
            a.seen = seen
        for name, j in FIELD_IDX.items():
            if st["fsrc"][k, j] < 0:
                continue
            v = getattr(a, name + "_valid")
            if int(st["fts"][k, j]) > v.updated:
                val = float(st["fval"][k, j])
                setattr(a, name, int(val) if name in INT_FIELDS else val)
                v.updated = int(st["fts"][k, j])
                v.source = v.last_source = SRC[int(st["fsrc"][k, j])]
        if st["alt_src"][k] >= 0 and int(st["alt_ts"][k]) > a.baro_alt_valid.updated:
            a.baro_alt = int(st["alt"][k])
            a.alt_reliable = int(st["alt_rel"][k])
            v = a.baro_alt_valid
            v.updated = int(st["alt_ts"][k])
            v.source = v.last_source = SRC[int(st["alt_src"][k])]
        if st["sq_src"][k] >= 0 and int(st["sq_ts"][k]) > a.squawk_valid.updated:
            a.squawk = int(st["squawk"][k]) if st["squawk"][k] >= 0 else None
            v = a.squawk_valid
            v.updated = int(st["sq_ts"][k])
            v.source = v.last_source = SRC[int(st["sq_src"][k])]
        if st["cs_src"][k] >= 0 and int(st["cs_ts"][k]) > a.callsign_valid.updated:
            b0 = int(st["callsign"][k, 0]) + (1 << 31)
            b1 = int(st["callsign"][k, 1]) + (1 << 31)
            a.callsign = (
                (b0.to_bytes(4, "big") + b1.to_bytes(4, "big"))
                .decode("latin1").rstrip("\x00").rstrip()
            )
            v = a.callsign_valid
            v.updated = int(st["cs_ts"][k])
            v.source = v.last_source = SRC[int(st["cs_src"][k])]
    arena.pop_cpr_decodes()
