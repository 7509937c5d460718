"""Aggregator ingest throughput: Beast frames -> decode -> track (msgs/s).

The port of the JAX repo's `tools/bench_net.py`:

    python3 -m readsb_tpu_torch.tools.bench_net [n_msgs]

The message mix is the original's: n_msgs (default 200,000) frames of 5,000
aircraft, DF17 positions alternating odd and even plus a DF11 every fifth
message, from 50 feeders.  Three paths of the port's App, each once:

  scalar    BeastFrames through App._handle_net_frame and drain_net_queue
            (--no-net-bulk-drain: the per-message path)
  bulk      decode_columns + BulkTracker.update_batch in 8192-frame drains
            (the columnar aggregator, no receiver location)
  bulk_app  Beast wire bytes through the columnar App's Beast input (the
            native deframer, the columnar accept / decode / track), then
            materialize and an aircraft.json snapshot

The App runs on the card unless READSB_TPU_PLATFORM=cpu; these paths are
host work either way (no --device-arena).  The last line is one JSON
object {"metric": "aggregator_ingest", "value": bulk_app msgs/s, ...}.
Unlike the original, it writes no BENCH_NET.json: the JSON line is the
result.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np

from ..app.bulk_drain import materialize
from ..app.config import parse_args
from ..app.main import App, platform_device
from ..decode.batch import decode_columns
from ..io import beast as beast_io
from ..io.json_out import aircraft_dict
from ..pipeline import _resolve_device
from ..synth import encode_df11, encode_df17_position
from ..track.bulk import BulkTracker
from . import device_fields

N_AC = 5000
N_FEED = 50
DRAIN = 8192  # frames per columnar drain batch


def build_messages(n: int) -> list[bytes]:
    """The original's mix: 5000 aircraft, a DF11 every fifth message of an
    aircraft, else a DF17 position moving north, odd and even in turn."""
    msgs = []
    for i in range(n):
        ac = i % N_AC
        addr = 0x400000 + ac
        seq = i // N_AC  # per-aircraft message counter
        if seq % 5 == 4:
            msgs.append(encode_df11(addr))
        else:
            lat = 45.0 + (ac % 70) * 0.1 + seq * 0.0002
            lon = -5.0 + (ac // 70) * 0.1
            msgs.append(encode_df17_position(addr, lat, lon, 30000 + ac % 1000, seq % 2))
    return msgs


def build_frames(msgs: list[bytes]) -> list[beast_io.BeastFrame]:
    """BeastFrames of the messages from 50 feeders, one per aircraft
    stripe, 100 frames per synthetic millisecond."""
    return [
        beast_io.BeastFrame(msg=m, timestamp=i * 500, signal_byte=40, msg_type=0,
                            receiver_id=0x1000_0000 + (i % N_AC) % N_FEED,
                            synthetic_ms=1_000_000 + i // 100)
        for i, m in enumerate(msgs)
    ]


def build_wire(msgs: list[bytes]) -> bytes:
    """The messages as one aggregator's multiplexed Beast stream: a
    synthetic-time prefix every 100 frames, a receiverId prefix per frame."""
    rid = {r: beast_io.encode_receiver_id(0x1000_0000 + r) for r in range(N_FEED)}
    parts = []
    for i, m in enumerate(msgs):
        if i % 100 == 0:
            parts.append(beast_io.encode_synthetic_ts(1_000_000 + i // 100))
        parts.append(rid[(i % N_AC) % N_FEED])
        parts.append(beast_io.encode_frame(m, i * 500, 0.04))
    return b"".join(parts)


def bench_scalar(msgs: list[bytes]) -> tuple[float, App]:
    frames = build_frames(msgs)
    app = App(parse_args(["--net-only", "--quiet", "--no-net-bulk-drain"]))
    scorer = app._net_scorer()
    t0 = time.perf_counter()
    for bf in frames:
        app._handle_net_frame(scorer, bf)
    app.drain_net_queue()
    return time.perf_counter() - t0, app


def bench_bulk(msgs: list[bytes]) -> tuple[float, BulkTracker]:
    msgs_np = np.zeros((len(msgs), 14), np.uint8)
    for i, m in enumerate(msgs):
        msgs_np[i, : len(m)] = np.frombuffer(m, np.uint8)
    ts = (1_000_000 + np.arange(len(msgs)) // 100).astype(np.int64)
    addrs = 0x400000 + np.arange(len(msgs), dtype=np.int64) % N_AC
    rids = (0x1000_0000 + (addrs - 0x400000) % N_FEED).astype(np.uint64)
    # aggregator mode: no receiver location; feeder extent boxes, CPR
    # duplicate cache and receiverPositionReceived all active
    bulk = BulkTracker(None, None)
    t0 = time.perf_counter()
    for a in range(0, len(msgs), DRAIN):
        cols = decode_columns(msgs_np[a : a + DRAIN], ts[a : a + DRAIN], addrs[a : a + DRAIN])
        cols["receiver_id"] = rids[a : a + DRAIN]
        cols["remote"] = True
        bulk.update_batch(cols)
    return time.perf_counter() - t0, bulk


def bench_bulk_app(msgs: list[bytes]) -> tuple[float, App, list[dict]]:
    wire = build_wire(msgs)
    app = App(parse_args(["--net-only", "--quiet"]))
    if app.bulk is None:
        raise RuntimeError("the columnar drain is not on by default for --net-only")
    conn = app._beast_input_factory()()

    async def pump():
        for i in range(0, len(wire), 1 << 20):
            await conn.feed(wire[i : i + (1 << 20)])

    t0 = time.perf_counter()
    asyncio.run(pump())
    app.drain_net_queue()
    materialize(app, app.now_ms())
    now = app.now_ms()
    snapshot = [aircraft_dict(app.tracker, a, now) for a in app.tracker.aircraft.values()]
    return time.perf_counter() - t0, app, snapshot


def run(n: int = 200_000) -> dict:
    """Measure and print; returns the JSON line's object."""
    dev = _resolve_device(platform_device())
    msgs = build_messages(n)

    dt, app = bench_scalar(msgs)
    print(f"net ingest: {n} msgs in {dt * 1e3:.0f} ms -> {n / dt / 1e3:.0f}k msgs/s "
          f"({len(app.tracker.aircraft)} aircraft, {app.messages} tracked)", flush=True)
    dt_bulk, bulk = bench_bulk(msgs)
    print(f"bulk ingest: {n} msgs in {dt_bulk * 1e3:.0f} ms -> {n / dt_bulk / 1e3:.0f}k msgs/s "
          f"({bulk.n_slots} aircraft, global_ok={bulk.cpr_global_ok})", flush=True)
    dt_app, app2, snapshot = bench_bulk_app(msgs)
    n_pos = sum(1 for d in snapshot if "lat" in d)
    print(f"bulk APP e2e (wire bytes -> aircraft.json): {app2.messages} msgs in "
          f"{dt_app * 1e3:.0f} ms -> {app2.messages / dt_app / 1e3:.0f}k msgs/s "
          f"({len(snapshot)} aircraft, {n_pos} with positions)", flush=True)
    line = {
        "metric": "aggregator_ingest", "value": app2.messages / dt_app, "unit": "msgs/s",
        **device_fields(dev), "n_msgs": n,
        "scalar_msgs_per_s": n / dt, "bulk_msgs_per_s": n / dt_bulk,
        "bulk_app_msgs_per_s": app2.messages / dt_app,
        "scalar_tracked": app.messages, "bulk_app_tracked": app2.messages,
        "aircraft": len(snapshot), "with_positions": n_pos,
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_msgs", nargs="?", type=int, default=200_000)
    return run(ap.parse_args(argv).n_msgs)


if __name__ == "__main__":
    main()
