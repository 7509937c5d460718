"""The port's columnar aggregator in its App against readsb_tpu's, at
tolerance 0.

One stream of Beast frames (DF17 positions of both parities, velocities,
idents, DF4, DF5, DF11, corrupted frames, receiver ids, Mode A/C) goes
into both Apps on the columnar drain, once as BeastFrame objects through
`_handle_net_frame` (drain_bulk) and once as wire bytes cut at random
points through `BeastIn.feed` (the native columnar deframer, drain_cols),
with `materialize` ticks along the way; the tracker's aircraft,
aircraft.json, stats.json and the message counts are equal.  Both Apps'
clocks are fixed, and every frame carries a 0xE8 synthetic-time prefix.
No demodulator runs, so no JAX compile is paid.

Also: where readsb_tpu's rule picks the columnar drain, the port takes it
and nothing raises; --device-arena on the scalar drain is ignored with
readsb_tpu's warning; `viewadsb_main` runs readsb_tpu's command line.
"""

import asyncio
import logging

import numpy as np
import pytest
import torch

from readsb_tpu.app import bulk_drain as jax_bulk_drain
from readsb_tpu.app import main as jax_main
from readsb_tpu.app.config import parse_args as jax_parse_args
from readsb_tpu.io import beast as jax_beast
from readsb_tpu.io import json_out as jax_json
from readsb_tpu_torch import synth
from readsb_tpu_torch.app import bulk_drain, main
from readsb_tpu_torch.io import beast, json_out
from tests.test_torch_net import _splits
from tests.test_torch_net_app import ARGV as NET_ARGV
from tests.test_torch_track import aircraft_state

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

N_AC = 400
N_FRAMES = 9000
T0 = 1_760_000_000_000  # epoch ms of the first frame
NOW = T0 + N_FRAMES // 3 + 1000
WALL_CLOCK = ("cpu", "start", "end")  # stats.json fields read off the host's clock
FEEDERS = (0x1111_2222_3333_4444, 0x5555_6666_7777_8888, 0x0102_0304_0506_0708)
CONFIGS = {
    "receiver": ["--net-only", "--quiet", "--lat", "49.5", "--lon", "3.5"],
    "aggregator": ["--net-only", "--quiet", "--net-receiver-id"],
}
TIMEOUT = 10.0  # seconds for any one await


def _frames(feeders: bool):
    """jax BeastFrames of the stream; with `feeders`, three receiver ids."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(N_FRAMES):
        ac = i % N_AC
        addr = 0x450000 + ac
        seq = i // N_AC
        lat = 49.0 + (ac % 20) * 0.05 + i * 1e-6
        lon = 3.0 + (ac // 20) * 0.05
        k = seq % 9
        if k < 4:
            msg = synth.encode_df17_position(addr, lat, lon, 20000 + ac * 50, seq & 1)
        elif k == 4:
            msg = synth.encode_df17_velocity(addr, 180 + ac % 200, (ac * 23) % 360, 512)
        elif k == 5:
            msg = synth.encode_df17_ident(addr, f"T{ac:04d}")
        elif k == 6:
            msg = synth.encode_df5(addr, 0x1000 + (ac % 512) * 4)
        elif k == 7:
            msg = synth.encode_df4(addr, 20000 + ac * 50)
        else:
            msg = synth.encode_df11(addr)
        if rng.random() < 0.03:  # a bit error for the fixer, or garbage
            b = bytearray(msg)
            b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
            msg = bytes(b)
        out.append(jax_beast.BeastFrame(
            msg=msg, timestamp=i * 6000, signal_byte=40 + (i % 20), msg_type=0,
            receiver_id=FEEDERS[i % 3] if feeders else 0, synthetic_ms=T0 + i // 3))
    return out


def _wire(frames):
    rng = np.random.default_rng(8)
    out = []
    for i, bf in enumerate(frames):
        out.append(jax_beast.encode_synthetic_ts(bf.synthetic_ms)
                   + jax_beast.encode_receiver_id(bf.receiver_id)
                   + jax_beast.encode_frame(bf.msg, bf.timestamp, bf.signal_level))
        if i % 500 == 7:  # a Mode A/C reply: the per-message path
            code = int(rng.choice([0x1200, 0x7700, 0x0030]))
            out.append(jax_beast.encode_frame(bytes([code >> 8, code & 0xFF]), bf.timestamp,
                                              0.3, modeac=True))
    return b"".join(out)


def _apps(argv):
    pa = main.App(main.parse_args(argv))
    ja = jax_main.App(jax_parse_args(argv))
    for app in (pa, ja):
        app.now_ms = lambda: NOW
        assert app.bulk is not None and app.arena is None
    return pa, ja


def _results(app, jo, bd):
    bd.materialize(app, NOW)
    app.stats_collector.sample(app, NOW / 1000.0)
    sj = app.stats_collector.stats_json(app, NOW / 1000.0)
    for w in sj.values():
        for k in WALL_CLOCK:
            w.pop(k)
    t = app.tracker
    return {
        "aircraft": aircraft_state(t.aircraft.values()),
        "aircraft.json": jo.generate_aircraft_json(t, NOW, app.messages),
        "remote": (app.messages, app.remote_modes, app.remote_bad, app.remote_modeac),
        "stats.json": sj,
        "receivers.json": t.receivers.receivers_json(NOW),
        "net_queue": (len(app._net_queue), len(app._net_cols_queue)),
    }


def _handle_frames(app, bd, frames):
    scorer = app._net_scorer()
    for i, bf in enumerate(frames):
        app._handle_net_frame(scorer, bf)
        if i % 3000 == 2999:  # a tick
            app.drain_net_queue()
            bd.materialize(app, NOW)
    app.drain_net_queue()


def _feed_wire(app, bd, wire):
    conn = app._beast_input_factory()()
    assert conn.cols_mode

    async def pump():
        for k, chunk in enumerate(_splits(np.random.default_rng(3), wire, 4000)):
            await asyncio.wait_for(conn.feed(chunk), TIMEOUT)
            if k % 200 == 199:  # a tick
                app.drain_net_queue()
                bd.materialize(app, NOW)

    asyncio.run(pump())
    app.drain_net_queue()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def streams(request):
    frames = _frames(feeders=request.param == "aggregator")
    return request.param, frames, _wire(frames)


@pytest.mark.parametrize("path", ["frames", "wire"])
def test_the_columnar_aggregator_equals_readsb_tpu(streams, path):
    config, frames, wire = streams
    pa, ja = _apps(CONFIGS[config])
    if path == "frames":
        port_frames = [beast.BeastFrame(**vars(bf)) for bf in frames]
        _handle_frames(pa, bulk_drain, port_frames)
        _handle_frames(ja, jax_bulk_drain, frames)
    else:
        _feed_wire(pa, bulk_drain, wire)
        _feed_wire(ja, jax_bulk_drain, wire)
    got, want = _results(pa, json_out, bulk_drain), _results(ja, jax_json, jax_bulk_drain)
    for k in want:
        assert got[k] == want[k], k
    assert want["remote"][0] > 0.9 * N_FRAMES
    assert len(want["aircraft.json"]["aircraft"]) == N_AC
    assert sum("lat" in a for a in want["aircraft.json"]["aircraft"]) > 0.9 * N_AC
    if path == "wire":
        assert want["remote"][3] > 0  # the Mode A/C replies took the per-message path


@pytest.mark.parametrize("argv", NET_ARGV, ids=" ".join)
def test_the_port_takes_the_columnar_drain_where_readsb_tpu_does(argv, monkeypatch):
    """Nothing raises where readsb_tpu's rule picks the columnar drain; the
    App then has the columnar tracker, and its arena with --device-arena."""
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    args = main.parse_args(argv)
    assert vars(args) == vars(jax_parse_args(argv))
    picks = jax_main.App._bulk_drain_enabled(jax_parse_args(argv))
    app = main.App(main.parse_args(argv + ["--device-arena"]))
    assert (app.bulk is not None) == picks and (app.arena is not None) == picks
    if picks:
        assert app.arena.device.type == "cpu" and app._beast_input_factory()().cols_mode


def test_device_arena_on_the_scalar_drain_is_ignored_with_a_warning(caplog):
    with caplog.at_level(logging.WARNING):
        app = main.App(main.parse_args(["--net-only", "--no-net-bulk-drain", "--device-arena"]))
    assert app.bulk is None and app.arena is None
    assert "--device-arena needs the columnar drain; ignored" in caplog.text


def test_viewadsb_builds_the_reference_command_line(monkeypatch):
    seen = []
    monkeypatch.setattr(main, "main", lambda argv=None: seen.append(argv) or 0)
    monkeypatch.setattr(jax_main, "main", lambda argv=None: seen.append(argv) or 0)
    assert main.viewadsb_main(["--lat", "1"]) == 0 == jax_main.viewadsb_main(["--lat", "1"])
    assert seen[0] == seen[1] == ["--net-only", "--interactive", "--net-connector",
                                  "127.0.0.1,30005,beast_in", "--lat", "1"]
    args = main.parse_args(seen[0])
    assert vars(args) == vars(jax_parse_args(seen[0]))
    assert main.App(args).bulk is not None  # viewadsb's command takes the columnar drain
