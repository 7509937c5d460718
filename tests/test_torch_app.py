"""The port's App against readsb_tpu's App, in process, at tolerance 0.

Both apps are built from the same argv, the port's under
READSB_TPU_PLATFORM=cpu, with one fixed epoch_ms.  After `run_ifile()` the
two give equal aircraft.json (`now` included), receiver.json,
receivers.json, outline.json, tracker counters, demod stats, `collect()`,
stats.json and print_stats' lines from the sample count on.  stats.json's
wall-clock fields are left out by name: each window's `cpu` block and its
`start` / `end`.

The accepted frames are equal too, field by field, apart from one known
difference of the reference (ROADMAP Queue 3): on the magnitude route
readsb_tpu's CPU path cuts the signal window of a frame in the last
SCAN_TAIL offsets of a superblock, where the port (on the CPU as on the
card) sums the whole window.  The port's run records each frame whose
signal power differs from readsb_tpu's, the tests hold every such frame
to that band, and the frame goes on with readsb_tpu's signal power so
that every aggregate still compares at tolerance 0.

Each route runs readsb_tpu's demodulator once, in a module-scoped fixture
(`app_runs`); captures are 0.6 s, and both packages get --blocks-per-batch
1.  This file holds the single-file uc8 and sc16 routes;
test_torch_app_routes.py holds run_ifile_multi and --modeac.
"""

import asyncio
import contextlib
import dataclasses
import io

import pytest
import torch

from readsb_tpu.app import main as jax_main
from readsb_tpu.decode.score import RawFrame as JaxRawFrame
from readsb_tpu.io import json_out as jax_json
from readsb_tpu.io import stats as jax_stats
from readsb_tpu_torch.app import main
from readsb_tpu_torch.constants import BLOCK_SAMPLES, SAMPLE_RATE, TRAILING_SAMPLES
from readsb_tpu_torch.decode.score import RawFrame
from readsb_tpu_torch.io import json_out, stats
from readsb_tpu_torch.ops.demod import SIG_LONG
from readsb_tpu_torch.synth import (
    build_traffic_capture,
    encode_df4,
    encode_df11,
    encode_df17_position,
    encode_df17_velocity,
    quantize_sc16,
    quantize_uc8,
)

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

EPOCH_MS = 1_760_000_000_000
WINDOWS = ("latest", "last1min", "last5min", "last15min", "total")
WALL_CLOCK = ("cpu", "start", "end")  # stats.json fields read off the host's clock
SCAN_TAIL = 19 + SIG_LONG  # superblock offsets whose window readsb_tpu's CPU path may cut


def argv_for(ifile, *extra):
    return ["--device-type", "ifile", "--ifile", ifile, "--blocks-per-batch", "1", *extra]


def make_apps(argv, monkeypatch):
    """readsb_tpu's App and the port's, from the same argv, at EPOCH_MS."""
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    ja = jax_main.App(jax_main.parse_args(argv))
    pa = main.App(main.parse_args(argv))
    assert pa.device == torch.device("cpu")
    ja.epoch_ms = pa.epoch_ms = EPOCH_MS
    return ja, pa


def _results(app, jo, so):
    now = app.now_ms()
    app.stats_collector.sample(app, now / 1000.0)
    sj = app.stats_collector.stats_json(app, now / 1000.0)
    for w in WINDOWS:
        for k in WALL_CLOCK:
            sj[w].pop(k)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        app.print_stats()
    t = app.tracker
    st = app._demod.stats
    return {
        "aircraft.json": jo.generate_aircraft_json(t, now, app.messages),
        "receiver.json": jo.generate_receiver_json(1000, app.args.lat, app.args.lon),
        "receivers.json": t.receivers.receivers_json(now),
        "outline.json": t.outline.outline_json(),
        "counters": {k: v for k, v in vars(t).items()  # readsb_tpu's trace setting aside
                     if isinstance(v, (int, float)) and not isinstance(v, bool)
                     and k != "json_trace_interval"},
        "aircraft": repr(list(t.aircraft.values())),
        "modeac": [x.tolist() for x in (t.modeac_count, t.modeac_lastcount, t.modeac_match,
                                        t.modeac_age)],
        "demod": (app._demod.scan_global, st.preambles, st.rejected_bad,
                  st.rejected_unknown_icao, list(st.accepted),
                  getattr(app._demod, "stats_modeac", 0)),
        "collect": so.collect(app, now),
        "stats.json": sj,
        "print_stats": err.getvalue().splitlines()[1:],
        "messages": app.messages,
    }


def _frame_fields(fr):
    """A frame's fields but its signal power (compared through the aggregates)."""
    return {**dataclasses.asdict(fr), "signal_power": None}


def _scan_span(demod):
    """A superblock's scan length; the multi route's, per channel."""
    return demod.seg_valid if hasattr(demod, "seg_valid") else demod.super_samples


def run_both(argv, monkeypatch):
    """Run both apps' run_ifile() over argv; return both results.

    Every accepted frame is recorded on its way into decode_frame.  A
    port frame whose signal power differs from readsb_tpu's is noted (its
    superblock offset, in "signal_cut") and goes on with readsb_tpu's."""
    ja, pa = make_apps(argv, monkeypatch)
    ref, port, cut = [], [], []

    def ref_decode(fr, epoch_ms, _decode=jax_main.decode_frame):
        ref.append(dataclasses.replace(fr))
        return _decode(fr, epoch_ms=epoch_ms)

    def port_decode(fr, epoch_ms, _decode=main.decode_frame):
        i = len(port)
        port.append(dataclasses.replace(fr))
        if i < len(ref) and fr.signal_power != ref[i].signal_power:
            span = _scan_span(pa._demod)
            cut.append((fr.scan_offset % span, span))
            fr.signal_power = ref[i].signal_power
        return _decode(fr, epoch_ms=epoch_ms)

    monkeypatch.setattr(jax_main, "decode_frame", ref_decode)
    monkeypatch.setattr(main, "decode_frame", port_decode)
    for app in (ja, pa):  # readsb_tpu's first: the port's frames are held to its
        asyncio.run(app.run_ifile())
        if "--modeac" in argv:  # what run_periodic does each tick
            app.tracker.match_ac(app.now_ms())
    want, got = _results(ja, jax_json, jax_stats), _results(pa, json_out, stats)
    want["frames"] = [_frame_fields(f) for f in ref]
    got["frames"] = [_frame_fields(f) for f in port]
    got["signal_cut"] = cut
    return want, got


RESULT_KEYS = ("aircraft.json", "receiver.json", "receivers.json", "outline.json", "counters",
               "aircraft", "modeac", "demod", "collect", "stats.json", "print_stats", "frames")


def check_run(want, got, seconds):
    """The port's run equals readsb_tpu's, and it decoded the traffic of
    a capture `seconds` long: every sample scanned, messages, positions."""
    assert got["messages"] == want["messages"] > 60 * seconds
    acs = got["aircraft.json"]["aircraft"]
    assert sum("lat" in a for a in acs) >= 4
    assert got["demod"][0] >= seconds * 2_400_000


def check_signal_cut(got):
    """A frame's signal power differs from readsb_tpu's only in the last
    SCAN_TAIL offsets of a superblock."""
    assert all(span - SCAN_TAIL <= off < span for off, span in got["signal_cut"])


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    """Both apps over one capture per route, run once for the module."""
    d = tmp_path_factory.mktemp("app")
    cap = build_traffic_capture(0.6, 6, 41)
    # two long frames of the first aircraft 12 and 25 scan offsets before
    # a superblock's end, where readsb_tpu's CPU path cuts the signal
    # window (the scan starts with the 326-sample overlap)
    for k, back in ((3, 12), (7, 25)):
        t = (BLOCK_SAMPLES * k - back - TRAILING_SAMPLES) / SAMPLE_RATE
        cap.add_frame(encode_df17_velocity(0x400101, 180, 41.0, 0), t, amplitude=0.3, phase=0.0)
    iq = cap.render_iq()
    quantize_uc8(iq).tofile(d / "cap.uc8.dat")
    quantize_sc16(iq).tofile(d / "cap.sc16.dat")
    routes = {
        "uc8": argv_for(str(d / "cap.uc8.dat")),
        "sc16": argv_for(str(d / "cap.sc16.dat"), "--iformat", "sc16",
                         "--lat", "46.3", "--lon", "6.6", "--max-range", "200"),
    }
    mp = pytest.MonkeyPatch()
    try:
        return {name: run_both(argv, mp) for name, argv in routes.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("route", ["uc8", "sc16"])
def test_app_run_decodes_traffic(app_runs, route):
    check_run(*app_runs[route], 0.6)


@pytest.mark.parametrize("route", ["uc8", "sc16"])
def test_signal_differs_only_in_the_scan_tail(app_runs, route):
    got = app_runs[route][1]
    check_signal_cut(got)
    assert len(got["signal_cut"]) == 2  # the two frames placed there (app_runs)


@pytest.mark.parametrize("key", RESULT_KEYS)
@pytest.mark.parametrize("route", ["uc8", "sc16"])
def test_app_equals_reference(app_runs, route, key):
    want, got = app_runs[route]
    assert got[key] == want[key]


# --- handle_frame's filters and displays, with no demodulator ----------------


def _frames(cls):
    out = []
    for k in range(40):
        addr = 0x4A0101 + 0x101 * (k % 4)
        msg = (encode_df11(addr), encode_df4(addr, 12000),
               encode_df17_position(addr, 46.2 + 0.01 * k, 6.4, 12000, k % 2))[k % 3]
        out.append(cls(msg=msg, msgbits=len(msg) * 8, timestamp=1_200_000 * k + 7, score=1000,
                       phase=4 + k % 5, correctedbits=0, addr=addr, signal_power=0.02 + 0.001 * k))
    return out


@pytest.mark.parametrize("extra", [
    [], ["--show-only", "4a0202"], ["--filter-DF", "17"], ["--raw"], ["--raw", "--onlyaddr"],
    ["--raw", "--mlat"], ["--receiver-focus", "2"], ["--json-reliable", "2", "--position-persistence", "6"],
], ids=lambda e: " ".join(e) or "plain")
def test_handle_frame_equals_reference(extra, monkeypatch, tmp_path):
    argv = argv_for(str(tmp_path / "unused.dat"), *extra)
    ja, pa = make_apps(argv, monkeypatch)
    outs = []
    for app, cls, jo in ((ja, JaxRawFrame, jax_json), (pa, RawFrame, json_out)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for k, fr in enumerate(_frames(cls)):
                if k % 2:
                    app.handle_frame(fr)
                else:  # the multi route's path: decoded, then tagged with a receiver
                    mm = (jax_main if cls is JaxRawFrame else main).decode_frame(fr, epoch_ms=EPOCH_MS)
                    mm.receiver_id = 1 + k % 3
                    app.handle_message(mm, raw_ts=fr.timestamp, signal=fr.signal_power)
        now = EPOCH_MS + 60_000
        outs.append((buf.getvalue(), app.messages, jo.generate_aircraft_json(app.tracker, now, app.messages),
                     app.stats_collector._sig))
    assert outs[1] == outs[0]
    assert outs[1][1] > 0
