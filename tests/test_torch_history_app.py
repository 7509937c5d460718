"""History in the port's App against readsb_tpu's App, at tolerance 0:
--json-globe-index, --json-trace-interval, --globe-history-dir, --heatmap,
--write-prom, --db-file and --write-state together.

Three runs, each of both Apps:
- the --ifile uc8 route (`run_ifile`, test_torch_app.run_both, once for
  the module, --blocks-per-batch 1): aircraft.json with the database's
  `r`, `t` and `dbFlags`, and what the exit sweep leaves (the trace files,
  at the App's clock, without a time budget), the globe tiles, the
  heatmap, the Prometheus text and the state directory;
- a Beast stream through the columnar drain (test_torch_bulk_app's, at
  small synthetic times so that readsb_tpu's int32 arena holds them),
  host only and with --device-arena (both Apps' arenas cut to 1024
  slots): traces, trace files, tiles and state;
- `amain` on --net-only after a scene with ACAS RAs, with the App's
  clock crossing a half hour on its second tick: the periodic block
  (trace files, tiles, the heatmap of the half hour, status.prom), the
  exit sweep, the ACAS log, aircraft.json and --write-state.

Compressed files are compared after decompression.  Prometheus text is
compared line by line with the lines that read the host's clock named and
set apart (`readsb_cpu_*`, `readsb_uptime`), and in `amain` also the
trace writer's counters, which count sweeps the host's clock paces; the
counters themselves are compared after the exit sweep.
"""

import asyncio
import gzip
import os

import numpy as np
import pytest
import torch

from readsb_tpu.app import bulk_drain as jax_bulk_drain
from readsb_tpu.app import main as jax_main
from readsb_tpu.decode import fields as jax_fields
from readsb_tpu.decode.score import RawFrame as JaxRawFrame
from readsb_tpu.io import history as jax_history
from readsb_tpu.io import json_out as jax_json
from readsb_tpu.io import state as jax_state
from readsb_tpu.io import stats as jax_stats
from readsb_tpu.track import arena as jax_arena
from readsb_tpu_torch.app import bulk_drain, main
from readsb_tpu_torch.decode import fields
from readsb_tpu_torch.decode.score import RawFrame
from readsb_tpu_torch.io import history, json_out, state, stats
from readsb_tpu_torch.synth import build_traffic_capture, encode_df17_ident, encode_df17_velocity
from readsb_tpu_torch.track import arena, traces, tracker
from tests.test_torch_app import RESULT_KEYS, argv_for, run_both
from tests.test_torch_bulk_app import TIMEOUT, _frames, _wire
from tests.test_torch_history import _files, _ref_chunk, _trace_key
from tests.test_torch_net import _splits
from tests.test_torch_track import _frame, _scene, aircraft_state

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

MIL = 0x3F4ABC  # a German military address (track/acdb.MIL_RANGES)
HALF_HOUR = 30 * 60_000
HOST_CLOCK = ("readsb_cpu_", "readsb_uptime")  # Prometheus lines read off the host's clock
TRACE_WRITER = ("readsb_tracewrites_",)


def _db(path, addrs):
    """tar1090's aircraft.csv.gz over `addrs`: registration, type, flags."""
    rng = np.random.default_rng(17)
    with gzip.open(path, "wt") as f:
        for addr in addrs:
            f.write(f"{addr:06X};HB-{addr & 0xFFF:03X};{rng.choice(['A320', 'B738', 'C172'])};"
                    f"{rng.choice(['', '1', '01', '0001'])};Type {addr & 0xF};2001;Op\n")


def _prom(text, apart):
    """(lines, {named line: value}) of Prometheus text, the lines whose
    name starts with one of `apart` set apart."""
    kept, named = [], {}
    for line in text.splitlines():
        name = line.split(" ")[0]
        if not line.startswith("#") and name.startswith(apart):
            named[name] = line.split(" ", 1)[1]
        else:
            kept.append(line)
    return kept, named


def _traces_of(t, reader):
    return {a.addr: _trace_key(a.trace, reader) for a in t.aircraft.values() if a.trace is not None}


def _split(t, reader):
    """(the aircraft, as aircraft_state sees them without their traces;
    {addr: the trace's content})."""
    acs = sorted(t.aircraft.values(), key=lambda a: a.addr)
    held, saved = _traces_of(t, reader), [a.trace for a in acs]
    for a in acs:
        a.trace = None
    try:
        return aircraft_state(acs), held
    finally:
        for a, tr in zip(acs, saved):
            a.trace = tr


def _reloaded(directory):
    """The port's load of a state directory: (count, aircraft, traces)."""
    t = tracker.Tracker()
    return (state.load_state(t, directory), *_split(t, traces.load_chunk))


def _outputs(app, pkg, hist, now, root):
    """What the exit sweep and the periodic writers leave, at `now`."""
    d = os.path.join(root, pkg)
    os.makedirs(os.path.join(d, "json"))
    hist.write_traces(app.tracker, os.path.join(d, "json"), now, time_budget_s=None)
    hist.write_globe_bincraft(app.tracker, os.path.join(d, "json"), now)
    start = now // HALF_HOUR * HALF_HOUR
    hist.write_heatmap(app.tracker, os.path.join(d, "hist"), start, start + HALF_HOUR,
                       interval_ms=1000)
    (state if pkg == "port" else jax_state).save_state(app.tracker, os.path.join(d, "state"), now)
    return d


# --- the --ifile uc8 route ------------------------------------------------------------


@pytest.fixture(scope="module")
def ifile_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hist_ifile")
    cap = build_traffic_capture(0.6, 6, 51)
    for k, t in enumerate(np.arange(0.02, 0.58, 0.06)):  # a military aircraft
        msg = (encode_df17_ident(MIL, "GAF123") if k % 2
               else encode_df17_velocity(MIL, 250, 90.0, 0))
        cap.add_frame(msg, float(t), amplitude=0.35)
    cap.write_uc8(str(d / "cap.uc8.dat"))
    scene = sorted({int(t["hex"][2:8], 16) for t in cap.truth if t.get("hex", "").startswith("8d")})
    _db(str(d / "aircraft.csv.gz"), [a for a in scene if a != MIL][:-1] + [MIL])
    argv = argv_for(str(d / "cap.uc8.dat"), "--write-json", str(d / "json"), "--json-globe-index",
                    "--json-trace-interval", "1", "--globe-history-dir", str(d / "hist"),
                    "--heatmap", "1", "--write-prom", str(d / "status.prom"),
                    "--db-file", str(d / "aircraft.csv.gz"), "--lat", "46.3", "--lon", "6.6")
    apps = []

    def run(app):
        apps.append(app)
        return app.run_ifile()

    mp = pytest.MonkeyPatch()
    try:
        want, got = run_both(argv, mp, run)
    finally:
        mp.undo()
    ja, pa = apps
    now = pa.now_ms()
    assert now == ja.now_ms()
    mp = pytest.MonkeyPatch()
    try:
        for mod in (history, jax_history):
            for k in mod.TRACE_WRITES:
                mp.setitem(mod.TRACE_WRITES, k, 0)
        root = str(d / "out")
        dirs = {"port": _outputs(pa, "port", history, now, root),
                "ref": _outputs(ja, "ref", jax_history, now, root)}
        proms = {"port": stats.generate_prom(pa, now), "ref": jax_stats.generate_prom(ja, now)}
    finally:
        mp.undo()
    return want, got, ja, pa, dirs, proms, scene


def test_ifile_app_with_history_equals_reference(ifile_runs):
    """Every result of test_torch_app's route parity; the aircraft with
    their traces set apart (compared in the next test)."""
    want, got, ja, pa, _, _, scene = ifile_runs
    for k in RESULT_KEYS:
        if k != "aircraft":  # its repr would print each Trace object's address
            assert got[k] == want[k], k
    assert _split(pa.tracker, traces.load_chunk)[0] == _split(ja.tracker, _ref_chunk)[0]
    acs = {a["hex"]: a for a in got["aircraft.json"]["aircraft"]}
    assert acs[f"{MIL:06x}"]["dbFlags"] & 1 and acs[f"{MIL:06x}"]["r"]
    assert sum("r" in a and "t" in a for a in acs.values()) >= len(scene) - 1
    assert pa.tracker.keep_traces and pa.tracker.db is not None and pa.acas_log is not None


def test_ifile_history_files_equal_reference(ifile_runs):
    _, _, ja, pa, dirs, _, _ = ifile_runs
    assert _traces_of(pa.tracker, traces.load_chunk) == _traces_of(ja.tracker, _ref_chunk)
    got = {k: v for k, v in _files(dirs["port"]).items() if not k.startswith("state")}
    want = {k: v for k, v in _files(dirs["ref"]).items() if not k.startswith("state")}
    assert got == want
    names = set(got)
    assert sum(n.startswith("json/traces/") for n in names) >= 2 * 6  # recent and full
    assert any(n.startswith("json/globe_") for n in names)
    assert any("/heatmap/" in n for n in names)
    assert _reloaded(os.path.join(dirs["port"], "state")) == \
        _reloaded(os.path.join(dirs["ref"], "state"))


def test_ifile_prometheus_text_equals_reference(ifile_runs):
    _, _, _, pa, _, proms, _ = ifile_runs
    got, got_named = _prom(proms["port"], HOST_CLOCK)
    want, want_named = _prom(proms["ref"], HOST_CLOCK)
    assert got == want
    assert set(got_named) == set(want_named) >= {"readsb_uptime", "readsb_cpu_demod"}
    assert "readsb_trace_current_memory" in proms["port"]  # --json-globe-index's gauges
    n = sum(a.trace is not None for a in pa.tracker.aircraft.values())
    assert [line for line in got if line.startswith("readsb_tracewrites_full")] == \
        [f"readsb_tracewrites_full {n}"] and n >= 6


# --- the columnar drain, host only and with --device-arena -------------------------------


BEAST_T0 = 1_000_000  # ms: readsb_tpu's arena keeps int32 times
BEAST_ARGV = ["--net-only", "--quiet", "--lat", "49.5", "--lon", "3.5", "--json-globe-index",
              "--json-trace-interval", "1", "--write-prom", "x.prom", "--db-file", "none.csv.gz"]


def _beast_app(pkg, device_arena, wire, now):
    argv = BEAST_ARGV + (["--device-arena"] if device_arena else [])
    if pkg == "port":
        app = main.App(main.parse_args(argv))
        if device_arena:
            app.arena = arena.Arena(n=1024, receiver_lat=49.5, receiver_lon=3.5, device="cpu")
    else:
        app = jax_main.App(jax_main.parse_args(argv))
        if device_arena:
            app.arena = jax_arena.Arena(n=1024, receiver_lat=49.5, receiver_lon=3.5)
    bd = bulk_drain if pkg == "port" else jax_bulk_drain
    app.now_ms = lambda: now
    assert app.bulk is not None and app.tracker.keep_traces
    conn = app._beast_input_factory()()
    assert conn.cols_mode

    def tick():
        app.drain_net_queue()
        bd.materialize(app, now)
        if app.arena is not None:
            bd.materialize_arena(app, now)

    async def pump():
        for k, chunk in enumerate(_splits(np.random.default_rng(3), wire, 4000)):
            await asyncio.wait_for(conn.feed(chunk), TIMEOUT)
            if k % 400 == 399:
                tick()

    asyncio.run(pump())
    tick()
    return app


@pytest.fixture(scope="module")
def beast_wire():
    frames = _frames(feeders=False)
    t0 = frames[0].synthetic_ms
    for bf in frames:
        bf.synthetic_ms = bf.synthetic_ms - t0 + BEAST_T0
    return _wire(frames), frames[-1].synthetic_ms + 1000


@pytest.mark.parametrize("device_arena", [False, True], ids=["host", "device-arena"])
def test_columnar_drain_traces_equal_reference(device_arena, beast_wire, tmp_path, monkeypatch):
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    wire, now = beast_wire
    pa = _beast_app("port", device_arena, wire, now)
    ja = _beast_app("ref", device_arena, wire, now)
    held = _traces_of(pa.tracker, traces.load_chunk)
    assert held == _traces_of(ja.tracker, _ref_chunk)
    assert len(held) == 400 and sum(tr["len"] for tr in held.values()) > 600
    assert json_out.generate_aircraft_json(pa.tracker, now, pa.messages) == \
        jax_json.generate_aircraft_json(ja.tracker, now, ja.messages)
    dirs = {"port": _outputs(pa, "port", history, now, str(tmp_path)),
            "ref": _outputs(ja, "ref", jax_history, now, str(tmp_path))}
    got = {k: v for k, v in _files(dirs["port"]).items() if not k.startswith("state")}
    assert got == {k: v for k, v in _files(dirs["ref"]).items() if not k.startswith("state")}
    assert _reloaded(os.path.join(dirs["port"], "state")) == \
        _reloaded(os.path.join(dirs["ref"], "state"))
    if device_arena:
        # the trace points come from the columnar tracker in materialize;
        # materialize_arena adds none: the traces equal the host path's
        host = _beast_app("port", False, wire, now)
        assert _traces_of(host.tracker, traces.load_chunk) == held


# --- amain: the periodic block, the exit sweep, the ACAS log -----------------------------


def _feed_scene(app, pkg, t0_ms):
    fmod, cls = (jax_fields, JaxRawFrame) if pkg == "ref" else (fields, RawFrame)
    for k, (t_s, msg, addr, rid) in enumerate(_scene(14, duration_s=24.0)):
        mm = fmod.decode_frame(_frame(cls, t_s, msg, addr, k), epoch_ms=t0_ms)
        mm.receiver_id = rid
        app.handle_message(mm, raw_ts=int(t_s * 12e6), signal=0.01)


def test_amain_writes_history_as_the_reference(tmp_path, monkeypatch):
    """Both Apps fed one scene (DF16 RAs included), then `amain` for 1.3 s
    on --net-only with every history option: the App's clock reads 1 s
    before a half-hour boundary on its first tick and 1 s after it from
    then on, so the second tick writes the heatmap of the half hour."""
    boundary = 1_760_001_200_000 // HALF_HOUR * HALF_HOUR + HALF_HOUR
    outs = {}
    for pkg, mod, hist in (("port", main, history), ("ref", jax_main, jax_history)):
        d = tmp_path / pkg
        d.mkdir()
        addrs = [0x3C0E00 + k * 0x11 for k in range(6)]
        _db(str(d / "aircraft.csv.gz"), addrs[:4])
        argv = ["--net-only", "--quiet", "--lat", "47.45", "--lon", "8.55",
                "--write-json", str(d / "json"), "--json-globe-index",
                "--json-trace-interval", "1", "--globe-history-dir", str(d / "hist"),
                "--heatmap", "2", "--write-prom", str(d / "status.prom"),
                "--db-file", str(d / "aircraft.csv.gz"), "--write-state", str(d / "state"),
                "--auto-exit", "1.3"]
        monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
        app = mod.App(mod.parse_args(argv))
        _feed_scene(app, pkg, boundary - 50_000)
        assert set(app.tracker.aircraft) == set(addrs)
        calls = []
        app.now_ms = lambda: boundary + (1000 if calls.append(1) or len(calls) > 1 else -1000)

        async def no_net():
            pass

        app.setup_net = no_net
        for k in hist.TRACE_WRITES:
            monkeypatch.setitem(hist.TRACE_WRITES, k, 0)
        assert asyncio.run(asyncio.wait_for(app.amain(), TIMEOUT)) == 0
        assert len(calls) >= 3  # two ticks at least, and the exit
        outs[pkg] = (app, _files(d), dict(hist.TRACE_WRITES))
    (pa, got, pw), (ja, want, jw) = outs["port"], outs["ref"]
    assert pw == jw and pw["full"] == len(pa.tracker.aircraft)
    clock_free = lambda files: {  # noqa: E731
        k: v for k, v in files.items()
        if k.split("/")[0] not in ("state", "status.prom")
        and k.split("/")[-1] not in ("stats.json", "clients.json", "receivers.json")}
    assert clock_free(got) == clock_free(want)
    names = set(clock_free(got))
    assert sum(n.startswith("json/traces/") for n in names) == 2 * len(pa.tracker.aircraft)
    assert any(n.startswith("json/globe_") for n in names) and "json/receivers.json" in got
    assert any(n.endswith("acas/acas.csv") for n in names)
    (heat,) = [n for n in names if "/heatmap/" in n]
    assert heat.endswith(f"/heatmap/{(boundary - HALF_HOUR) % 86_400_000 // HALF_HOUR:02d}.bin.ttf")
    assert _prom(got["status.prom"].decode(), HOST_CLOCK + TRACE_WRITER)[0] == \
        _prom(want["status.prom"].decode(), HOST_CLOCK + TRACE_WRITER)[0]
    assert _reloaded(str(tmp_path / "port" / "state")) == _reloaded(str(tmp_path / "ref" / "state"))
    acs = {a["hex"]: a for a in json_out.generate_aircraft_json(
        pa.tracker, boundary + 1000, pa.messages)["aircraft"]}
    assert sum("r" in a for a in acs.values()) == 4 and pa.acas_log.events == ja.acas_log.events > 0
