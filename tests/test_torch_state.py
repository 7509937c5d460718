"""Persistence in the port against readsb_tpu, at tolerance 0: the zstd
codec (`io/zstd.py`), state blobs (`io/state.py`, rangeDirs.gz) with and
without history traces, the App's --write-state writes and triggers, and
--dump-beast (`io/beastdump.py`).  readsb_tpu's state directories with
traces load into the port also in a process where readsb_tpu cannot be
imported: their blobs and their trace chunks pickle readsb_tpu's classes.

readsb_tpu's `zstandard` is used here only, as the other codec: its
compressed bytes depend on the library's version, so decompressed content
is compared.  Trackers are fed one scene (test_torch_track._scene) through
each package's decoder; aircraft are compared field by field through
test_torch_track.aircraft_state, in address order.  No test bounds a
wall-clock time.
"""

import asyncio
import gzip
import io
import json
import os
import dataclasses
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import zstandard

from readsb_tpu.app import main as jax_main
from readsb_tpu.decode import fields as jax_fields
from readsb_tpu.decode.score import RawFrame as JaxRawFrame
from readsb_tpu.io import beast as jax_beast
from readsb_tpu.io import history as jax_history
from readsb_tpu.io import state as jax_state
from readsb_tpu.track import tracker as jax_tracker
from readsb_tpu_torch.app import main
from readsb_tpu_torch.decode import fields
from readsb_tpu_torch.decode.score import RawFrame
from readsb_tpu_torch.io import beast, beastdump, history, state, zstd
from readsb_tpu_torch.track import traces, tracker
from tests.test_torch_history import _files, _ref_chunk, _run_flight, _trace_key
from tests.test_torch_sdr import _beast_stream
from tests.test_torch_track import (
    EPOCH_MS,
    PORT_ONLY_FIELDS,
    _frame,
    _scene,
    aircraft_state,
)

TIMEOUT = 30.0  # seconds for any one await
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECEIVER = dict(receiver_lat=47.45, receiver_lon=8.55, max_range_km=300 * 1.852)


# --- the codec ------------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(4)
    return [b"", b"x", rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(),
            b"readsb" * 70_000, rng.integers(0, 4, 3_000_000, dtype=np.uint8).tobytes()]


class _Sink(io.BytesIO):
    """A file that keeps its bytes when the stream writer closes it."""

    def close(self):
        self.data = self.getvalue()
        super().close()


def _port_stream(data, piece=40_000):
    sink = _Sink()
    w = zstd.StreamWriter(sink, level=3)
    for i in range(0, len(data), piece):
        assert w.write(data[i:i + piece]) == len(data[i:i + piece])
    w.close()
    return sink.data


def _zstandard_stream(data):
    sink = _Sink()
    w = zstandard.ZstdCompressor(level=3).stream_writer(sink)
    w.write(data)
    w.close()
    return sink.data


@pytest.mark.parametrize("k", range(5))
def test_codec_round_trips_one_shot_and_streamed(k):
    data = _payloads()[k]
    for level in (1, 3, 19):
        assert zstd.decompress(zstd.compress(data, level)) == data
    assert zstd.decompress(_port_stream(data)) == data


@pytest.mark.parametrize("k", range(5))
def test_each_codec_decodes_the_other(k):
    data = _payloads()[k]
    one_shot = zstd.compress(data, 1)
    assert zstandard.ZstdDecompressor().decompress(one_shot) == data  # its content size
    assert zstandard.ZstdDecompressor().decompressobj().decompress(_port_stream(data)) == data
    assert zstd.decompress(zstandard.ZstdCompressor(level=1).compress(data)) == data
    assert zstd.decompress(_zstandard_stream(data)) == data


def test_codec_errors_are_zstd_errors():
    whole = zstd.compress(b"readsb" * 10_000)
    stream = _port_stream(b"readsb" * 10_000)
    for bad in (b"", b"garbage", whole[:-4], stream[:-4], whole[:6] + b"\0" * 20):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)


def test_codec_raises_naming_the_library_when_absent(monkeypatch, tmp_path):
    """Without libzstd.so.1 every call raises naming it; the Beast dumper
    then writes gzip chunks, as readsb_tpu's does without zstandard."""
    def absent(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd.ctypes, "CDLL", absent)
    assert zstd.available() is False
    for call in (lambda: zstd.compress(b"x"), lambda: zstd.decompress(b"x"),
                 lambda: zstd.StreamWriter(io.BytesIO())):
        with pytest.raises(RuntimeError, match=r"libzstd\.so\.1"):
            call()
    d = beastdump.BeastDumper(str(tmp_path / "dump"))
    d.record(beast.BeastFrame(msg=bytes(7), timestamp=5, signal_byte=9, msg_type=0), 1000)
    d.close()
    (name,) = os.listdir(tmp_path / "dump")
    assert name.endswith(".gz") and gzip.decompress((tmp_path / "dump" / name).read_bytes())
    monkeypatch.undo()
    assert zstd.available() is True


# --- state blobs -------------------------------------------------------------------


def _trackers(seed=12, duration_s=12.0, **kw):
    """readsb_tpu's tracker and the port's, fed one scene."""
    jt, pt = jax_tracker.Tracker(**RECEIVER, **kw), tracker.Tracker(**RECEIVER)
    for k, (t_s, msg, addr, rid) in enumerate(_scene(seed, duration_s=duration_s)):
        for t, fmod, cls in ((jt, jax_fields, JaxRawFrame), (pt, fields, RawFrame)):
            mm = fmod.decode_frame(_frame(cls, t_s, msg, addr, k), epoch_ms=EPOCH_MS)
            mm.receiver_id = rid
            t.update(mm)
    assert len(pt.aircraft) >= 6
    return jt, pt


def _state(t):
    return aircraft_state(sorted(t.aircraft.values(), key=lambda a: a.addr))


def _write_v1(t, directory):
    """readsb_tpu's v1 state directory: gzip'd JSON blobs of _aircraft_to_dict."""
    os.makedirs(directory, exist_ok=True)
    for blob in range(jax_state.STATE_BLOBS):
        recs = [jax_state._aircraft_to_dict(a) for addr, a in t.aircraft.items()
                if addr % jax_state.STATE_BLOBS == blob]
        with gzip.open(os.path.join(directory, f"blob_{blob:02d}.json.gz"), "wt") as f:
            json.dump({"magic": jax_state.STATE_MAGIC, "blob": blob, "aircraft": recs}, f)


@pytest.fixture(scope="module")
def fed():
    return _trackers()


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_reference_state_loads_into_the_port(fed, version, tmp_path):
    jt, _ = fed
    d = str(tmp_path / "state")
    if version == "v1":
        _write_v1(jt, d)
    else:
        jax_state.save_state(jt, d, EPOCH_MS)
    want, got = jax_tracker.Tracker(), tracker.Tracker()
    n = jax_state.load_state(want, d)
    assert state.load_state(got, d) == n == len(jt.aircraft)
    assert _state(got) == _state(want)
    if version == "v2":
        assert _state(got) == _state(jt)  # v1 leaves the signal ring out
        for name in ("distance", "lat", "lon", "alt"):
            assert np.array_equal(getattr(got.outline, name), getattr(jt.outline, name))
        assert got.outline.distance.any()
    for a in got.aircraft.values():
        assert a.pos_reliable_valid == tracker.Validity()  # absent there: fresh


class _ToReference(pickle.Unpickler):
    """The port's blobs read with readsb_tpu's classes, for comparison."""

    def find_class(self, module, name):
        return super().find_class(module.replace("readsb_tpu_torch.", "readsb_tpu."), name)


def _blob_docs(directory, unpickler=pickle.Unpickler):
    out = []
    for blob in range(state.STATE_BLOBS):
        raw = open(os.path.join(directory, f"blob_{blob:02d}.bin.zst"), "rb").read()
        assert raw.startswith(state.STATE_MAGIC_V2)
        body = zstandard.ZstdDecompressor().decompress(raw[len(state.STATE_MAGIC_V2):])
        out.append(unpickler(io.BytesIO(body)).load())
    return out


def _without_port_field(docs):
    return [{**d, "aircraft": [{k: v for k, v in r.items() if k != "pos_reliable_valid"}
                               for r in d["aircraft"]]} for d in docs]


def test_port_blobs_equal_the_reference_record_by_record(fed, tmp_path):
    jt, pt = fed
    n = state.save_state(pt, str(tmp_path / "port"), EPOCH_MS)
    assert n == jax_state.save_state(jt, str(tmp_path / "ref"), EPOCH_MS) == len(pt.aircraft)
    got = _blob_docs(str(tmp_path / "port"), _ToReference)
    want = _blob_docs(str(tmp_path / "ref"))
    assert _without_port_field(got) == want
    assert sum(len(d["aircraft"]) for d in got) == n
    assert any("pos_reliable_valid" in r for d in got for r in d["aircraft"])


def test_port_state_round_trips(fed, tmp_path):
    _, pt = fed
    d = str(tmp_path / "state")
    assert state.save_state(pt, d, EPOCH_MS) == len(pt.aircraft)
    back = tracker.Tracker()
    assert state.load_state(back, d) == len(pt.aircraft)
    key = lambda t: sorted(repr(a) for a in t.aircraft.values())  # noqa: E731
    assert key(back) == key(pt)  # every field, the port's own included
    assert np.array_equal(back.outline.distance, pt.outline.distance)


@pytest.mark.parametrize("way", ["readsb_tpu-to-port", "port-to-readsb_tpu"])
def test_range_dirs_both_ways(fed, way, tmp_path):
    jt, pt = fed
    src, dst = (jt, tracker.Tracker()) if way.startswith("readsb") else (pt, jax_tracker.Tracker())
    path = str(tmp_path / "rangeDirs.gz")
    src.outline.save(path)
    assert dst.outline.load(path) is True
    for name in ("distance", "lat", "lon", "alt"):
        assert np.array_equal(getattr(dst.outline, name), getattr(src.outline, name))
    assert (dst.outline.last_ival, dst.outline.duration_ms) == (src.outline.last_ival,
                                                                  src.outline.duration_ms)
    assert dst.outline.outline_json() == src.outline.outline_json()


@pytest.mark.parametrize("kind", ["garbage-after-magic", "wrong-magic", "bad-pickle",
                                  "truncated-frame"])
def test_a_corrupt_blob_is_skipped(fed, kind, tmp_path):
    jt, pt = fed
    d = str(tmp_path / "state")
    state.save_state(pt, d, EPOCH_MS)
    blob = next(a.addr for a in pt.aircraft.values()) % state.STATE_BLOBS
    path = os.path.join(d, f"blob_{blob:02d}.bin.zst")
    good = open(path, "rb").read()
    bad = {"garbage-after-magic": state.STATE_MAGIC_V2 + b"\x00garbage" * 9,
           "wrong-magic": b"readsb-tpu-state-v9" + good[19:],
           "bad-pickle": state.STATE_MAGIC_V2 + zstandard.ZstdCompressor().compress(b"x" * 50),
           "truncated-frame": good[:-9]}[kind]
    open(path, "wb").write(bad)
    lost = sum(1 for a in pt.aircraft if a % state.STATE_BLOBS == blob)
    want, got = jax_tracker.Tracker(), tracker.Tracker()
    assert state.load_state(got, d) == jax_state.load_state(want, d) == len(pt.aircraft) - lost
    assert _state(got) == _state(want) and lost > 0


def _traced(seed=13):
    """readsb_tpu's tracker with history traces: a scene, and the flight of
    test_torch_history (whose trace has chunks) as one more aircraft."""
    jt, _ = _trackers(seed=seed, duration_s=4.0, keep_traces=True, json_trace_interval=1000)
    a, _ = _run_flight("ref", 1, 8000)
    jt.aircraft[a.addr] = a
    assert sum(a.trace is not None for a in jt.aircraft.values()) >= 4 and a.trace.chunks
    return jt


def _write_reference(jt, version, d):
    if version == "v1":
        _write_v1(jt, d)
    else:
        jax_state.save_state(jt, d, EPOCH_MS)


def _with_traces(t, chunk_reader):
    """(aircraft_state without the traces, {addr: the trace's content})."""
    acs = sorted(t.aircraft.values(), key=lambda a: a.addr)
    held = {a.addr: _trace_key(a.trace, chunk_reader) for a in acs if a.trace is not None}
    saved = [a.trace for a in acs]
    for a in acs:
        a.trace = None
    try:
        return aircraft_state(acs), held
    finally:
        for a, tr in zip(acs, saved):
            a.trace = tr


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_a_blob_with_a_trace_loads_equal_to_the_reference(version, tmp_path):
    """readsb_tpu's state directory with history traces loads into the
    port as into readsb_tpu: every aircraft, every trace (chunks pickled
    with readsb_tpu's State included); the port's trace files from it
    equal readsb_tpu's."""
    jt = _traced()
    d = str(tmp_path / "state")
    _write_reference(jt, version, d)
    want, got = jax_tracker.Tracker(), tracker.Tracker()
    assert state.load_state(got, d) == jax_state.load_state(want, d) == len(jt.aircraft)
    assert _with_traces(got, traces.load_chunk) == _with_traces(want, _ref_chunk)
    # v1 leaves out a trace's buffered point and dirty flag, in both packages
    lost = ("buffered", "dirty") if version == "v1" else ()
    kept = lambda held: {k: {f: v for f, v in tr.items() if f not in lost}  # noqa: E731
                         for k, tr in held.items()}
    assert kept(_with_traces(want, _ref_chunk)[1]) == kept(_with_traces(jt, _ref_chunk)[1])
    now = EPOCH_MS + 30 * 3_600_000
    history.write_traces(got, str(tmp_path / "port"), now, time_budget_s=None)
    jax_history.write_traces(want, str(tmp_path / "ref"), now, time_budget_s=None)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    # the port's own save of the traces it loaded round-trips
    d2 = str(tmp_path / "again")
    state.save_state(got, d2, EPOCH_MS)
    back = tracker.Tracker()
    assert state.load_state(back, d2) == len(jt.aircraft)
    assert _with_traces(back, traces.load_chunk)[1] == _with_traces(got, traces.load_chunk)[1]


_ISOLATED = """
import dataclasses, json, sys
sys.modules["readsb_tpu"] = None  # importing readsb_tpu, or anything under it, fails
sys.modules["zstandard"] = None
from readsb_tpu_torch.io import history, state
from readsb_tpu_torch.track import tracker
t = tracker.Tracker()
n = state.load_state(t, sys.argv[1])
history.write_traces(t, sys.argv[2], int(sys.argv[3]), time_budget_s=None)
json.dump({"n": n, "traces": {str(a.addr): [dataclasses.asdict(s) for s in a.trace.full()]
                              for a in t.aircraft.values() if a.trace is not None}},
          open(sys.argv[4], "w"))
"""


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_reference_traces_load_where_readsb_tpu_cannot_be_imported(version, tmp_path):
    """The loader and the trace writer read readsb_tpu's pickled trace
    classes, in the blobs and in the chunks, without importing it (or
    zstandard): in a process where neither imports."""
    jt = _traced()
    d = str(tmp_path / "state")
    _write_reference(jt, version, d)
    now = EPOCH_MS + 30 * 3_600_000
    out = tmp_path / "out.json"
    r = subprocess.run([sys.executable, "-c", _ISOLATED, d, str(tmp_path / "port"), str(now),
                        str(out)], cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(out.read_text())
    want = jax_tracker.Tracker()
    assert got["n"] == jax_state.load_state(want, d) == len(jt.aircraft)
    jax_history.write_traces(want, str(tmp_path / "ref"), now, time_budget_s=None)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    # the traces after the sweep (which marks the legs of the live points)
    assert got["traces"] == {str(a.addr): [dataclasses.asdict(s) for s in a.trace.full()]
                             for a in want.aircraft.values() if a.trace is not None}


def test_port_v1_records_equal_the_reference(tmp_path):
    """The port's v1 writer (_aircraft_to_dict, traces included) gives
    readsb_tpu's records, and they load back."""
    jt = _traced()
    d = str(tmp_path / "v1")
    _write_v1(jt, d)
    pt = tracker.Tracker()
    state.load_state(pt, d)
    key = lambda rec: {k: v for k, v in rec.items() if k not in PORT_ONLY_FIELDS}  # noqa: E731
    for addr, a in sorted(pt.aircraft.items()):
        got = json.loads(json.dumps(state._aircraft_to_dict(a)))
        want = json.loads(json.dumps(jax_state._aircraft_to_dict(jt.aircraft[addr])))
        assert key(got) == want
    assert any("__trace" in state._aircraft_to_dict(a) for a in pt.aircraft.values())


# --- the App: startup restore, triggers, periodic and final writes ---------------


def _apps(argv, monkeypatch):
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    ja, pa = jax_main.App(jax_main.parse_args(argv)), main.App(main.parse_args(argv))
    ja.epoch_ms = pa.epoch_ms = EPOCH_MS
    return ja, pa


def _feed(app, pkg, seed=12, duration_s=12.0, t0_ms=EPOCH_MS):
    fmod, cls = (jax_fields, JaxRawFrame) if pkg is jax_main else (fields, RawFrame)
    for k, (t_s, msg, addr, rid) in enumerate(_scene(seed, duration_s=duration_s)):
        mm = fmod.decode_frame(_frame(cls, t_s, msg, addr, k), epoch_ms=t0_ms)
        app.handle_message(mm, raw_ts=int(t_s * 12e6), signal=0.01)


def test_write_state_is_restored_at_startup(fed, tmp_path, monkeypatch):
    """readsb restores --write-state at startup (readInternalState,
    globe_index.c:3565); readsb_tpu's App never does (it reads state only
    on replaceState), so a restart loses every aircraft.  The port's App
    holds them before its first frame; readsb_tpu's starts empty."""
    jt, _ = fed
    d = str(tmp_path / "state")
    jax_state.save_state(jt, d, EPOCH_MS)
    ja, pa = _apps(["--net-only", "--write-state", d], monkeypatch)
    assert len(ja.tracker.aircraft) == 0  # the fault of readsb_tpu
    assert _state(pa.tracker) == _state(jt) and len(pa.tracker.aircraft) >= 6
    fresh = main.App(main.parse_args(["--net-only", "--write-state", str(tmp_path / "none")]))
    assert len(fresh.tracker.aircraft) == 0  # no directory yet: an empty start


def test_get_state_and_replace_state(fed, tmp_path, monkeypatch):
    jt, _ = fed
    outs = []
    for name in ("ref", "port"):
        jd = tmp_path / name
        ja, pa = _apps(["--net-only", "--write-json", str(jd)], monkeypatch)
        app, pkg = (ja, jax_main) if name == "ref" else (pa, main)
        _feed(app, pkg)
        get = jd / "getState"
        get.mkdir(parents=True)
        (get / "writeState").write_text("\n")  # the whole state
        app._check_state_triggers(EPOCH_MS)
        assert not (get / "writeState").exists()  # unlinked: the scripts poll for it
        whole = _blob_docs(str(get), _ToReference)
        assert (get / "rangeDirs.gz").exists()
        blob = next(iter(app.tracker.aircraft)) % state.STATE_BLOBS
        one = tmp_path / f"{name}-one"
        shutil.move(str(get), str(one))
        get.mkdir()
        (get / "writeState").write_text(f"{blob:02x}")  # one blob by its hex suffix
        app._check_state_triggers(EPOCH_MS)
        assert sorted(os.listdir(get)) == [f"blob_{blob:02d}.bin.zst"]
        rep = jd / "replaceState"
        jax_state.save_state(jt, str(rep), EPOCH_MS)
        app._check_state_triggers(EPOCH_MS)
        assert not rep.exists()
        outs.append((_without_port_field(whole), _state(app.tracker)))
    assert outs[1] == outs[0]
    assert len(outs[1][0][0]["aircraft"]) + sum(len(d["aircraft"]) for d in outs[1][0]) > 6


@pytest.mark.parametrize("only_on_exit", [False, True], ids=["periodic", "only-on-exit"])
def test_periodic_and_final_state_writes(only_on_exit, tmp_path, monkeypatch):
    """amain writes --write-state every --write-state-every seconds and at
    shutdown, or only at shutdown with --write-state-only-on-exit; what it
    wrote last loads to the App's final aircraft, in both packages."""
    import time

    finals = []
    now = int(time.time() * 1000)  # one clock for both: the host's, as amain's ticks read it
    for pkg, st in ((jax_main, jax_state), (main, state)):
        d = str(tmp_path / pkg.__name__.split(".")[0])
        argv = ["--net-only", "--write-state", d, "--write-state-every", "0.3",
                "--auto-exit", "1.3", *(["--write-state-only-on-exit"] if only_on_exit else [])]
        monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
        app = pkg.App(pkg.parse_args(argv))
        app.epoch_ms = now
        _feed(app, pkg, duration_s=4.0, t0_ms=now - 5000)

        async def no_net():
            pass

        app.setup_net = no_net
        writes = []
        real = st.save_state
        monkeypatch.setattr(st, "save_state",
                            lambda t, dd, n: writes.append(len(t.aircraft)) or real(t, dd, n))
        assert asyncio.run(asyncio.wait_for(app.amain(), TIMEOUT)) == 0
        monkeypatch.setattr(st, "save_state", real)
        assert writes and writes[-1] == len(app.tracker.aircraft) >= 4
        assert len(writes) == 1 if only_on_exit else len(writes) >= 2
        back = tracker.Tracker()
        assert state.load_state(back, d) == len(app.tracker.aircraft)
        finals.append(_state(back))
        assert finals[-1] == _state(app.tracker)
    assert finals[1] == finals[0]


# --- --dump-beast --------------------------------------------------------------------


def _dump(directory):
    (name,) = os.listdir(directory)
    assert name.startswith("beast-") and name.endswith(".zst")
    data = open(os.path.join(directory, name), "rb").read()
    return zstandard.ZstdDecompressor().decompressobj().decompress(data)


def test_dump_beast_equals_reference_and_holds_the_frames_taken(tmp_path, monkeypatch):
    stream, n = _beast_stream()
    dumps = []
    for name in ("ref", "port"):
        d = tmp_path / name
        ja, pa = _apps(["--net-only", "--dump-beast", f"{d},30"], monkeypatch)
        app = ja if name == "ref" else pa
        conn = app._beast_input_factory()()
        assert app.bulk is not None and conn.cols_mode is False  # the object deframer
        for i in range(0, len(stream), 333):
            asyncio.run(asyncio.wait_for(conn.feed(stream[i:i + 333]), TIMEOUT))
        app.drain_net_queue()
        app.beast_dump.close()
        dumps.append(_dump(str(d)))
    assert dumps[1] == dumps[0]
    key = lambda fs: [(f.msg, f.timestamp, f.signal_byte, f.synthetic_ms) for f in fs]  # noqa: E731
    taken = key(jax_beast.BeastDeframer().feed(stream))
    assert key(beast.BeastDeframer().feed(dumps[1])) == taken and len(taken) == n


def test_without_dump_beast_the_input_stays_columnar(monkeypatch):
    for pkg in (jax_main, main):
        monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
        app = pkg.App(pkg.parse_args(["--net-only"]))
        assert app.beast_dump is None and app._beast_input_factory()().cols_mode is True


def test_dump_beast_writes_through_the_port_codec(tmp_path):
    d = beastdump.BeastDumper(str(tmp_path / "d"))
    frames = [beast.BeastFrame(msg=bytes([0x5d, 1, 2, 3, 4, 5, 0x1a]), timestamp=12 * k,
                               signal_byte=40, msg_type=0) for k in range(300)]
    for k, f in enumerate(frames):
        f.receiver_id = 7 if k >= 150 else 0
        d.record(f, 1_700_000_000_000 + k)
    d.close()
    data = zstd.decompress(open(os.path.join(tmp_path / "d", os.listdir(tmp_path / "d")[0]),
                                "rb").read())
    got = beast.BeastDeframer().feed(data)
    assert [(f.msg, f.timestamp, f.synthetic_ms, f.receiver_id) for f in got] == [
        (f.msg, f.timestamp, 1_700_000_000_000 + k, 7 if k >= 150 else 0)
        for k, f in enumerate(frames)]
