"""History in the port against readsb_tpu, at tolerance 0, with no App:
traces (`track/traces.py`), the trace files, globe tiles and heatmaps
(`io/history.py`), the aircraft database (`track/acdb.py`),
`globe_indexes`, the ACAS log (`io/acas.py`) and `write_bincraft_zst`.

The same seeded inputs, made with numpy, go through both packages.  A
flight of a few thousand steps over hours of synthetic time drives
`Trace.add` directly (both packages' Aircraft, field by field), so that
chunks form, go cold in the render cache, are pruned and rewritten;
trackers fed one scene (test_torch_track._scene) through each decoder
with `keep_traces` give the trace files, tiles and heatmaps.  Every
writer runs with a fixed `now` and without a time budget, except where
the budget's rotation is the subject, and then it is 1e-12 s, so that
each sweep writes exactly one aircraft.  Compressed files are compared
after decompression: zstd and gzip bytes need not be equal (gzip stamps
the time); readsb_tpu's `zstandard` also decodes the port's files.
"""

import dataclasses
import functools
import gzip
import json
import os
import pickle
import sys

import numpy as np
import pytest
import zstandard

from readsb_tpu.decode import fields as jax_fields
from readsb_tpu.decode.score import RawFrame as JaxRawFrame
from readsb_tpu.io import acas as jax_acas
from readsb_tpu.io import bincraft as jax_bincraft
from readsb_tpu.io import history as jax_history
from readsb_tpu.track import acdb as jax_acdb
from readsb_tpu.track import globe as jax_globe
from readsb_tpu.track import traces as jax_traces
from readsb_tpu.track import tracker as jax_tracker
from readsb_tpu_torch.decode import fields
from readsb_tpu_torch.decode.score import RawFrame
from readsb_tpu_torch.io import acas, bincraft, history, zstd
from readsb_tpu_torch.synth import _setbits, append_crc
from readsb_tpu_torch.track import acdb, globe, traces, tracker
from tests.test_torch_track import EPOCH_MS, _frame, _overlay, _scene

PKGS = {"ref": (jax_fields, jax_tracker, jax_traces), "port": (fields, tracker, traces)}
HOUR = 3_600_000


# --- a flight through Trace.add ----------------------------------------------------

# (field, validity) driven by the flight; "position" carries lat / lon
_DRIVEN = (("gs", "gs_valid"), ("track", "track_valid"), ("baro_alt", "baro_alt_valid"),
           ("baro_rate", "baro_rate_valid"), ("geom_alt", "geom_alt_valid"),
           ("geom_rate", "geom_rate_valid"), ("ias", "ias_valid"), ("roll", "roll_valid"),
           ("true_heading", "true_heading_valid"), ("callsign", "callsign_valid"),
           ("squawk", "squawk_valid"), ("nav_qnh", "nav_qnh_valid"),
           ("nav_altitude_mcp", "nav_altitude_mcp_valid"), ("nav_heading", "nav_heading_valid"),
           ("tas", "tas_valid"), ("mach", "mach_valid"), ("oat", "oat_valid"),
           ("wind_speed", "wind_valid"), ("emergency", "emergency_valid"),
           ("airground", "airground_valid"))
_SOURCES = (5, 10, 10, 10, 4)  # MODE_S, ADSB x3, MLAT (decode.fields.Source values)


@functools.lru_cache(maxsize=None)
def _flight(seed, n_steps=1600):
    """[(t_ms, {field: (value, source value) or None}, lat, lon, pos source,
    stale)]: a flight of climbs, cruises, descents, ground spells, speed and
    track changes, squawks 7700 / 7777, MLAT spells and gaps up to 40 min."""
    rng = np.random.default_rng(seed)
    n, nf = n_steps, len(_DRIVEN)
    steps = rng.choice([400, 1000, 2500, 6000, 9000, 20000, 45000, 200_000, 2_400_000], n,
                       p=[.1, .2, .2, .2, .1, .1, .06, .03, .01])
    new_phase = np.where(rng.random(n) < 0.01, rng.integers(0, 4, n), -1)
    climb = rng.uniform(100, 1500, n)
    gs_jump, gs_air, gs_gnd = rng.random(n) < 0.05, rng.uniform(5, 520, n), rng.uniform(0, 30, n)
    gs_noise = rng.normal(0, 2, n)
    trk_noise = rng.normal(0, 1, n) * np.where(rng.random(n) < 0.9, 3, 60)
    dlat, dlon = rng.normal(0, 0.01, n), rng.normal(0, 0.01, n)
    dlat += np.where(rng.random(n) < 0.02, rng.uniform(-0.5, 0.5, n), 0)
    srcs = rng.choice(_SOURCES, n)
    gone, skip = rng.random((n, nf)) < 0.08, rng.random((n, nf)) < 0.5
    stale = rng.random(n) < 0.02
    draws = {
        "baro_rate": rng.choice([-2048, -640, 0, 0, 64, 1280, 3200], n),
        "geom_rate": rng.choice([-1024, 0, 512], n), "ias": rng.integers(0, 400, n),
        "roll": rng.uniform(-30, 30, n).round(2), "true_heading": rng.uniform(0, 360, n).round(2),
        "callsign": rng.integers(0, 3, n),
        "squawk": rng.choice([0x1000, 0x7700, 0x7777, 0x2345], n, p=[.7, .05, .05, .2]),
        "nav_qnh": rng.uniform(990, 1030, n).round(1),
        "nav_altitude_mcp": rng.integers(0, 400, n) * 100,
        "nav_heading": rng.uniform(0, 360, n).round(2), "tas": rng.integers(100, 500, n),
        "mach": rng.uniform(.3, .85, n).round(3), "oat": rng.uniform(-60, 20, n).round(1),
        "wind_speed": rng.uniform(0, 90, n).round(1), "emergency": rng.integers(0, 3, n),
        "airground": rng.choice([2, 3], n),
    }
    sometimes = {"geom_alt", "geom_rate", "roll", "ias", "nav_qnh", "nav_altitude_mcp",
                 "nav_heading", "tas", "mach", "oat", "wind_speed", "emergency", "true_heading"}
    t = 1_700_000_000_000 + int(rng.integers(0, HOUR))
    lat, lon, alt, gs, trk = 46.0, 7.0, 0.0, 15.0, 90.0
    phase = "ground"
    out = []
    for i in range(n):
        t += int(steps[i])
        if new_phase[i] >= 0:
            phase = ("ground", "climb", "cruise", "descent")[new_phase[i]]
        if phase == "climb":
            alt = min(39000.0, alt + climb[i])
            phase = "cruise" if alt >= 39000 else phase
        elif phase == "descent":
            alt = max(0.0, alt - climb[i])
            phase = "ground" if alt <= 0 else phase
        if gs_jump[i]:
            gs = float(gs_air[i] if phase != "ground" else gs_gnd[i])
        else:
            gs = max(0.0, gs + float(gs_noise[i]))
        trk = (trk + float(trk_noise[i])) % 360
        lat, lon = lat + float(dlat[i]), lon + float(dlon[i])
        src = int(srcs[i])
        upd = {}
        for f, (name, _) in enumerate(_DRIVEN):
            if gone[i, f]:
                upd[name] = None  # gone stale
                continue
            if name in sometimes and skip[i, f]:
                continue  # not updated this step
            if name == "gs":
                val = round(gs, 1)
            elif name == "track":
                val = round(trk, 2)
            elif name in ("baro_alt", "geom_alt"):
                val = int(round(alt / 25) * 25) + (100 if name == "geom_alt" else 0)
                if phase == "ground" and name == "baro_alt":
                    val = None
            elif name == "callsign":
                val = ("SWR12A", "EZY34B", "TEST1")[draws[name][i]]
            elif name == "airground":
                val = 1 if phase == "ground" else int(draws[name][i])
            else:
                val = draws[name][i].item()
            upd[name] = None if val is None else (val, src)
        pos_src = 4 if src == 4 else 10
        out.append((t, upd, round(lat, 6), round(lon, 6), pos_src, bool(stale[i])))
    return out


def _aircraft(pkg, addr=0x4B1234):
    fmod, tmod, _ = PKGS[pkg]
    a = tmod.Aircraft(addr=addr)
    a.addrtype = fmod.AddrType(0)
    a.category, a.adsb_version, a.nac_p, a.sil, a.alert = 0xA3, 2, 9, 3, True
    a.wind_dir = 270.0
    return a


def _step(a, pkg, t, upd, lat, lon, pos_src):
    fmod = PKGS[pkg][0]
    for name, vname in _DRIVEN:
        if name not in upd:
            continue
        v = getattr(a, vname)
        if upd[name] is None:
            v.updated = t - 10 * 60_000
            continue
        val, src = upd[name]
        setattr(a, name, fmod.AirGround(val) if name == "airground" else val)
        v.updated, v.source, v.last_source = t, fmod.Source(src), fmod.Source(src)
    a.lat, a.lon = lat, lon
    pv = a.position_valid
    pv.updated, pv.source, pv.last_source = t, fmod.Source(pos_src), fmod.Source(pos_src)


def _run_flight(pkg, seed, interval_ms):
    """One aircraft through the flight; its Trace; the committed count."""
    tmod = PKGS[pkg][2]
    a = _aircraft(pkg)
    a.trace = tmod.Trace()
    committed = 0
    for t, upd, lat, lon, pos_src, stale in _flight(seed):
        _step(a, pkg, t, upd, lat, lon, pos_src)
        committed += a.trace.add(a, t, stale=stale, json_trace_interval=interval_ms)
    return a, committed


def _states(states):
    return [dataclasses.asdict(s) for s in states]


def _trace_key(tr, chunk_reader):
    return {
        "full": _states(tr.full()), "points": _states(tr.points),
        "chunks": [_states(chunk_reader(b)) for b in tr.chunks],
        "chunk_meta": list(tr.chunk_meta), "len": len(tr), "dirty": tr.dirty,
        "next_marker": tr.next_marker,
        "buffered": dataclasses.asdict(tr.buffered) if tr.buffered else None,
    }


def _ref_chunk(blob):
    return pickle.loads(zstandard.ZstdDecompressor().decompress(blob))


@pytest.fixture(scope="module", params=[(1, 8000), (2, 30000), (3, 4000)],
                ids=["seed1-8s", "seed2-30s", "seed3-4s"])
def flights(request):
    seed, interval = request.param
    (ja, jn), (pa, pn) = (_run_flight(p, seed, interval) for p in ("ref", "port"))
    assert pn == jn and len(pa.trace.chunks) >= 2  # the chunk path ran
    return seed, interval, ja, pa


def test_trace_add_over_a_flight_equals_reference(flights):
    _, _, ja, pa = flights
    want = _trace_key(ja.trace, _ref_chunk)
    assert _trace_key(pa.trace, traces.load_chunk) == want
    assert any(s["all"] for s in want["full"]) and any(s["stale"] for s in want["full"])
    assert any(s["on_ground"] for s in want["full"])
    # the port's chunks are zstd frames that zstandard decodes
    assert [_states(_ref_chunk(b)) for b in pa.trace.chunks] == want["chunks"]


def test_since_and_the_cold_render_cache_equal_reference(flights):
    _, _, ja, pa = flights
    metas = ja.trace.chunk_meta
    for ts in (0, metas[0][1], metas[0][2] + 1, metas[-1][2], ja.trace.points[-1].timestamp):
        assert _states(pa.trace.since(ts)) == _states(ja.trace.since(ts))
    last = ja.trace.points[-1].timestamp
    # now with no chunk cold, with the first cold, with all cold; each twice
    # (the second render comes from the cache)
    for now in (metas[0][2], metas[0][2] + traces.TRACE_CACHE_COLD_MS,
                last + traces.TRACE_CACHE_COLD_MS + 1):
        for _ in range(2):
            got = traces.render_full_cached(pa.trace, now)
            want = jax_traces.render_full_cached(ja.trace, now)
            assert (got[0], _states(got[1]), got[2]) == (want[0], _states(want[1]), want[2])
            assert traces.mark_legs(got[1]) == jax_traces.mark_legs(want[1])
            assert traces.trace_rows(got[1], got[2]) == jax_traces.trace_rows(want[1], want[2])
    assert len(got[0]) == sum(n for n, _, _ in metas)  # every chunk came from the cache
    assert traces.render_cache_memory() > 0


def test_mark_legs_rows_and_json_equal_reference(flights):
    _, _, ja, pa = flights
    want_states, got_states = ja.trace.full(), pa.trace.full()
    for start in (0, 5, len(want_states) // 2):
        assert traces.mark_legs(got_states, start) == jax_traces.mark_legs(want_states, start)
        assert _states(got_states) == _states(want_states)
    now = want_states[-1].timestamp + 1000
    for ref_ts in (0, want_states[0].timestamp - 5000, want_states[10].timestamp):
        assert traces.trace_rows(got_states, ref_ts) == jax_traces.trace_rows(want_states, ref_ts)
    for a in (ja, pa):
        a.registration, a.type_code, a.db_flags = "HB-JXA", "A320", 1
    assert traces.trace_json(pa, got_states, now) == jax_traces.trace_json(ja, want_states, now)
    assert traces.trace_json(pa, [], now) == jax_traces.trace_json(ja, [], now)


def test_mark_legs_over_two_flights_equals_reference():
    """test_history.py's climb, cruise, descent, ground, 40 min gap, climb."""
    def states(tmod):
        out, t = [], 1_000_000_000
        for alts, ground, step in ((range(0, 30000, 750), False, 20_000),
                                   ([30000] * 40, False, 20_000),
                                   (range(30000, 0, -750), False, 20_000),
                                   ([0] * 5, True, 60_000)):
            for alt in alts:
                s = tmod.State(timestamp=t, lat=48_000_000, lon=11_000_000, on_ground=ground)
                if not ground:
                    s.baro_alt = int(alt / 6.25)
                out.append(s)
                t += step
        t += 40 * 60_000
        for alt in range(0, 30000, 750):
            out.append(tmod.State(timestamp=t, lat=48_000_000, lon=11_000_000,
                                  baro_alt=int(alt / 6.25)))
            t += 20_000
        return out

    got, want = states(traces), states(jax_traces)
    assert traces.mark_legs(got) == jax_traces.mark_legs(want) >= 1
    assert _states(got) == _states(want)


def test_prune_and_delete_range_equal_reference(flights):
    _, _, ja, pa = flights
    meta = ja.trace.chunk_meta
    assert pa.trace.delete_range(meta[0][1] + 1, meta[0][2] - 1) == \
        ja.trace.delete_range(meta[0][1] + 1, meta[0][2] - 1) > 0  # inside the first chunk
    mid = ja.trace.points[len(ja.trace.points) // 2].timestamp
    assert pa.trace.delete_range(meta[-1][2] - 1, mid) == \
        ja.trace.delete_range(meta[-1][2] - 1, mid) > 0  # a chunk and live points
    assert pa.trace.delete_range(0, 1) == ja.trace.delete_range(0, 1) == 0
    assert _trace_key(pa.trace, traces.load_chunk) == _trace_key(ja.trace, _ref_chunk)
    keep = ja.trace.chunk_meta[0][2] + 1
    pa.trace.prune(keep)
    ja.trace.prune(keep)
    assert _trace_key(pa.trace, traces.load_chunk) == _trace_key(ja.trace, _ref_chunk)
    got = traces.render_full_cached(pa.trace, mid + 10 * HOUR)
    want = jax_traces.render_full_cached(ja.trace, mid + 10 * HOUR)
    assert (got[0], _states(got[1]), got[2]) == (want[0], _states(want[1]), want[2])


def test_a_chunk_of_reference_states_reads_without_readsb_tpu():
    """A chunk pickled with readsb_tpu's State reads as the port's State;
    a chunk naming another readsb_tpu class is refused."""
    st = [jax_traces.State(timestamp=5, lat=1, lon=2, all={"flight": "X"})]
    blob = zstandard.ZstdCompressor(level=3).compress(pickle.dumps(st, protocol=4))
    (got,) = traces.load_chunk(blob)
    assert type(got) is traces.State and dataclasses.asdict(got) == dataclasses.asdict(st[0])
    bad = zstd.compress(pickle.dumps([jax_tracker.Validity()], protocol=4))
    with pytest.raises(pickle.UnpicklingError):
        traces.load_chunk(bad)


# --- trackers with traces, and the writers ------------------------------------------

RECEIVER = dict(receiver_lat=47.45, receiver_lon=8.55, max_range_km=300 * 1.852)


def _trackers(seed=12, duration_s=40.0, interval_ms=1000):
    """Both packages' trackers with traces, fed one scene, plus the
    flight's aircraft (chunks and cold chunks) in each."""
    out = {}
    for pkg, (fmod, tmod, _) in PKGS.items():
        cls = JaxRawFrame if pkg == "ref" else RawFrame
        t = tmod.Tracker(json_reliable=1, keep_traces=True, json_trace_interval=interval_ms,
                         **RECEIVER)
        for k, (t_s, msg, addr, rid) in enumerate(_scene(seed, duration_s=duration_s)):
            mm = fmod.decode_frame(_frame(cls, t_s, msg, addr, k), epoch_ms=EPOCH_MS)
            mm.receiver_id = rid
            t.update(mm)
        a, _ = _run_flight(pkg, 1, 8000)
        a.seen = a.trace.points[-1].timestamp
        t.aircraft[a.addr] = a
        out[pkg] = t
    assert sum(a.trace is not None for a in out["port"].aircraft.values()) >= 5
    return out["ref"], out["port"]


def _files(root):
    """{relative path: content, gunzipped or zstd-decompressed} under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            data = open(p, "rb").read()
            if data[:2] == b"\x1f\x8b":  # trace files and heatmaps
                data = gzip.decompress(data)
            elif data[:4] == b"\x28\xb5\x2f\xfd":  # globe tiles, bincraft
                assert zstd.decompress(data) == zstandard.ZstdDecompressor().decompress(data)
                data = zstd.decompress(data)
            out[os.path.relpath(p, root)] = data
    return out


@pytest.mark.parametrize("hist_only", [0, 1, 2, 3])
def test_write_traces_equals_reference(hist_only, tmp_path):
    jt, pt = _trackers()
    now = EPOCH_MS + 30 * HOUR  # after the flight: its chunks are cold
    before = dict(history.TRACE_WRITES), dict(jax_history.TRACE_WRITES)
    got = history.write_traces(pt, str(tmp_path / "port"), now, time_budget_s=None,
                               hist_only=hist_only)
    want = jax_history.write_traces(jt, str(tmp_path / "ref"), now, time_budget_s=None,
                                    hist_only=hist_only)
    assert got == want and want[0] == sum(a.trace is not None for a in jt.aircraft.values())
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "ref")
    kinds = {n.split("/")[-1].split("_")[1] for n in files}
    assert kinds == {"recent", "full"} - ({"recent"} if hist_only & 1 else set()) \
        - ({"full"} if hist_only & 2 else set())
    for k in ("recent", "full"):
        assert history.TRACE_WRITES[k] - before[0][k] == jax_history.TRACE_WRITES[k] - before[1][k]
    for name, data in files.items():
        doc = json.loads(data)
        assert doc["icao"] == name.split("_")[-1][:-5] and doc["trace"]
    # nothing is dirty now: a second sweep writes nothing
    assert history.write_traces(pt, str(tmp_path / "port"), now, time_budget_s=None)[0] == 0


def test_write_traces_budget_rotation_equals_reference(tmp_path):
    """A budget of 1e-12 s: each sweep writes one aircraft and hands on its
    cursor; both packages visit the aircraft in the same order."""
    jt, pt = _trackers(duration_s=12.0)
    now = EPOCH_MS + 30 * HOUR
    cursors = {"port": 0, "ref": 0}
    for _ in range(len(pt.aircraft) + 1):
        outs = {}
        for pkg, mod, t in (("port", history, pt), ("ref", jax_history, jt)):
            outs[pkg] = mod.write_traces(t, str(tmp_path / pkg), now, time_budget_s=1e-12,
                                         cursor=cursors[pkg])
            cursors[pkg] = outs[pkg][1]
        assert outs["port"] == outs["ref"] and outs["port"][0] <= 1
    assert not any(a.trace is not None and a.trace.dirty for a in pt.aircraft.values())
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_globe_tiles_equal_reference(tmp_path):
    jt, pt = _trackers()
    now = EPOCH_MS + 41_000
    for pkg in PKGS:
        os.makedirs(tmp_path / pkg)
    n = history.write_globe_bincraft(pt, str(tmp_path / "port"), now)
    assert n == jax_history.write_globe_bincraft(jt, str(tmp_path / "ref"), now) >= 2
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "ref") and len(files) == n
    assert all(name.startswith("globe_") and name.endswith(".binCraft.zst") for name in files)


@pytest.mark.parametrize("interval_ms", [30_000, 2_000, 700_000])
def test_heatmap_equals_reference(interval_ms, tmp_path):
    jt, pt = _trackers()
    flight = pt.aircraft[0x4B1234].trace.full()
    start = flight[len(flight) // 2].timestamp // (30 * 60_000) * 30 * 60_000
    outs = []
    for pkg, mod, t in (("port", history, pt), ("ref", jax_history, jt)):
        path = mod.write_heatmap(t, str(tmp_path / pkg), start, start + 30 * 60_000,
                                 interval_ms=interval_ms)
        outs.append((os.path.relpath(path, tmp_path / pkg), gzip.decompress(open(path, "rb").read())))
    assert outs[0] == outs[1]
    body = outs[0][1]
    assert len(body) % history.HEAT_ENTRY.size == 0
    assert len(body) // history.HEAT_ENTRY.size > 2 * ((30 * 60_000) // interval_ms)  # points


def test_heat_entries_equal_reference():
    rng = np.random.default_rng(9)
    for _ in range(300):
        kw = dict(timestamp=int(rng.integers(0, 1 << 42)), lat=int(rng.integers(-90e6, 90e6)),
                  lon=int(rng.integers(-180e6, 180e6)), on_ground=bool(rng.random() < 0.2),
                  baro_alt=None if rng.random() < 0.3 else int(rng.integers(-200, 9000)),
                  geom_alt=None if rng.random() < 0.5 else int(rng.integers(-200, 9000)),
                  gs=None if rng.random() < 0.2 else int(rng.integers(0, 40000)),
                  addrtype=int(rng.integers(0, 14)))
        addr = int(rng.integers(0, 1 << 24))
        assert history._heat_point(addr, traces.State(**kw)) == \
            jax_history._heat_point(addr, jax_traces.State(**kw))
        sq, cs = int(rng.integers(0, 0x7778)), "".join(rng.choice(list("AB1 "), int(rng.integers(0, 10))))
        assert history._heat_info(addr, sq, cs) == jax_history._heat_info(addr, sq, cs)


def test_write_bincraft_zst_equals_reference(tmp_path, monkeypatch):
    jt, pt = _trackers(duration_s=12.0)
    now = EPOCH_MS + 12_000
    got, want = str(tmp_path / "port.binCraft.zst"), str(tmp_path / "ref.binCraft.zst")
    bincraft.write_bincraft_zst(pt, got, now)
    jax_bincraft.write_bincraft_zst(jt, want, now)
    data = zstandard.ZstdDecompressor().decompress(open(got, "rb").read())
    assert data == zstandard.ZstdDecompressor().decompress(open(want, "rb").read())
    assert data == zstd.decompress(open(got, "rb").read()) == bincraft.generate_bincraft(pt, now)
    # without their codecs both write zlib to a .zlib file
    monkeypatch.setattr(zstd, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    bincraft.write_bincraft_zst(pt, got, now)
    jax_bincraft.write_bincraft_zst(jt, want, now)
    assert open(got.replace(".zst", ".zlib"), "rb").read() == \
        open(want.replace(".zst", ".zlib"), "rb").read()


# --- the aircraft database ---------------------------------------------------------


def _db_lines(seed, addrs):
    rng = np.random.default_rng(seed)
    lines = []
    for addr in addrs:
        flags = "".join(rng.choice(list("01"), int(rng.integers(0, 6))))
        cols = [f"{addr:06X}", f"HB-{seed}{addr & 0xFFF:03X}", str(rng.choice(["A320", "B738", ""])),
                flags, "Airbus A320" if rng.random() < 0.5 else "", "2004", "Op " + str(seed)]
        lines.append(";".join(cols[: int(rng.integers(3, 8))]))
    lines += ["", "nothex;x;y", "000000;zero;Z", "ab;short", "3C0C11;;  ;1;;;"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("gz", [True, False], ids=["csv.gz", "csv"])
def test_aircraft_db_and_its_reload_equal_reference(gz, tmp_path):
    path = str(tmp_path / ("aircraft.csv.gz" if gz else "aircraft.csv"))

    def write(text, mtime):
        with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
            f.write(text)
        os.utime(path, (mtime, mtime))

    jt, pt = _trackers(duration_s=12.0)
    addrs = sorted(pt.aircraft)[::2] + [0xADF7C9, 0x3B7001]
    write(_db_lines(1, addrs), 1_000_000)
    for t, mod in ((pt, acdb), (jt, jax_acdb)):
        t.db = mod.AircraftDb(path)
    for step, text in enumerate((None, _db_lines(2, addrs[1:]), "", None)):
        if text is not None:
            write(text, 1_000_000 + step)
        assert pt.db_reload() == jt.db_reload()
        assert {k: dataclasses.asdict(v) for k, v in pt.db.entries.items()} == \
            {k: dataclasses.asdict(v) for k, v in jt.db.entries.items()}
        keys = ("registration", "type_code", "db_flags", "type_long", "own_op", "year")
        got = {k: [getattr(a, f) for f in keys] for k, a in pt.aircraft.items()}
        assert got == {k: [getattr(a, f) for f in keys] for k, a in jt.aircraft.items()}
        assert pt.db._mtime == jt.db._mtime
    # the empty file kept the second table
    assert all(e.registration.startswith("HB-2") for e in pt.db.entries.values() if e.registration)
    for addr in (0xADF7C9, 0x3B7001, 0x4B8201, 0x123456):
        a, ja = tracker.Aircraft(addr=addr), jax_tracker.Aircraft(addr=addr)
        pt.db.apply(a)
        jt.db.apply(ja)
        assert (a.registration, a.db_flags) == (ja.registration, ja.db_flags)
    assert acdb.AircraftDb(str(tmp_path / "absent")).maybe_reload() is False
    assert acdb.AircraftDb(None).maybe_reload() is False


def test_mil_ranges_and_flags_equal_reference():
    rng = np.random.default_rng(3)
    addrs = [int(x) for x in rng.integers(0, 1 << 24, 20000)]
    addrs += [x for lo, hi in jax_acdb.MIL_RANGES for x in (lo - 1, lo, hi, hi + 1)]
    assert [acdb.is_mil_range(x) for x in addrs] == [jax_acdb.is_mil_range(x) for x in addrs]
    assert acdb.MIL_RANGES == jax_acdb.MIL_RANGES
    for _ in range(500):
        f = "".join(rng.choice(list("01x"), int(rng.integers(0, 40))))
        assert acdb._parse_flags(f) == jax_acdb._parse_flags(f)


def test_globe_indexes_equal_reference():
    got = globe.globe_indexes()
    assert got == jax_globe.globe_indexes()
    assert len(got) > len(globe.SPECIAL_TILES) and len(set(got)) == len(got)


# --- the ACAS log --------------------------------------------------------------------


def _ra(bits):
    b = bytearray(7)
    for n in bits:
        b[(n - 1) // 8] |= 1 << (7 - ((n - 1) % 8))
    return bytes(b)


def _df16(addr, mv):
    msg = bytearray(14)
    _setbits(msg, 1, 5, 16)
    _setbits(msg, 20, 32, 0x0C10)  # altitude
    msg[4:11] = mv
    return _overlay(append_crc(bytes(msg), 112), addr)


def _df20(addr, mb):
    msg = bytearray(14)
    _setbits(msg, 1, 5, 20)
    _setbits(msg, 20, 32, 0x0C10)
    msg[4:11] = mb
    return _overlay(append_crc(bytes(msg), 112), addr)


def _ra_stream():
    """(t_ms, msg, addr): DF16 MV and DF20 MB RAs (BDS 3,0) of three
    aircraft over a UTC midnight, repeats inside and outside the dedup
    windows, a Clear of Conflict."""
    midnight = 1_760_054_400_000  # 2025-10-10 00:00:00 UTC
    pays = [_ra([1, 2, 3, 4, 9, 10, 15]), _ra([3, 4, 9, 10, 11, 15]), _ra([3, 4, 9]),
            _ra([3, 4, 9, 23, 25]), _ra([3, 4, 27]), _ra([3, 4, 28, 10, 12])]
    pays = [bytes([0x30]) + p[1:] for p in pays]
    out = []
    t = midnight - 4000
    for i in range(60):
        addr = (0x3C6541, 0x4CA2D1, 0xADF7C9)[i % 3]
        p = pays[(i // 2) % len(pays)]
        out.append((t, (_df16 if i % 2 else _df20)(addr, p), addr))
        t += (100, 250, 350, 6000)[i % 4]
    return out


def test_acas_log_equals_reference_over_midnight(tmp_path):
    """RAs decoded by each package and logged as its App logs them: both
    days' acas.csv and acas.json are equal, the dedup included."""
    events = []
    for pkg, mod in (("port", acas), ("ref", jax_acas)):
        fmod, tmod, _ = PKGS[pkg]
        cls = JaxRawFrame if pkg == "ref" else RawFrame
        t = tmod.Tracker()
        log = mod.AcasLogger(str(tmp_path / pkg))
        for k, (ts, msg, addr) in enumerate(_ra_stream()):
            mm = fmod.decode_frame(_frame(cls, 0.001 * k, msg, addr, k), epoch_ms=ts - k)
            a = t.update(mm)
            if mm.acas_ra_valid:
                ra = mm.MV if mm.msgtype == 16 else mm.MB
                if ra and mod.ra_valid(bytes(ra), mm.msgtype):
                    log.log(mm.addr, bytes(ra), a, mm, mm.sys_timestamp_ms)
        log.close()
        events.append(log.events)
    assert events[0] == events[1] > 10
    files = {pkg: {k: v.decode() for k, v in _files(tmp_path / pkg).items()} for pkg in PKGS}
    assert files["port"] == files["ref"]
    assert sorted(files["port"]) == ["2025-10-09/acas/acas.csv", "2025-10-09/acas/acas.json",
                                     "2025-10-10/acas/acas.csv", "2025-10-10/acas/acas.json"]


def test_acas_csv_line_equals_reference():
    rng = np.random.default_rng(6)
    for i in range(400):
        ra = bytes(rng.integers(0, 256, 7, dtype=np.uint8))
        kw = dict(addr=0xABCDEF, lat=47.1, lon=8.2, seen_pos=5 if i % 3 else 0,
                  baro_alt=None if i % 5 == 0 else 12000,
                  geom_rate=None if i % 2 else -640, baro_rate=None if i % 7 == 0 else 1280)
        a, ja = tracker.Aircraft(**kw), jax_tracker.Aircraft(**kw)
        mm = fields.ModesMessage(msgtype=(16, 20, 17)[i % 3]) if i % 4 else None
        jm = jax_fields.ModesMessage(msgtype=(16, 20, 17)[i % 3]) if i % 4 else None
        now = EPOCH_MS + int(rng.integers(0, 1 << 31))
        assert acas.csv_line(0xABCDEF, ra, a, mm, now) == jax_acas.csv_line(0xABCDEF, ra, ja, jm, now)
        assert acas.csv_line(0x123, ra, None, None, now) == jax_acas.csv_line(0x123, ra, None, None, now)
