"""The port's network layer in its App against readsb_tpu's, at tolerance 0.

No demodulator of either package runs here but in the one end-to-end run
of the port alone, so no JAX compile is paid.

- Lanes: both Apps from one argv, one fake client on every output lane;
  one list of decoded messages (MLAT, JAERO, PRIO, SBS-replay, 2-bit
  corrected, reduce_forward and Mode A/C among them) through
  `handle_message` in each; every lane's bytes are equal, with and
  without --net-verbatim / --forward-mlat.  Both Apps share one epoch, so
  the SBS clock fields are equal too.
- Inputs: one Beast stream (receiver-id and synthetic-time prefixes, Mode
  A/C frames), raw, SBS (three sources), ASTERIX, UAT, planefinder and
  gpsd streams, cut at random points, into both Apps' input factories
  under --no-net-bulk-drain; after `drain_net_queue` the tracker's
  aircraft, the remote counters, stats.json and aircraft.json are equal.
  Each App's clock (`now_ms`) is fixed to one value, since the network
  inputs stamp messages with the host's clock.
- API: both packages' ApiServer over that tracker state answer every
  query form with equal bodies, `ptime` set aside; `&binCraft&zstd`
  decompresses to readsb_tpu's answer and to the uncompressed one;
  `aircraft_json_bytes_from_api` gives equal bytes.
- The JAERO altitude gate: the one named difference of the port's
  tracker (test_torch_track.PORT_ONLY_FIELDS).
- End to end, the port alone over 127.0.0.1: a feeder App demodulates a
  0.3 s capture and serves Beast, raw, SBS and the API; an aggregator App
  takes the feeder's Beast lane through --net-connector.
- Argument time: every network option parses as readsb_tpu's does.

Every network read and await has its own asyncio.wait_for limit.
"""

import asyncio
import json
import math
import os
import socket

import numpy as np
import pytest
import torch

from readsb_tpu.app import interactive as jax_interactive
from readsb_tpu.app import main as jax_main
from readsb_tpu.app.config import parse_args as jax_parse_args
from readsb_tpu.decode import fields as jax_fields
from readsb_tpu.decode.mode_ac import decode_modeac_message as jax_modeac
from readsb_tpu.decode.score import RawFrame as JaxRawFrame
from readsb_tpu.io import api as jax_api
from readsb_tpu.io import asterix as jax_asterix
from readsb_tpu.io import beast as jax_beast
from readsb_tpu.io import json_out as jax_json
from readsb_tpu.io import net as jax_net
from readsb_tpu.io import raw as jax_raw
from readsb_tpu.io import sbs as jax_sbs
from readsb_tpu.io import stats as jax_stats
from readsb_tpu.io import vrs as jax_vrs
from readsb_tpu_torch.app import interactive, main
from readsb_tpu_torch.decode import fields
from readsb_tpu_torch.decode.mode_ac import decode_modeac_message
from readsb_tpu_torch.decode.score import RawFrame
from readsb_tpu_torch.io import api, beast, json_out, net, stats, vrs
from readsb_tpu_torch.synth import _setbits, append_crc, build_traffic_capture, encode_df17_position
from tests.test_torch_net import _pf_stuff, _splits
from tests.test_torch_track import EPOCH_MS, _frame, _overlay, _scene, aircraft_state
from tests.test_uat import make_uat_frame

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

WALL_CLOCK = ("cpu", "start", "end")  # stats.json fields read off the host's clock
NET = ["--net-only", "--no-net-bulk-drain"]
LANE_ARGS = {
    "plain": [],
    "verbatim-mlat": ["--net-verbatim", "--forward-mlat"],
    "reduce-rid-gnss": ["--net-receiver-id", "--net-sbs-reduce", "--net-asterix-reduce",
                        "--gnss", "--net-json-port-interval", "1",
                        "--net-json-port-include-noposition", "--filter-DF",
                        "0,4,5,11,16,17,20,21,77"],
}
SOURCES = (fields.Source.MLAT, fields.Source.JAERO, fields.Source.PRIO, fields.Source.SBS,
           fields.Source.ADSR)
TIMEOUT = 10.0  # seconds for any one network read or await


class FakeWriter:
    """A client of an output lane: it keeps what the lane writes."""

    def __init__(self, port):
        self.buf = bytearray()
        self.port = port

    def write(self, data):
        self.buf += data

    def get_extra_info(self, key):
        return ("127.0.0.1", self.port) if key == "peername" else None

    def close(self):
        pass


def make_apps(argv):
    """The port's App and readsb_tpu's, from one argv, at EPOCH_MS."""
    pa = main.App(main.parse_args(argv))
    ja = jax_main.App(jax_parse_args(argv))
    pa.epoch_ms = ja.epoch_ms = EPOCH_MS
    return pa, ja


def attach(app):
    """One fake client on every output lane; {lane: writer}."""
    out = {}
    for i, (name, svc) in enumerate(sorted(app.net.outputs.items())):
        w = FakeWriter(40000 + i)
        svc.clients.add(w)
        svc.client_opts[id(w)] = {"modeac": False, "ping": False}
        out[name] = w
    return out


def lane_bytes(app, writers):
    for svc in app.net.outputs.values():
        svc.flush()
    return {name: bytes(w.buf) for name, w in writers.items()}


# --- lanes --------------------------------------------------------------------


def _messages(pkg_fields, raw_frame, modeac, seed):
    """The scene of test_torch_track as decoded messages with their raw
    timestamp and signal: one message in nine from each other source, SBS
    replay, 2-bit corrected, remote; a Mode A/C reply every 40."""
    out = []
    for k, (t_s, msg, addr, rid) in enumerate(_scene(seed)):
        mm = pkg_fields.decode_frame(_frame(raw_frame, t_s, msg, addr, k), epoch_ms=EPOCH_MS)
        mm.receiver_id = rid
        kind = k % 9
        if kind < len(SOURCES):
            mm.source = pkg_fields.Source(int(SOURCES[kind]))
        elif kind == 5:
            mm.sbs_in = True
        elif kind == 6:
            mm.correctedbits = 2
        elif kind == 7:
            mm.remote = True
        raw_ts = int(t_s * 12_000_000)
        out.append((mm, raw_ts, 0.01 * (1 + k % 50)))
        if k % 40 == 0:
            ac = modeac(0x1200 + k, timestamp=raw_ts, sys_timestamp_ms=EPOCH_MS + int(t_s * 1000))
            ac.receiver_id = rid
            out.append((ac, raw_ts, 0.0))
    return out


@pytest.mark.parametrize("lanes", LANE_ARGS)
def test_output_lanes_equal_reference(lanes):
    pa, ja = make_apps(NET + LANE_ARGS[lanes])
    pw, jw = attach(pa), attach(ja)
    assert sorted(pw) == sorted(jw)
    seed = 31
    for app, msgs in ((pa, _messages(fields, RawFrame, decode_modeac_message, seed)),
                      (ja, _messages(jax_fields, JaxRawFrame, jax_modeac, seed))):
        for mm, raw_ts, signal in msgs:
            app.handle_message(mm, raw_ts=raw_ts, signal=signal)
    got, want = lane_bytes(pa, pw), lane_bytes(ja, jw)
    for name in want:
        assert got[name] == want[name], name
    fed = {n for n, b in got.items() if b}
    assert {"raw_out", "beast_out", "sbs_out", "sbs_out_jaero", "sbs_out_prio",
            "sbs_out_replay", "json_out", "beast_reduce_out", "asterix_out"} <= fed
    assert "sbs_out_mlat" in fed or lanes == "reduce-rid-gnss"
    assert (pa.messages, pa.remote_modes, pa.remote_modeac) == (
        ja.messages, ja.remote_modes, ja.remote_modeac)
    now = EPOCH_MS + 40_000
    assert aircraft_state(pa.tracker.aircraft.values()) == aircraft_state(ja.tracker.aircraft.values())
    assert pa.clients_json(now) == ja.clients_json(now)
    # the periodic lane: one VRS snapshot of this state
    assert vrs.generate_vrs(pa.tracker, now) == jax_vrs.generate_vrs(ja.tracker, now)


def test_verbatim_and_mlat_gate_the_raw_lane():
    """--net-verbatim forwards 2-bit-corrected frames, --forward-mlat MLAT ones."""
    sizes = {}
    for lanes in ("plain", "verbatim-mlat"):
        pa, _ = make_apps(NET + LANE_ARGS[lanes])
        pw = attach(pa)
        for mm, raw_ts, signal in _messages(fields, RawFrame, decode_modeac_message, 31):
            pa.handle_message(mm, raw_ts=raw_ts, signal=signal)
        sizes[lanes] = lane_bytes(pa, pw)["raw_out"].count(b"\n")
    assert sizes["verbatim-mlat"] > sizes["plain"] > 0


def test_beast_commands_and_pings_equal_reference():
    """Client commands on an output lane ('1J' / '1j' / 'WO', split and
    partial) and the ping state's RTT bookkeeping."""
    rng = np.random.default_rng(5)
    stream = b"".join(rng.choice([b"\x1a1J", b"\x1a1j", b"\x1aWO", b"\x1a1", b"xx", b"\x1a"],
                                 400).tolist())
    chunks = _splits(rng, stream, 80)
    out = []
    for mod in (net, jax_net):
        svc = mod.OutputService("beast_out")
        w = object()
        svc.client_opts[id(w)] = {"modeac": False, "ping": False}
        pending, states = b"", []
        for chunk in chunks:
            pending = svc._handle_commands(w, pending + chunk)
            states.append((pending, dict(svc.client_opts[id(w)]), svc.modeac_wanted))
        ps = mod.PingState(reject_ms=50.0)
        for k in range(10):
            ps.pong((k * 1000) & 0xFFFFFF, k * 1000 + 20 + 15 * k)
        ps.pong(0xFFFFF0, 5)  # across the 24-bit wrap
        states.append((ps.rtt, ps.recent_rtt, ps.latest_rtt, ps.pongs, ps.should_shed))
        out.append(states)
    assert out[0] == out[1]
    assert any(st[2] for st in out[0][:-1]) and not all(st[2] for st in out[0][:-1])


# --- inputs -------------------------------------------------------------------

NOW = EPOCH_MS + 45_000  # the clock both Apps read while they take network input


def _df4(addr, alt_ft):
    """DF4 altitude reply (AC13 with the Q bit), parity overlaid with addr."""
    msg = bytearray(7)
    _setbits(msg, 1, 5, 4)
    n = (alt_ft + 1000) // 25
    _setbits(msg, 20, 32, ((n & 0x7E0) << 2) | ((n & 0x10) << 1) | 0x10 | (n & 0xF))
    return _overlay(append_crc(bytes(msg), 56), addr)


def _input_streams(seed):
    """{factory: bytes} for every input protocol, from one seed."""
    rng = np.random.default_rng(seed)
    scene = _scene(seed)
    wire = bytearray()
    for k, (t_s, msg, addr, rid) in enumerate(scene):
        if k % 5 == 0:
            wire += jax_beast.encode_receiver_id(rid)
        wire += jax_beast.encode_synthetic_ts(EPOCH_MS + int(t_s * 1000))
        wire += jax_beast.encode_frame(msg, int(t_s * 12e6), 0.01 * (1 + k % 50))
        if k % 50 == 0:
            wire += jax_beast.encode_frame(bytes([0x12, k & 0xFF]), int(t_s * 12e6), 0.2, modeac=True)
        if k % 97 == 0:
            wire += b"\x1aZ\x00\x1a"  # malformed
    raw_lines = b"".join(jax_raw.encode_line(m, int(t * 12e6)) for t, m, _, _ in _scene(seed + 1)[:200])
    # SBS lines for other aircraft: the scene's positions as decoded by a tracker
    jt_app = jax_main.App(jax_parse_args(NET))
    sbs_lines = {}
    for k, (t_s, msg, addr, rid) in enumerate(_scene(seed + 2)):
        fr = _frame(JaxRawFrame, t_s, msg, addr, k)
        mm = jax_fields.decode_frame(fr, epoch_ms=EPOCH_MS)
        mm.addr = mm.addr ^ 0x800000  # other aircraft than the Beast stream's
        a = jt_app.tracker.update(mm)
        line = jax_sbs.encode_line(mm, geom_delta=a.geom_delta if a else None,
                                   now_ms=mm.sys_timestamp_ms)
        if line:
            src = ("sbs", "mlat", "prio")[(mm.addr >> 4) % 3]
            sbs_lines.setdefault(src, []).append(line)
    asterix = b"".join(jax_asterix.encode_cat21(mm, now_ms=NOW) for mm in _asterix_msgs(seed))
    uat_lines = b"".join(
        b"-" + make_uat_frame(addr=0xA00000 + (k % 5), lat=40.0 + 0.01 * k, lon=-75.0 + 0.01 * k,
                             alt_ft=10000 + 100 * k).hex().encode() + b";rssi=-12.5;\n"
        for k in range(40))
    # clocks within 48 bits of 12 MHz ticks: readsb_tpu's writers raise on wider ones
    pf = b"".join(_pf_stuff(bytes([0, 0x82, 0x40]) + (1000 + k).to_bytes(4, "big")
                            + bytes(4) + m) for k, (_, m, _, _) in enumerate(_scene(seed + 3)[:100])
                  if len(m) == 14)
    gpsd = b'{"class":"TPV","lat":47.25,"lon":8.75}\n{"class":"SKY"}\n'
    return rng, {
        "beast": bytes(wire), "raw": raw_lines,
        **{f"sbs_{k}": b"".join(v) for k, v in sbs_lines.items()},
        "asterix": asterix, "uat": uat_lines, "planefinder": pf, "gpsd": gpsd,
    }


def _asterix_msgs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(60):
        mm = jax_fields.ModesMessage(msgtype=17, addr=0x3D0000 + k % 7,
                                     source=jax_fields.Source.ADSB, sys_timestamp_ms=NOW)
        mm.callsign, mm.callsign_valid = f"AX{k % 7:04d}", True
        mm.baro_alt = int(rng.integers(10, 400)) * 100
        mm.cpr_decoded = mm.sbs_pos_valid = True
        mm.decoded_lat, mm.decoded_lon = 48.0 + 0.01 * k, 9.0 + 0.01 * k
        out.append(mm)
    return out


def _factories(app, Src):
    return {
        "beast": app._beast_input_factory(), "raw": app._raw_input_factory(),
        "sbs_sbs": app._sbs_input_factory(), "sbs_mlat": app._sbs_input_factory(Src.MLAT),
        "sbs_prio": app._sbs_input_factory(Src.PRIO), "asterix": app._asterix_input_factory(),
        "uat": app._uat_input_factory(), "planefinder": app._planefinder_input_factory(),
        "gpsd": app._gpsd_input_factory(),
    }


async def _feed(app, Src, streams, rng):
    facs = _factories(app, Src)
    for name, data in streams.items():
        conn = facs[name]()
        for chunk in _splits(rng, data, 40):
            await asyncio.wait_for(conn.feed(chunk), TIMEOUT)
        conn.close()
    app.drain_net_queue()


def _app_results(app, jo, so):
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
        "collect": so.collect(app, NOW),
        "receiver": (t.receiver_lat, t.receiver_lon),
        "receivers.json": t.receivers.receivers_json(NOW),
    }


@pytest.fixture(scope="module")
def input_apps():
    """Both Apps after every input stream, with a client on each lane."""
    apps = []
    for app, Src in zip(make_apps(NET + ["--modeac"]), (fields.Source, jax_fields.Source)):
        app.now_ms = lambda: NOW
        writers = attach(app)
        rng, streams = _input_streams(41)
        asyncio.run(_feed(app, Src, streams, rng))
        apps.append((app, writers))
    return apps


def test_inputs_equal_reference(input_apps):
    (pa, pw), (ja, jw) = input_apps
    got, want = _app_results(pa, json_out, stats), _app_results(ja, jax_json, jax_stats)
    for key in want:
        assert got[key] == want[key], key
    doc = got["aircraft.json"]
    assert sum("lat" in a for a in doc["aircraft"]) > 20
    assert got["remote"][1] > 1000 and got["remote"][3] > 0  # Mode S and Mode A/C
    assert got["receiver"] == (47.25, 8.75)  # gpsd
    lanes_p, lanes_j = lane_bytes(pa, pw), lane_bytes(ja, jw)
    assert lanes_p == lanes_j and lanes_p["uat_replay_out"] and lanes_p["beast_out"]
    srcs = {a.position_valid.source for a in pa.tracker.aircraft.values()}
    assert {fields.Source.ADSB, fields.Source.MLAT, fields.Source.SBS} <= srcs  # PRIO files as ADSB


# --- API ----------------------------------------------------------------------

QUERIES = [
    "/?all", "/?all_with_pos", "/?circle=47.5,8.5,200", "/?closest=47.5,8.5,500",
    "/?box=46.0,49.5,6.0,11.0", "/?box=47.0,47.6,8.0,9.0&filter_with_pos",
    "/?find_hex={hex0},{hex1},zz,~{hex2}", "/?find_callsign={cs0},nobody",
    "/?find_reg=HBXYZ", "/?find_type=A320", "/?all&filter_squawk={sq0}",
    "/?all&above_alt_baro=10000", "/?all&below_alt_baro=12000",
    "/?all&filter_callsign_prefix=PT", "/?all&filter_callsign_exact={cs0}",
    "/?all&filter_mil", "/?all&filter_interesting&filter_pia&filter_ladd",
    "/?circle=47.5,8.5,200&jv2", "/?all&jv2", "/?all&binCraft",
    "/?box=46.0,49.5,6.0,11.0&binCraft", "/?status", "/?circle=1,2", "/?nonsense=1",
    "/re-api/?all_with_pos&filter_with_pos&above_alt_baro=abc",
]


@pytest.fixture(scope="module")
def api_servers(input_apps):
    (pa, _), (ja, _) = input_apps
    ps, js = api.ApiServer(pa), jax_api.ApiServer(ja)
    ps.update(NOW)
    js.update(NOW)
    acs = [a for a in pa.tracker.aircraft.values() if a.callsign and a.squawk is not None]
    fill = {"hex0": "%06x" % acs[0].addr, "hex1": "%06X" % acs[1].addr,
            "hex2": "%06x" % acs[2].addr, "cs0": acs[0].callsign.strip(),
            "sq0": "%04x" % acs[0].squawk}
    return ps, js, fill


def _body(doc, ctype):
    if ctype != "application/json":
        return doc
    d = json.loads(doc)
    d.pop("ptime", None)
    return d


@pytest.mark.parametrize("query", QUERIES)
def test_api_queries_equal_reference(query, api_servers):
    ps, js, fill = api_servers
    target = query.format(**fill)
    pb, pst, pct = ps.respond(target)
    jb, jst, jct = js.respond(target)
    assert (pst, pct) == (jst, jct)
    assert _body(pb, pct) == _body(jb, jct)
    if query.startswith("/?all") and "filter" not in query:
        assert len(pb) > 1000


def test_api_zstd_is_501_and_the_byte_join_equals_reference(api_servers):
    """&binCraft&zstd is compressed by the port's codec (no longer 501):
    zstandard decodes it to readsb_tpu's answer and to the plain one."""
    import zstandard

    ps, js, _ = api_servers
    body, status, ctype = ps.respond("/?all&binCraft&zstd")
    jbody, jstatus, jctype = js.respond("/?all&binCraft&zstd")
    assert (status, ctype) == (jstatus, jctype) == ("200 OK", "application/zstd")
    plain = zstandard.ZstdDecompressor().decompress(body)
    assert plain == zstandard.ZstdDecompressor().decompress(jbody)
    assert plain == ps.respond("/?all&binCraft")[0] and len(plain) > 1000
    assert ps.request_count == js.request_count + 1
    pj = json_out.aircraft_json_bytes_from_api(ps.snapshot, 1234)
    assert pj == jax_json.aircraft_json_bytes_from_api(js.snapshot, 1234)
    doc = json.loads(json.dumps(json_out.generate_aircraft_json(ps.app.tracker, NOW, 1234)))
    by_hex = sorted(json.loads(pj)["aircraft"], key=lambda a: a["hex"])
    assert by_hex == sorted(doc["aircraft"], key=lambda a: a["hex"])  # the API's order is by latitude
    ps.draining = True  # --api-shutdown-delay: new queries get 503 in handle()
    assert ps.snapshot.n_pos == js.snapshot.n_pos > 20


def test_interactive_rows_equal_reference(input_apps):
    (pa, _), (ja, _) = input_apps
    for metric in (False, True):
        got = interactive._rows(pa.tracker, NOW, 40, 60_000, metric)
        assert got == jax_interactive._rows(ja.tracker, NOW, 40, 60_000, metric) and got


# --- the JAERO altitude gate -----------------------------------------------------


def test_jaero_altitude_gate_reads_the_reliable_position():
    """An aircraft whose reliable position came from JAERO (SBS-jaero
    input) and whose latest position is ADS-B, not yet reliable under
    --json-reliable 2.  Its held ADS-B altitude goes stale, and DF4
    replies jumping by 15000 ft exhaust the altitude score.  The port,
    like readsb (track.c:1798-1800), keeps the altitude because the
    reliable position's source is JAERO; readsb_tpu reads the latest
    position's source and invalidates it, and then takes the next DF4."""
    addr = 0x4B1234
    t0 = EPOCH_MS
    jaero = b"MSG,3,1,1,%06X,1,,,,,,35000,,,50.000000,8.000000,,,,,,0\r\n" % addr
    beast_wire = b"".join(
        jax_beast.encode_synthetic_ts(t0 + 3000 + 100 * odd)
        + jax_beast.encode_frame(encode_df17_position(addr, 50.01, 8.01, 35000, odd), 0, 0.1)
        for odd in (0, 1))
    beast_wire += b"".join(
        jax_beast.encode_synthetic_ts(t0 + 14_200 + 20 * k)
        + jax_beast.encode_frame(_df4(addr, 5000 if k % 2 else 20000), 0, 0.1)
        for k in range(20))
    out = []
    for app, src in zip(make_apps(NET + ["--json-reliable", "2"]),
                        (fields.Source.JAERO, jax_fields.Source.JAERO)):

        async def feed(app=app, src=src):
            for k in range(3):
                app.now_ms = lambda k=k: t0 + 1000 * k
                await asyncio.wait_for(app._sbs_input_factory(src)().feed(jaero), TIMEOUT)
            await asyncio.wait_for(app._beast_input_factory()().feed(beast_wire), TIMEOUT)
            app.drain_net_queue()

        asyncio.run(feed())
        a = app.tracker.aircraft[addr]
        out.append((int(a.position_valid.source), int(a.baro_alt_valid.source), a.baro_alt, a))
    (p_pos, p_alt_src, p_alt, pa), (j_pos, j_alt_src, j_alt, _) = out
    assert p_pos == j_pos == fields.Source.ADSB
    assert pa.pos_reliable_valid.source == fields.Source.JAERO
    assert (p_alt_src, p_alt) == (fields.Source.ADSB, 35000) and pa.alt_reliable == 0
    assert (j_alt_src, j_alt) == (fields.Source.MODE_S, 5000)


def test_the_jaero_gate_agrees_with_the_reference_when_both_sources_are_one():
    """The same replies after a reliable ADS-B position: both invalidate."""
    addr = 0x4B1235
    wire = b"".join(
        jax_beast.encode_synthetic_ts(EPOCH_MS + 100 * k)
        + jax_beast.encode_frame(encode_df17_position(addr, 50.01, 8.01, 35000, k % 2), 0, 0.1)
        for k in range(4))
    wire += b"".join(
        jax_beast.encode_synthetic_ts(EPOCH_MS + 11_500 + 20 * k)
        + jax_beast.encode_frame(_df4(addr, 5000 if k % 2 else 20000), 0, 0.1)
        for k in range(20))
    got = []
    for app in make_apps(NET):
        asyncio.run(app._beast_input_factory()().feed(wire))
        app.drain_net_queue()
        a = app.tracker.aircraft[addr]
        got.append((int(a.pos_reliable_valid.source) if hasattr(a, "pos_reliable_valid") else None,
                    int(a.baro_alt_valid.source), a.baro_alt))
    assert got[0][0] == fields.Source.ADSB
    assert got[0][1:] == got[1][1:] == (fields.Source.MODE_S, 5000)


# --- argument time --------------------------------------------------------------

ARGV = [
    ["--net"], ["--net-only"], ["--net", "--modeac"], ["--net", "--net-sbs-port", "30003"],
    ["--net", "--net-json-port", "30047"], ["--net", "--net-ao-port", "30006"],
    ["--net", "--net-beast-reduce-out-port", "30105"], ["--net", "--net-bo-port", "30005"],
    ["--net", "--net-bo-port", "30005", "--net-api-port", "30152"],
    ["--net-only", "--net-bi-port", "30004", "--net-connector", "h,1,sbs_out"],
    ["--net-only", "--net-connector", "h,1,beast_in"],
    ["--net-only", "--net-connector", "h,1,beast_reduce_plus_out"],
    ["--net-only", "--net-connector", "h, 1, json_out"],
    ["--net-only", "--net-connector", "h,1,raw_out", "--net-connector", "h,2,feedmap_out"],
    ["--net-ro-port", "30002"], ["--interactive", "--net", "--net-sbs-port", "30003"],
    ["--net", "--net-bulk-drain"], ["--net", "--no-net-bulk-drain"],
    ["--net-only", "--modeac-auto", "--net-sbs-in-port", "30005"],
]


@pytest.mark.parametrize("argv", ARGV, ids=" ".join)
def test_the_columnar_pick_raises_naming_8d(argv):
    """Nothing raises any more where readsb_tpu's rule picks its columnar
    drain (or it is forced): the port has that drain (ROADMAP item 8d), and
    every option parses as readsb_tpu's does, on either drain
    (tests/test_torch_bulk_app.py drives it)."""
    args = main.parse_args(argv)
    assert vars(args) == vars(jax_parse_args(argv))


# --- end to end, the port alone -----------------------------------------------


def _free_port_block(n):
    """A base port where base..base+n-1 are all bindable now."""
    for _ in range(200):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        socks = []
        try:
            for k in range(n):
                t = socket.socket()
                t.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                t.bind(("127.0.0.1", base + k))
                socks.append(t)
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
        if len(socks) == n:
            return base
    raise RuntimeError("no free block of ports")


async def _read_to_eof(reader):
    out = bytearray()
    while True:
        data = await asyncio.wait_for(reader.read(65536), TIMEOUT)
        if not data:
            return bytes(out)
        out += data


async def _get(port, target):
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), TIMEOUT)
    try:
        writer.write(b"GET %s HTTP/1.1\r\nHost: localhost\r\n\r\n" % target.encode())
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), TIMEOUT)
        length = int(head.lower().split(b"content-length:")[1].split(b"\r\n")[0])
        return head, await asyncio.wait_for(reader.readexactly(length), TIMEOUT)
    finally:
        writer.close()


async def _noop():
    pass


async def _feeder_and_aggregator(cap, d):
    # an SBS port ending in 5 brings its four variant lanes on the next ports
    base = _free_port_block(8)
    sbs, bo, ro, api_port = base, base + 5, base + 6, base + 7
    feeder = main.App(main.parse_args([
        "--device-type", "ifile", "--ifile", cap, "--blocks-per-batch", "1", "--net",
        "--net-bind-address", "127.0.0.1", "--net-bo-port", str(bo), "--net-ro-port", str(ro),
        "--net-sbs-port", str(sbs), "--net-api-port", str(api_port),
        "--write-json", os.path.join(d, "feeder"), "--write-json-every", "0.1"]))
    frames = []
    handle = feeder.handle_frame
    feeder.handle_frame = lambda fr: (frames.append(fr), handle(fr))
    await asyncio.wait_for(feeder.setup_net(), TIMEOUT)
    feeder.setup_net = _noop  # bound above, so that clients connect before the replay
    clients = {}
    for name, port in (("beast", bo), ("raw", ro), ("sbs", sbs)):
        clients[name] = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), TIMEOUT)
    aggregator = main.App(main.parse_args([
        "--net-only", "--no-net-bulk-drain", "--net-connector", f"127.0.0.1,{bo},beast_in",
        "--write-json", os.path.join(d, "aggregator"), "--write-json-every", "0.1"]))
    agg_task = asyncio.ensure_future(aggregator.amain())
    try:
        async def connected():
            while len(feeder.out_beast.clients) < 2 or len(feeder.out_sbs.clients) < 1:
                await asyncio.sleep(0.01)

        await asyncio.wait_for(connected(), TIMEOUT)
        reads = {k: asyncio.ensure_future(_read_to_eof(r)) for k, (r, _) in clients.items()}
        assert await asyncio.wait_for(feeder.amain(), 120) == 0
        streams = {k: await asyncio.wait_for(t, TIMEOUT) for k, t in reads.items()}
        feeder.api_server.update(feeder.now_ms())  # the API over the final tracker state
        head, body = await _get(api_port, "/?all")

        async def aggregated():  # every frame read off the feeder's Beast lane
            while len(aggregator._net_queue) + aggregator.remote_modes < feeder.messages:
                await asyncio.sleep(0.01)

        await asyncio.wait_for(aggregated(), TIMEOUT)
    finally:
        feeder.api_server.server.close()
        aggregator._exit_event.set()
        await asyncio.wait_for(agg_task, TIMEOUT)
        for _, w in clients.values():
            w.close()
    return feeder, aggregator, frames, streams, head, json.loads(body)


def test_feeder_and_aggregator_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    cap = str(tmp_path / "cap.uc8.dat")
    build_traffic_capture(0.3, 5, 71).write_uc8(cap)
    feeder, aggregator, frames, streams, head, api_all = asyncio.run(
        _feeder_and_aggregator(cap, str(tmp_path)))
    assert len(frames) > 20
    got = list(beast.BeastDeframer().feed(streams["beast"]))
    assert [(f.msg, f.timestamp) for f in got] == [(f.msg, f.timestamp) for f in frames]
    assert [f.signal_byte for f in got] == [
        int(round(math.sqrt(max(0.0, min(1.0, f.signal_power))) * 255)) for f in frames]
    assert streams["raw"].count(b"\n") == len(frames)
    assert streams["sbs"].count(b"\r\n") > len(frames) // 2
    feed_doc = json.loads((tmp_path / "feeder" / "aircraft.json").read_text())
    assert b"200 OK" in head
    assert sorted(a["hex"] for a in api_all["aircraft"]) == sorted(a["hex"] for a in feed_doc["aircraft"])
    assert len(feed_doc["aircraft"]) == 5 and feeder.tracker.cpr_global_ok > 0, feeder.tracker.cpr_global_ok
    clients = json.loads((tmp_path / "feeder" / "clients.json").read_text())
    assert {c["service"] for c in clients["clients"]} >= {"beast_out", "raw_out", "sbs_out"}
    # the aggregator holds the feeder's aircraft; it stamps them with its own
    # clock ("seen") and keeps the signal as the Beast lane's byte ("rssi")
    agg_doc = json.loads((tmp_path / "aggregator" / "aircraft.json").read_text())
    assert aggregator.remote_modes == len(frames)

    def strip(doc):
        return {a["hex"]: {k: v for k, v in a.items() if k not in ("seen", "seen_pos", "rssi")}
                for a in doc["aircraft"]}

    assert strip(agg_doc) == strip(feed_doc)
