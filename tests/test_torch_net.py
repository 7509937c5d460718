"""The port's wire codecs against readsb_tpu's, at tolerance 0.

The same inputs, made from a numpy seed, go through each copied encoder
and deframer of both packages, and the bytes or the fields must be equal:
Beast (frames of 2, 7 and 14 bytes, receiver-id, synthetic-time and UUID
prefixes, pings and commands, escapes, split across feed() calls at
random points), raw, SBS, ASTERIX CAT021 both ways, UAT (`convert_line`
with `encode_cpr`), planefinder, gpsd TPV, VRS and binCraft.  Decoded
messages come from each package's `decode_frame` and tracker over the
replay scene of test_torch_track.py.  No demodulator runs here.

One difference is named: the port writes a clock wider than 48 bits as
its low 48 bits, where readsb_tpu's writers fail on it.
"""

import math

import numpy as np
import pytest

from readsb_tpu.decode import cpr as jax_cpr
from readsb_tpu.decode import fields as jax_fields
from readsb_tpu.decode.score import RawFrame as JaxRawFrame
from readsb_tpu.io import asterix as jax_asterix
from readsb_tpu.io import beast as jax_beast
from readsb_tpu.io import bincraft as jax_bincraft
from readsb_tpu.io import gpsd as jax_gpsd
from readsb_tpu.io import net as jax_net
from readsb_tpu.io import planefinder as jax_pf
from readsb_tpu.io import raw as jax_raw
from readsb_tpu.io import sbs as jax_sbs
from readsb_tpu.io import uat as jax_uat
from readsb_tpu.io import vrs as jax_vrs
from readsb_tpu.track import tracker as jax_tracker
from readsb_tpu_torch.decode import cpr, fields
from readsb_tpu_torch.decode.score import RawFrame
from readsb_tpu_torch.io import asterix, beast, bincraft, gpsd, net, planefinder, raw, sbs, uat, vrs
from readsb_tpu_torch.track import tracker
from tests.test_torch_track import EPOCH_MS, _frame, _scene
from tests.test_uat import make_uat_frame

SEEDS = (21, 22, 23)
SOURCES = (fields.Source.ADSB, fields.Source.MLAT, fields.Source.JAERO,
           fields.Source.PRIO, fields.Source.SBS, fields.Source.ADSR)


def _splits(rng, data: bytes, n: int) -> list[bytes]:
    """data cut at n random points."""
    cuts = sorted(int(c) for c in rng.integers(0, len(data) + 1, n))
    edges = [0, *cuts, len(data)]
    return [data[a:b] for a, b in zip(edges, edges[1:])]


def _msgs(rng, n: int) -> list[bytes]:
    """n messages of 2, 7 and 14 bytes, one byte in eight an escape."""
    out = []
    for _ in range(n):
        m = rng.integers(0, 256, int(rng.choice([2, 7, 14])), dtype=np.uint8)
        m[rng.random(len(m)) < 0.125] = 0x1A
        out.append(bytes(m))
    return out


# --- Beast ------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_beast_encoders_equal_reference(seed):
    rng = np.random.default_rng(seed)
    msgs = _msgs(rng, 300)
    for i, m in enumerate(msgs):
        ts = int(rng.integers(0, 1 << 48))
        if i % 5 == 0:
            ts = 0x1A1A1A1A1A1A  # every timestamp byte an escape
        sig = float(rng.uniform(-0.1, 1.2))
        args = (m, ts, sig, len(m) == 2)
        assert beast.encode_frame(*args) == jax_beast.encode_frame(*args)
        rid = int(rng.integers(0, 1 << 63)) | (0x1A << 8 * (i % 8))
        assert beast.encode_receiver_id(rid) == jax_beast.encode_receiver_id(rid)
        ms = int(rng.integers(0, 1 << 47))
        assert beast.encode_synthetic_ts(ms) == jax_beast.encode_synthetic_ts(ms)
        assert net.escape_beast(m) == jax_net.escape_beast(m)
        assert net.make_ping(ts) == jax_net.make_ping(ts)
    with pytest.raises(ValueError):
        beast.encode_frame(b"\x00" * 5, 0)


def _beast_stream(rng, n: int) -> tuple[bytes, list[tuple]]:
    """A Beast byte stream with prefixes, pings, commands and noise, and the
    frames it holds as (msg, timestamp, signal byte, receiver id, ms)."""
    wire, want = bytearray(), []
    rid = ms = 0
    for m in _msgs(rng, n):
        r = rng.random()
        if r < 0.15:
            rid = int(rng.integers(0, 1 << 64, dtype=np.uint64))
            wire += jax_beast.encode_receiver_id(rid)
        elif r < 0.3:
            ms = int(rng.integers(1, 1 << 44))
            wire += jax_beast.encode_synthetic_ts(ms)
        elif r < 0.35:
            wire += b"\x1a\xe4" + jax_net.escape_beast(bytes(rng.integers(0, 256, 16, dtype=np.uint8)))
        elif r < 0.4:
            wire += jax_net.make_ping(int(rng.integers(0, 1 << 24)))
        elif r < 0.45:
            wire += b"\x1aWO"
        elif r < 0.5:
            wire += b"\x1a\x1a"  # a doubled escape outside a frame
        ts = int(rng.integers(0, 1 << 48))
        sig = float(rng.uniform(0.0, 1.0))
        wire += jax_beast.encode_frame(m, ts, sig, modeac=len(m) == 2)
        want.append((m, ts, int(round(math.sqrt(sig) * 255)), rid, ms))
    return bytes(wire), want


def _deframe(mod, chunks):
    d = mod.BeastDeframer()
    out = [(f.msg, f.timestamp, f.signal_byte, f.msg_type, f.receiver_id, f.synthetic_ms)
           for c in chunks for f in d.feed(c)]
    return out, d.commands, d.frames_bad


@pytest.mark.parametrize("seed", SEEDS)
def test_beast_deframer_equals_reference(seed):
    rng = np.random.default_rng(seed)
    wire, want = _beast_stream(rng, 400)
    chunks = _splits(rng, wire, 60)
    bad0 = (beast.MALFORMED_BYTES[0], jax_beast.MALFORMED_BYTES[0])
    got, ref = _deframe(beast, chunks), _deframe(jax_beast, chunks)
    assert got == ref
    assert [(m, ts, s, r, ms) for m, ts, s, _, r, ms in got[0]] == want
    assert got[1] and all(c[:1] in (b"P", b"W") for c in got[1])
    # a frame cut by a new escape, and an unknown type byte, count as bad
    broken = jax_beast.encode_frame(b"\x8d" * 14, 5, 0.5)[:9] + b"\x1aZ" + wire[:200]
    got, ref = _deframe(beast, _splits(rng, broken, 5)), _deframe(jax_beast, _splits(rng, broken, 5))
    assert got == ref and got[2] >= 1
    assert (beast.MALFORMED_BYTES[0] - bad0[0]) == (jax_beast.MALFORMED_BYTES[0] - bad0[1]) > 0


def test_wide_clocks_are_written_as_their_low_48_bits():
    """The one named difference of the writers: a clock wider than the
    wire's 48 bits (a planefinder clock in 12 MHz ticks) goes out as its
    low 48 bits, as readsb writes it; readsb_tpu's Beast writer raises and
    its raw writer writes a line of the wrong width."""
    msg = bytes.fromhex("8d4840d6202cc371c32ce0576098")
    wide = (1_700_000_000 * 10**9 + 5) * 12 // 1000
    low = wide & ((1 << 48) - 1)
    assert beast.encode_frame(msg, wide, 0.3) == jax_beast.encode_frame(msg, low, 0.3)
    with pytest.raises(OverflowError):
        jax_beast.encode_frame(msg, wide, 0.3)
    assert raw.encode_line(msg, wide) == jax_raw.encode_line(msg, low)
    assert len(jax_raw.encode_line(msg, wide)) > len(raw.encode_line(msg, wide))


# --- raw ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_raw_codec_equals_reference(seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i, m in enumerate(_msgs(rng, 300)):
        ts = None if i % 3 == 0 else int(rng.integers(0, 1 << 48))
        line = raw.encode_line(m, ts)
        assert line == jax_raw.encode_line(m, ts)
        lines.append(line)
        if i % 4 == 0:
            # the '<' form with a signal byte, and lines it cannot parse
            lines.append(b"<%012x%02x%s;\n" % (i, i % 256, m.hex().encode()))
            lines.append(b"*zz;\n" if i % 8 else b"?00;\r\n")
    chunks = _splits(rng, b"".join(lines), 50)
    dp, dj = raw.RawDeframer(), jax_raw.RawDeframer()
    got = [(r.msg, r.timestamp, r.signal_byte) for c in chunks for r in dp.feed(c)]
    want = [(r.msg, r.timestamp, r.signal_byte) for c in chunks for r in dj.feed(c)]
    assert got == want and len(got) > 300 and dp.lines_bad == dj.lines_bad > 0


# --- decoded messages of the replay scene, in both packages ------------------


def _replay(seed, receiver=(47.45, 8.55)):
    """Both trackers over _scene(seed); every decoded message of each, with
    one message in three given another source."""
    kw = dict(json_reliable=1, receiver_lat=receiver[0], receiver_lon=receiver[1],
              max_range_km=300 * 1.852)
    pt, jt = tracker.Tracker(**kw), jax_tracker.Tracker(**kw)
    pms, jms = [], []
    for k, (t_s, msg, addr, rid) in enumerate(_scene(seed)):
        pm = fields.decode_frame(_frame(RawFrame, t_s, msg, addr, k), epoch_ms=EPOCH_MS)
        jm = jax_fields.decode_frame(_frame(JaxRawFrame, t_s, msg, addr, k), epoch_ms=EPOCH_MS)
        pm.receiver_id = jm.receiver_id = rid
        if k % 3 == 1:
            pm.source = SOURCES[k % len(SOURCES)]
            jm.source = jax_fields.Source(int(pm.source))
        pt.update(pm)
        jt.update(jm)
        pms.append(pm)
        jms.append(jm)
    now = EPOCH_MS + int(_scene(seed)[-1][0] * 1000)
    return pt, jt, pms, jms, now


@pytest.fixture(scope="module")
def replays():
    return {seed: _replay(seed) for seed in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_sbs_codec_equals_reference(seed, replays):
    pt, jt, pms, jms, _ = replays[seed]
    rng = np.random.default_rng(seed)
    lines = []
    for k, (pm, jm) in enumerate(zip(pms, jms)):
        pa, ja = pt.aircraft.get(pm.addr), jt.aircraft.get(jm.addr)
        for gnss in (False, True):
            now = EPOCH_MS + 1000 * k
            got = sbs.encode_line(pm, geom_delta=pa.geom_delta, now_ms=now, use_gnss=gnss)
            assert got == jax_sbs.encode_line(jm, geom_delta=ja.geom_delta, now_ms=now,
                                              use_gnss=gnss)
            if got:
                lines.append(got)
    assert len(lines) > 200 and any(b",-1," in l or b",0," in l for l in lines)
    lines.append(b"MSG,3,1,1,ZZZZZZ,1\n")  # bad fields
    lines.append(b"MSG,8,1\n")  # too short
    chunks = _splits(rng, b"".join(lines), 40)
    dp, dj = sbs.SbsDeframer(), jax_sbs.SbsDeframer()
    got = [vars(s) for c in chunks for s in dp.feed(c)]
    want = [vars(s) for c in chunks for s in dj.feed(c)]
    assert got == want and dp.lines_bad == dj.lines_bad == 2
    assert sum(s["lat"] is not None for s in got) > 20


@pytest.mark.parametrize("seed", SEEDS)
def test_asterix_cat21_both_ways_equals_reference(seed, replays):
    pt, jt, pms, jms, _ = replays[seed]
    rng = np.random.default_rng(seed)
    pkts = []
    for k, (pm, jm) in enumerate(zip(pms, jms)):
        now = EPOCH_MS + 37 * k
        hint = 1000 * (k % 40) if k % 2 else None
        got = asterix.encode_cat21(pm, now_ms=now, baro_alt_hint=hint)
        assert got == jax_asterix.encode_cat21(jm, now_ms=now, baro_alt_hint=hint)
        if got:
            pkts.append(got)
    assert len(pkts) > 200
    chunks = _splits(rng, b"".join(pkts), 40)
    dp, dj = asterix.AsterixDeframer(), jax_asterix.AsterixDeframer()
    fp = [f for c in chunks for f in dp.feed(c)]
    assert fp == [f for c in chunks for f in dj.feed(c)] == pkts
    # a block length below 3 resynchronises byte by byte
    bad = _splits(rng, b"\x15\x00\x01" + b"".join(pkts[:20]), 5)
    dp, dj = asterix.AsterixDeframer(), jax_asterix.AsterixDeframer()
    assert [f for c in bad for f in dp.feed(c)] == [f for c in bad for f in dj.feed(c)]
    for i, f in enumerate(fp):
        now = EPOCH_MS + 1000 * i
        assert repr(asterix.decode_cat21(f, now_ms=now)) == repr(jax_asterix.decode_cat21(f, now_ms=now))
    assert asterix.decode_cat21(b"\x15\x00\x04\x00") is None


@pytest.mark.parametrize("seed", SEEDS)
def test_vrs_and_bincraft_equal_reference(seed, replays):
    pt, jt, _, _, now = replays[seed]
    assert pt.aircraft
    for t in (now - 5000, now, now + 30_000):
        for reduced in (False, True):
            assert vrs.generate_vrs(pt, t, reduced) == jax_vrs.generate_vrs(jt, t, reduced)
        for addr, pa in pt.aircraft.items():
            rec = bincraft.to_bincraft(pt, pa, t)
            assert len(rec) == bincraft.RECORD_BYTES
            assert rec == jax_bincraft.to_bincraft(jt, jt.aircraft[addr], t)
        assert bincraft.generate_bincraft(pt, t) == jax_bincraft.generate_bincraft(jt, t)


# --- UAT, planefinder, gpsd ---------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_cpr_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for lat, lon in zip(rng.uniform(-89.9, 89.9, 300), rng.uniform(-180.0, 180.0, 300)):
        for odd in (0, 1):
            for surface in (False, True):
                assert cpr.encode_cpr(lat, lon, odd, surface) == jax_cpr.encode_cpr(lat, lon, odd, surface)


@pytest.mark.parametrize("seed", SEEDS)
def test_uat_convert_line_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n_frames = 0
    for i in range(200):
        frame = make_uat_frame(
            addr=int(rng.integers(0, 1 << 24)), lat=float(rng.uniform(-60, 70)),
            lon=float(rng.uniform(-180, 180)), alt_ft=int(rng.integers(-1000, 45000)),
            ns_vel=int(rng.integers(-600, 600)), ew_vel=int(rng.integers(-600, 600)),
            vert_rate=int(rng.integers(-4000, 4000)),
            callsign="".join(rng.choice(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "), 8)),
            mdb_type=int(rng.integers(0, 11)), address_qualifier=int(rng.integers(0, 8)),
            airground=int(rng.integers(0, 4)),
        )
        if i % 7 == 0:
            frame = frame[:jax_uat.SHORT_FRAME_DATA_BYTES]
        tail = (b";rs=3;rssi=%.1f;" % rng.uniform(-40, 0)) if i % 3 else b";ss=-20.5;"
        sign = b"+" if i % 23 == 0 else b"-"
        line = sign + frame.hex().upper().encode() + tail
        got, want = uat.convert_line(line), jax_uat.convert_line(line)
        assert got == want
        n_frames += len(got[0])
        for f in got[0]:
            assert uat.format_esnt_line(f, got[1]) == jax_uat.format_esnt_line(f, got[1])
    assert n_frames > 300
    assert uat.convert_line(b"-zz;") == jax_uat.convert_line(b"-zz;") == ([], 255)  # rssi 0 dB


def _pf_stuff(payload: bytes) -> bytes:
    out = bytearray([jax_pf.DLE, 0xC1])
    for b in payload:
        out.append(b)
        if b == jax_pf.DLE:
            out.append(jax_pf.DLE)
    return bytes(out + bytes([jax_pf.DLE, jax_pf.ETX]))


@pytest.mark.parametrize("seed", SEEDS)
def test_planefinder_and_gpsd_equal_reference(seed):
    rng = np.random.default_rng(seed)
    wire = bytearray()
    for m in _msgs(rng, 300):
        m = bytes(0x10 if b == 0x1A else b for b in m)  # DLE in place of the Beast escape
        kind = {2: 0, 7: 1, 14: 2}[len(m)] if rng.random() > 0.05 else 3
        payload = (bytes([0, 0x80 | kind, int(rng.integers(0, 256))])
                   + int(rng.integers(0, 1 << 32)).to_bytes(4, "big")
                   + int(rng.integers(0, 10**9)).to_bytes(4, "big") + m)
        wire += _pf_stuff(payload)
        if rng.random() < 0.1:
            wire += bytes([jax_pf.DLE, 0xC2, 1, 2, jax_pf.DLE, jax_pf.ETX])  # another type
    chunks = _splits(rng, bytes(wire), 50)
    dp, dj = planefinder.PfDeframer(), jax_pf.PfDeframer()
    got = [vars(p) for c in chunks for p in dp.feed(c)]
    assert got == [vars(p) for c in chunks for p in dj.feed(c)]
    assert len(got) > 250 and dp.frames_bad == dj.frames_bad
    assert gpsd.WATCH_COMMAND == jax_gpsd.WATCH_COMMAND
    for lat, lon in zip(rng.uniform(-95, 95, 100), rng.uniform(-185, 185, 100)):
        for line in (b'{"class":"TPV","lat":%r,"lon":%r,"alt":%r}' % (lat, lon, lat * 3),
                     b'{"class":"TPV","lat":%r,"lon":%r}' % (lat / 1e3, lon / 1e3),
                     b'{"class":"SKY","lat":%r,"lon":%r}' % (lat, lon), b"not json"):
            assert gpsd.parse_tpv_line(line) == jax_gpsd.parse_tpv_line(line)
