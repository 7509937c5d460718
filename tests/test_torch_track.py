"""The port's tracker, CPR, receiver, outline, ACAS and JSON layers
against readsb_tpu's, with no demodulator: the same inputs through both
packages give equal outputs, at tolerance 0.

The vectors of the reference's own tests (test_cpr_golden.py,
test_geomag.py, test_acas.py, test_receiver.py) go through both packages.
The replay builds frames with the port's synth encoders (airborne odd/even
CPR pairs, surface positions, velocities, idents, DF4/DF5/DF11/DF16 with
an ACAS RA), decodes each with both decoders at one fixed epoch_ms, and
feeds each package's tracker its own messages; at several `now`s, one of
them past remove_stale's expiry, aircraft.json, receiver.json,
receivers.json, outline.json and every counter are equal.
"""

import dataclasses
import math

import numpy as np
import pytest

from readsb_tpu.decode import cpr as jax_cpr
from readsb_tpu.decode import fields as jax_fields
from readsb_tpu.decode.score import RawFrame as JaxRawFrame
from readsb_tpu.io import acas as jax_acas
from readsb_tpu.io import json_out as jax_json
from readsb_tpu.track import geomag as jax_geomag
from readsb_tpu.track import globe as jax_globe
from readsb_tpu.track import receiver as jax_receiver
from readsb_tpu.track import tracker as jax_tracker
from readsb_tpu_torch.decode import cpr
from readsb_tpu_torch.decode import fields
from readsb_tpu_torch.decode.score import RawFrame
from readsb_tpu_torch.io import acas, json_out
from readsb_tpu_torch.track import geomag, globe, receiver, tracker
from readsb_tpu_torch.synth import (
    _setbits,
    append_crc,
    encode_df4,
    encode_df11,
    encode_df17_ident,
    encode_df17_position,
    encode_df17_velocity,
)
from tests.test_acas import _mk
from tests.test_cpr_golden import GLOBAL_AIRBORNE, GLOBAL_SURFACE, RELATIVE
from tests.test_geomag import GOLDEN as GEOMAG_GOLDEN

EPOCH_MS = 1_760_000_000_000


# --- the reference tests' vectors, through both packages ---------------------


@pytest.mark.parametrize("v", GLOBAL_AIRBORNE)
@pytest.mark.parametrize("fflag", [0, 1])
def test_cpr_global_airborne_vectors(v, fflag):
    got = cpr.decode_airborne(*v[:4], fflag)
    assert got is not None and got == jax_cpr.decode_airborne(*v[:4], fflag)


@pytest.mark.parametrize("v", GLOBAL_SURFACE)
@pytest.mark.parametrize("fflag", [0, 1])
def test_cpr_global_surface_vectors(v, fflag):
    got = cpr.decode_surface(*v[:6], fflag)
    assert got is not None and got == jax_cpr.decode_surface(*v[:6], fflag)


def test_cpr_relative_vectors():
    for reflat, reflon, cprlat, cprlon, fflag, surface, _, _ in RELATIVE:
        args = (reflat, reflon, cprlat, cprlon, fflag, bool(surface))
        got = cpr.decode_relative(*args)
        assert got is not None and got == jax_cpr.decode_relative(*args)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cpr_random_fields(seed):
    """Random 17-bit fields and reference points: equal results, None included."""
    rng = np.random.default_rng(seed)
    for _ in range(400):
        e = [int(x) for x in rng.integers(0, 1 << 17, 4)]
        f = int(rng.integers(0, 2))
        ref = (float(rng.uniform(-89, 89)), float(rng.uniform(-180, 180)))
        assert cpr.decode_airborne(*e, f) == jax_cpr.decode_airborne(*e, f)
        assert cpr.decode_surface(*ref, *e, f) == jax_cpr.decode_surface(*ref, *e, f)
        for surface in (False, True):
            args = (*ref, e[0], e[1], f, surface)
            assert cpr.decode_relative(*args) == jax_cpr.decode_relative(*args)
        lat = float(rng.uniform(-90, 90))
        assert cpr.nl(lat) == jax_cpr.nl(lat)


def test_geomag_and_globe_index():
    for (lat, lon) in GEOMAG_GOLDEN:
        assert geomag.declination(lat, lon, 0, 2025.5) == jax_geomag.declination(lat, lon, 0, 2025.5)
    rng = np.random.default_rng(4)
    for lat, lon, alt in zip(rng.uniform(-90, 90, 300), rng.uniform(-180, 180, 300),
                             rng.uniform(0, 12000, 300)):
        lat, lon, alt = float(lat), float(lon), float(alt)
        assert geomag.declination(lat, lon, alt, 2026.8) == jax_geomag.declination(lat, lon, alt, 2026.8)
        assert globe.globe_index(lat, lon) == jax_globe.globe_index(lat, lon)


def test_acas_vectors():
    rng = np.random.default_rng(5)
    payloads = [_mk([]), _mk([9, 23, 24]), _mk([9, 10, 11]), _mk([9, 30]), _mk([9, 10, 11, 15]),
                _mk([9, 10, 15]), _mk([27]), _mk([9, 10]), _mk([9]), _mk([9, 10, 15, 29, 40])]
    payloads += [bytes(rng.integers(0, 256, 7, dtype=np.uint8)) for _ in range(200)]
    a = tracker.Aircraft(addr=0xABCDEF, lat=47.1, lon=8.2, seen_pos=5, baro_alt=12000)
    ja = jax_tracker.Aircraft(addr=0xABCDEF, lat=47.1, lon=8.2, seen_pos=5, baro_alt=12000)
    for ra in payloads:
        for df in (16, 17, 20, 21):
            assert acas.ra_valid(ra, df) == jax_acas.ra_valid(ra, df)
        assert acas.advisory_text(ra) == jax_acas.advisory_text(ra)
        assert acas.json_record(0xABCDEF, ra, a, None, EPOCH_MS + 123) == jax_acas.json_record(
            0xABCDEF, ra, ja, None, EPOCH_MS + 123)


def _receiver_scene(rmod, amod, fmod):
    """test_receiver.py's scenarios on one store: extent growth, a far
    aircraft, bad extents, quarantine, maintenance."""
    rs = rmod.ReceiverStore()

    def reliable(addr):
        a = amod.Aircraft(addr=addr)
        a.pos_reliable_odd = a.pos_reliable_even = 4.0
        return a

    def mm(rid):
        return fmod.ModesMessage(receiver_id=rid, source=fmod.Source.ADSB,
                                 cpr_type=fmod.CprType.AIRBORNE)

    out = [rs.position_received(amod.Aircraft(addr=0x111111), mm(0x42), 48.0, 11.0, 1000)]
    a = reliable(0xABC123)
    out += [rs.position_received(a, mm(0x42), 48.0 + i * 0.001, 11.0, 1000 + i) for i in range(120)]
    out += [rs.get_reference(0x42)]
    for j, addr in enumerate((0x222222, 0x333333, 0x444444, 0x555555, 0x666666)):
        out.append(rs.position_received(reliable(addr), mm(0x43), -33.0, 151.0, 1200 + j))
    out += [rs.position_received(a, mm(0x43), 48.0, 11.0, 1300 + i) for i in range(10)]
    out += [rs.get_reference(0x43), rs.get(0x43).bad_extent, rs.receivers_json(2000)]
    for _ in range(7):
        rs.bad(0x99, 0xABCDEF, 5000)
    out += [rs.check_bad(0x99, 5000), rs.check_bad(0x99, 18_000)]
    out += [rs.maintenance(25 * 3600 * 1000), rs.receivers_json(25 * 3600 * 1000)]
    return out


def test_receiver_store_scenarios():
    got = _receiver_scene(receiver, tracker, fields)
    want = _receiver_scene(jax_receiver, jax_tracker, jax_fields)
    assert got[-5]["receivers"] and got[-4] is True
    assert repr(got) == repr(want)


# --- tracker replay ----------------------------------------------------------


def _encode_surface(addr, lat, lon, odd, movement=12, track_deg=90.0):
    """DF17 surface position (metype 7) with surface CPR (90-degree zones)."""
    msg = bytearray(14)
    _setbits(msg, 1, 5, 17)
    _setbits(msg, 6, 8, 5)
    _setbits(msg, 9, 32, addr)
    _setbits(msg, 33, 37, 7)
    _setbits(msg, 38, 44, movement)
    _setbits(msg, 45, 45, 1)
    _setbits(msg, 46, 52, int(round(track_deg / 360.0 * 128)) & 0x7F)
    _setbits(msg, 54, 54, odd)
    ylat, xlon = jax_cpr.encode_cpr(lat, lon, odd, surface=True)
    _setbits(msg, 55, 71, ylat)
    _setbits(msg, 72, 88, xlon)
    return append_crc(bytes(msg), 112)


def _overlay(msg, addr):
    out = bytearray(msg)
    out[-3] ^= (addr >> 16) & 0xFF
    out[-2] ^= (addr >> 8) & 0xFF
    out[-1] ^= addr & 0xFF
    return bytes(out)


def _encode_df16_ra(addr, alt_ft):
    """DF16 long air-air surveillance with an ACAS RA in MV (VDS 3,0)."""
    msg = bytearray(14)
    _setbits(msg, 1, 5, 16)
    n = max(0, min(int(round((alt_ft + 1000) / 25)), 0x7FF))
    _setbits(msg, 20, 32, ((n & 0x7F0) << 2) | 0x040 | (n & 0x00F))
    _setbits(msg, 33, 40, 0x30)
    _setbits(msg, 41, 47, 0b1100001)  # ARA: climb
    return _overlay(append_crc(bytes(msg), 112), addr)


def _encode_df5(addr, squawk_id13):
    msg = bytearray(7)
    _setbits(msg, 1, 5, 5)
    _setbits(msg, 20, 32, squawk_id13)
    return _overlay(append_crc(bytes(msg), 56), addr)


def _scene(seed, n_aircraft=6, duration_s=40.0):
    """(t_s, msg, addr, receiver_id) in time order: airborne aircraft with
    odd/even pairs, surface aircraft near the receiver, and Mode-S replies."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_aircraft):
        addr = 0x3C0000 + seed * 0x100 + k * 0x11
        surface = k % 3 == 2
        lat0 = 47.4 + 0.05 * k if surface else 46.5 + 0.4 * k
        lon0 = 8.5 + 0.04 * k if surface else 7.5 + 0.5 * k
        gs, trk = (12.0, 45.0 * k) if surface else (220.0 + 15 * k, (70.0 * k + 20) % 360)
        t = float(rng.uniform(0.0, 0.5))
        i = 0
        while t < duration_s:
            mps = gs * 0.514444
            lat = lat0 + mps * math.cos(math.radians(trk)) * t / 111320.0
            lon = lon0 + mps * math.sin(math.radians(trk)) * t / (111320.0 * math.cos(math.radians(lat0)))
            kind = i % 7
            if kind in (0, 1, 4):
                # odd/even pairs, but every third aircraft sends only even
                # halves for 15 s: the odd half goes stale, and the even
                # ones take the local (aircraft-relative) decode
                odd = 0 if k % 3 == 1 and 15.0 <= t < 30.0 else i % 2
                msg = (_encode_surface(addr, lat, lon, odd, track_deg=trk) if surface
                       else encode_df17_position(addr, lat, lon, 9000 + 1500 * k, odd))
            elif kind == 2:
                msg = encode_df17_velocity(addr, gs, trk, (k - 2) * 256)
            elif kind == 3:
                msg = encode_df17_ident(addr, f"PT{seed}{k:03d}", 0xA3)
            elif kind == 5:
                msg = (encode_df11(addr), encode_df4(addr, 9000 + 1500 * k),
                       _encode_df5(addr, 0x0808 + k), _encode_df16_ra(addr, 9000 + 1500 * k))[i // 7 % 4]
            else:
                msg = encode_df11(addr)
            out.append((t, msg, addr, 1 + (i + k) % 3))
            t += float(rng.uniform(0.2, 0.9))
            i += 1
    out.sort(key=lambda m: m[0])
    return out


def _frame(cls, t_s, msg, addr, k):
    return cls(msg=msg, msgbits=len(msg) * 8, timestamp=int(t_s * 12_000_000), score=1000 + k % 7,
               phase=4 + k % 5, correctedbits=0, addr=addr, signal_power=0.01 * (1 + k % 50))


def _counters(t):
    """Every number the tracker keeps, and each aircraft's whole state
    (readsb_tpu's trace setting aside: the port's tracker has no traces)."""
    out = {k: v for k, v in vars(t).items() if isinstance(v, (int, float))
           and not isinstance(v, bool) and k != "json_trace_interval"}
    out["pos_by_type"] = dict(t.pos_by_type)
    out["aircraft"] = repr(list(t.aircraft.values()))
    return out


def _outputs(t, jo, now, messages):
    return {
        "aircraft.json": jo.generate_aircraft_json(t, now, messages),
        "receiver.json": jo.generate_receiver_json(1000, t.receiver_lat, t.receiver_lon),
        "receivers.json": t.receivers.receivers_json(now),
        "outline.json": t.outline.outline_json(),
        "counters": _counters(t),
        "modeac": [x.tolist() for x in (t.modeac_count, t.modeac_match, t.modeac_age)],
    }


@pytest.mark.parametrize("seed,receiver", [(11, None), (12, (47.45, 8.55)), (13, (47.45, 8.55))])
def test_tracker_replay_equals_reference(seed, receiver):
    lat, lon = receiver or (None, None)
    kw = dict(json_reliable=1, receiver_lat=lat, receiver_lon=lon, max_range_km=300 * 1.852)
    jt, pt = jax_tracker.Tracker(**kw), tracker.Tracker(**kw)
    scene = _scene(seed)
    checkpoints = {len(scene) // 3, 2 * len(scene) // 3, len(scene) - 1}
    n_pos = 0
    for k, (t_s, msg, addr, rid) in enumerate(scene):
        jm = jax_fields.decode_frame(_frame(JaxRawFrame, t_s, msg, addr, k), epoch_ms=EPOCH_MS)
        pm = fields.decode_frame(_frame(RawFrame, t_s, msg, addr, k), epoch_ms=EPOCH_MS)
        jm.receiver_id = pm.receiver_id = rid
        assert repr(pm) == repr(jm)
        jt.update(jm)
        pt.update(pm)
        n_pos += pm.cpr_decoded
        if k in checkpoints:
            now = EPOCH_MS + int(t_s * 1000)
            for tr in (jt, pt):
                tr.remove_stale(now)
                tr.match_ac(now)
            assert _outputs(pt, json_out, now, k + 1) == _outputs(jt, jax_json, now, k + 1)
    assert n_pos > 50 and pt.cpr_global_ok > 0
    if receiver:
        assert pt.cpr_surface > 0
    end = EPOCH_MS + int(scene[-1][0] * 1000)
    for now in (end + 61_000, end + tracker.TRACK_EXPIRE_LONG + tracker.MINUTES * 2 + 1):
        assert jt.remove_stale(now) == pt.remove_stale(now)
        assert _outputs(pt, json_out, now, len(scene)) == _outputs(jt, jax_json, now, len(scene))
    assert not pt.aircraft and pt.tracks_all == len({m[2] for m in scene})


def test_aircraft_fields_match_reference():
    """The port's Aircraft and ModesMessage carry the reference's fields."""
    assert [f.name for f in dataclasses.fields(tracker.Aircraft)] == [
        f.name for f in dataclasses.fields(jax_tracker.Aircraft)]
    assert [f.name for f in dataclasses.fields(fields.ModesMessage)] == [
        f.name for f in dataclasses.fields(jax_fields.ModesMessage)]
