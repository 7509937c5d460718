"""The port's device CPR codec and device arena against readsb_tpu's, at
tolerance 0, and on real epoch milliseconds, where readsb_tpu raises or
wraps.

- CPR cores: the airborne, surface and relative cores on the CPU against
  readsb_tpu's `jnp` cores (decisions), and the golden vectors through the
  copied f64 maps.
- Arena: readsb_tpu's tests/test_arena.py streams (lattice fields,
  altitude excursions and squawk churn, airborne and surface CPR pairs),
  small timestamps, one after the other through one arena of each package
  with a fixed receiver location, in batches of at most 256 messages and
  16 rounds (readsb_tpu compiles its update per batch shape): every state
  field and `cpr_decodes` equal.  The port's time fields are int64, the
  reference's int32.
- Epoch ms: the same stream 1.76e12 ms later gives the same state, every
  time field moved by exactly that offset; `sweep(now)` frees exactly the
  aircraft idle for the TTL; the --device-arena app's aircraft.json equals
  the host-only columnar app's; `cpr_decodes` is empty after every tick;
  the overlay of `materialize_arena` fires on epoch time.
- A batch on another device than the state is refused.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from readsb_tpu.app.config import parse_args as jax_parse_args
from readsb_tpu.decode import cpr as jax_cpr
from readsb_tpu.ops import cpr_device as jax_cpr_device
from readsb_tpu.track import arena as jax_arena
from readsb_tpu_torch.app import bulk_drain, main
from readsb_tpu_torch.io import json_out
from readsb_tpu_torch.ops import cpr_device
from readsb_tpu_torch.track import arena
from tests import test_arena
from tests.test_bulk_app import _stream as bulk_app_stream
from tests.test_cpr_golden import GLOBAL_AIRBORNE, GLOBAL_SURFACE, RELATIVE

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

OFFSET = 1_760_000_000_000  # epoch ms, 2025-10
REF = (47.0, 8.0)  # the receiver of test_arena.py's CPR streams
MAX_BATCH, MAX_ROUNDS = 256, 16


# --- the CPR cores --------------------------------------------------------------


def _pairs(seed, n=4096):
    rng = np.random.default_rng(seed)
    elat = rng.integers(0, 1 << 17, n)
    elon = rng.integers(0, 1 << 17, n)
    olat = np.where(rng.random(n) < 0.5,
                    np.clip(elat + rng.integers(-600, 600, n), 0, (1 << 17) - 1),
                    rng.integers(0, 1 << 17, n))
    olon = np.clip(elon + rng.integers(-600, 600, n), 0, (1 << 17) - 1)
    return [np.asarray(a, np.int32) for a in (elat, elon, olat, olon, rng.integers(0, 2, n))]


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k


REFS = [(-60.0, 10.0), (-44.9, -170.0), (0.0, 0.0), (30.0, 100.0), (46.0, 5.0),
        (52.0, -1.0), (80.0, 179.5)]


def test_airborne_core_equals_readsb_tpu():
    cols = _pairs(23)
    got = cpr_device.decode_airborne_core(*map(torch.from_numpy, cols))
    _same(got, jax_cpr_device.decode_airborne_device(*cols))
    assert got["ok"].sum() > 800


@pytest.mark.parametrize("reflat,reflon", REFS)
def test_surface_and_relative_cores_equal_readsb_tpu(reflat, reflon):
    cols = _pairs(131 + int(reflat))
    q = cpr_device.surface_quadrant_consts(reflat)
    got = cpr_device.decode_surface_core(*map(torch.from_numpy, cols),
                                         q["zneg"], q["zpos"], q["t0"], q["t1"])
    want = jax_cpr_device.decode_surface_device(
        *cols, *(np.int32(q[k]) for k in ("zneg", "zpos", "t0", "t1")))
    _same(got, want)
    surface = np.asarray(np.random.default_rng(7).integers(0, 2, len(cols[0])), np.int32)
    args = (cols[0], cols[1], cols[4], surface)
    got = cpr_device.make_decode_relative_device(reflat, reflon, device="cpu")(
        *map(torch.from_numpy, args))
    _same(got, jax_cpr_device.make_decode_relative_device(reflat, reflon)(*args))


def test_golden_vectors_through_the_f64_maps():
    """cprtests.c's vectors: the port's cores and its copied f64 maps give
    the reference's degrees, bit for bit the scalar chain's."""
    for elat, elon, olat, olon, *want in GLOBAL_AIRBORNE:
        for f in (0, 1):
            c = [torch.tensor([v], dtype=torch.int32) for v in (elat, elon, olat, olon, f)]
            dev = {k: v.numpy() for k, v in cpr_device.decode_airborne_core(*c).items()}
            lat, lon = cpr_device.airborne_latlon_f64(dev, elat, elon, olat, olon, f)
            assert dev["ok"][0]
            assert (lat[0], lon[0]) == jax_cpr.decode_airborne(elat, elon, olat, olon, f)
            assert abs(lat[0] - want[2 * f]) < 1e-6 and abs(lon[0] - want[2 * f + 1]) < 1e-6
    for reflat, reflon, elat, elon, olat, olon, *want in GLOBAL_SURFACE:
        q = cpr_device.surface_quadrant_consts(reflat)
        for f in (0, 1):
            c = [torch.tensor([v], dtype=torch.int32) for v in (elat, elon, olat, olon, f)]
            dev = cpr_device.decode_surface_core(*c, q["zneg"], q["zpos"], q["t0"], q["t1"])
            dev = {k: v.numpy() for k, v in dev.items()}
            lat, lon = cpr_device.surface_latlon_f64(dev, reflat, reflon, elat, elon, olat, olon, f)
            assert dev["ok"][0]
            assert (lat[0], lon[0]) == jax_cpr.decode_surface(reflat, reflon, elat, elon, olat, olon, f)
            assert abs(lat[0] - want[2 * f]) < 1e-5 and abs(lon[0] - want[2 * f + 1]) < 1e-5
    n = 0
    for reflat, reflon, clat, clon, f, surf, *_ in RELATIVE:
        run = cpr_device.make_decode_relative_device(reflat, reflon, device="cpu")
        dev = run(*(torch.tensor([int(v)], dtype=torch.int32) for v in (clat, clon, f, surf)))
        dev = {k: v.numpy() for k, v in dev.items()}
        want = jax_cpr.decode_relative(reflat, reflon, clat, clon, f, bool(surf))
        assert bool(dev["ok"][0]) == (want is not None)
        if want is not None:
            assert cpr_device.relative_latlon_f64(dev, clat, clon, f, surf) == (
                np.array([want[0]]), np.array([want[1]]))
            n += 1
    assert n > 0


# --- the arena against readsb_tpu's ---------------------------------------------


def _streams():
    """test_arena.py's four streams, one after the other in time: lattice
    fields and callsigns; altitude and squawk; airborne CPR; surface CPR."""
    out = list(test_arena.make_msgs())
    for fn in (test_arena.test_arena_altitude_and_squawk_fuzz,
               test_arena.test_arena_device_cpr_matches_host_chain,
               test_arena.test_arena_device_cpr_surface_matches_host_chain):
        out += _capture(fn)
    assert all(a.sys_timestamp_ms < b.sys_timestamp_ms for a, b in zip(out, out[1:]))
    return out


def _capture(test_fn):
    """The messages a test_arena.py test feeds its Arena, in order."""
    got = []

    class Recorder:
        def __init__(self, *a, **k):
            self.cpr_decodes = []

        def update_batch(self, msgs):
            got.extend(msgs)

        def snapshot(self, now):
            raise _Done

    class _Done(Exception):
        pass

    orig = test_arena.Arena
    test_arena.Arena = Recorder
    try:
        test_fn()
    except (_Done, AssertionError):
        pass
    finally:
        test_arena.Arena = orig
    return got


def _batches(msgs):
    """Cuts of at most MAX_BATCH messages and MAX_ROUNDS per aircraft, of
    uneven sizes: readsb_tpu then compiles its update for at most two
    shapes (pad 256; 8 or 16 rounds)."""
    rng = np.random.default_rng(1)
    out, i = [], 0
    while i < len(msgs):
        want = int(rng.integers(100, MAX_BATCH + 1))
        count: dict[int, int] = {}
        j = i
        while j < len(msgs) and j - i < want:
            a = msgs[j].addr
            if count.get(a, 0) == MAX_ROUNDS:
                break
            count[a] = count.get(a, 0) + 1
            j += 1
        out.append(msgs[i:j])
        i = j
    return out


def _shifted(msgs, offset):
    out = []
    for mm in msgs:
        m = copy.copy(mm)
        m.sys_timestamp_ms += offset
        out.append(m)
    return out


def _replay(make, batches):
    ar = make()
    decodes = []
    for b in batches:
        ar.update_batch(b)
        decodes += ar.pop_cpr_decodes() if hasattr(ar, "pop_cpr_decodes") else ar.cpr_decodes
        if not hasattr(ar, "pop_cpr_decodes"):
            ar.cpr_decodes = []
    return ar, decodes


@pytest.fixture(scope="module")
def replays():
    msgs = _streams()
    batches = _batches(msgs)
    ref, ref_dec = _replay(lambda: jax_arena.Arena(n=1024, receiver_lat=REF[0], receiver_lon=REF[1]),
                           batches)
    port, port_dec = _replay(lambda: arena.Arena(n=1024, receiver_lat=REF[0],
                                                 receiver_lon=REF[1], device="cpu"), batches)
    late, late_dec = _replay(lambda: arena.Arena(n=1024, receiver_lat=REF[0],
                                                 receiver_lon=REF[1], device="cpu"),
                             [_shifted(b, OFFSET) for b in batches])
    return {"msgs": msgs, "batches": batches, "ref": (ref, ref_dec), "port": (port, port_dec),
            "late": (late, late_dec)}


def test_the_arena_equals_readsb_tpu(replays):
    ref, ref_dec = replays["ref"]
    port, port_dec = replays["port"]
    st = jax.device_get(ref.state)
    for name, got in port.state._asdict().items():
        want = np.asarray(getattr(st, name))
        if name in arena.TIME_FIELDS:
            assert want.dtype == np.int32 and got.dtype == torch.int64, name
            want = want.astype(np.int64)
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), name
    assert port_dec == ref_dec
    assert port.slot_of == ref.slot_of
    now = replays["msgs"][-1].sys_timestamp_ms
    assert port.snapshot(now) == ref.snapshot(now)
    # every kind of state was exercised
    assert len(ref_dec) > 200 and any(d[3] < 47.5 for d in ref_dec)
    assert (st.alt_rel < 20).any() and (st.sq_tent >= 0).any() and (st.cs_src >= 0).any()
    assert {len(b) for b in replays["batches"]} != {MAX_BATCH}


def test_epoch_ms_moves_every_time_field_by_the_offset(replays):
    """readsb_tpu wraps these timestamps into int32; the port keeps them."""
    port, port_dec = replays["port"]
    late, late_dec = replays["late"]
    used = port.state.icao >= 0
    for name, small in port.state._asdict().items():
        big = getattr(late.state, name)
        if name in arena.TIME_FIELDS:
            live = used.reshape((-1,) + (1,) * (small.dim() - 1)) & (small != arena._NEVER)
            assert torch.equal(big, torch.where(live, small + OFFSET, small)), name
            assert (big[live] > OFFSET).all() and live.any(), name
        else:
            assert torch.equal(big, small), name
    assert late_dec == [(a, t + OFFSET, *rest) for a, t, *rest in port_dec]


def test_sweep_on_epoch_ms_frees_the_idle_aircraft(replays):
    """readsb_tpu's sweep raises OverflowError on epoch ms."""
    late, _ = replays["late"]
    msgs = _shifted(replays["msgs"], OFFSET)
    last = {}
    for mm in msgs:
        last[mm.addr] = mm.sys_timestamp_ms
    ttl = 5 * arena.TRACK_EXPIRE
    now = msgs[-1].sys_timestamp_ms + ttl - 60_000  # the last minute's aircraft stay
    idle = {a for a, t in last.items() if now >= t + ttl}
    assert 0 < len(idle) < len(last)
    with pytest.raises(OverflowError):
        jax_arena.Arena(n=8).sweep(now)
    slots = {late.slot_of[a] for a in idle}
    assert late.sweep(now) == len(idle)
    assert set(late.slot_of) == set(last) - idle
    for name, t in late.state._asdict().items():
        rows = t[sorted(slots)]
        assert (rows == arena._FILL[name]).all(), name
    assert sorted(late.free[-len(idle):]) == sorted(slots)


def test_arena_refuses_a_batch_on_another_device():
    st = arena.empty_arena(512, "cpu")
    cols = {k: np.zeros((256,) + ((arena.NFIELDS,) if k in ("fmask", "fval") else
                                 (2,) if k == "cs" else ()), dt)
            for k, dt in arena._BATCH_DTYPES.items()}
    cols["slot"][:] = -1
    with pytest.raises(ValueError, match="on the arena's device"):
        arena.arena_update(st, arena.upload_batch(cols, "meta"), 1)
    new, ys = arena.arena_update(st, arena.upload_batch(cols, "cpu"), 1)
    assert tuple(ys.shape) == (1, 512, 12)
    assert all(torch.equal(a, b) for a, b in zip(new, st))


def test_the_arena_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        arena.Arena(n=16)


# --- the app with --device-arena on epoch ms ------------------------------------


ARGV = ["--net-only", "--quiet", "--lat", "49.5", "--lon", "3.5", "--net-bulk-drain"]


def _app_replay(device_arena, frames, monkeypatch):
    """The columnar drain of `frames` (test_bulk_app.py's stream moved to
    epoch ms) with a tick every 1500 frames; the popped device fixes and
    whether `cpr_decodes` was empty after every tick."""
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    app = main.App(main.parse_args(ARGV + (["--device-arena"] if device_arena else [])))
    clock = [0]
    app.now_ms = lambda: clock[0]
    popped, empty = [], []
    if device_arena:
        pop = app.arena.pop_cpr_decodes
        app.arena.pop_cpr_decodes = lambda: popped.extend(pop()) or []
    scorer = app._net_scorer()

    def tick():
        app.drain_net_queue()
        app._materialize(clock[0])
        if app.arena is not None:
            app.arena.sweep(clock[0])
            empty.append(app.arena.cpr_decodes == [])

    for i, bf in enumerate(frames):
        clock[0] = bf.synthetic_ms
        app._handle_net_frame(scorer, bf)
        if i % 1500 == 1499:
            tick()
    tick()
    return app, popped, empty


def test_device_arena_app_on_epoch_ms_equals_the_host_path(monkeypatch):
    frames = bulk_app_stream(10500)  # seven frames per aircraft: each kind once
    for bf in frames:
        bf.synthetic_ms += OFFSET
    host, _, _ = _app_replay(False, frames, monkeypatch)
    dev, popped, empty = _app_replay(True, frames, monkeypatch)
    now = frames[-1].synthetic_ms
    doc_h = json_out.generate_aircraft_json(host.tracker, now, host.messages)
    doc_d = json_out.generate_aircraft_json(dev.tracker, now, dev.messages)
    keys = ("hex", "flight", "alt_baro", "gs", "track", "baro_rate", "squawk", "lat", "lon",
            "seen", "messages")
    assert [{k: a.get(k) for k in keys} for a in doc_d["aircraft"]] == \
        [{k: a.get(k) for k in keys} for a in doc_h["aircraft"]]
    assert doc_d == doc_h
    assert len(doc_h["aircraft"]) == 1500 and host.messages == dev.messages > 5000
    # the arena ran at epoch time, its fixes were drained every tick
    assert int(dev.arena.state.messages.sum()) == dev.messages
    assert int(dev.arena.state.seen.max()) == now
    assert len(popped) > 1000 and all(empty) and len(empty) == 8
    # the overlay compares in the dict tracker's time base: a field whose
    # dict copy is older than the arena's is overlaid
    addr, a = next((k, v) for k, v in dev.tracker.aircraft.items() if v.gs is not None)
    want = a.gs
    a.gs, a.gs_valid.updated = -1.0, 0
    bulk_drain.materialize_arena(dev, now)
    s = dev.arena.slot_of[addr]
    assert a.gs_valid.updated == int(dev.arena.state.fts[s, arena.FIELD_IDX["gs"]]) > OFFSET
    assert a.gs == float(np.float32(want))
    assert vars(dev.args) == vars(jax_parse_args(ARGV + ["--device-arena"]))
