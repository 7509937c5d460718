"""The port's measurement and compile-check entry points against the JAX repo's:
`readsb_tpu_torch.bench` against `bench.py`, `readsb_tpu_torch.graft_entry`
against `__graft_entry__.py`, and `readsb_tpu_torch.tools.*` against the
four `tools/` benches.

Inputs are held to the originals' recipes at small sizes (bench.py and
tools/bench_arena.py, tools/bench_net.py and tools/bench_serving.py read
argv or build their inputs at import, so their recipes are rebuilt here
with `tools.synth` and readsb_tpu's classes; tools/state_scale_1m.py is
imported).  The bench's dispatch and entry()'s step are held to
readsb_tpu's at tolerance 0: the dispatch with readsb_tpu's raw-UC8
kernels in the Mosaic interpreter, entry() on readsb_tpu's plain dense
stages, the port on its plain versions.  The host-only tools run at a
tiny size on the CPU; the two card-only benches raise here.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft_entry
import readsb_tpu.ops.pallas_kernels as jax_pk
from readsb_tpu import pipeline as jax_pipeline
from readsb_tpu.constants import BLOCK_SAMPLES
from readsb_tpu.decode.fields import ModesMessage as JaxModesMessage
from readsb_tpu.decode.fields import Source as JaxSource
from readsb_tpu.io import beast as jax_beast
from readsb_tpu.io import json_out as jax_json_out
from readsb_tpu.track import globe as jax_globe
from readsb_tpu.track.traces import Trace as JaxTrace
from readsb_tpu.track.tracker import Aircraft as JaxAircraft
from readsb_tpu.track.tracker import Tracker as JaxTracker
from readsb_tpu.track.tracker import Validity as JaxValidity
from readsb_tpu_torch import bench, graft_entry
from readsb_tpu_torch import tools as port_tools
from readsb_tpu_torch.io import json_out
from readsb_tpu_torch.pipeline import MultiDemodulator
from readsb_tpu_torch.tools import bench_arena, bench_net, bench_serving, state_scale_1m
from readsb_tpu_torch.track.tracker import Tracker
from tests.test_torch_track import aircraft_state
from tools import state_scale_1m as jax_state_scale
from tools.synth import build_standard_capture, encode_df11, encode_df17_position

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)


def _bench_py_workload(n_blocks: int, seed: int = 3):
    """bench.py's build_workload (bench.py:52-66), on tools.synth."""
    total = n_blocks * BLOCK_SAMPLES
    dur = total / 2.4e6
    cap = build_standard_capture(duration_s=dur + 0.1, n_aircraft=8, seed=seed)
    iq = cap.render_iq()[:total]
    i8 = np.clip(np.round(iq.real * 127.5 + 127.5), 0, 255).astype(np.uint8)
    q8 = np.clip(np.round(iq.imag * 127.5 + 127.5), 0, 255).astype(np.uint8)
    raw = np.empty(total * 2, dtype=np.uint8)
    raw[0::2] = i8
    raw[1::2] = q8
    return raw, total, cap.truth


def _equal_fields(got, want) -> None:
    """Every field of a port NamedTuple equals readsb_tpu's, dtype included."""
    assert got._fields == want._fields
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        w, g = np.asarray(w), g.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def _last_json(out: str) -> dict:
    line = json.loads(out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "device", "power_limit_w"} <= set(line)
    return line


# --- bench.py --------------------------------------------------------------


def test_workload_bytes_equal_bench_py():
    raw, total, truth = bench.build_workload(2)
    want_raw, want_total, want_truth = _bench_py_workload(2)
    assert total == want_total == 2 * BLOCK_SAMPLES
    assert raw.dtype == want_raw.dtype and raw.tobytes() == want_raw.tobytes()
    # the truth: the messages that lie whole inside the blocks
    inside = [t for t in want_truth if round(t["t"] * 2.4e6) + 288 <= total]
    assert truth == inside and len(inside) >= 8


def test_bench_dispatch_equals_jax(monkeypatch):
    """One C = 2 dispatch with the bench's arguments (a demodulator warmed by
    one feed(), the known table it learned) equals readsb_tpu's
    _demod_and_gate_multi_raw in every field."""
    monkeypatch.setattr(jax_pk, "INTERPRET", True)
    raw, _, truth = bench.build_workload(2)
    chunks = [bytes(raw[c * BLOCK_SAMPLES * 2 : (c + 1) * BLOCK_SAMPLES * 2]) for c in range(2)]
    multi = MultiDemodulator(2, blocks_per_batch=1, device="cpu")
    frames = multi.feed(chunks)
    assert sum(len(f) for f in frames) >= 0.9 * len(truth)
    got = bench.make_dispatch(multi, torch.from_numpy(raw.view("<u2").reshape(2, BLOCK_SAMPLES)))()
    tbl = multi.mirror.tbl.numpy()
    assert (tbl < 0x1000000).sum() > 0  # the gate sees a known table
    want = jax_pipeline._demod_and_gate_multi_raw(
        jnp.asarray(raw.view("<u2").reshape(2, BLOCK_SAMPLES)),
        jnp.full((2, 326), 0x8080, jnp.uint16), jnp.int32(multi.seg_valid), jnp.int32(58),
        jnp.asarray(tbl), **bench.dispatch_args(multi),
    )
    assert int(want.n_keep) > 0 and int(want.pre_drop) > 0
    _equal_fields(got, want)


@pytest.mark.parametrize("run", [
    lambda: bench.run(2), lambda: bench.main(["2"]),
    lambda: bench_arena.run(64, 2), lambda: bench_arena.main(["64", "2"]),
], ids=["bench", "bench-cli", "arena", "arena-cli"])
def test_card_benches_raise_without_a_card(run, monkeypatch):
    """bench and bench_arena time on the card only: without one they raise
    before building anything, from Python as from the command line, also
    under READSB_TPU_PLATFORM=cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def no_workload(*a, **k):
        raise AssertionError("built a workload without a card")

    monkeypatch.setattr(bench, "build_workload", no_workload)
    monkeypatch.setattr(bench_arena, "build_batches", no_workload)
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()


# --- __graft_entry__.py ------------------------------------------------------


def test_entry_equals_jax():
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jax_graft_entry.entry()
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert args[0].dtype == torch.uint16 and args[1] == int(jargs[1]) == 58
    got = fn(*args)
    want = jax.jit(jfn)(*jargs)
    assert got.offsets.shape == (4, 256) and (np.asarray(want.n_cand) > 256).all()
    _equal_fields(got, want)


def test_graft_entry_main_runs_entry_and_the_dry_run_on_the_cpu(capsys):
    graft_entry.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry OK:" in out and "'offsets': (4, 256)" in out
    assert "dryrun_multichip OK: mesh=(chan=1, time=2)" in out


# --- tools/bench_arena.py ------------------------------------------------------


def _jax_arena_batches(m: int, b: int):
    """tools/bench_arena.py's batches (:17-32) with readsb_tpu's ModesMessage."""
    rng = np.random.default_rng(0)
    addrs = rng.integers(0x100000, 0x100000 + 10000, m * b)
    t = 1_000_000
    batches = []
    for j in range(b):
        msgs = []
        for i in range(m):
            t += 1
            mm = JaxModesMessage(msgtype=17, addr=int(addrs[j * m + i]),
                                 source=JaxSource.ADSB, sys_timestamp_ms=t)
            mm.gs_selected = 450.0
            mm.baro_rate = -640.0
            mm.ias = 280.0
            msgs.append(mm)
        batches.append(msgs)
    return batches


def test_arena_batches_equal_the_original():
    got = bench_arena.build_batches(96, 3)
    want = _jax_arena_batches(96, 3)
    assert [len(b) for b in got] == [96, 96, 96]
    for g, w in zip(got, want):
        assert [dataclasses.asdict(m) for m in g] == [dataclasses.asdict(m) for m in w]


# --- tools/bench_net.py ----------------------------------------------------------


def _jax_net_messages(n: int) -> list[bytes]:
    """tools/bench_net.py's message mix (:68-84)."""
    msgs = []
    for i in range(n):
        ac = i % 5000
        addr = 0x400000 + ac
        seq = i // 5000
        if seq % 5 == 4:
            msgs.append(encode_df11(addr))
        else:
            lat = 45.0 + (ac % 70) * 0.1 + seq * 0.0002
            lon = -5.0 + (ac // 70) * 0.1
            msgs.append(encode_df17_position(addr, lat, lon, 30000 + ac % 1000, seq % 2))
    return msgs


def test_net_inputs_equal_the_original():
    """Messages, frames and wire bytes at 5 messages per aircraft plus some
    (every kind of message: DF11 at seq 4, odd and even positions)."""
    n = 5000 * 5 + 7
    msgs = bench_net.build_messages(n)
    assert msgs == _jax_net_messages(n)
    frames = bench_net.build_frames(msgs)
    for i in (0, 1, 4999, 5000, 20000, n - 1):
        want = jax_beast.BeastFrame(
            msg=msgs[i], timestamp=i * 500, signal_byte=40, msg_type=0,
            receiver_id=0x1000_0000 + (i % 5000) % 50, synthetic_ms=1_000_000 + i // 100)
        assert dataclasses.asdict(frames[i]) == dataclasses.asdict(want)
    short = msgs[:1200]
    parts = []
    for i, m in enumerate(short):  # tools/bench_net.py:172-180
        if i % 100 == 0:
            parts.append(jax_beast.encode_synthetic_ts(1_000_000 + i // 100))
        parts.append(jax_beast.encode_receiver_id(0x1000_0000 + (i % 5000) % 50))
        parts.append(jax_beast.encode_frame(m, i * 500, 0.04))
    assert bench_net.build_wire(short) == b"".join(parts)


def test_bench_net_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    line = bench_net.main(["600"])
    out = capsys.readouterr().out
    assert _last_json(out) == line
    assert line["metric"] == "aggregator_ingest" and line["unit"] == "msgs/s"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["scalar_tracked"] == line["bulk_app_tracked"] == 600
    assert line["aircraft"] == 600 and line["value"] > 0


# --- tools/bench_serving.py -------------------------------------------------------


def _jax_serving_fleet(tr, n: int) -> None:
    """tools/bench_serving.py's build_fleet (:38-71) on readsb_tpu's classes."""
    now = 10_000_000
    rng = np.random.default_rng(7)
    lat = rng.uniform(-60, 70, n)
    lon = rng.uniform(-180, 180, n)
    alt = rng.integers(1000, 43000, n)
    gs = rng.uniform(80, 520, n)
    trk = rng.uniform(0, 360, n)
    for i in range(n):
        a = JaxAircraft(addr=0x400000 + i)
        a.seen = now - int(rng.integers(0, 5000))
        a.messages = 50 + i % 997
        a.lat, a.lon = float(lat[i]), float(lon[i])
        a.seen_pos = a.seen
        a.pos_nic, a.pos_rc = 8, 186.0
        a.pos_reliable_odd = a.pos_reliable_even = 4.0
        a.baro_alt = int(alt[i])
        a.gs = float(gs[i])
        a.track = float(trk[i])
        a.callsign = f"BNC{i % 10000:04d}"
        a.squawk = 0x1000 + (i % 0o7777)
        for v in ("baro_alt_valid", "gs_valid", "track_valid",
                  "position_valid", "callsign_valid", "squawk_valid"):
            setattr(a, v, JaxValidity(updated=a.seen, source=JaxSource.ADSB,
                                      last_source=JaxSource.ADSB))
        a.globe_index = jax_globe.globe_index(a.lat, a.lon)
        if i % 5 == 0:
            t = JaxTrace()
            for k in range(30):
                t.add(a, a.seen - (30 - k) * 4000, json_trace_interval=1000)
            t.dirty = True
            a.trace = t
        tr.aircraft[a.addr] = a


def _fleet_key(tracker) -> tuple:
    """The aircraft's whole state, traces set apart (an aircraft's repr
    prints its trace object's address), and each trace's points."""
    traces = {}
    for addr, a in tracker.aircraft.items():
        t, a.trace = a.trace, None
        if t is not None:
            traces[addr] = (repr(t.points), repr(t.buffered), t.len_total, t.dirty, t.chunks)
    key = aircraft_state(tracker.aircraft.values()), traces
    return key


def test_serving_fleet_equals_the_original():
    got, want = Tracker(keep_traces=True), JaxTracker(keep_traces=True)
    bench_serving.build_fleet(got, 60)
    _jax_serving_fleet(want, 60)
    now = bench_serving.NOW
    assert json_out.generate_aircraft_json(got, now) == jax_json_out.generate_aircraft_json(want, now)
    key = _fleet_key(got)
    assert key == _fleet_key(want) and len(key[1]) == 12


def test_bench_serving_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    line = bench_serving.main(["60"])
    out = capsys.readouterr().out
    assert _last_json(out) == line
    assert "SERVING_TICK {'n': 60, " in out.strip().splitlines()[-2]
    assert line["metric"] == "serving_tick" and line["unit"] == "ms"
    assert line["device"] == "cpu" and line["traces"] == 12 and line["api_rows"] == 60


# --- tools/state_scale_1m.py -------------------------------------------------------


def test_state_fleet_equals_the_original():
    got, want = Tracker(), JaxTracker()
    state_scale_1m.build_fleet(got, 45)
    jax_state_scale.build_fleet(want, 45)
    key = _fleet_key(got)
    assert key == _fleet_key(want) and len(key[1]) == 3


def test_state_scale_runs_on_the_cpu_and_round_trips(monkeypatch, capsys):
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    line = state_scale_1m.main(["300"])
    out = capsys.readouterr().out
    assert _last_json(out) == line
    assert "roundtrip spot-check ok" in out
    assert line["metric"] == "state_save" and line["unit"] == "s" and line["device"] == "cpu"
    assert line["saved"] == line["loaded"] == line["n"] == 300 and line["bytes"] > 0


# --- the tools' shared parts -----------------------------------------------------------


@pytest.mark.parametrize("run", [
    lambda: bench_serving.run(10), lambda: state_scale_1m.run(10), lambda: bench_net.run(10),
], ids=["serving", "state", "net"])
def test_host_tools_default_to_the_card(run, monkeypatch):
    """The host-only tools name the card beside their numbers by default,
    and raise without one; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("READSB_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run()


def test_device_fields_read_the_cards_name_and_power_limit(monkeypatch):
    """nvidia-smi is asked about the card itself, by its UUID: it lists the
    machine's cards in PCI order whatever CUDA_VISIBLE_DEVICES hides."""
    uuids = {0: "0000aaaa-0000-0000-0000-000000000000", 1: "1111bbbb-1111-1111-1111-111111111111"}
    limits = {f"GPU-{u}": f"{500 + 100 * i}.00 W" for i, u in uuids.items()}
    asked = []

    class Props:
        def __init__(self, i):
            self.uuid = uuids[i]

    def smi(cmd, **kw):
        assert cmd[0] == "nvidia-smi" and cmd[1] == "-i"
        assert "--query-gpu=name,power.limit" in cmd and "--format=csv,noheader" in cmd
        asked.append(cmd[2])

        class Done:
            stdout = f"NVIDIA H100 80GB HBM3, {limits[cmd[2]]}\n"
        return Done

    monkeypatch.setattr(port_tools.subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "get_device_properties", Props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    assert port_tools.device_fields(torch.device("cuda", 1)) == {
        "device": "card 1", "power_limit_w": 600.0}
    assert port_tools.card_line(torch.device("cuda", 0)) == "NVIDIA H100 80GB HBM3, 500.00 W"
    assert asked == [f"GPU-{uuids[1]}", f"GPU-{uuids[0]}"]
    assert port_tools.device_fields(torch.device("cpu")) == {
        "device": "cpu", "power_limit_w": None}


def test_the_entry_point_modules_are_scanned_by_the_rules():
    """The import rules (no jax, readsb_tpu, top-level tools or zstandard)
    cover the new modules: tests/test_torch_rules.py finds them by rglob."""
    from tests.test_torch_rules import PORT_FILES, REPO

    scanned = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"readsb_tpu_torch/bench.py", "readsb_tpu_torch/graft_entry.py"} | {
        f"readsb_tpu_torch/tools/{m}.py" for m in
        ("__init__", "bench_arena", "bench_net", "bench_serving", "state_scale_1m")} <= scanned
