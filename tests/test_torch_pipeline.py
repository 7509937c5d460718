"""The port's streaming pipeline against readsb_tpu's: frames (bytes,
timestamps, phases, scores, signal power) and stats, bit for bit.

On the CPU readsb_tpu's gated Demodulator takes its magnitude route; one
test forces its raw-UC8 route through the Mosaic interpreter
(pallas_kernels.INTERPRET), the route the port follows, so the raw route's
0x8080 initial overlap is held too.
"""

import numpy as np
import pytest
import torch

import readsb_tpu.ops.pallas_kernels as jax_pk
from readsb_tpu.pipeline import Demodulator as JaxDemodulator
from readsb_tpu.pipeline import MultiDemodulator as JaxMultiDemodulator
from readsb_tpu.pipeline import demodulate_file as jax_demodulate_file
from readsb_tpu_torch.pipeline import Demodulator, MultiDemodulator, demodulate_file
from readsb_tpu_torch.state import demod_state_from_numpy
from readsb_tpu_torch.synth import build_standard_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

SUPER = 131072 * 2  # bytes of one 131072-sample block


def _uc8(duration, n_aircraft, seed) -> bytes:
    return bytes(build_standard_capture(duration, n_aircraft, seed).render_uc8())


def _key(frames):
    return [(f.msg, f.timestamp, f.phase, f.score, f.signal_power, f.scan_offset) for f in frames]


def _stats(s):
    return (s.preambles, s.rejected_bad, s.rejected_unknown_icao, list(s.accepted))


@pytest.fixture(scope="module")
def capture():
    return _uc8(0.6, 4, 7)


@pytest.fixture(scope="module")
def captures():
    return [_uc8(0.4, 3, s) for s in (5, 6, 7, 8)]


@pytest.mark.parametrize("use_native", [False, True])
def test_demodulator_equals_jax(capture, use_native):
    j = JaxDemodulator(fmt="uc8", blocks_per_batch=2, use_gate=True, use_native=use_native)
    want = j.feed(capture) + j.flush()
    p = Demodulator(blocks_per_batch=2, use_native=use_native, device="cpu")
    got = p.feed(capture) + p.flush()
    assert len(want) > 10
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _stats(j.stats)


@pytest.mark.parametrize("use_native", [False, True])
def test_multidemodulator_equals_jax(captures, use_native):
    n = len(captures)
    j = JaxMultiDemodulator(n, blocks_per_batch=1, use_native=use_native)
    want = j.feed(captures)
    for c, t in enumerate(j.flush()):
        want[c].extend(t)
    p = MultiDemodulator(n, blocks_per_batch=1, use_native=use_native, device="cpu")
    got = p.feed(captures)
    for c, t in enumerate(p.flush()):
        got[c].extend(t)
    assert sum(len(w) for w in want) > 10
    for c in range(n):
        assert _key(got[c]) == _key(want[c]), f"channel {c} frames"
        assert _stats(p.channel_stats(c)) == _stats(j.channel_stats(c)), f"channel {c} stats"
    assert _stats(p.stats) == _stats(j.stats)


def test_raw_route_equals_jax_interpret(monkeypatch):
    """One superblock through readsb_tpu's raw-UC8 route (Pallas kernels in
    the interpreter), the route whose first overlap is 0x8080 words."""
    monkeypatch.setattr(jax_pk, "INTERPRET", True)
    raw = _uc8(0.06, 8, 21)[:SUPER]
    j = JaxDemodulator(fmt="uc8", blocks_per_batch=1, use_gate=True, use_native=False)
    want = j.feed(raw) + j.flush()
    p = Demodulator(blocks_per_batch=1, use_native=False, device="cpu")
    got = p.feed(raw) + p.flush()
    assert len(want) > 0
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _stats(j.stats)
    np.testing.assert_array_equal(p._overlap_words.numpy(), np.asarray(j._overlap_words))


def test_demodulate_file_equals_jax(tmp_path):
    path = str(tmp_path / "cap.uc8.dat")
    build_standard_capture(0.5, 3, 9).write_uc8(path)
    want, jd = jax_demodulate_file(path, fmt="uc8", blocks_per_batch=2, use_native=False)
    got, pd = demodulate_file(path, blocks_per_batch=2, use_native=False, device="cpu")
    assert len(want) > 10
    assert _key(got) == _key(want)
    assert _stats(pd.stats) == _stats(jd.stats)


def _filter(f) -> dict:
    return {"cur": set(f.cur), "prev": set(f.prev), "next_swap_ms": f.next_swap_ms}


def _jax_state(d, overlap_words, mirror, filters) -> dict:
    return {
        "overlap_words": overlap_words,
        "scan_global": d.scan_global,
        "k": d.k, "compact_l": d.compact_l, "gate_k2": d.gate_k2, "gate_keep_l": d.gate_keep_l,
        "mirror": {
            "cur": mirror._cur_set, "prev": mirror._prev_set,
            "next_swap_ms": mirror.next_swap_ms, "capacity": mirror.capacity,
        },
        "icao": [_filter(f) for f in filters],
    }


def _delta(after, before):
    a, b = _stats(after), _stats(before)
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2], [x - y for x, y in zip(a[3], b[3])])


def test_state_handover_single(capture):
    """readsb_tpu demodulates the first superblock; the port takes the
    stream over mid-way and continues exactly as readsb_tpu does."""
    head, rest = capture[: 2 * SUPER], capture[2 * SUPER :]
    j = JaxDemodulator(fmt="uc8", blocks_per_batch=2, use_gate=True, use_native=False)
    first = j.feed(head)
    assert first
    state = demod_state_from_numpy(_jax_state(
        j, np.frombuffer(head, "<u2")[-326:], j.icao_mirror, [j.scorer.icao]
    ))
    before = j.stats
    p = Demodulator(blocks_per_batch=2, use_native=False, device="cpu")
    p.load_state(state)
    want = j.feed(rest) + j.flush()
    got = p.feed(rest) + p.flush()
    assert len(want) > 5
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _delta(j.stats, before)
    assert _filter(p.scorer.icao) == _filter(j.scorer.icao)
    np.testing.assert_array_equal(p.icao_mirror.tbl.numpy(), np.asarray(j.icao_mirror.tbl))


def test_state_handover_multi(captures):
    n = len(captures)
    heads = [c[:SUPER] for c in captures]
    rests = [c[SUPER:] for c in captures]
    j = JaxMultiDemodulator(n, blocks_per_batch=1, use_native=False)
    j.feed(heads)
    ow = np.stack([np.frombuffer(h, "<u2")[-326:] for h in heads])
    state = demod_state_from_numpy(_jax_state(j, ow, j.mirror, [f.icao for f in j.fins]))
    before = [j.channel_stats(c) for c in range(n)]
    p = MultiDemodulator(n, blocks_per_batch=1, use_native=False, device="cpu")
    p.load_state(state)
    want = j.feed(rests)
    got = p.feed(rests)
    for c, (tw, tg) in enumerate(zip(j.flush(), p.flush())):
        assert _key(got[c] + tg) == _key(want[c] + tw), f"channel {c}"
        assert _stats(p.channel_stats(c)) == _delta(j.channel_stats(c), before[c])
        assert _filter(p.fins[c].icao) == _filter(j.fins[c].icao)


def test_state_rejects_bad_values():
    good = {
        "overlap_words": np.zeros(326, np.uint16), "scan_global": 0,
        "k": 2048, "compact_l": 64, "gate_k2": 1024, "gate_keep_l": 64,
        "mirror": {"cur": [], "prev": [], "next_swap_ms": None, "capacity": 2048},
        "icao": [{"cur": [1], "prev": [], "next_swap_ms": 60000}],
    }
    assert demod_state_from_numpy(good)["icao"][0]["cur"] == {1}
    for bad in (
        {"overlap_words": np.zeros(300, np.uint16)},
        {"overlap_words": np.zeros(326, np.int32)},
        {"k": 3000},
        {"icao": []},
        {"mirror": {**good["mirror"], "cur": [1 << 24]}},
    ):
        with pytest.raises(ValueError):
            demod_state_from_numpy({**good, **bad})
    p = Demodulator(blocks_per_batch=1, use_native=False, device="cpu")
    with pytest.raises(ValueError):
        p.load_state(demod_state_from_numpy({**good, "overlap_words": np.zeros((2, 326), np.uint16),
                                             "icao": good["icao"] * 2}))
    assert torch.equal(p._overlap_words, torch.full((326,), 0x8080, dtype=torch.uint16))
