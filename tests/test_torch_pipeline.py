"""The port's streaming pipeline against readsb_tpu's: frames (bytes,
timestamps, phases, scores, signal power) and stats, bit for bit.

On the CPU readsb_tpu's gated Demodulator takes its magnitude route; one
test forces its raw-UC8 route through the Mosaic interpreter
(pallas_kernels.INTERPRET), the route the port follows, so the raw route's
0x8080 initial overlap is held too.  The magnitude-route tests (sc16,
sc16q11, ungated, Mode A/C, process_mag) follow; mean_level / mean_power
are held to relative 1e-5 because readsb_tpu sums float32 and the port
sums integers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import readsb_tpu.ops.pallas_kernels as jax_pk
from readsb_tpu.pipeline import Demodulator as JaxDemodulator
from readsb_tpu.pipeline import MultiDemodulator as JaxMultiDemodulator
from readsb_tpu.pipeline import demodulate_file as jax_demodulate_file
from readsb_tpu_torch.pipeline import Demodulator, MultiDemodulator, demodulate_file
from readsb_tpu_torch.state import demod_state_from_numpy
from readsb_tpu_torch.synth import (
    CaptureBuilder,
    build_standard_capture,
    encode_df11,
    encode_df17_ident,
    quantize_sc16,
    quantize_uc8,
)

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


# ---------------------------------------------------------------------------
# The magnitude route
# ---------------------------------------------------------------------------

LEVEL_RTOL = 1e-5  # float32 sums in readsb_tpu, exact integer sums in the port


def _sc16(duration, n_aircraft, seed, scale=1.0) -> bytes:
    iq = build_standard_capture(duration, n_aircraft, seed).render_iq()
    return quantize_sc16(iq * scale).tobytes()


@pytest.fixture(scope="module")
def sc16_capture():
    return _sc16(0.4, 4, 7)


def _run(d, raw):
    return d.feed(raw) + d.flush()


def _hold_levels(p, j):
    assert p.mean_level == pytest.approx(j.mean_level, rel=LEVEL_RTOL)
    assert p.mean_power == pytest.approx(j.mean_power, rel=LEVEL_RTOL)
    assert p.mean_level > 0


@pytest.mark.parametrize(
    "fmt,use_gate,use_native",
    [("sc16", True, False), ("sc16", True, True), ("sc16q11", True, False),
     ("sc16", False, False), ("sc16", False, True), ("sc16q11", False, True)],
)
def test_magnitude_route_equals_jax(sc16_capture, fmt, use_gate, use_native):
    # sc16q11 full scale is 2048: the same scene at 1/16 of the sc16 scale
    raw = sc16_capture if fmt == "sc16" else _sc16(0.4, 4, 7, scale=1 / 16)
    kw = dict(fmt=fmt, blocks_per_batch=2, use_gate=use_gate, use_native=use_native)
    j = JaxDemodulator(**kw)
    want = _run(j, raw)
    p = Demodulator(device="cpu", **kw)
    assert p.raw_route is False
    got = _run(p, raw)
    assert len(want) > 10
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _stats(j.stats)
    _hold_levels(p, j)
    overlap = j._overlap_dev if use_gate else j.overlap
    np.testing.assert_array_equal(p._overlap_dev.numpy(), np.asarray(overlap))


def test_ungated_uc8_equals_jax_interpret(monkeypatch):
    """readsb_tpu's ungated uc8 route with mag_uc8_pallas and
    dense_scan_pallas in the interpreter, one superblock."""
    monkeypatch.setattr(jax_pk, "INTERPRET", True)
    raw = _uc8(0.06, 8, 21)[:SUPER]
    kw = dict(fmt="uc8", blocks_per_batch=1, use_gate=False, use_native=False)
    j = JaxDemodulator(**kw)
    want = _run(j, raw)
    p = Demodulator(device="cpu", **kw)
    got = _run(p, raw)
    assert len(want) > 0
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _stats(j.stats)
    _hold_levels(p, j)


def test_gated_prefetch_feed_equals_one_by_one(sc16_capture):
    """Several superblocks in one feed() (the prefetch branch) against the
    same bytes fed a superblock at a time, and against readsb_tpu."""
    kw = dict(fmt="sc16", blocks_per_batch=1, use_native=False)
    a = Demodulator(device="cpu", **kw)
    fa = _run(a, sc16_capture)
    b = Demodulator(device="cpu", **kw)
    step = 131072 * 4
    fb = []
    for o in range(0, len(sc16_capture), step):
        fb.extend(b.feed(sc16_capture[o : o + step]))
    fb.extend(b.flush())
    j = JaxDemodulator(use_gate=True, **kw)
    assert _key(fa) == _key(fb) == _key(_run(j, sc16_capture))
    assert _stats(a.stats) == _stats(b.stats) == _stats(j.stats)


@pytest.mark.parametrize("use_native", [False, True])
def test_multidemodulator_sc16_equals_jax(use_native):
    caps = [_sc16(0.3, 3, s) for s in (5, 6, 7, 8)]
    n = len(caps)
    j = JaxMultiDemodulator(n, fmt="sc16", blocks_per_batch=1, use_native=use_native)
    want = j.feed(caps)
    for c, t in enumerate(j.flush()):
        want[c].extend(t)
    p = MultiDemodulator(n, fmt="sc16", blocks_per_batch=1, use_native=use_native, device="cpu")
    got = p.feed(caps)
    for c, t in enumerate(p.flush()):
        got[c].extend(t)
    assert sum(len(w) for w in want) > 10
    for c in range(n):
        assert _key(got[c]) == _key(want[c]), f"channel {c} frames"
        assert _stats(p.channel_stats(c)) == _stats(j.channel_stats(c)), f"channel {c} stats"
    assert _stats(p.stats) == _stats(j.stats)
    np.testing.assert_allclose(p.mean_level, np.asarray(j.mean_level), rtol=LEVEL_RTOL)
    np.testing.assert_allclose(p.mean_power, np.asarray(j.mean_power), rtol=LEVEL_RTOL)
    assert p.mean_level.shape == (n,) and (p.mean_level > 0).all()
    np.testing.assert_array_equal(p._overlap_dev.numpy(), np.asarray(j._overlap_dev))


@pytest.mark.parametrize("kw", [{"use_gate": True}, {"use_gate": False}, {"modeac": True}],
                         ids=["gated", "ungated", "modeac"])
def test_process_mag_equals_jax(kw):
    raw = np.frombuffer(_uc8(0.12, 6, 33)[: 2 * SUPER], np.uint8)
    from readsb_tpu_torch.ops import convert

    mag = convert.mag_uc8(torch.from_numpy(raw.copy())).numpy()
    j = JaxDemodulator(fmt="uc8", blocks_per_batch=1, use_native=False, **kw)
    p = Demodulator(fmt="uc8", blocks_per_batch=1, use_native=False, device="cpu", **kw)
    want, got = [], []
    for o in (0, 131072):
        want += j.process_mag(mag[o : o + 131072])
        got += p.process_mag(mag[o : o + 131072])
    assert len(want) > 0
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _stats(j.stats)
    if kw != {"use_gate": False}:
        _hold_levels(p, j)
    with pytest.raises(ValueError):
        p.process_mag(mag[:1000])


def _modeac_capture() -> bytes:
    """The capture of tests/test_modeac.py's end-to-end test, plus Mode-S
    frames of two aircraft on the same timeline."""
    cap = CaptureBuilder(duration_s=0.35, noise_rms=0.012, seed=11)
    for code, t in zip([0x1200, 0x7700, 0x0030, 0x2644], [0.02, 0.09, 0.17, 0.25]):
        cap.add_modeac(code, t, amplitude=0.5, phase=0.05)
    for i in range(12):
        addr = 0x4B1600 + (i % 2)
        msg = encode_df11(addr) if i % 3 else encode_df17_ident(addr, f"SWR{i:03d}")
        cap.add_frame(msg, 0.01 + 0.027 * i, amplitude=0.4)
    return quantize_uc8(cap.render_iq()).tobytes()


@pytest.mark.parametrize("use_native", [False, True])
def test_modeac_end_to_end_equals_jax(use_native):
    raw = _modeac_capture()
    kw = dict(fmt="uc8", blocks_per_batch=2, modeac=True, use_native=use_native)
    j = JaxDemodulator(**kw)
    want = _run(j, raw)
    p = Demodulator(device="cpu", **kw)
    got = _run(p, raw)

    def noise(d):
        std = np.sqrt(max(0.0, d.mean_power - d.mean_level**2))
        return int((d.mean_power + std) * 65535 + 0.5)

    why = f"last block noise_level: port {noise(p)}, readsb_tpu {noise(j)}"
    assert {m.squawk_hex for m in p.modeac_msgs} == {0x1200, 0x7700, 0x0030, 0x2644}, why
    assert [dataclasses.asdict(m) for m in p.modeac_msgs] == [
        dataclasses.asdict(m) for m in j.modeac_msgs
    ], why
    assert p.stats_modeac == j.stats_modeac == len(p.modeac_msgs), why
    assert p.modeac_k == j.modeac_k
    assert len(want) >= 8
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _stats(j.stats)
    _hold_levels(p, j)


def test_demodulate_file_sc16_equals_jax(tmp_path):
    path = str(tmp_path / "cap.sc16.dat")
    build_standard_capture(0.4, 3, 9).write_sc16(path)
    want, jd = jax_demodulate_file(path, fmt="sc16", blocks_per_batch=2, use_native=False,
                                   use_gate=True)
    got, pd = demodulate_file(path, fmt="sc16", blocks_per_batch=2, use_native=False,
                              device="cpu")
    assert len(want) > 10
    assert _key(got) == _key(want)
    assert _stats(pd.stats) == _stats(jd.stats)


def _mag_state(d, overlap, mirror, filters, **extra) -> dict:
    st = _jax_state(d, None, mirror, filters)
    del st["overlap_words"]
    return {**st, "overlap_mag": np.asarray(overlap), "mean_level": d.mean_level,
            "mean_power": d.mean_power, **extra}


@pytest.mark.parametrize("route", ["gated", "modeac"])
def test_state_handover_magnitude_single(sc16_capture, route):
    """readsb_tpu runs the first superblock of a magnitude-route stream;
    the port continues it."""
    step = 2 * 131072 * 4
    head, rest = sc16_capture[:step], sc16_capture[step:]
    kw = dict(fmt="sc16", blocks_per_batch=2, use_native=False)
    if route == "gated":
        j = JaxDemodulator(use_gate=True, **kw)
        p = Demodulator(device="cpu", **kw)
    else:
        j = JaxDemodulator(modeac=True, **kw)
        p = Demodulator(modeac=True, device="cpu", **kw)
    assert j.feed(head)
    if route == "gated":
        state = _mag_state(j, j._overlap_dev, j.icao_mirror, [j.scorer.icao])
    else:
        from readsb_tpu.ops.gate import DeviceIcaoMirror as JaxMirror

        state = _mag_state(j, j.overlap, JaxMirror(), [j.scorer.icao], modeac_k=j.modeac_k)
    before, n_ac = j.stats, j.stats_modeac
    p.load_state(demod_state_from_numpy(state))
    want = j.feed(rest) + j.flush()
    got = p.feed(rest) + p.flush()
    assert len(want) > 3
    assert _key(got) == _key(want)
    assert _stats(p.stats) == _delta(j.stats, before)
    assert p.stats_modeac == j.stats_modeac - n_ac
    assert _filter(p.scorer.icao) == _filter(j.scorer.icao)
    _hold_levels(p, j)


def test_state_handover_magnitude_multi():
    caps = [_sc16(0.3, 3, s) for s in (5, 6, 7, 8)]
    n = len(caps)
    step = 131072 * 4
    heads = [c[:step] for c in caps]
    rests = [c[step:] for c in caps]
    j = JaxMultiDemodulator(n, fmt="sc16", blocks_per_batch=1, use_native=False)
    j.feed(heads)
    state = demod_state_from_numpy(
        _mag_state(j, j._overlap_dev, j.mirror, [f.icao for f in j.fins])
    )
    before = [j.channel_stats(c) for c in range(n)]
    p = MultiDemodulator(n, fmt="sc16", blocks_per_batch=1, use_native=False, device="cpu")
    p.load_state(state)
    np.testing.assert_array_equal(p.mean_level, np.asarray(j.mean_level, np.float64))
    want = j.feed(rests)
    got = p.feed(rests)
    for c, (tw, tg) in enumerate(zip(j.flush(), p.flush())):
        assert _key(got[c] + tg) == _key(want[c] + tw), f"channel {c}"
        assert _stats(p.channel_stats(c)) == _delta(j.channel_stats(c), before[c])
        assert _filter(p.fins[c].icao) == _filter(j.fins[c].icao)


def test_state_refuses_the_other_route():
    good = {
        "scan_global": 0, "k": 2048, "compact_l": 64, "gate_k2": 1024, "gate_keep_l": 64,
        "mirror": {"cur": [], "prev": [], "next_swap_ms": None, "capacity": 2048},
        "icao": [{"cur": [], "prev": [], "next_swap_ms": None}],
    }
    words = demod_state_from_numpy({**good, "overlap_words": np.zeros(326, np.uint16)})
    mags = demod_state_from_numpy({**good, "overlap_mag": np.zeros(326, np.uint16)})
    assert mags["modeac_k"] == 512 and float(mags["mean_level"]) == 0.0
    with pytest.raises(ValueError):
        Demodulator(fmt="sc16", use_native=False, device="cpu").load_state(words)
    with pytest.raises(ValueError):
        Demodulator(fmt="uc8", use_native=False, device="cpu").load_state(mags)
    for bad in (
        {"overlap_words": np.zeros(326, np.uint16), "overlap_mag": np.zeros(326, np.uint16)},
        {},
        {"overlap_mag": np.zeros(326, np.uint16), "modeac_k": 700},
        {"overlap_mag": np.zeros(326, np.uint16), "mean_power": -1.0},
        {"overlap_mag": np.zeros(326, np.uint16), "mean_level": np.zeros(3)},
    ):
        with pytest.raises(ValueError):
            demod_state_from_numpy({**good, **bad})


def test_candidate_windows_are_whole_at_the_scan_end():
    """The CPU's dense stage gives the prefix sums of the card's, run on
    over the zero padding to the kernel's granule, so a candidate in the
    last scan offsets of a single-channel buffer gets its whole 268-sample
    signal window on both.  readsb_tpu's CPU path cuts every window at the
    last whole 128-sample row of its unpadded sums, so there the last ~30
    offsets get a shorter window (a fault of the reference, ROADMAP
    Queue 3, not held as truth here)."""
    import jax.numpy as jnp

    from readsb_tpu.ops import demod as jax_demod
    from readsb_tpu_torch.constants import PREAMBLE_THRESHOLD_DEFAULT as thr
    from readsb_tpu_torch.ops import demod as demod_ops
    from readsb_tpu_torch.ops import kernels

    scan_len = 131072
    rng = np.random.default_rng(5)
    mag = rng.integers(0, 65536, scan_len + 326, dtype=np.int64)
    buf = torch.from_numpy(mag.astype(np.uint16))
    offsets = torch.arange(scan_len - 64, scan_len, dtype=torch.int32)
    _, _, hi, lo = demod_ops.dense_stage(buf, thr, raw_uc8=False)
    _, _, phi, plo = kernels.dense_scan_plain(demod_ops.pad_mag(buf), thr)
    assert torch.equal(hi, phi) and torch.equal(lo, plo)
    got = demod_ops.window_sums(offsets, hi, lo)
    m2 = mag * mag
    for i, o in enumerate(offsets.tolist()):
        for sig, length in zip(got, (demod_ops.SIG_LONG, demod_ops.SIG_SHORT)):
            w = m2[o + 19: o + 19 + length]
            assert sig[i].tolist() == [int((w >> 16).sum()), int((w & 0xFFFF).sum())]
    # readsb_tpu's CPU path: whole windows below the band, cut in it
    _, _, jhi, jlo = jax_demod._dense_stages_jnp(jnp.asarray(mag.astype(np.uint16)), thr)
    ref = [np.asarray(a) for a in jax_demod.window_sums(jnp.asarray(offsets.numpy()), jhi, jlo)]
    cut = [i for i in range(len(offsets)) if not np.array_equal(got[0][i].numpy(), ref[0][i])]
    assert cut and min(offsets[cut].tolist()) > scan_len - 64 and cut == list(range(cut[0], 64))
