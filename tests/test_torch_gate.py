"""Score gate of the port against readsb_tpu: every GatedCandidates field,
drop counters included, for the single-channel and seg_stride layouts.
Tolerance 0 (integer outputs).

Where a dispatch learns more phases than readsb_tpu's 256-entry teach set
holds, readsb_tpu passes every ICAO-dependent candidate and the port's
exact teach set does not: there the port keeps a subset of readsb_tpu's
rows, and the frames and stats of the stream stay equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readsb_tpu.ops import convert as jax_convert
from readsb_tpu.ops import demod as jax_demod
from readsb_tpu.ops import gate as jax_gate
from readsb_tpu.pipeline import MultiDemodulator as JaxMultiDemodulator
from readsb_tpu_torch import synth
from readsb_tpu_torch.ops import demod, gate
from readsb_tpu_torch.pipeline import MultiDemodulator
from tools.synth import build_standard_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

TRAILING = 326


def _mags(seed: int, duration: float) -> np.ndarray:
    return _mags_of(build_standard_capture(duration_s=duration, n_aircraft=3, seed=seed))


def _mags_of(cap) -> np.ndarray:
    iq = cap.render_iq()
    raw = np.empty(len(iq) * 2, dtype=np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 127.5 + 127.5), 0, 255).astype(np.uint8)
    raw[1::2] = np.clip(np.round(iq.imag * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return np.asarray(jax_convert.mag_uc8(jnp.asarray(raw)))


def _known_table(addrs) -> np.ndarray:
    vals = sorted(set(addrs))
    size = max(128, -(-len(vals) // 128) * 128)
    tbl = np.full(size, gate.TBL_SENTINEL, np.int32)
    tbl[: len(vals)] = vals
    return tbl


_GATE_STATIC = ("scan_len", "k2", "nfix", "fix_df", "reset_every", "seg_stride", "keep_l")
_jax_gate = jax.jit(jax_gate.score_gate, static_argnames=_GATE_STATIC)


def _cores(buf: np.ndarray, *, k, scan_len, **layout):
    """The demod cores (JAX, port) of one magnitude buffer.

    The port's prefix sums are readsb_tpu's, run on over the zero padding
    to the dense kernel's granule (demod.dense_stage), as the card's are.
    Both gates then read the port's sums, so that a row whose window ends
    past readsb_tpu's shorter sums reads the same window in both."""
    bcj, hj, lj = jax_demod._demod_core(jnp.asarray(buf), 58, k=k, scan_len=scan_len, l=64, **layout)
    tc = demod._demod_core(torch.from_numpy(buf.copy()), 58, k=k, scan_len=scan_len, l=64, **layout)
    for j, t in ((hj, tc[1]), (lj, tc[2])):
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_array_equal(t[: len(j)], j)
        assert len(t) % 65536 == 0 and (t[len(j):] == j[-1]).all()
    return (bcj, jnp.asarray(tc[1].numpy()), jnp.asarray(tc[2].numpy())), tc


def _compare(cores, tbl: np.ndarray, *, scan_len, valid_len, **kw):
    (bcj, hj, lj), (bct, ht, lt) = cores
    want = _jax_gate(bcj, jnp.asarray(tbl), hj, lj, jnp.int32(valid_len), scan_len=scan_len, **kw)
    got = gate.score_gate(bct, torch.from_numpy(tbl), ht, lt, valid_len, scan_len=scan_len, **kw)
    for field in gate.GatedCandidates._fields:
        if getattr(want, field) is None:  # fused_overflow off the fused route
            assert getattr(got, field) is None, field
            continue
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )
    return got


# known-table cases: empty, the capture's own aircraft, unrelated addresses
_TABLES = {
    "empty": [],
    "fleet": [0x400000 + a * 0x1111 for a in range(3)],
    "other": [0x123456, 0xABCDEF, 0x000001],
}
_SINGLE_SCAN = 2 * 131072


@pytest.fixture(scope="module")
def single_cores():
    mag = _mags(11, 0.12)[: _SINGLE_SCAN + TRAILING]
    return _cores(mag, k=4096, scan_len=_SINGLE_SCAN)


@pytest.mark.parametrize("nfix,fix_df", [(1, True), (0, False), (2, True)])
@pytest.mark.parametrize("table", sorted(_TABLES))
def test_gate_single_channel_equals_jax(single_cores, table, nfix, fix_df):
    got = _compare(
        single_cores, _known_table(_TABLES[table]), scan_len=_SINGLE_SCAN,
        valid_len=_SINGLE_SCAN - 1000, k2=512, nfix=nfix, fix_df=fix_df,
        reset_every=65536, keep_l=64, seg_stride=None,
    )
    assert int(got.pre_drop) > 0 and int(got.n_keep) > 0


def test_gate_seg_stride_equals_jax():
    """Three channels in the MultiDemodulator layout [overlap | S | gap]."""
    seg_valid = 131072
    stride = seg_valid + 512
    chans = [_mags(s, 0.16)[131072 : 131072 + seg_valid] for s in (5, 6, 7)]
    buf = np.zeros(3 * stride + 512, np.uint16)
    for c, m in enumerate(chans):
        buf[c * stride + TRAILING : c * stride + TRAILING + seg_valid] = m
    cores = _cores(buf, k=8192, scan_len=3 * stride, seg_stride=stride, seg_valid=seg_valid)
    got = _compare(
        cores, _known_table(_TABLES["fleet"]), scan_len=3 * stride,
        valid_len=seg_valid - 300, k2=1024, nfix=1, fix_df=True,
        reset_every=65536, keep_l=64, seg_stride=stride,
    )
    assert int(got.n_keep) > 0


def test_icao_mirror_equals_jax():
    from readsb_tpu.decode.score import RawFrame

    def frame(addr, df, corrected=0, iid=0):
        return RawFrame(msg=bytes([df << 3]) + b"\0" * 6, msgbits=56, timestamp=0, score=0,
                        phase=4, correctedbits=corrected, addr=addr, signal_power=0.0, iid=iid)

    frames = [frame(0x111111, 17), frame(0x222222, 11), frame(0x333333, 11, iid=3),
              frame(0x444444, 17, corrected=1), frame(0x555555, 4)]
    jm, tm = jax_gate.DeviceIcaoMirror(), gate.DeviceIcaoMirror(device="cpu")
    for now in (0, 30_000, 61_000, 90_000, 125_000):
        swapped = []
        for m in (jm, tm):
            m.add_from_frames(frames[: 1 + now // 30_000])
            swapped.append(m.expire(now))
        assert swapped[0] == swapped[1]
        np.testing.assert_array_equal(tm.tbl.numpy(), np.asarray(jm.tbl))
        assert tm.next_swap_ms == jm.next_swap_ms


# eight receivers of eight aircraft, one superblock of four blocks each: a
# dispatch with more learning phases than readsb_tpu's 256-entry teach set
_DENSE_CHAN = 8
_DENSE_SEG = 4 * 131072


def _dense_capture(c: int):
    return synth.build_standard_capture(_DENSE_SEG / 2.4e6 + 0.01, 8, 100 + c)


def _learners(bc) -> int:
    """Fired phases that could teach the ICAO filter (score_gate's learn)."""
    msg = bc.msg.to(torch.int32)
    df = msg[:, :, 0] >> 3
    fired = bc.corr_fired[:, [0, 0, 1, 1, 2]]
    learn = fired & (((df == 17) & (bc.syn112 == 0)) | ((df == 11) & (bc.syn56 == 0)))
    return int(learn.sum())


def test_gate_teach_set_is_exact_where_jaxs_overflows():
    """The port keeps under 2% of the candidates, every row it keeps
    readsb_tpu keeps too, with the same fields, and both count the same
    valid candidates (pre_drop + n_keep)."""
    stride = _DENSE_SEG + 512
    scan_len = _DENSE_CHAN * stride
    buf = np.zeros(scan_len + 512, np.uint16)
    for c in range(_DENSE_CHAN):
        buf[c * stride + TRAILING : c * stride + TRAILING + _DENSE_SEG] = (
            _mags_of(_dense_capture(c))[:_DENSE_SEG])
    (bcj, hj, lj), (bct, ht, lt) = _cores(
        buf, k=_DENSE_CHAN * 4 * 2048, scan_len=scan_len, seg_stride=stride, seg_valid=_DENSE_SEG)
    assert int(bct.n_cand) <= bct.offsets.shape[0]
    assert _learners(bct) > 256
    kw = dict(scan_len=scan_len, k2=32768, nfix=1, fix_df=False, reset_every=65536,
              keep_l=256, seg_stride=stride)
    tbl = _known_table([])
    want = _jax_gate(bcj, jnp.asarray(tbl), hj, lj, jnp.int32(_DENSE_SEG - 300), **kw)
    got = gate.score_gate(bct, torch.from_numpy(tbl), ht, lt, _DENSE_SEG - 300, **kw)
    for g in (want, got):
        assert int(g.n_keep) <= kw["k2"] and int(g.keep_watermark) <= kw["keep_l"]
    n_keep, n_keep_j = int(got.n_keep), int(want.n_keep)
    assert int(got.pre_drop) + n_keep == int(want.pre_drop) + n_keep_j
    assert 0 < n_keep < 0.02 * (int(got.pre_drop) + n_keep)
    offs_j = np.asarray(want.offsets)[:n_keep_j]
    rows = np.searchsorted(offs_j, got.offsets[:n_keep].numpy())
    np.testing.assert_array_equal(offs_j[rows], got.offsets[:n_keep].numpy())
    for field in ("msg", "syn112", "syn56", "corr_fired", "sig_long", "sig_short"):
        np.testing.assert_array_equal(
            getattr(got, field)[:n_keep].numpy(), np.asarray(getattr(want, field))[rows],
            err_msg=field)


@pytest.mark.parametrize("use_native", [False, True])
def test_multidemodulator_with_an_exact_teach_set_equals_jax(use_native):
    """Eight sc16 receivers, one superblock of four blocks: the port keeps
    under 2% of the candidates at its first gate_k2, and its frames and
    per-channel stats equal readsb_tpu's, which passes a quarter."""
    caps = [synth.quantize_sc16(_dense_capture(c).render_iq()).tobytes()[: _DENSE_SEG * 4]
            for c in range(_DENSE_CHAN)]
    key = lambda fr: [(f.msg, f.timestamp, f.phase, f.score, f.signal_power, f.scan_offset)
                      for f in fr]
    stats = lambda s: (s.preambles, s.rejected_bad, s.rejected_unknown_icao, list(s.accepted))
    runs = []
    for cls, kw in ((JaxMultiDemodulator, {}), (MultiDemodulator, {"device": "cpu"})):
        d = cls(_DENSE_CHAN, fmt="sc16", blocks_per_batch=4, use_native=use_native, **kw)
        frames = d.feed(caps)
        for c, tail in enumerate(d.flush()):
            frames[c].extend(tail)
        runs.append((d, frames))
    (j, want), (p, got) = runs
    assert p.superblocks == 1 and p.redispatches == 0 and p.gate_k2 == 1024  # its first
    assert 0 < p.kept < 0.02 * p.candidates
    assert sum(len(w) for w in want) > 100
    for c in range(_DENSE_CHAN):
        assert key(got[c]) == key(want[c]), f"channel {c} frames"
        assert stats(p.channel_stats(c)) == stats(j.channel_stats(c)), f"channel {c} stats"
