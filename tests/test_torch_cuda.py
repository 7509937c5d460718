"""The port's CUDA kernels and pipeline on the card, against the plain
versions and the CPU run.  Marked `cuda`; they skip without a CUDA device.
This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from readsb_tpu_torch.ops import convert, kernels, modeac
from readsb_tpu_torch.pipeline import Demodulator, MultiDemodulator
from readsb_tpu_torch.synth import CaptureBuilder, build_standard_capture, quantize_sc16

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_dense_scan_kernel_equals_plain(dev):
    rng = np.random.default_rng(2)
    words = torch.from_numpy(rng.integers(0, 65536, 4 * 65536, dtype=np.int64).astype(np.uint16))
    before = kernels.dense_scan_uc8.launches
    got = kernels.dense_scan_uc8(words.to(dev), 58)
    assert kernels.dense_scan_uc8.launches == before + 1
    for g, w in zip(got, kernels.dense_scan_uc8_plain(words, 58)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 5000])
def test_extract_kernel_equals_plain(dev, k):
    rng = np.random.default_rng(k)
    rows = torch.from_numpy(rng.integers(-(2**31), 2**31, (k, 128), dtype=np.int64).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, 2**24, k, dtype=np.int64).astype(np.int32))
    got = kernels.extract_syndromes(rows.to(dev), offs.to(dev))
    assert torch.equal(got.cpu(), kernels.extract_syndromes_plain(rows, offs))


def test_multidemodulator_card_equals_cpu(dev):
    caps = [bytes(build_standard_capture(0.4, 3, s).render_uc8()) for s in (5, 6, 7, 8)]

    def run(device):
        m = MultiDemodulator(4, blocks_per_batch=1, use_native=False, device=device)
        out = m.feed(caps)
        for c, t in enumerate(m.flush()):
            out[c].extend(t)
        return [[(f.msg, f.timestamp) for f in fr] for fr in out], [
            (s.preambles, s.rejected_bad, s.rejected_unknown_icao, s.accepted)
            for s in map(m.channel_stats, range(4))
        ]

    card, cpu = run(dev), run("cpu")
    assert sum(map(len, card[0])) > 10
    assert card == cpu


def test_mag_uc8_kernel_equals_lut_on_all_pairs(dev):
    ii, qq = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    words = torch.from_numpy((ii.ravel() | (qq.ravel() << 8)).astype(np.uint16))
    before = kernels.mag_uc8.launches
    got = kernels.mag_uc8(words.to(dev))
    assert kernels.mag_uc8.launches == before + 1
    lut = torch.from_numpy(convert.uc8_lut_np().astype(np.int32))
    assert torch.equal(got.cpu().to(torch.int32), lut)


@pytest.mark.parametrize("n,shift", [(1, 0), (7, 0), (8, 0), (70001, 0), (70001, 3)])
def test_mag_uc8_kernel_odd_sizes(dev, n, shift):
    """Ragged tails, and a view that is not 16-byte aligned."""
    rng = np.random.default_rng(n + shift)
    words = torch.from_numpy(rng.integers(0, 65536, n + shift, dtype=np.int64).astype(np.uint16))
    got = kernels.mag_uc8(words.to(dev)[shift:])
    assert torch.equal(got.cpu(), kernels.mag_uc8(words[shift:]))


def test_dense_scan_mag_kernel_equals_plain(dev):
    rng = np.random.default_rng(4)
    mag = torch.from_numpy(rng.integers(0, 65536, 3 * 65536, dtype=np.int64).astype(np.uint16))
    before = kernels.dense_scan.launches
    got = kernels.dense_scan(mag.to(dev), 58)
    assert kernels.dense_scan.launches == before + 1
    for g, w in zip(got, kernels.dense_from_mag(mag.to(torch.int32), 58, tail=0)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("fmt", ["sc16", "sc16q11"])
def test_sc16_converters_card_equals_cpu(dev, fmt):
    axis = np.concatenate([np.arange(-32768, 32768, 53), [32767, -2048, 2047, 2048, 0]])
    ii, qq = np.meshgrid(axis.astype(np.int16), axis.astype(np.int16), indexing="ij")
    iq = torch.from_numpy(np.stack([ii.ravel(), qq.ravel()], axis=1).reshape(-1))
    fn = convert.CONVERTERS[fmt]
    assert torch.equal(fn(iq.to(dev)).cpu(), fn(iq))


def test_modeac_block_card_equals_cpu(dev):
    rng = np.random.default_rng(3)
    scan = 262144
    mag = np.abs(rng.normal(0, 800, scan + 326)).astype(np.uint16)
    pos = rng.integers(400, scan - 200, 15000)
    amp = rng.integers(3000, 30000, 15000)
    for d in (0, 1, 48, 49, 50):
        mag[pos + d] = np.maximum(mag[pos + d], (amp * rng.uniform(0.3, 1, 15000)).astype(np.uint16))
    buf = torch.from_numpy(mag)
    card = modeac.modeac_block(buf.to(dev), 300, k=32768, scan_len=scan)
    cpu = modeac.modeac_block(buf, 300, k=32768, scan_len=scan)
    assert int(cpu.n_cand) > 5000
    for c, h in zip(card, cpu):
        assert torch.equal(c.cpu(), h)


def test_multidemodulator_sc16_card_equals_cpu(dev):
    caps = [quantize_sc16(build_standard_capture(0.4, 3, s).render_iq()).tobytes()
            for s in (5, 6, 7, 8)]

    def run(device):
        m = MultiDemodulator(4, fmt="sc16", blocks_per_batch=1, use_native=False, device=device)
        out = m.feed(caps)
        for c, t in enumerate(m.flush()):
            out[c].extend(t)
        return [[(f.msg, f.timestamp) for f in fr] for fr in out], [
            (s.preambles, s.rejected_bad, s.rejected_unknown_icao, s.accepted)
            for s in map(m.channel_stats, range(4))
        ], m.mean_level.tolist(), m.mean_power.tolist()

    before = kernels.dense_scan.launches
    card, cpu = run(dev), run("cpu")
    assert kernels.dense_scan.launches > before
    assert sum(map(len, card[0])) > 10
    assert card == cpu


def test_ungated_modeac_card_equals_cpu(dev):
    cap = CaptureBuilder(duration_s=0.35, noise_rms=0.012, seed=11)
    for code, t in zip([0x1200, 0x7700, 0x0030, 0x2644], [0.02, 0.09, 0.17, 0.25]):
        cap.add_modeac(code, t, amplitude=0.5, phase=0.05)
    raw = bytes(cap.render_uc8())

    def run(device):
        d = Demodulator(fmt="uc8", blocks_per_batch=2, modeac=True, use_native=False,
                        device=device)
        frames = d.feed(raw) + d.flush()
        return ([(f.msg, f.timestamp) for f in frames],
                [(m.squawk_hex, m.timestamp) for m in d.modeac_msgs],
                d.stats_modeac, d.mean_level, d.mean_power)

    before = (kernels.mag_uc8.launches, kernels.dense_scan.launches)
    card, cpu = run(dev), run("cpu")
    assert kernels.mag_uc8.launches > before[0] and kernels.dense_scan.launches > before[1]
    assert {c for c, _ in card[1]} == {0x1200, 0x7700, 0x0030, 0x2644}
    assert card == cpu
