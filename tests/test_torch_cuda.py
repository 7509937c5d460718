"""The port's CUDA kernels and pipeline on the card, against the plain
versions and the CPU run.  Marked `cuda`; they skip without a CUDA device.
This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from readsb_tpu_torch.ops import kernels
from readsb_tpu_torch.pipeline import MultiDemodulator
from readsb_tpu_torch.synth import build_standard_capture

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
