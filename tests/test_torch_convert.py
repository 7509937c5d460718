"""UC8 conversion and the fused dense scan of the port against readsb_tpu.

Everything here is integer: the tolerance is 0.  The Pallas kernel runs in
the Mosaic interpreter on the CPU (interpret=True), two 65536-sample tiles
so that the tile halo runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readsb_tpu.ops import convert as jax_convert
from readsb_tpu.ops.pallas_kernels import dense_scan_uc8_pallas
from readsb_tpu_torch.ops import convert, kernels

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)


def _all_pairs_words() -> np.ndarray:
    ii, qq = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return (ii.ravel() | (qq.ravel() << 8)).astype(np.uint16)  # I low byte


def test_lut_equals_jax_on_all_pairs():
    np.testing.assert_array_equal(convert.uc8_lut_np(), jax_convert.uc8_lut_np())


def test_mag_uc8_equals_jax():
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, 2 * 70000, dtype=np.int64).astype(np.uint8)
    got = convert.mag_uc8(torch.from_numpy(raw)).numpy()
    want = np.asarray(jax_convert.mag_uc8(jnp.asarray(raw)))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_dense_scan_magnitude_is_the_lut_on_all_pairs():
    """mag^2 recovered from the prefix-sum steps equals LUT^2 for every pair."""
    words = _all_pairs_words()
    _, _, hi, lo = kernels.dense_scan_uc8(torch.from_numpy(words), 58)

    def steps(cs):
        u = cs.numpy().astype(np.int64) & 0xFFFFFFFF
        return np.diff(u, prepend=0) & 0xFFFFFFFF

    lut = convert.uc8_lut_np().astype(np.int64)
    ii, qq = words & 0xFF, words >> 8
    want = lut[ii.astype(np.int64) * 256 + qq] ** 2
    np.testing.assert_array_equal((steps(hi) << 16) + steps(lo), want)


@pytest.mark.parametrize("threshold", [58, 75])
def test_dense_scan_plain_equals_pallas(threshold):
    n = 2 * 65536  # two tiles so the halo path runs
    rng = np.random.default_rng(5 + threshold)
    words = rng.integers(0, 65536, n, dtype=np.int64).astype(np.uint16)
    want = dense_scan_uc8_pallas(jnp.asarray(words), jnp.int32(threshold), interpret=True)
    got = kernels.dense_scan_uc8(torch.from_numpy(words), threshold)
    for name, w, g in zip(("corrbits", "pwords", "cs_hi", "cs_lo"), want, got):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32}[w.dtype]
        # full arrays, tail included: both read zero words past the end
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize(
    "words",
    [
        np.zeros(65536, np.int32).astype(np.uint16)[:1000],  # not a multiple of 65536
        np.zeros(65536, np.int32),  # wrong dtype
        np.zeros((2, 65536), np.uint16),  # not 1-D
    ],
    ids=["length", "dtype", "rank"],
)
def test_dense_scan_rejects_bad_words(words):
    with pytest.raises(ValueError):
        kernels.dense_scan_uc8(torch.from_numpy(words), 58)
