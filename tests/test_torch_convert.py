"""The converters and the dense scans of the port against readsb_tpu.

Integer outputs are held with tolerance 0; the float tolerances are stated
at their tests.  The Pallas kernels run in the Mosaic interpreter on the
CPU (interpret=True), two 65536-sample tiles for the dense scans so that
the tile halo runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readsb_tpu.ops import convert as jax_convert
from readsb_tpu.ops.pallas_kernels import (
    _sq_table_np,
    dense_scan_pallas,
    dense_scan_uc8_pallas,
    mag_uc8_pallas,
)
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


# ---------------------------------------------------------------------------
# The magnitude route: kernels #3 and #4 in the interpreter, sc16 converters
# ---------------------------------------------------------------------------


def test_mag_uc8_plain_equals_pallas():
    """One tile through mag_uc8_pallas in the interpreter, all 65536 pairs."""
    words = _all_pairs_words()
    rng = np.random.default_rng(17)
    rng.shuffle(words)
    want = np.asarray(mag_uc8_pallas(jnp.asarray(words.view(np.uint8)), interpret=True))
    got = kernels.mag_uc8(torch.from_numpy(words))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        convert.mag_uc8(torch.from_numpy(words.view(np.uint8))).numpy(), want
    )


@pytest.mark.parametrize("threshold", [58, 75])
def test_dense_scan_mag_plain_equals_pallas(threshold):
    """kernels.dense_scan (dense_from_mag with a zero tail on the CPU)
    against dense_scan_pallas on a zero-padded magnitude buffer."""
    n = 2 * 65536
    rng = np.random.default_rng(9 + threshold)
    mag = np.zeros(n, np.uint16)
    mag[: n - 700] = rng.integers(0, 65536, n - 700, dtype=np.int64).astype(np.uint16)
    want = dense_scan_pallas(jnp.asarray(mag), jnp.int32(threshold), interpret=True)
    got = kernels.dense_scan(torch.from_numpy(mag), threshold)
    for name, w, g in zip(("corrbits", "pwords", "cs_hi", "cs_lo"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    again = kernels.dense_from_mag(torch.from_numpy(mag.astype(np.int32)), threshold, tail=0)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def _int16_grid() -> np.ndarray:
    """Interleaved int16 pairs: both axes densely, and the clamp at 1.0."""
    axis = np.concatenate([
        np.arange(-32768, 32768, 53),
        [-32768, -32767, 32767, 32766, -2049, -2048, -2047, 2047, 2048, 2049,
         -1449, 1448, 1449, 23170, 23171, -23170, -23171, -1, 0, 1],
    ]).astype(np.int16)
    ii, qq = np.meshgrid(axis, axis, indexing="ij")
    return np.stack([ii.ravel(), qq.ravel()], axis=1).reshape(-1)


@pytest.mark.parametrize("fmt", ["sc16", "sc16q11"])
def test_mag_sc16_equals_jax(fmt):
    """Tolerance 0: float32 products, sum, sqrt and scale round one by one
    in both packages."""
    iq = _int16_grid()
    want = np.asarray(jax_convert.CONVERTERS[fmt](jnp.asarray(iq)))
    got = convert.CONVERTERS[fmt](torch.from_numpy(iq))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 65535 and want.min() == 0


def test_block_stats_equals_jax():
    """Relative 1e-5: readsb_tpu sums float32, the port sums integers."""
    rng = np.random.default_rng(23)
    mag = rng.integers(0, 65536, 300000, dtype=np.int64).astype(np.uint16)
    level, power = convert.block_stats(torch.from_numpy(mag))
    jl, jp = jax_convert.block_stats(jnp.asarray(mag))
    assert level == pytest.approx(float(jl), rel=1e-5)
    assert power == pytest.approx(float(jp), rel=1e-5)
    m = mag.astype(np.float64)
    assert level == m.sum() / 65536.0 / len(m)
    assert power == (m * m).sum() / (65535.0 * 65535.0) / len(m)
    sums = convert.block_sums(torch.from_numpy(mag.reshape(3, -1)))
    assert sums.dtype == torch.int64 and tuple(sums.shape) == (3, 2)
    assert int(sums[:, 0].sum()) == int(m.sum())


def _dc_serial(f, z0, a):
    z = np.empty(len(f), np.float64)
    acc = float(z0)
    for i, x in enumerate(f.astype(np.float64)):
        acc = (1.0 - a) * acc + a * x
        z[i] = acc
    return f - z, acc


@pytest.mark.parametrize("a", [convert.dc_filter_coeff(2.4e6), 0.01])
def test_dc_block_against_serial_and_jax(a):
    """Samples in [-1, 1].  Against the serial recurrence in float64:
    absolute 2e-6 (the scan reorders float32 sums of up to 20000 terms).
    Against readsb_tpu: absolute 5e-5, because its scan rounds the slope
    1 - a to float32 before raising it to the n-th power, which the port
    does in float64; bit equality is not expected of two scans."""
    rng = np.random.default_rng(29)
    f = (rng.normal(0.2, 0.3, 20000)).astype(np.float32)
    y, z_last = convert.dc_block(torch.from_numpy(f), 0.125, a)
    ys, zs = _dc_serial(f, 0.125, a)
    np.testing.assert_allclose(y.numpy(), ys, atol=2e-6, rtol=0)
    assert float(z_last) == pytest.approx(zs, abs=2e-6)
    yj, zj = jax_convert.dc_block(jnp.asarray(f), jnp.float32(0.125), a)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=5e-5, rtol=0)
    assert float(z_last) == pytest.approx(float(zj), abs=5e-5)


def test_dc_filter_coeff_equals_jax():
    assert convert.dc_filter_coeff(2.4e6) == jax_convert.dc_filter_coeff(2.4e6)


@pytest.mark.parametrize("fmt", ["uc8", "sc16", "sc16q11"])
def test_mag_with_dc_against_jax(fmt):
    """At most 4 LSB of 65535: the filtered samples agree with readsb_tpu's
    to 5e-5 (above), which is 3.3 LSB at full scale, plus rounding."""
    rng = np.random.default_rng(31)
    n = 8192
    if fmt == "uc8":
        iq = rng.integers(100, 156, 2 * n, dtype=np.int64).astype(np.uint8)
    else:
        iq = rng.integers(-1500, 1500, 2 * n, dtype=np.int64).astype(np.int16)
    z1 = np.array([0.01, -0.02], np.float32)
    mag, z = convert.mag_with_dc(torch.from_numpy(iq), torch.from_numpy(z1), fmt)
    jm, jz = jax_convert.mag_with_dc(jnp.asarray(iq), jnp.asarray(z1), fmt)
    assert mag.dtype == torch.uint16 and tuple(z.shape) == (2,)
    diff = np.abs(mag.numpy().astype(np.int64) - np.asarray(jm).astype(np.int64))
    assert diff.max() <= 4
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=5e-5, rtol=0)


def test_kernel_sq_table_is_the_reference_table():
    """The fi^2 table that the dense-scan library loads (convert.sq_table_np)
    equals readsb_tpu's symmetric half, mirrors it, and equals fi^2 of the
    correctly rounded float32 quotient (2i - 255) / 255 on all 256 entries."""
    sq = convert.sq_table_np()
    assert sq.dtype == np.float32 and sq.shape == (256,)
    np.testing.assert_array_equal(sq[:128], _sq_table_np())
    np.testing.assert_array_equal(sq[::-1], sq)
    i = np.arange(256, dtype=np.float32)
    fi = (np.float32(2) * i - np.float32(255)) / np.float32(255)
    np.testing.assert_array_equal(sq, fi * fi)


def test_kernel_magnitude_expression_over_the_table_is_the_lut():
    """The kernels' float32 expression over the table (uc8_mag.cuh: add,
    min, sqrt, scale, + 0.5, truncate; one rounding each) gives
    readsb_tpu's LUT on all 65536 pairs."""
    sq = convert.sq_table_np()
    w = _all_pairs_words().astype(np.int64)
    s = np.minimum(sq[w & 255] + sq[w >> 8], np.float32(1.0))
    m = (np.sqrt(s) * np.float32(65535.0) + np.float32(0.5)).astype(np.uint32)
    np.testing.assert_array_equal(m, jax_convert.uc8_lut_np()[(w & 255) * 256 + (w >> 8)])
