"""Extraction of the port against readsb_tpu, and the static tables.

extract_syndromes' plain version is held to extract_syndromes_pallas in the
Mosaic interpreter (interpret=True) on a 0.2 s capture's win rows, as
tests/test_pallas.py holds the Pallas kernel to the jnp chain.  Tolerance 0.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readsb_tpu.constants import TRAILING_SAMPLES
from readsb_tpu.decode import score as jax_score
from readsb_tpu.ops import convert as jax_convert
from readsb_tpu.ops import crc as jax_crc
from readsb_tpu.ops import demod as jax_demod
from readsb_tpu.ops import gate as jax_gate
from readsb_tpu.ops.pallas_kernels import extract_syndromes_pallas
from readsb_tpu_torch.decode import score
from readsb_tpu_torch.ops import crc, demod, gate, kernels
from tools.synth import build_standard_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def win_case():
    """(rows, offsets, n_cand, Pallas result) of a 0.2 s capture."""
    cap = build_standard_capture(duration_s=0.2, n_aircraft=3, seed=13)
    iq = cap.render_iq()
    raw = np.empty(len(iq) * 2, dtype=np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 127.5 + 127.5), 0, 255).astype(np.uint8)
    raw[1::2] = np.clip(np.round(iq.imag * 127.5 + 127.5), 0, 255).astype(np.uint8)
    mag = jax_convert.mag_uc8(jnp.asarray(raw))
    scan_len = (int(mag.shape[0]) - TRAILING_SAMPLES) // 512 * 512
    buf = mag[: scan_len + TRAILING_SAMPLES]
    k = 8192
    bc, _, _ = jax_demod._demod_core(buf, 58, k=k, scan_len=scan_len, l=64)
    corrbits, pwords, _, _ = jax_demod._dense_stages_jnp(buf, 58)
    win, nv = jax_demod.win_rows(corrbits, pwords, scan_len)
    rows = win[jnp.clip(bc.offsets >> 8, 0, nv - 1)]
    want = np.asarray(extract_syndromes_pallas(rows, bc.offsets, interpret=True))
    return np.asarray(rows), np.asarray(bc.offsets), int(bc.n_cand), want


def test_extract_plain_equals_pallas(win_case):
    rows, offsets, n_cand, want = win_case
    assert 0 < n_cand < len(offsets)
    got = kernels.extract_syndromes(torch.from_numpy(rows.copy()), torch.from_numpy(offsets.copy()))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 33, 1000])
def test_extract_any_k(win_case, k):
    """K need not be a multiple of 512 (the Pallas kernel's step)."""
    rows, offsets, _, want = win_case
    got = kernels.extract_syndromes(
        torch.from_numpy(rows[:k].copy()), torch.from_numpy(offsets[:k].copy())
    )
    np.testing.assert_array_equal(got.numpy(), want[:k])


def test_extract_rejects_bad_input(win_case):
    rows, offsets, _, _ = win_case
    r = torch.from_numpy(rows[:8].copy())
    o = torch.from_numpy(offsets[:8].copy())
    with pytest.raises(ValueError):
        kernels.extract_syndromes(r[:, :64], o)
    with pytest.raises(ValueError):
        kernels.extract_syndromes(r, o[:4])
    with pytest.raises(ValueError):
        kernels.extract_syndromes(r.to(torch.int64), o)


def test_slicer_and_lattice_tables_equal():
    for a, b in zip(demod.slicer_tables(), jax_demod.slicer_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(demod.lattice_tables(), jax_demod.lattice_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(demod._combined_matrix(), jax_demod._combined_matrix())


@pytest.mark.parametrize("bits", [56, 112])
def test_crc_tables_equal(bits):
    np.testing.assert_array_equal(crc.syndrome_matrix(bits), jax_crc.syndrome_matrix(bits))
    np.testing.assert_array_equal(
        crc.single_bit_syndromes(bits), jax_crc.single_bit_syndromes(bits)
    )
    for nfix in (1, 2):
        a, b = crc.error_table(bits, nfix), jax_crc.error_table(bits, nfix)
        for field in ("syndromes", "nerrors", "bit0", "bit1"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        np.testing.assert_array_equal(
            gate._table_syndromes_np(bits, nfix), jax_gate._table_syndromes_np(bits, nfix)
        )


def test_df_delta_syndromes_equal():
    np.testing.assert_array_equal(score.df_delta_syndromes(), jax_score.df_delta_syndromes())
    np.testing.assert_array_equal(gate._df_delta_np(), jax_gate._df_delta_np())


def test_kernel_tables_are_the_lattice_and_syndromes():
    """The tap table (written out as csrc/extract_taps.cuh) and the per-bit
    syndromes (the byte table's source) decode back to JAX's tables."""
    tap, s112, s56 = kernels.extract_tables_np()
    aoff, kid = jax_demod.lattice_tables()
    np.testing.assert_array_equal(tap.reshape(5, 112) & 511, aoff)
    np.testing.assert_array_equal(tap.reshape(5, 112) >> 9, kid)
    for syn, bits in ((s112, 112), (s56, 56)):
        m = jax_crc.syndrome_matrix(bits).astype(np.int64)
        packed = (m << np.arange(23, -1, -1)).sum(axis=1)
        np.testing.assert_array_equal(syn.astype(np.int64), packed)


@pytest.mark.parametrize("nbytes", [14, 7], ids=["112-bit", "56-bit"])
def test_byte_syndrome_table_matches_the_bit_syndromes(nbytes):
    """For random messages (and all-zero and all-one ones), the XOR of the
    byte-table entries that the extraction kernel reads (a 56-bit
    message's byte i at row i + 7) equals the XOR of the per-bit syndromes
    of the set bits, and readsb_tpu's syndrome-matrix product."""
    table = kernels.syndrome_bytes_np()
    assert table.shape == (14, 256) and table.dtype == np.uint32
    bits = nbytes * 8
    rng = np.random.default_rng(nbytes)
    msgs = np.concatenate([rng.integers(0, 256, (300, nbytes)),
                           np.zeros((1, nbytes), np.int64), np.full((1, nbytes), 255)])
    rows = np.arange(nbytes) + 14 - nbytes
    by_bytes = np.bitwise_xor.reduce(table[rows[None, :], msgs], axis=1)
    msg_bits = ((msgs[:, :, None] >> np.arange(7, -1, -1)) & 1).reshape(len(msgs), bits)
    single = crc.single_bit_syndromes(bits).astype(np.uint32)
    by_bits = np.bitwise_xor.reduce(np.where(msg_bits == 1, single[None, :], np.uint32(0)), axis=1)
    m = jax_crc.syndrome_matrix(bits).astype(np.int64)
    by_matrix = ((msg_bits @ m) & 1) @ (1 << np.arange(23, -1, -1))
    np.testing.assert_array_equal(by_bytes, by_bits)
    np.testing.assert_array_equal(by_bytes.astype(np.int64), by_matrix)


def test_compile_time_tap_header_is_the_tap_table():
    """csrc/extract_taps.cuh, parsed as text, holds extract_tables_np()'s
    560 taps in (phase, bit) order, and every tap lies in the 9 aligned
    window words per plane that the extraction kernel keeps."""
    text = (pathlib.Path(kernels.CSRC) / "extract_taps.cuh").read_text()
    body = text[text.index("kTaps[5][112] = {"):]
    body = body[body.index("{"):body.index("};")]
    taps = np.array([int(v) for v in re.findall(r"\d+", body)])
    tap = kernels.extract_tables_np()[0]
    np.testing.assert_array_equal(taps, tap)
    assert int(((tap & 511) >> 5).max()) < 9
