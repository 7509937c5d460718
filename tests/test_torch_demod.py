"""Compaction, win rows and demod_block of the port against readsb_tpu.

Tolerance 0 (integer outputs).  JAX runs on the CPU, where demod_block
takes the jnp dense stages and the jnp extract tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readsb_tpu.ops import convert as jax_convert
from readsb_tpu.ops import demod as jax_demod
from readsb_tpu_torch.ops import demod
from tools.synth import build_standard_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)


@pytest.mark.parametrize("density,l", [(0.0, 16), (0.01, 16), (0.05, 64)])
def test_compaction_equals_jax(density, l):
    rng = np.random.default_rng(3)
    scan = 131072 + 17
    cand = rng.random(scan) < density
    o1, m1 = jax_demod._compact_two_level(jnp.asarray(cand), 4096, l, scan)
    o2, m2 = demod._compact_two_level(torch.from_numpy(cand), 4096, l, scan)
    assert o2.dtype == torch.int32 and m2.dtype == torch.int32
    np.testing.assert_array_equal(o2.numpy(), np.asarray(o1))
    assert int(m2) == int(m1)


def test_compaction_k_overflow_keeps_first_k():
    """More candidates than k: the first k offsets, and n_cand > k tells."""
    rng = np.random.default_rng(4)
    scan = 65536
    cand = rng.random(scan) < 0.05
    o1, m1 = jax_demod._compact_two_level(jnp.asarray(cand), 1024, 64, scan)
    o2, m2 = demod._compact_two_level(torch.from_numpy(cand), 1024, 64, scan)
    np.testing.assert_array_equal(o2.numpy(), np.asarray(o1))
    np.testing.assert_array_equal(o2.numpy(), np.nonzero(cand)[0][:1024])
    assert int(m2) == int(m1)


@pytest.fixture(scope="module")
def mag_buf():
    cap = build_standard_capture(duration_s=0.2, n_aircraft=3, seed=13)
    iq = cap.render_iq()
    raw = np.empty(len(iq) * 2, dtype=np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 127.5 + 127.5), 0, 255).astype(np.uint8)
    raw[1::2] = np.clip(np.round(iq.imag * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return np.asarray(jax_convert.mag_uc8(jnp.asarray(raw)))


def test_win_rows_equal_jax(mag_buf):
    scan_len = len(mag_buf) - 326
    cj, pj, _, _ = jax_demod._dense_stages_jnp(jnp.asarray(mag_buf), 58)
    wj, nvj = jax_demod.win_rows(cj, pj, scan_len)
    ct, pt, _, _ = demod._dense_stages(torch.from_numpy(mag_buf.copy()), 58)
    wt, nvt = demod.win_rows(ct, pt, scan_len)
    assert nvt == nvj
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("k,threshold", [(8192, 58), (4096, 75)])
def test_demod_block_equals_jax(mag_buf, k, threshold):
    want = jax_demod.demod_block(jnp.asarray(mag_buf), threshold, k=k, l=64)
    got = demod.demod_block(torch.from_numpy(mag_buf.copy()), threshold, k=k, l=64)
    assert int(got.n_cand) > 0
    for field in demod.BlockCandidates._fields:
        if getattr(want, field) is None:  # flags, live, fused_overflow: staged route
            assert getattr(got, field) is None, field
            continue
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )
    np.testing.assert_array_equal(got.sigsum_long, want.sigsum_long)
