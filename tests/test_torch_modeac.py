"""Mode A/C of the port against readsb_tpu: the dense pass (modeac_block),
the host finalizer and the message decode.

Tolerance 0 everywhere: modeac_block is held field by field, sentinel rows
included, with the same noise_level passed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readsb_tpu.decode import mode_ac as jax_mode_ac
from readsb_tpu.ops import convert as jax_convert
from readsb_tpu.ops import modeac as jax_modeac
from readsb_tpu_torch.decode import mode_ac
from readsb_tpu_torch.ops import modeac
from readsb_tpu_torch.synth import CaptureBuilder
from tools.synth import CaptureBuilder as ToolsCaptureBuilder

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

SCAN = 262144
CODES = [0x1200, 0x7700, 0x0030, 0x2644]


def _replies(make, seed=11):
    cap = make(duration_s=0.12, noise_rms=0.012, seed=seed)
    for i, t in enumerate(np.linspace(0.005, 0.105, 30)):
        cap.add_modeac(CODES[i % 4], float(t), amplitude=0.3 + 0.01 * i, phase=(i * 0.07) % 1)
    return cap


def _buf(mag: np.ndarray) -> np.ndarray:
    out = np.zeros(SCAN + 326, np.uint16)
    out[326 : 326 + len(mag)] = mag[:SCAN]
    return out


@pytest.fixture(scope="module")
def reply_buf():
    raw = _replies(CaptureBuilder).render_uc8()
    return _buf(np.asarray(jax_convert.mag_uc8(jnp.asarray(raw))))


@pytest.fixture(scope="module")
def pulse_buf():
    """Noise with many pulse pairs 48-50 samples apart: tens of thousands of
    F1 candidates up to the end of the scan, where float32 clock steps are
    0.5 and the reference's fused multiply-add shows."""
    rng = np.random.default_rng(3)
    mag = np.abs(rng.normal(0, 800, SCAN + 326)).astype(np.uint16)
    pos = rng.integers(400, SCAN - 200, 15000)
    amp = rng.integers(3000, 30000, 15000)
    for d in (0, 1, 48, 49, 50):
        mag[pos + d] = np.maximum(mag[pos + d], (amp * rng.uniform(0.3, 1.0, 15000)).astype(np.uint16))
    return mag


def _hold(buf, noise, k):
    want = jax_modeac.modeac_block(jnp.asarray(buf), jnp.int32(noise), k=k, scan_len=SCAN)
    got = modeac.modeac_block(torch.from_numpy(buf.copy()), noise, k=k, scan_len=SCAN)
    for field in modeac.ModeACCandidates._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == {np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}[w.dtype]
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{field} noise={noise} k={k}")
    return got


def test_synth_modeac_equals_tools():
    a, b = _replies(CaptureBuilder), _replies(ToolsCaptureBuilder)
    np.testing.assert_array_equal(a.env, b.env)
    assert a.truth == b.truth
    np.testing.assert_array_equal(a.render_iq(), b.render_iq())


def test_synth_sc16_file_equals_tools(tmp_path):
    a, b = _replies(CaptureBuilder, seed=5), _replies(ToolsCaptureBuilder, seed=5)
    a.write_sc16(str(tmp_path / "a.dat"))
    b.write_sc16(str(tmp_path / "b.dat"))
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    raw = np.frombuffer((tmp_path / "a.dat").read_bytes(), "<i2")
    assert len(raw) == 2 * a.n and np.abs(raw).max() > 5000


@pytest.mark.parametrize("noise,k", [(600, 512), (600, 64), (1500, 512), (200, 512)])
def test_modeac_block_equals_jax_on_replies(reply_buf, noise, k):
    got = _hold(reply_buf, noise, k)
    if noise == 1500:
        assert int(got.ok.sum()) >= 10
    if k == 64:
        assert int(got.n_cand) > k  # the first k in order, and n_cand tells


@pytest.mark.parametrize("noise,k", [(300, 32768), (300, 1024), (900, 32768)])
def test_modeac_block_equals_jax_on_dense_pulses(pulse_buf, noise, k):
    got = _hold(pulse_buf, noise, k)
    assert int(got.n_cand) > 5000


def test_modeac_block_equals_jax_on_noise_alone():
    rng = np.random.default_rng(41)
    buf = np.abs(rng.normal(0, 900, SCAN + 326)).astype(np.uint16)
    got = _hold(buf, 700, 512)
    assert int(got.n_cand) > 0 and int(got.ok.sum()) <= 2  # chance decodes only


def test_modeac_block_rejects_short_buffer():
    with pytest.raises(ValueError):
        modeac.modeac_block(torch.zeros(1000, dtype=torch.uint16), 100, k=64, scan_len=1000)


def test_bit_permute_equals_jax():
    bits = np.arange(0, 1 << 20, 37, dtype=np.int32)
    np.testing.assert_array_equal(
        modeac._bit_permute(torch.from_numpy(bits)).numpy(),
        np.asarray(jax_modeac._bit_permute(jnp.asarray(bits))),
    )


def test_constants_equal_jax():
    for name in ("NUM_BITS", "BIT_CYCLES", "CYCLES_PER_SAMPLE", "F2_OFFSET_CYCLES",
                 "FRAME_SAMPLES", "FRAMING_MASK", "QUIET_MASK", "SQRT2"):
        assert getattr(modeac, name) == getattr(jax_modeac, name), name


def test_decode_modeac_message_equals_jax():
    for code in list(range(0, 0x8000, 97)) + [0x1200 | 0x0080, 0x0030, 0x7700, 0x7777]:
        a = mode_ac.decode_modeac_message(code, timestamp=12345, sys_timestamp_ms=7)
        b = jax_mode_ac.decode_modeac_message(code, timestamp=12345, sys_timestamp_ms=7)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), hex(code)
    for modec in range(-12, 4083, 5):
        assert mode_ac.modec_to_modea(modec) == jax_mode_ac.modec_to_modea(modec)


def test_finalize_modeac_equals_jax(reply_buf):
    got = modeac.modeac_block(torch.from_numpy(reply_buf.copy()), 1500, k=512, scan_len=SCAN)
    args = (got.offsets.numpy(), got.ok.numpy(), got.modeac.numpy(), got.f2_clock.numpy(),
            int(got.n_cand))
    a = mode_ac.finalize_modeac(*args, scan_len=SCAN, block_scan_start=1000)
    b = jax_mode_ac.finalize_modeac(*args, scan_len=SCAN, block_scan_start=1000)
    assert a == b and len(a) >= 10
    assert {code & 0x7777 for code, _, _ in a} <= set(CODES)
