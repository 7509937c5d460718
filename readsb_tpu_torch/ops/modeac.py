"""Mode A/C (SSR transponder) demodulation as a dense batch pass (PyTorch).

Behavioral contract mirrors the reference demodulator (wiedehopf/readsb
demod_2400.c:575-761, `demodulate2400AC`) and readsb_tpu.ops.modeac, as
the same two-stage dense pattern as the Mode-S demodulator:

  stage 1  dense per-offset F1 framing-pulse pre-check over the block
           (rising edge, quiet third sample, 6 dB above noise)
  stage 2  fixed-K compaction, then per-candidate fractional clock
           estimation, F2 framing-pulse check 14 bit-periods later, and
           a 20-bit slice on the virtual 60 MHz clock (25 cycles/sample,
           87 cycles/bit) with geometric-mean +-3 dB thresholds
  stage 3  (host) the serial "skip one frame after accept" rule, which
           is the only sequential part (decode.mode_ac.finalize_modeac)

Numerology is kept bit-compatible with the reference:
- noise_level = (mean_power + stddev) * 65535 (demod_2400.c:580-581)
- F1/F2: m[s-1] < m[s], m[s+2] <= max gate, level = (m[s]+m[s+1])/2,
  2*noise_level <= level (631-669)
- clock phase from the power split of the two F1 samples: fraction^2 of a
  sample period (644-650), f2_clock = f1_clock + 87*14
- thresholds: midpoint = sqrt(noise_level * max(f1,f2)_level),
  on >= midpoint*sqrt(2), off <= midpoint/sqrt(2) (673-679)
- framing mask 0x80020 set, quiet mask 0x0101B clear, no noisy or
  uncertain bits (706-718)

The float32 steps are eager tensor ops in the reference's order, one
rounding each, with truncating casts, except where readsb_tpu's compiled
program rounds once (the clock's multiply-add) or multiplies by a rounded
reciprocal (the division by sqrt(2)): the CPU and the card give the same
bits, and both give readsb_tpu's.

The scan is a single global grid over the superblock with offset 0
masked, so a candidate at an exact 131072-sample boundary is judged once
rather than skipped, as in readsb_tpu.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .convert import sqrt_f32
from .demod import first_k

NUM_BITS = 20
BIT_CYCLES = 87  # 1.45 us on the virtual 60 MHz clock
CYCLES_PER_SAMPLE = 25  # 2.4 MS/s sample on the 60 MHz clock
F2_OFFSET_CYCLES = BIT_CYCLES * 14  # F2 is 14 bit periods after F1
FRAME_SAMPLES = NUM_BITS * BIT_CYCLES // CYCLES_PER_SAMPLE  # 69: skip after accept

FRAMING_MASK = 0x80020  # F1 and F2 must be on
QUIET_MASK = 0x0101B  # X1..X5 quiet bits must be off

SQRT2 = 1.4142135623730951
# float32 constants of the threshold arithmetic: sqrt(2), and its
# reciprocal (the division by sqrt(2) is a product with the rounded
# reciprocal, as the XLA build of readsb_tpu evaluates it)
_SQRT2_F32 = float(np.float32(SQRT2))
_INV_SQRT2_F32 = float(np.float32(1.0) / np.float32(SQRT2))


class ModeACCandidates(NamedTuple):
    """Device outputs for one block of Mode A/C detection (fixed K)."""

    offsets: torch.Tensor  # int32[K] scan offsets (ascending; sentinel = scan_len)
    n_cand: torch.Tensor  # int32[] true F1-candidate count (overflow if > K)
    ok: torch.Tensor  # bool[K] candidate passed all stage-2 gates
    modeac: torch.Tensor  # int32[K] decoded 00A4..D1 hex-style code
    f2_clock: torch.Tensor  # int32[K] 60 MHz clock of F2 relative to buf[0]


_PERMUTE_PAIRS = (
    (0x40000, 0x0010),  # C1
    (0x20000, 0x1000),  # A1
    (0x10000, 0x0020),  # C2
    (0x08000, 0x2000),  # A2
    (0x04000, 0x0040),  # C4
    (0x02000, 0x4000),  # A4
    (0x00800, 0x0100),  # B1
    (0x00400, 0x0001),  # D1
    (0x00200, 0x0200),  # B2
    (0x00100, 0x0002),  # D2
    (0x00080, 0x0400),  # B4
    (0x00040, 0x0004),  # D4
    (0x00004, 0x0080),  # SPI
)


def _bit_permute(bits: torch.Tensor) -> torch.Tensor:
    """20-bit raw frame -> hex-style 00A4A2A1 00B4B2B1 SPIC4C2C1 00D4D2D1
    (demod_2400.c:722-736)."""
    out = torch.zeros_like(bits)
    for src, dst in _PERMUTE_PAIRS:
        out = out | (((bits & src) != 0).to(bits.dtype) * dst)
    return out


def modeac_block(
    buf: torch.Tensor,
    noise_level: int,
    *,
    k: int = 512,
    scan_len: int,
) -> ModeACCandidates:
    """Detect Mode A/C replies in one magnitude block.

    buf: uint16[>= scan_len + 76] magnitudes; scan offsets 0..scan_len-1.
    noise_level: int, (mean_power + stddev) * 65535 of the block.
    """
    if buf.shape[0] < scan_len + 76:
        raise ValueError(f"buffer of {buf.shape[0]} samples is short for scan_len {scan_len}")
    m = buf.to(torch.int32)
    noise = int(noise_level)

    def at(i):
        return m[i : i + scan_len]

    # stage 1: dense F1 pre-check; m[s-1] through a right-shifted view
    # (offset 0 is masked below)
    prev = torch.cat([m[:1], m[: scan_len - 1]])
    s0, s1, s2 = at(0), at(1), at(2)

    rising = prev < s0
    quiet = (s2 <= s0) & (s2 <= s1)
    f1_level = (s0 + s1) >> 1
    loud = 2 * noise <= f1_level

    # dense F2 pre-gate: the stage-2 clock math puts f2_sample at exactly
    # s+48 or s+49, so requiring the full F2 gate at either position is a
    # lossless candidate filter before compaction
    def f2_gate(d: int):
        a, b, c, p = at(d), at(d + 1), at(d + 2), at(d - 1)
        return (p < a) & (c <= a) & (c <= b) & (2 * noise <= ((a + b) >> 1))

    cand = rising & quiet & loud & (f2_gate(48) | f2_gate(49))
    cand[0] = False  # reference scan starts at offset 1
    n_cand = cand.sum(dtype=torch.int32)

    offsets = first_k(cand, k, scan_len)
    safe = offsets.clamp(max=scan_len - 1).to(torch.int64)

    # stage 2: per-candidate fractional clock, F2 gate, 20-bit slice
    f1a = m[safe].to(torch.float32)
    f1b = m[safe + 1].to(torch.float32)
    f1a_pow = f1a * f1a
    f1b_pow = f1b * f1b
    fraction = f1b_pow / (f1a_pow + f1b_pow + 1e-30)
    frac_sq = fraction * fraction
    # 25 * s + 0.5 is one fused multiply-add in readsb_tpu's compiled
    # program (one rounding, which shows from s >= 2^17 on, where float32
    # steps are 0.5); the float64 product and sum are exact, so rounding
    # them once to float32 is that FMA on every device
    s_f32 = safe.to(torch.float32) + frac_sq
    clock_f = (s_f32.to(torch.float64) * float(CYCLES_PER_SAMPLE) + 0.5).to(torch.float32)
    f1_clock = clock_f.to(torch.int32).to(torch.int64)
    f2_clock = f1_clock + F2_OFFSET_CYCLES
    f2_sample = f2_clock // CYCLES_PER_SAMPLE

    f2m0 = m[f2_sample]
    f2m1 = m[f2_sample + 1]
    f2m2 = m[f2_sample + 2]
    f2_rising = m[f2_sample - 1] < f2m0
    f2_quiet = (f2m2 <= f2m0) & (f2m2 <= f2m1)
    f2_level = (f2m0 + f2m1) >> 1
    f2_loud = 2 * noise <= f2_level
    f2_ok = f2_rising & f2_quiet & f2_loud

    f1f2 = torch.maximum((m[safe] + m[safe + 1]) >> 1, f2_level)
    midpoint = sqrt_f32(float(np.float32(noise)) * f1f2.to(torch.float32))
    signal_threshold = (midpoint * _SQRT2_F32 + 0.5).to(torch.int32)
    noise_threshold = (midpoint * _INV_SQRT2_F32 + 0.5).to(torch.int32)

    # slice 20 bits at 87-cycle spacing
    bit_clocks = f1_clock[:, None] + BIT_CYCLES * torch.arange(
        NUM_BITS, dtype=torch.int64, device=buf.device
    )
    bit_samples = bit_clocks // CYCLES_PER_SAMPLE  # (K, 20)
    b0 = m[bit_samples]
    b1 = m[bit_samples + 1]
    b2 = m[bit_samples + 2]

    st = signal_threshold[:, None]
    nt = noise_threshold[:, None]
    noisy = b2 >= st
    on = (b0 >= st) | (b1 >= st)
    uncertain = (~on) & (b0 > nt) & (b1 > nt)

    weights = 1 << torch.arange(NUM_BITS - 1, -1, -1, dtype=torch.int32, device=buf.device)
    bits = torch.where(on, weights, 0).sum(-1, dtype=torch.int32)

    frame_ok = (
        f2_ok
        & ((bits & FRAMING_MASK) == FRAMING_MASK)
        & ((bits & QUIET_MASK) == 0)
        & ~noisy.any(-1)
        & ~uncertain.any(-1)
        & (offsets < scan_len)
    )

    return ModeACCandidates(
        offsets=offsets,
        n_cand=n_cand,
        ok=frame_ok,
        modeac=_bit_permute(bits),
        f2_clock=f2_clock.to(torch.int32),
    )
