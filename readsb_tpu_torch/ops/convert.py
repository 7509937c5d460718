"""IQ -> magnitude conversion.

Behavioral contract matches the reference (wiedehopf/readsb convert.c):
- UC8: mag = round(65535 * sqrt(min(1, ((I-127.5)/127.5)^2 + ((Q-127.5)/127.5)^2)))
  via a 256x256 uint16 LUT (convert.c:35-62); mean_level = sum(mag)/65536/n,
  mean_power = sum(mag^2)/65535^2/n (convert.c:101-107)
- SC16: fI = I/32768 (convert.c:227-241); SC16Q11: fI = I/2048 clamped
- optional 1-pole DC-block IIR: z1 += (f - z1) * a (convert.c:443-485),
  carried across blocks by the caller

The CUDA kernels (csrc/mag_uc8.cu, csrc/dense_scan_uc8.cu) evaluate the
UC8 float32 expression per sample and are held to the LUT on all 65536
pairs.  The sc16 converters are eager float32 tensor ops, one rounding per
op (nothing here may be fused into an FMA) and a correctly rounded square
root (sqrt_f32), so the CPU and the card give the same bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def sq_table_np() -> np.ndarray:
    """f32[256]: fi^2 with fi = f32((i - 127.5) / 127.5) (convert.c:45-50)."""
    i = np.arange(256, dtype=np.float64)
    fi = ((i - 127.5) / 127.5).astype(np.float32)
    return fi * fi


@functools.lru_cache(maxsize=None)
def uc8_lut_np() -> np.ndarray:
    """65536-entry uint16 LUT indexed by I * 256 + Q (symmetric in I/Q).

    Emulates the reference's float32 evaluation order exactly
    (convert.c:45-58): fI rounded to f32 from the double quotient, f32
    products/sum, sqrtf, f32 scale + 0.5, truncating cast.
    """
    sq = sq_table_np()
    magsq = np.minimum(sq[:, None] + sq[None, :], np.float32(1.0))  # f32
    mag = np.sqrt(magsq)  # f32, correctly rounded like sqrtf
    return (mag * np.float32(65535.0) + np.float32(0.5)).astype(np.uint16).reshape(-1)


def _lut_gather(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int32 magnitudes of int64 I and Q byte values, by the LUT."""
    lut = torch.from_numpy(uc8_lut_np().astype(np.int32)).to(i.device)
    return lut[i * 256 + q]


def mag_uc8_words_i32(words: torch.Tensor) -> torch.Tensor:
    """UC8 words (one I/Q pair per uint16, I in the low byte) -> int32
    magnitudes, by the LUT gather."""
    w = words.to(torch.int64)
    return _lut_gather(w & 0xFF, w >> 8)


def mag_uc8_words(words: torch.Tensor) -> torch.Tensor:
    """UC8 words uint16[N] -> uint16[N] magnitudes (the LUT gather)."""
    return mag_uc8_words_i32(words).to(torch.uint16)


def mag_uc8(iq: torch.Tensor) -> torch.Tensor:
    """UC8 interleaved bytes (2N,) uint8 -> (N,) uint16 magnitudes."""
    pairs = iq.reshape(-1, 2).to(torch.int64)
    return _lut_gather(pairs[:, 0], pairs[:, 1]).to(torch.uint16)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.  torch's
    vectorised float32 sqrt on the CPU is off by one unit in the last place
    for some inputs; the float64 root rounded once to float32 is exact
    (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _mag_from_float(fi: torch.Tensor, fq: torch.Tensor) -> torch.Tensor:
    magsq = torch.clamp(fi * fi + fq * fq, max=1.0)
    mag = sqrt_f32(magsq)
    scaled = mag * 65535.0
    return (scaled + 0.5).to(torch.int32).to(torch.uint16)  # truncation


def mag_sc16(iq: torch.Tensor) -> torch.Tensor:
    """SC16 interleaved int16 (2N,) -> (N,) uint16 magnitudes."""
    pairs = iq.reshape(-1, 2).to(torch.float32) * (1.0 / 32768.0)
    return _mag_from_float(pairs[:, 0], pairs[:, 1])


def mag_sc16q11(iq: torch.Tensor) -> torch.Tensor:
    """SC16Q11 interleaved int16 (2N,) -> (N,) uint16 magnitudes."""
    pairs = iq.reshape(-1, 2).to(torch.float32) * (1.0 / 2048.0)
    return _mag_from_float(pairs[:, 0], pairs[:, 1])


def block_sums(mag: torch.Tensor) -> torch.Tensor:
    """int64[..., 2]: exact (sum(mag), sum(mag^2)) over the last axis.

    Integer sums are the same on every device and in every order, which
    float32 sums are not; callers divide on the host (level_power)."""
    m = mag.to(torch.int64)
    return torch.stack([m.sum(-1), (m * m).sum(-1)], dim=-1)


def level_power(sums: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(mean_level, mean_power) in [0, 1] units from block_sums of n samples."""
    s = np.asarray(sums, dtype=np.float64)
    n = max(int(n), 1)
    return s[..., 0] / 65536.0 / n, s[..., 1] / (65535.0 * 65535.0) / n


def block_stats(mag: torch.Tensor) -> tuple[float, float]:
    """(mean_level, mean_power) of a magnitude block, in [0,1] units."""
    level, power = level_power(block_sums(mag).cpu().numpy(), mag.shape[-1])
    return float(level), float(power)


# ---------------------------------------------------------------------------
# DC-block IIR as a log-depth scan (cross-block state carried by the caller)
# ---------------------------------------------------------------------------


def dc_filter_coeff(sample_rate: float) -> float:
    """1-pole DC block @ 1 Hz: a = 1 - exp(-2*pi/fs) (convert.c:477-480)."""
    return 1.0 - math.exp(-2.0 * math.pi / sample_rate)


def dc_block(f: torch.Tensor, z0, a: float) -> tuple[torch.Tensor, torch.Tensor]:
    """y[n] = f[n] - z[n],  z[n] = (1-a) z[n-1] + a f[n].

    The recurrence is a scan over affine maps with one constant slope
    b = 1 - a, so doubling the span of every partial sum log2(n) times
    gives all z[n] in float32 tensor ops: after the step of span s,
    acc[i] = sum_{j > i - 2s} b^(i-j) a f[j].  Returns (y, z_last).
    """
    b = 1.0 - a
    n = f.shape[0]
    f32 = f.to(torch.float32)
    acc = a * f32
    s = 1
    while s < n:
        acc = torch.cat([acc[:s], acc[s:] + (b**s) * acc[:-s]])
        s *= 2
    powers = torch.pow(
        torch.tensor(b, dtype=torch.float64, device=f.device),
        torch.arange(1, n + 1, dtype=torch.float64, device=f.device),
    ).to(torch.float32)
    z = powers * torch.as_tensor(z0, dtype=torch.float32, device=f.device) + acc
    return f32 - z, z[-1]


def mag_with_dc(iq: torch.Tensor, z1: torch.Tensor, fmt: str, sample_rate: float = 2.4e6):
    """Full conversion with DC filter; z1 is shape (2,) float32 carry state."""
    if fmt == "uc8":
        pairs = (iq.reshape(-1, 2).to(torch.float32) - 127.5) * (1.0 / 127.5)
    else:
        scale = {"sc16": 1.0 / 32768.0, "sc16q11": 1.0 / 2048.0}[fmt]
        pairs = iq.reshape(-1, 2).to(torch.float32) * scale
    a = dc_filter_coeff(sample_rate)
    yi, zi = dc_block(pairs[:, 0], z1[0], a)
    yq, zq = dc_block(pairs[:, 1], z1[1], a)
    return _mag_from_float(yi, yq), torch.stack([zi, zq])


CONVERTERS = {
    "uc8": mag_uc8,
    "sc16": mag_sc16,
    "sc16q11": mag_sc16q11,
}
