"""UC8 IQ -> magnitude conversion (the raw-UC8 route's part of convert).

Behavioral contract matches the reference (wiedehopf/readsb convert.c):
mag = round(65535 * sqrt(min(1, ((I-127.5)/127.5)^2 + ((Q-127.5)/127.5)^2)))
via a 256x256 uint16 LUT (convert.c:35-62).  The dense-scan kernel
(csrc/dense_scan_uc8.cu) evaluates the same float32 expression per sample
and is held to this LUT on all 65536 pairs.
"""

from __future__ import annotations

import functools

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


def mag_uc8(iq: torch.Tensor) -> torch.Tensor:
    """UC8 interleaved bytes (2N,) uint8 -> (N,) uint16 magnitudes."""
    lut = torch.from_numpy(uc8_lut_np().astype(np.int32)).to(iq.device)
    pairs = iq.reshape(-1, 2).to(torch.int64)
    return lut[pairs[:, 0] * 256 + pairs[:, 1]].to(torch.uint16)
