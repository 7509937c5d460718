"""Bytes each kernel needs, and the least time they take at the card's peak.

The arithmetic behind PERF.md's bound column (first written for the
table of kernels): each input byte read once, each output byte written
once.  The buffer lengths follow the program's layout (MultiDemodulator:
C segments of S + SEG_PAD samples plus SEG_PAD; the raw route adds
RAW_PAD words; both round up to the dense scan's 65536-sample granule).
"""

from __future__ import annotations

SEG_PAD = 512
RAW_PAD = 512
TILE = 65536


def scan_samples(cfg: dict) -> int:
    """Samples one dense-scan launch covers at this configuration."""
    seg = int(cfg["block_samples"]) * int(cfg["blocks_per_batch"]) + SEG_PAD
    n = int(cfg["channels"]) * seg + SEG_PAD
    if cfg["fmt"] == "uc8":
        n += RAW_PAD
    return -(-n // TILE) * TILE


def scan_bytes(n: int) -> int:
    """Dense scan of n samples: uint16 in; int8 correlation bits, five
    sign planes of n/32 int32 words, two int32 prefix sums out
    (98.3 MB at n = 8,454,144)."""
    return n * 2 + n + 5 * (n // 32) * 4 + 2 * n * 4


def extract_bytes(k: int) -> int:
    """Extraction of k candidates: a 128-word int32 row and an int32
    offset in, a 128-word int32 row out (134.7 MB at k = 131,072)."""
    return k * (128 * 4 + 4 + 128 * 4)
