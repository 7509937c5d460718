"""Mode-S CRC-24 (generator 0xFFF409) as GF(2) linear algebra.

The syndrome of a message is the remainder of its data bits XOR its
trailing 24 parity bits; it is linear in the message bits, so it is the
XOR of the per-bit syndromes of the set bits.  Shared by the traffic
generator and the reference demodulator.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0xFFF409


@functools.lru_cache(maxsize=None)
def _byte_table() -> tuple[int, ...]:
    tab = []
    for i in range(256):
        c = i << 16
        for _ in range(8):
            c = ((c << 1) ^ POLY) & 0xFFFFFF if c & 0x800000 else (c << 1) & 0xFFFFFF
        tab.append(c)
    return tuple(tab)


def checksum(msg: bytes, bits: int) -> int:
    """Syndrome of one message of `bits` bits (remainder XOR parity)."""
    tab = _byte_table()
    n = bits // 8
    rem = 0
    for i in range(n - 3):
        rem = ((rem << 8) & 0xFFFFFF) ^ tab[msg[i] ^ (rem >> 16)]
    return (rem ^ int.from_bytes(msg[n - 3 : n], "big")) & 0xFFFFFF


@functools.lru_cache(maxsize=None)
def bit_syndromes(bits: int) -> np.ndarray:
    """int64[bits]: the syndrome of a message with only bit i set."""
    out = np.zeros(bits, dtype=np.int64)
    for i in range(bits):
        msg = bytearray(bits // 8)
        msg[i >> 3] = 1 << (7 - (i & 7))
        out[i] = checksum(bytes(msg), bits)
    return out


@functools.lru_cache(maxsize=None)
def syndrome_matrix(bits: int) -> np.ndarray:
    """float32[bits, 24]: bit j (MSB first) of each per-bit syndrome.  A 0/1
    bit row times this matrix gives counts whose parity is the syndrome."""
    syn = bit_syndromes(bits)
    return np.stack([(syn >> (23 - j)) & 1 for j in range(24)], axis=1).astype(np.float32)


def pack24(parity: np.ndarray) -> np.ndarray:
    """(..., 24) 0/1 -> (...) int64, MSB first."""
    w = (1 << np.arange(23, -1, -1)).astype(np.int64)
    return (np.asarray(parity, dtype=np.int64) * w).sum(-1)


@functools.lru_cache(maxsize=None)
def single_error_table(bits: int) -> dict[int, int]:
    """syndrome -> bit index of a one-bit error in bits 5..bits-1 (the DF
    field is never corrected); syndromes shared by two positions dropped."""
    syn = bit_syndromes(112)
    offset = 112 - bits  # a short message's bits sit at the tail of the basis
    seen: dict[int, list[int]] = {}
    for i in range(5, bits):
        seen.setdefault(int(syn[i + offset]), []).append(i)
    return {s: b[0] for s, b in seen.items() if len(b) == 1}
