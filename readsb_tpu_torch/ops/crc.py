"""Mode-S CRC-24 as GF(2) linear algebra.

The Mode-S checksum is linear over GF(2): the syndrome of a message is the
XOR of per-bit syndrome contributions.  The extraction kernel
(csrc/extract_syndromes.cu) XORs the rows of `single_bit_syndromes`;
error diagnosis is a lookup into a sorted syndrome table.

Behavioral contract matches the reference (wiedehopf/readsb crc.c):
- generator polynomial 0xFFF409, MSB-first, syndrome = remainder over the
  data bits XORed with the trailing 24-bit parity field (crc.c:67-82)
- error tables cover 1-bit errors (default) or 2-bit (aggressive) in bits
  5..n only — the 5 DF bits are never corrected (crc.c:211)
- syndrome 0 -> "no errors"; unknown syndrome -> uncorrectable
  (crc.c:383-406)
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import CRC24_POLY, MODES_LONG_MSG_BITS, MODES_SHORT_MSG_BITS

# ---------------------------------------------------------------------------
# Scalar/byte-wise reference implementation (host, numpy)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _byte_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i << 16
        for _ in range(8):
            if c & 0x800000:
                c = ((c << 1) ^ CRC24_POLY) & 0xFFFFFF
            else:
                c = (c << 1) & 0xFFFFFF
        tab[i] = c
    return tab


def checksum(msg: bytes | np.ndarray, bits: int) -> int:
    """Syndrome of one message (remainder XOR parity field)."""
    tab = _byte_table()
    msg = np.asarray(bytearray(msg), dtype=np.uint8) if isinstance(msg, (bytes, bytearray)) else msg
    n = bits // 8
    rem = 0
    for i in range(n - 3):
        rem = ((rem << 8) & 0xFFFFFF) ^ int(tab[int(msg[i]) ^ (rem >> 16)])
    rem ^= (int(msg[n - 3]) << 16) | (int(msg[n - 2]) << 8) | int(msg[n - 1])
    return rem & 0xFFFFFF


def checksum_batch(msgs: np.ndarray, bits: int) -> np.ndarray:
    """Vectorized syndrome of (N, nbytes) uint8 messages."""
    tab = _byte_table()
    msgs = np.atleast_2d(msgs)
    n = bits // 8
    rem = np.zeros(len(msgs), dtype=np.uint32)
    for i in range(n - 3):
        rem = ((rem << 8) & 0xFFFFFF) ^ tab[msgs[:, i] ^ (rem >> 16)]
    rem ^= (msgs[:, n - 3].astype(np.uint32) << 16) ^ (msgs[:, n - 2].astype(np.uint32) << 8) ^ msgs[:, n - 1]
    return rem & 0xFFFFFF


# ---------------------------------------------------------------------------
# GF(2) linear form: per-bit syndrome contributions
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def single_bit_syndromes(bits: int = 112) -> np.ndarray:
    """syndromes[i] = checksum of an all-zero message with only bit i set."""
    out = np.zeros(bits, dtype=np.uint32)
    msg = np.zeros(bits // 8, dtype=np.uint8)
    for i in range(bits):
        msg[i >> 3] ^= 1 << (7 - (i & 7))
        out[i] = checksum(msg, bits)
        msg[i >> 3] ^= 1 << (7 - (i & 7))
    return out


@functools.lru_cache(maxsize=None)
def syndrome_matrix(bits: int = 112) -> np.ndarray:
    """(bits, 24) int8 matrix M with syndrome = pack24((msg_bits @ M) & 1).

    Column j is the j-th bit (MSB first) of the per-bit syndrome.
    """
    syn = single_bit_syndromes(bits)
    cols = [(syn >> (23 - j)) & 1 for j in range(24)]
    return np.stack(cols, axis=1).astype(np.int8)


# ---------------------------------------------------------------------------
# Error-correction tables (1-bit default / 2-bit aggressive)
# ---------------------------------------------------------------------------


class ErrorTable:
    """Sorted syndrome -> error-bit-pattern table for one message length.

    Mirrors readsb's prepareErrorTable semantics: errors only in bits
    5..nbits, exact-collision entries dropped, and (for max_correct=2)
    syndromes that collide with any 3..4-bit error pattern dropped too.
    """

    def __init__(self, bits: int, max_correct: int = 1, max_detect: int | None = None):
        if max_detect is None:
            max_detect = 1 if max_correct == 1 else 4
        self.bits = bits
        self.max_correct = max_correct
        syn112 = single_bit_syndromes(112)
        offset = 112 - bits  # short messages use the tail of the 112-bit basis

        entries: list[tuple[int, int, int, int]] = []  # (syndrome, nerrors, bit0, bit1)
        for i in range(5, bits):
            s1 = int(syn112[i + offset])
            entries.append((s1, 1, i, -1))
            if max_correct >= 2:
                for j in range(i + 1, bits):
                    entries.append((s1 ^ int(syn112[j + offset]), 2, i, j))

        entries.sort(key=lambda e: e[0])
        # drop exact collisions (all entries sharing a syndrome)
        dedup: list[tuple[int, int, int, int]] = []
        i = 0
        while i < len(entries):
            j = i
            while j + 1 < len(entries) and entries[j + 1][0] == entries[i][0]:
                j += 1
            if j == i:
                dedup.append(entries[i])
            i = j + 1

        if max_detect > max_correct and dedup:
            syns = np.array([e[0] for e in dedup], dtype=np.uint32)
            bad = np.zeros(len(dedup), dtype=bool)
            # Flag syndromes reachable by any (max_correct+1..max_detect)-bit
            # strictly-increasing error combination.  Enumerate per max-bit to
            # keep i<j<k<l semantics without repeated indices.
            base = syn112[offset + 5 : offset + bits].astype(np.uint32)
            nb = len(base)
            # combos_by_max[k] = syndromes of all r-combos whose largest bit is k
            prev_by_max: list[np.ndarray] = [np.array([base[k]], dtype=np.uint32) for k in range(nb)]
            for order in range(2, max_detect + 1):
                cur_by_max: list[np.ndarray] = []
                acc = np.zeros(0, dtype=np.uint32)  # all (order-1)-combos with maxbit < k
                for k in range(nb):
                    cur_by_max.append(acc ^ base[k] if len(acc) else acc.copy())
                    acc = np.concatenate([acc, prev_by_max[k]])
                prev_by_max = cur_by_max
                if order > max_correct:
                    all_syn = np.unique(np.concatenate(cur_by_max)) if nb else np.zeros(0, np.uint32)
                    bad |= np.isin(syns, all_syn)
            dedup = [e for e, b in zip(dedup, bad) if not b]

        self.syndromes = np.array([e[0] for e in dedup], dtype=np.uint32)
        self.nerrors = np.array([e[1] for e in dedup], dtype=np.int8)
        self.bit0 = np.array([e[2] for e in dedup], dtype=np.int32)
        self.bit1 = np.array([e[3] for e in dedup], dtype=np.int32)

    def diagnose(self, syndromes: np.ndarray):
        """Vectorized lookup.

        Returns (nerrors, bit0, bit1): nerrors = 0 for syndrome 0,
        -1 for uncorrectable, else 1 or 2 with the error bit indices.
        """
        syndromes = np.asarray(syndromes, dtype=np.uint32)
        idx = np.searchsorted(self.syndromes, syndromes)
        idx = np.clip(idx, 0, max(len(self.syndromes) - 1, 0))
        if len(self.syndromes):
            hit = self.syndromes[idx] == syndromes
        else:
            hit = np.zeros(syndromes.shape, dtype=bool)
        nerr = np.where(hit, self.nerrors[idx] if len(self.syndromes) else 0, -1).astype(np.int8)
        b0 = np.where(hit, self.bit0[idx] if len(self.syndromes) else -1, -1)
        b1 = np.where(hit, self.bit1[idx] if len(self.syndromes) else -1, -1)
        zero = syndromes == 0
        return (
            np.where(zero, 0, nerr).astype(np.int8),
            np.where(zero, -1, b0).astype(np.int32),
            np.where(zero, -1, b1).astype(np.int32),
        )


@functools.lru_cache(maxsize=None)
def error_table(bits: int, max_correct: int = 1) -> ErrorTable:
    return ErrorTable(bits, max_correct)


def fix_message(msg: np.ndarray, bit0: int, bit1: int = -1) -> np.ndarray:
    """Return a copy of msg with the given error bits flipped."""
    out = msg.copy()
    for b in (bit0, bit1):
        if b >= 0:
            out[b >> 3] ^= 1 << (7 - (b & 7))
    return out


def correct_aa_field(addr: int, bit0: int, bit1: int = -1) -> int:
    """Apply error bits that fall inside the AA field (bits 8..31) to addr
    (mode_s.c:230-245)."""
    for b in (bit0, bit1):
        if 8 <= b <= 31:
            addr ^= 1 << (31 - b)
    return addr


SHORT_BITS = MODES_SHORT_MSG_BITS
LONG_BITS = MODES_LONG_MSG_BITS
