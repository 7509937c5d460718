"""Candidate scoring / acceptance / non-max suppression.

This is stage 5 of the demod pipeline: the only inherently *sequential*
part of Mode-S demodulation (the "skip past an accepted message" rule and
the ICAO-filter feedback loop).  It operates on the tiny compacted
candidate set produced by ops.demod.demod_block, so it runs on host over
a few dozen rows per 131072-sample block.

Semantics mirror the reference exactly for frame-level parity:
- scoreModesMessage score table (mode_s.c:309-419)
- decodeModesMessage CRC handling / accept conditions (mode_s.c:443-596)
- fixDF17msgtype 1-bit DF repair (mode_s.c:276-301)
- the serial scan rules of demodulate2400 (demod_2400.c:264-472):
  candidates are visited in offset order, phases tried in order 4..8 with
  strictly-greater best selection, and an accepted message skips the scan
  to offset + msgbits*2 + 1.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from ..constants import HEX_UNKNOWN, TIMESTAMP_BIT56_TICKS
from ..ops import crc as crc_ops
from .icao import IcaoFilter

SHORT_GATE = frozenset((0, 4, 5, 11))
LONG_GATE_BASE = frozenset((16, 17, 18, 20, 21))
DF17_FIXABLE = frozenset((1, 25, 21, 19, 16))  # 1-bit damaged DF17 values


@functools.lru_cache(maxsize=None)
def df_delta_syndromes() -> np.ndarray:
    """delta[df] = syndrome change from rewriting the DF field to 17."""
    syn = crc_ops.single_bit_syndromes(112)
    out = np.zeros(32, dtype=np.uint32)
    for df in range(32):
        d = df ^ 17
        delta = 0
        for j in range(5):  # msg bit j is DF bit (4-j)
            if (d >> (4 - j)) & 1:
                delta ^= int(syn[j])
        out[df] = delta
    return out


@dataclasses.dataclass
class DemodStats:
    preambles: int = 0
    rejected_bad: int = 0
    rejected_unknown_icao: int = 0
    accepted: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    overflow_blocks: int = 0

    def accepted_total(self) -> int:
        return sum(self.accepted)


@dataclasses.dataclass
class RawFrame:
    """An accepted Mode-S frame (pre-tracking)."""

    msg: bytes  # corrected message, 7 or 14 bytes
    msgbits: int
    timestamp: int  # 12 MHz clock
    score: int
    phase: int  # winning try_phase (4..8)
    correctedbits: int
    addr: int
    signal_power: float  # mean power over the message, [0,1] FS units
    iid: int = 0
    scan_offset: int = 0  # global scan index (diagnostics)


def _aa(msg: np.ndarray) -> int:
    return (int(msg[1]) << 16) | (int(msg[2]) << 8) | int(msg[3])


class Scorer:
    """Stateful scorer: owns the ICAO filter and CRC error tables."""

    def __init__(self, nfix: int = 1, fix_df: bool = True):
        self.nfix = nfix
        self.fix_df = fix_df and nfix > 0
        self.icao = IcaoFilter()
        self.table_long = crc_ops.error_table(112, min(nfix, 2)) if nfix else None
        self.table_short = crc_ops.error_table(56, min(nfix, 2)) if nfix else None
        self.df_delta = df_delta_syndromes()
        self.long_gate = set(LONG_GATE_BASE)
        if self.fix_df:
            self.long_gate |= DF17_FIXABLE
        self.stats = DemodStats()

    # -- scoreModesMessage ---------------------------------------------------

    def score(self, msg: np.ndarray, validbits: int, syn112: int, syn56: int) -> int:
        msgtype = int(msg[0]) >> 3

        if validbits >= 112 and self.fix_df and msgtype in DF17_FIXABLE:
            if (syn112 ^ int(self.df_delta[msgtype])) == 0:
                return 900 if self.icao.test(_aa(msg)) else 700

        msgbits = 112 if msgtype >= 16 else 56
        if validbits < msgbits:
            return -2
        if not msg[:7].any():
            return -2

        crc = syn112 if msgbits == 112 else syn56

        if msgtype in (0, 4, 5, 16, 20, 21):
            return 1000 if self.icao.test(crc) else -1

        if msgtype == 11:
            iid = crc & 0x7F
            addr = _aa(msg)
            if crc & 0xFFFF80:
                if self.table_short is None:
                    return -2
                nerr, b0, b1 = self.table_short.diagnose(np.uint32(crc))
                nerr = int(nerr)
                if nerr < 0 or nerr > 1:
                    return -2
                addr = crc_ops.correct_aa_field(addr, int(b0), int(b1))
                return 800 if self.icao.test(addr) else -1
            if iid == 0:
                return 1600 if self.icao.test(addr) else 750
            return 1000 if self.icao.test(addr) else -1

        if msgtype in (17, 18):
            if crc == 0:
                nerr, b0, b1 = 0, -1, -1
            else:
                if self.table_long is None:
                    return -2
                nerr, b0, b1 = self.table_long.diagnose(np.uint32(crc))
                nerr = int(nerr)
                if nerr < 0:
                    return -2
            addr = crc_ops.correct_aa_field(_aa(msg), int(b0), int(b1))
            base = 1800 if self.icao.test(addr) else 1400
            return base // (nerr + 1)

        return -2

    # -- decodeModesMessage CRC/accept stage ---------------------------------

    def decode_accept(self, msg: np.ndarray, syn112: int, syn56: int) -> tuple[int, Optional[dict]]:
        """Returns (result, info).  result: 0 accepted, -1/-2 rejected.

        info (when accepted): corrected msg bytes, addr, correctedbits, iid.
        The ICAO-filter add side effect is applied here (mode_s.c:766-779).
        """
        msg = msg.copy()
        if not msg[:7].any():
            return -2, None

        msgtype = int(msg[0]) >> 3
        correctedbits = 0
        if self.fix_df and msgtype in DF17_FIXABLE and (syn112 ^ int(self.df_delta[msgtype])) == 0:
            msg[0] = (17 << 3) | (msg[0] & 7)
            syn112 = 0
            msgtype = 17
            correctedbits = 1

        msgbits = 112 if msgtype >= 16 else 56
        crc = syn112 if msgbits == 112 else syn56
        addr = HEX_UNKNOWN
        iid = 0

        if msgtype in (0, 4, 5, 16) or 24 <= msgtype <= 31:
            if not self.icao.test(crc):
                return -1, None
            addr = crc
        elif msgtype == 11:
            iid = crc & 0x7F
            if crc & 0xFFFF80:
                if self.table_short is None:
                    return -2, None
                nerr, b0, b1 = self.table_short.diagnose(np.uint32(crc))
                nerr = int(nerr)
                if nerr < 0 or nerr > 1:
                    return -2, None
                correctedbits = nerr
                iid = 0
                msg = crc_ops.fix_message(msg, int(b0), int(b1))
                if not self.icao.test(_aa(msg)):
                    return -1, None
            addr = _aa(msg)
        elif msgtype in (17, 18):
            if crc != 0:
                if self.table_long is None:
                    return -2, None
                nerr, b0, b1 = self.table_long.diagnose(np.uint32(crc))
                nerr = int(nerr)
                if nerr < 0:
                    return -2, None
                addr1 = _aa(msg)
                correctedbits = nerr
                msg = crc_ops.fix_message(msg, int(b0), int(b1))
                addr2 = _aa(msg)
                if addr1 != addr2 and not self.icao.test(addr2):
                    return -1, None
            addr = _aa(msg)
        elif msgtype in (20, 21):
            if not self.icao.test(crc):
                return -1, None
            addr = crc
        else:
            return -2, None

        # the only place addresses are learned (mode_s.c:778)
        if correctedbits == 0 and (msgtype == 17 or (msgtype == 11 and iid == 0)):
            self.icao.add(addr)

        return 0, {
            "msg": msg[: msgbits // 8],
            "msgbits": msgbits,
            "addr": addr,
            "correctedbits": correctedbits,
            "iid": iid,
            "msgtype": msgtype,
        }


def finalize_block(
    scorer: Scorer,
    offsets: np.ndarray,
    n_cand: int,
    corr_fired: np.ndarray,
    msg: np.ndarray,
    syn112: np.ndarray,
    syn56: np.ndarray,
    sigsum_long: np.ndarray,
    sigsum_short: np.ndarray,
    *,
    scan_len: int,
    block_scan_start: int = 0,
    carry_skip: int = 0,
    reset_every: int | None = None,
) -> tuple[list[RawFrame], int]:
    """Serial scoring + NMS over one (super)block's compacted candidates.

    Returns (accepted frames, skip carried past the end of this block).
    block_scan_start: global scan index of this block's offset 0 (used for
    timestamps: ts = (global_index * 5) + 768 + phase, matching the
    reference's block bookkeeping).
    reset_every: emulate the reference's per-SDR-buffer scan restart — an
    accepted message's skip never crosses a reset_every boundary
    (demodulate2400 restarts its pointer each mag_buf).  None disables
    (slightly better than the reference: no duplicate accepts at block
    seams when carry_skip is used).
    """
    st = scorer.stats
    if n_cand > len(offsets):
        st.overflow_blocks += 1

    frames: list[RawFrame] = []
    skip_until = carry_skip

    for i in range(len(offsets)):
        o = int(offsets[i])
        if o >= scan_len:
            break
        if o < skip_until:
            continue

        bestscore = -42
        best = None  # (phase_idx, validbits)
        phase_order = []
        if corr_fired[i, 0]:
            phase_order += [0, 1]  # try_phase 4, 5
        if corr_fired[i, 1]:
            phase_order += [2, 3]  # try_phase 6, 7
        if corr_fired[i, 2]:
            phase_order += [4]  # try_phase 8

        for p in phase_order:
            m_p = msg[i, p]
            df = int(m_p[0]) >> 3
            if df in scorer.long_gate:
                validbits = 112
            elif df in SHORT_GATE:
                validbits = 56
            else:
                if -2 > bestscore:
                    bestscore = -2
                continue
            s = scorer.score(m_p, validbits, int(syn112[i, p]), int(syn56[i, p]))
            if s > bestscore:
                bestscore = s
                best = p

        if bestscore == -42:
            continue
        st.preambles += 1
        if bestscore < 0:
            if bestscore == -1:
                st.rejected_unknown_icao += 1
            else:
                st.rejected_bad += 1
            continue

        p = best
        m_best = msg[i, p]
        msgbits = 112 if (int(m_best[0]) >> 3) >= 16 else 56
        result, info = scorer.decode_accept(m_best, int(syn112[i, p]), int(syn56[i, p]))
        if result < 0:
            if result == -1:
                st.rejected_unknown_icao += 1
            else:
                st.rejected_bad += 1
            continue

        st.accepted[min(info["correctedbits"], 2)] += 1
        gidx = block_scan_start + o
        siglen = msgbits * 12 // 5
        sigsum = sigsum_long[i] if msgbits == 112 else sigsum_short[i]
        frames.append(
            RawFrame(
                msg=bytes(info["msg"]),
                msgbits=info["msgbits"],
                timestamp=gidx * 5 + TIMESTAMP_BIT56_TICKS + (p + 4),
                score=bestscore,
                phase=p + 4,
                correctedbits=info["correctedbits"],
                addr=info["addr"],
                signal_power=float(sigsum) / (65535.0 * 65535.0) / siglen,
                iid=info["iid"],
                scan_offset=gidx,
            )
        )
        skip_until = o + msgbits * 2 + 1
        if reset_every is not None:
            # reference semantics: the skip dies at the next buffer boundary
            skip_until = min(skip_until, (o // reset_every + 1) * reset_every)

    return frames, max(0, skip_until - scan_len)
