"""Columnar network-frame acceptance: the batch analog of Scorer.decode_accept.

The reference's aggregator path decodes every network frame on a thread
pool (decodeTask, net_io.c:5365-5474); each frame passes the CRC/accept
stage of decodeModesMessage (mode_s.c:443-803).  Here one drain batch is
accepted as numpy columns:

  - DF-field repair of 1-bit-damaged DF17 (fixDF17msgtype, mode_s.c:276)
  - syndrome-table correction of DF11/DF17/18 (vectorized ErrorTable)
  - known-ICAO residual tests for DF0/4/5/16/20/21 with the *serial*
    within-batch learning order: a clean DF17 / DF11-IID0 at batch
    position i teaches its address to the filter for every position > i
    (mode_s.c:778 is the only learn site), reproduced by a first-teach
    position compare instead of a mutable hash table.

Equivalence with the serial Scorer.decode_accept — including the
learning-order effects — is fuzz-tested in tests/test_netaccept.py.

A copy of readsb_tpu's module, unchanged.
"""

from __future__ import annotations

import numpy as np

from ..ops import crc as crc_ops
from .score import DF17_FIXABLE


def accept_columns(scorer, msgs: np.ndarray, syn112: np.ndarray, syn56: np.ndarray) -> dict:
    """Batch accept.  msgs: (N, 14) uint8 (mutated copies are returned).

    Returns dict of columns:
      result    int8[N]: 0 accepted, -1 unknown-ICAO reject, -2 bad reject
      msgs      (N, 14) uint8 with corrections applied
      addr      int64[N]
      corrected int64[N]
      iid       int64[N]
      msgbits   int64[N]
      learned   int64[]: addresses to add to the filter (scorer.icao.add
                side effect — the caller applies it after forwarding)
    """
    msgs = msgs.copy()
    n = len(msgs)
    syn112 = np.asarray(syn112, np.int64)
    syn56 = np.asarray(syn56, np.int64)
    df = (msgs[:, 0] >> 3).astype(np.int64)
    result = np.zeros(n, np.int8)
    corrected = np.zeros(n, np.int64)
    iid = np.zeros(n, np.int64)
    addr = np.zeros(n, np.int64)

    zero = ~msgs[:, :7].any(axis=1)
    result[zero] = -2

    # --- 1-bit-damaged DF17 DF-field repair (fixDF17msgtype) ---------------
    if scorer.fix_df:
        for t in DF17_FIXABLE:
            m = ~zero & (df == t) & (syn112 == int(scorer.df_delta[t]))
            if m.any():
                msgs[m, 0] = (17 << 3) | (msgs[m, 0] & 7)
                syn112 = np.where(m, 0, syn112)
                df = np.where(m, 17, df)
                corrected[m] = 1

    long = df >= 16
    msgbits = np.where(long, 112, 56)
    crc = np.where(long, syn112, syn56)

    is_df11 = ~zero & (df == 11)
    is_df1718 = ~zero & ((df == 17) | (df == 18))
    is_icao_res = ~zero & (
        np.isin(df, (0, 4, 5, 16, 20, 21)) | ((df >= 24) & (df <= 31))
    )
    other = ~zero & ~is_df11 & ~is_df1718 & ~is_icao_res
    result[other] = -2

    # --- DF11: clean high bits pass; else 1-bit table correction -----------
    d11_dirty = is_df11 & ((crc & 0xFFFF80) != 0)
    iid[is_df11 & ~d11_dirty] = crc[is_df11 & ~d11_dirty] & 0x7F
    need_known = np.zeros(n, bool)
    if d11_dirty.any():
        if scorer.table_short is None:
            result[d11_dirty] = -2
            d11_dirty &= False
        else:
            nerr, b0, b1 = scorer.table_short.diagnose(
                crc[d11_dirty].astype(np.uint32)
            )
            bad = (nerr < 0) | (nerr > 1)
            rows = np.nonzero(d11_dirty)[0]
            result[rows[bad]] = -2
            ok = rows[~bad]
            _flip_bits(msgs, ok, b0[~bad], b1[~bad])
            corrected[ok] = nerr[~bad]
            need_known[ok] = True
            d11_dirty = np.zeros(n, bool)
            d11_dirty[ok] = True

    # --- DF17/18: zero syndrome passes; else table correction --------------
    d17_dirty = is_df1718 & (crc != 0)
    if d17_dirty.any():
        if scorer.table_long is None:
            result[d17_dirty] = -2
            d17_dirty &= False
        else:
            aa_before = _aa(msgs)
            nerr, b0, b1 = scorer.table_long.diagnose(
                crc[d17_dirty].astype(np.uint32)
            )
            bad = nerr < 0
            rows = np.nonzero(d17_dirty)[0]
            result[rows[bad]] = -2
            ok = rows[~bad]
            _flip_bits(msgs, ok, b0[~bad], b1[~bad])
            corrected[ok] = nerr[~bad]
            aa_after = _aa(msgs)
            changed = np.zeros(n, bool)
            changed[ok] = aa_before[ok] != aa_after[ok]
            need_known |= changed  # addr changed by the fix: must be known
            d17_dirty = np.zeros(n, bool)
            d17_dirty[ok] = True

    aa = _aa(msgs)
    addr = np.where(is_df11 | is_df1718, aa, crc & 0xFFFFFF)
    need_known |= is_icao_res

    # --- serial-order known-ICAO membership --------------------------------
    # learners: clean (uncorrected) DF17 or DF11 with IID 0 that will be
    # accepted unconditionally — their acceptance never depends on `known`
    learned_mask = (
        (result == 0)
        & (corrected == 0)
        & ((df == 17) | ((df == 11) & ~((crc & 0xFFFF80) != 0) & (iid == 0)))
    )
    both = scorer.icao.cur | scorer.icao.prev
    pre_known = np.fromiter(both, np.int64, len(both))
    pre_known.sort()
    q_rows = np.nonzero(need_known & (result == 0))[0]
    if len(q_rows):
        q = addr[q_rows] & 0xFFFFFF
        known = np.isin(q, pre_known)
        l_rows = np.nonzero(learned_mask)[0]
        if len(l_rows):
            l_addr = addr[l_rows] & 0xFFFFFF
            order = np.argsort(l_addr, kind="stable")
            uniq, first = np.unique(l_addr[order], return_index=True)
            first_pos = l_rows[order][first]  # earliest teach position/addr
            j = np.minimum(np.searchsorted(uniq, q), len(uniq) - 1)
            hit = uniq[j] == q
            known |= hit & (first_pos[j] < q_rows)
        result[q_rows[~known]] = -1

    learned = np.unique(addr[learned_mask] & 0xFFFFFF)
    return {
        "result": result,
        "msgs": msgs,
        "addr": addr & 0xFFFFFF,
        "corrected": corrected,
        "iid": iid,
        "msgbits": msgbits,
        "learned": learned,
    }


def _aa(msgs: np.ndarray) -> np.ndarray:
    return (
        msgs[:, 1].astype(np.int64) << 16
    ) | (msgs[:, 2].astype(np.int64) << 8) | msgs[:, 3].astype(np.int64)


def _flip_bits(msgs: np.ndarray, rows: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> None:
    """Vectorized crc_ops.fix_message: flip bits b0 (and b1 >= 0) in rows."""
    for b in (b0, b1):
        m = b >= 0
        r = rows[m]
        bb = b[m].astype(np.int64)
        np.bitwise_xor.at(msgs, (r, bb >> 3), (1 << (7 - (bb & 7))).astype(np.uint8))
