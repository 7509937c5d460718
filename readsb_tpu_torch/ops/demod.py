"""2.4 MS/s Mode-S demodulation as a dense batch pipeline (PyTorch).

Stages of one dispatch:

  1  dense scan: preamble pre-check, 3 correlation lanes, 5 slicer sign
     planes packed 32 samples per word, split hi/lo prefix sums of mag^2;
     of raw UC8 words with the conversion fused (kernels.dense_scan_uc8,
     the raw route) or of uint16 magnitudes (kernels.dense_scan, the
     magnitude route)
  2  compaction of the candidate mask to K ascending offsets
  3  win rows: per 256-sample block one 128-lane row holding every bit a
     candidate of that block needs; one whole-row gather per candidate
  4  per-candidate extraction (kernels.extract_syndromes): 5 phases x
     112 bits, CRC-24 syndromes, message bytes, correlation bits
  (5 the score gate, ops/gate.py, and the host finalizer follow)

Two alternative device routes, both off unless their module constant is
set, as in readsb_tpu:

  pipeline.FUSE_CLASSIFY  stage 4 runs kernels.extract_classify_v3 and the
     score gate reads its per-phase flags instead of searching the tables
  USE_FUSED (below)       stages 1-4 are one kernel per 65536-sample tile
     (ops/fused.py), with a return to the staged route when a tile
     overflows its capacities

Numerology is bit-exact with the reference demodulator (wiedehopf/readsb
demod_2400.c) and with readsb_tpu.ops.demod:
- pre-check pa[1]>pa[7] && pa[12]>pa[14] && pa[12]>pa[15] (demod_2400.c:311)
- noise = pa[5]+pa[8]+pa[16]+pa[17]+pa[18]; ref = noise*T>>5 (330-340)
- 3 correlations firing 5 phase hypotheses (344-378)
- 5 slicer kernels / byte schedule, 19/19/19/19/20 stride (74-93,133-213)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import MODES_LONG_MSG_BITS, PREAMBLE_THRESHOLD_DEFAULT, TRAILING_SAMPLES
from . import crc as crc_ops
from . import kernels
from .kernels import WIN_CORR_BASE, WIN_PLANE_WORDS, pack_plane_words

# 3/4-tap integer slicer kernels, index = sub-sample phase (demod_2400.c:74-93)
_KERNELS = {
    0: (18, -15, -3, 0),
    1: (14, -5, -9, 0),
    2: (16, 5, -20, 0),
    3: (7, 11, -18, 0),
    4: (4, 15, -20, 1),
}

# per-phase byte schedule: (sample offset within byte window, kernel id)
# and the pointer advance to the next byte (demod_2400.c:133-213)
_BYTE_SCHED = {
    0: ([(0, 0), (2, 2), (4, 4), (7, 1), (9, 3), (12, 0), (14, 2), (16, 4)], 19),
    1: ([(0, 1), (2, 3), (5, 0), (7, 2), (9, 4), (12, 1), (14, 3), (17, 0)], 19),
    2: ([(0, 2), (2, 4), (5, 1), (7, 3), (10, 0), (12, 2), (14, 4), (17, 1)], 19),
    3: ([(0, 3), (3, 0), (5, 2), (7, 4), (10, 1), (12, 3), (15, 0), (17, 2)], 19),
    4: ([(0, 4), (3, 1), (5, 3), (8, 0), (10, 2), (12, 4), (15, 1), (17, 3)], 20),
}

NUM_PHASES = 5  # try_phase 4..8
# Fused per-tile demodulator (ops/fused.py): dense scan + in-tile
# compaction + extraction in one kernel.  Off by default, as in readsb_tpu.
USE_FUSED = False
MAX_TAPS = 4
SLICE_WINDOW = 320  # max sample offset read by any tap, padded
SIG_LONG = 112 * 12 // 5  # 268 samples of message body (demod_2400.c:436)
SIG_SHORT = 56 * 12 // 5  # 134
RAW_PAD = 512  # zero words past every candidate window on the raw route
_COMPACT_BLK = 256  # samples per local compaction block


@functools.lru_cache(maxsize=None)
def slicer_tables() -> tuple[np.ndarray, np.ndarray]:
    """(OFF, COEF): int32[5, 112, 4] absolute sample offsets & coefficients.

    Row p corresponds to try_phase = p + 4.  Offsets are relative to the
    candidate (preamble start) sample.
    """
    off = np.zeros((NUM_PHASES, MODES_LONG_MSG_BITS, MAX_TAPS), dtype=np.int32)
    coef = np.zeros((NUM_PHASES, MODES_LONG_MSG_BITS, MAX_TAPS), dtype=np.int32)
    for p in range(NUM_PHASES):
        try_phase = p + 4
        ptr = 19 + try_phase // 5
        phase = try_phase % 5
        bit = 0
        for _byte in range(MODES_LONG_MSG_BITS // 8):
            sched, adv = _BYTE_SCHED[phase]
            for boff, kid in sched:
                taps = _KERNELS[kid]
                for t in range(MAX_TAPS):
                    off[p, bit, t] = ptr + boff + t
                    coef[p, bit, t] = taps[t]
                bit += 1
            ptr += adv
            phase = (phase + 1) % 5
    assert off.max() < SLICE_WINDOW
    return off, coef


@functools.lru_cache(maxsize=None)
def lattice_tables() -> tuple[np.ndarray, np.ndarray]:
    """(AOFF, KID): int32[5, 112] base sample offset & kernel id per bit.

    bit(o, p, b) = sign_plane[KID[p,b]][o + AOFF[p,b]] — the sign-plane
    reformulation of the tap schedule above.
    """
    off, _ = slicer_tables()
    aoff = np.ascontiguousarray(off[:, :, 0])
    kid = np.zeros((NUM_PHASES, MODES_LONG_MSG_BITS), dtype=np.int32)
    for p in range(NUM_PHASES):
        phase = (p + 4) % 5
        bit = 0
        for _byte in range(MODES_LONG_MSG_BITS // 8):
            for _boff, k in _BYTE_SCHED[phase][0]:
                kid[p, bit] = k
                bit += 1
            phase = (phase + 1) % 5
    return aoff, kid


@functools.lru_cache(maxsize=None)
def _combined_matrix() -> np.ndarray:
    """f32[112, 62]: columns 0:24 CRC-112 parity, 24:48 CRC-56 parity
    (over the first 56 bits only), 48:62 MSB-first byte-packing weights.
    Every entry is an integer <= 128, so 0/1 bits times this matrix give
    exact integer sums (the plain extraction's one product)."""
    m112 = np.asarray(crc_ops.syndrome_matrix(112), dtype=np.float32)  # (112,24)
    m56 = np.asarray(crc_ops.syndrome_matrix(56), dtype=np.float32)  # (56,24)
    pack = np.zeros((112, 14), dtype=np.float32)
    for b in range(112):
        pack[b, b // 8] = float(128 >> (b % 8))
    out = np.zeros((112, 62), dtype=np.float32)
    out[:, 0:24] = m112
    out[:56, 24:48] = m56
    out[:, 48:62] = pack
    return out


@functools.lru_cache(maxsize=None)
def extract_plan_lanes() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 560 emission lanes of the plan-order extraction
    (kernels.extract_classify): (word, shift, col) int32[560] each.

    After a candidate's window is word-rotated and bit-shifted by
    (offset & 255), every slicer bit lives at a static position: bit
    `shift` of aligned window word `word` = plane * 11 + word_j.  Lanes are
    emitted grouped by (plane, word_j), ascending; col = phase * 112 +
    message bit says which bit a lane carries.
    """
    aoff, kid = lattice_tables()
    lanes = sorted(
        (int(kid[p, b]) * 11 + (int(aoff[p, b]) >> 5), p * MODES_LONG_MSG_BITS + b)
        for p in range(NUM_PHASES)
        for b in range(MODES_LONG_MSG_BITS)
    )  # by word, then by column: the order of readsb_tpu's _extract_plan
    word = np.array([w for w, _ in lanes], np.int32)
    col = np.array([c for _, c in lanes], np.int32)
    shift = (aoff.reshape(-1)[col] & 31).astype(np.int32)
    return word, shift, col


@functools.lru_cache(maxsize=None)
def _extract_plan():
    """Pick schedule + permuted product matrix, in readsb_tpu's form.

    Returns (plan, m) where plan = [(plane, word_j, shifts int32[g])...]
    in emission order and m = f32[560, 310] with column block
    p*62:(p+1)*62 equal to _combined_matrix rows for phase p's bits: the
    column permutation of the grouped emission is folded into the matrix,
    so the product's outputs are unchanged.
    """
    word, shift, col = extract_plan_lanes()
    plan = [
        (int(w) // 11, int(w) % 11, shift[word == w])
        for w in np.unique(word)
    ]
    comb = _combined_matrix()  # (112, 62)
    m = np.zeros((NUM_PHASES * MODES_LONG_MSG_BITS, NUM_PHASES * 62), np.float32)
    for row, c in enumerate(col):
        p, b = divmod(int(c), MODES_LONG_MSG_BITS)
        m[row, p * 62 : (p + 1) * 62] = comb[b]
    return plan, m


def _dense_stages(buf: torch.Tensor, threshold: int):
    """Plain dense scan of magnitudes (uint16[n], any n), the contract of
    readsb_tpu's _dense_stages_jnp: corrbits are 0 from n - 19 on and plane
    bits 0 from n - 4 on (where a window would leave the buffer).  Returns
    (corrbits int8[n'], pwords int32[5, n'//32], cs_hi, cs_lo), n' = n
    rounded up to 32."""
    n = buf.shape[0]
    n2 = -(-n // 32) * 32
    m = torch.zeros(n2, dtype=torch.int32, device=buf.device)
    m[:n] = buf.to(torch.int32)
    corrbits, pwords, cs_hi, cs_lo = kernels.dense_from_mag(m, threshold, tail=0)
    corrbits[n - 19 :] = 0
    inside = torch.arange(n2, device=buf.device) < n - MAX_TAPS
    return corrbits, pwords & pack_plane_words(inside[None]), cs_hi, cs_lo


def first_k(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """The first k set positions of a bool mask, ascending, `fill`-padded:
    int32[k].  One int32 cumsum and one scatter into a k+1 buffer (slot k
    collects ranks >= k): no nonzero, so no dynamic size and no device sync."""
    dev = mask.device
    rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    dest = torch.where(mask, rank.clamp(max=k), k).to(torch.int64)
    pos = torch.arange(mask.shape[0], dtype=torch.int32, device=dev)
    out = torch.full((k + 1,), fill, dtype=torch.int32, device=dev)
    out.scatter_(0, dest, torch.where(mask, pos, fill))
    return out[:k]


def _compact_two_level(cand: torch.Tensor, k: int, l: int, scan_len: int):
    """Compact the candidate mask to k ascending offsets (sentinel scan_len).

    Returns (offsets int32[k], max_local int32[]): the first k candidate
    positions in ascending order and the most candidates in any 256-sample
    block.  readsb_tpu's two-level TPU compaction has a per-block capacity
    l and reports max_local > l as an overflow that the caller retries
    with a larger l; this version (first_k) is exact for any l, and the
    callers keep the same escalation on max_local so both packages move
    through the same capacities.
    """
    del l  # exact for every capacity; kept for the escalation contract
    nb = (scan_len + _COMPACT_BLK - 1) // _COMPACT_BLK
    c = torch.zeros(nb * _COMPACT_BLK, dtype=torch.bool, device=cand.device)
    n = min(scan_len, cand.shape[0])
    c[:n] = cand[:n]
    max_local = c.reshape(nb, _COMPACT_BLK).sum(1, dtype=torch.int32).max()
    return first_k(c, k, scan_len), max_local


class BlockCandidates(NamedTuple):
    """Device outputs of one demodulated block (fixed-size, K candidates)."""

    offsets: torch.Tensor  # int32[K] scan offsets (ascending; == sentinel when unused)
    n_cand: torch.Tensor  # int32[] true candidate count (may exceed K => overflow)
    max_local: torch.Tensor  # int32[] max candidates in any 256-sample block
    corr_fired: torch.Tensor  # bool[K, 3] which correlation lanes fired (A, B, C)
    msg: torch.Tensor  # uint8[K, 5, 14] sliced message bytes per try_phase
    syn112: torch.Tensor  # int32[K, 5] CRC syndrome over 112 bits
    syn56: torch.Tensor  # int32[K, 5] CRC syndrome over first 56 bits
    sig_long: torch.Tensor  # int32[K, 2] (hi, lo) exact split sum of mag^2, 268 samples
    sig_short: torch.Tensor  # int32[K, 2] (hi, lo) over the first 134 samples
    # classifier flags of kernels.extract_classify_v3 (lanes 83:88), or None:
    # int32[K, 5] per-phase bitmask 1=in_t112 2=in_t56 4=in_tbl 8=fix_ok 16=zero7
    flags: torch.Tensor | None = None
    # fused route (ops/fused.py): bool[K] live mask (rows that are not live
    # carry their tile's end as offset, so the list stays nondecreasing) and
    # an overflow scalar int32[] (> 0: a tile's or a 128-sample row's
    # capacity was exceeded and the caller redoes the block staged)
    live: torch.Tensor | None = None
    fused_overflow: torch.Tensor | None = None

    @property
    def sigsum_long(self) -> np.ndarray:
        """Exact f64 sum of mag^2 over the long message body (host-side)."""
        s = self.sig_long.cpu().numpy().astype(np.int64)
        return ((s[:, 0] << 16) + s[:, 1]).astype(np.float64)

    @property
    def sigsum_short(self) -> np.ndarray:
        s = self.sig_short.cpu().numpy().astype(np.int64)
        return ((s[:, 0] << 16) + s[:, 1]).astype(np.float64)


def win_rows(corrbits: torch.Tensor, pwords: torch.Tensor, scan_len: int):
    """Build the (nv, 128) candidate win rows.

    Per 256-sample block v: lanes 0..94 = five slicer planes x 19 packed
    words (words 8v..8v+18: a 574-bit reach covers offset & 255 plus the
    320-sample slicer window), 95..118 = three correlation bitplanes x 8
    words, rest zero.  Pure reshapes/concats — no gather.
    """
    dev = pwords.device
    nv = (scan_len + 255) // 256
    need = 8 * nv + WIN_PLANE_WORDS
    nw = pwords.shape[1]
    if nw < need:
        pwords = torch.cat(
            [pwords, torch.zeros((5, need - nw), dtype=torch.int32, device=dev)], dim=1
        )
    a = pwords[:, : 8 * nv].reshape(5, nv, 8)
    b = pwords[:, 8 : 8 * nv + 8].reshape(5, nv, 8)
    c3 = pwords[:, 16 : 8 * nv + 16].reshape(5, nv, 8)[..., :3]
    wp = torch.cat([a, b, c3], dim=-1).permute(1, 0, 2).reshape(nv, 5 * WIN_PLANE_WORDS)

    clen = 256 * nv
    cpad = torch.zeros(clen, dtype=torch.int32, device=dev)
    m = min(clen, corrbits.shape[0])
    cpad[:m] = corrbits[:m].to(torch.int32)
    cpl = torch.stack([((cpad >> i) & 1) != 0 for i in range(3)])  # (3, clen)
    cw3 = pack_plane_words(cpl).reshape(3, nv, 8).permute(1, 0, 2).reshape(nv, 24)

    win = torch.cat(
        [wp, cw3, torch.zeros((nv, 128 - WIN_CORR_BASE - 24), dtype=torch.int32, device=dev)],
        dim=1,
    )
    return win, nv


def window_sums(offsets: torch.Tensor, cs_hi: torch.Tensor, cs_lo: torch.Tensor):
    """Exact split hi/lo mag^2 sums over the long/short message bodies.

    Returns (sig_long, sig_short) int32[K, 2] from the dense stage's
    wraparound-exact prefix sums (demod_2400.c:436-457 accounting).  The
    sums run on over the dense stage's padding (dense_stage), so every
    candidate below scan_len gets its whole window.
    """
    n = cs_hi.shape[0]
    last = (n // 128) * 128 - 1
    h64 = cs_hi.to(torch.int64)
    l64 = cs_lo.to(torch.int64)

    def wsum(a, b):
        # sum over samples [offset+a, offset+b) per candidate (a >= 1)
        ia = (offsets.to(torch.int64) + (a - 1)).clamp(max=last)
        ib = (offsets.to(torch.int64) + (b - 1)).clamp(max=last)
        return kernels.wrap_i32(
            torch.stack([h64[ib] - h64[ia], l64[ib] - l64[ia]], dim=-1)
        )

    return wsum(19, 19 + SIG_LONG), wsum(19, 19 + SIG_SHORT)


def pad_raw_words(buf: torch.Tensor) -> torch.Tensor:
    """Zero-pad raw UC8 words to the dense-scan granule with >= RAW_PAD
    extra words: they convert to loud magnitudes, so they must sit beyond
    every candidate window."""
    n = buf.shape[0]
    padded = -(-(n + RAW_PAD) // kernels.TILE) * kernels.TILE
    bufp = torch.zeros(padded, dtype=torch.uint16, device=buf.device)
    bufp[:n] = buf
    return bufp


def pad_mag(buf: torch.Tensor) -> torch.Tensor:
    """Zero-pad magnitudes to the dense-scan granule."""
    n = buf.shape[0]
    padded = -(-n // kernels.TILE) * kernels.TILE
    if padded == n:
        return buf
    bufp = torch.zeros(padded, dtype=torch.uint16, device=buf.device)
    bufp[:n] = buf
    return bufp


def dense_stage(buf: torch.Tensor, threshold: int, *, raw_uc8: bool):
    """Stage 1: (corrbits, pwords, cs_hi, cs_lo) of raw words or magnitudes.

    Magnitudes on the card go to the dense-scan kernel, zero-padded to its
    granule; on the CPU to _dense_stages, which takes any length, with its
    prefix sums run on over the same zero padding.  The two agree wherever
    a candidate below scan_len reads, signal windows included."""
    if raw_uc8:
        return kernels.dense_scan_uc8(pad_raw_words(buf), threshold)
    if buf.device.type == "cpu":
        corrbits, pwords, cs_hi, cs_lo = _dense_stages(buf, threshold)
        pad = -(-buf.shape[0] // kernels.TILE) * kernels.TILE - cs_hi.shape[0]
        return corrbits, pwords, *(torch.cat([s, s[-1:].expand(pad)]) for s in (cs_hi, cs_lo))
    return kernels.dense_scan(pad_mag(buf), threshold)


def candidate_rows(
    corrbits: torch.Tensor,
    pwords: torch.Tensor,
    *,
    k: int,
    l: int,
    scan_len: int,
    seg_stride: int | None = None,
    seg_valid: int | None = None,
):
    """Stages 2-3: (offsets int32[k], n_cand, max_local, rows int32[k, 128])."""
    cand = (corrbits[:scan_len] & 8) != 0
    if seg_stride is not None:
        pos = torch.arange(scan_len, dtype=torch.int32, device=cand.device)
        cand = cand & ((pos % seg_stride) < seg_valid)
    n_cand = cand.sum(dtype=torch.int32)
    offsets, max_local = _compact_two_level(cand, k, l, scan_len)
    win, nv = win_rows(corrbits, pwords, scan_len)
    rows = win[(offsets >> 8).clamp(0, nv - 1).to(torch.int64)]
    return offsets, n_cand, max_local, rows


def _demod_core(
    buf: torch.Tensor,
    threshold: int,
    *,
    k: int,
    scan_len: int,
    l: int,
    seg_stride: int | None = None,
    seg_valid: int | None = None,
    raw_uc8: bool = False,
    known_tbl: torch.Tensor | None = None,
    nfix: int = 1,
    fix_df: bool = True,
    force_staged: bool = False,
):
    """Stages 1-4 of the demodulator (everything except signal power).

    raw_uc8=True: buf is uint16 IQ *words* and the fused convert + dense
    scan kernel runs; otherwise buf holds uint16 magnitudes (the magnitude
    route).

    known_tbl (sorted, sentinel-padded known-ICAO addresses): when given,
    stage 4 runs kernels.extract_classify_v3 and the BlockCandidates carry
    its per-phase flags, which ops.gate.score_gate then reads instead of
    searching the tables itself.  nfix / fix_df select that kernel's
    static tables.

    With USE_FUSED set and force_staged False, stages 1-4 are
    fused.fused_demod_tiles: raw words are first converted
    (kernels.mag_uc8), the result has ntiles * cap rows instead of k, with
    `live` and `fused_overflow` set.

    Returns (BlockCandidates with zeroed sig fields, cs_hi, cs_lo).

    seg_stride/seg_valid: channel-batched layout.  The buffer is C
    concatenated channel segments of seg_stride samples, each laid out
    [326-sample carried overlap][seg_valid samples][zero gap]; scan
    positions with (offset % seg_stride) >= seg_valid are masked off so no
    candidate window ever crosses a channel seam.  Candidate offsets stay
    global (channel = offset // seg_stride).
    """
    if buf.shape[0] < scan_len + SLICE_WINDOW:
        raise ValueError(f"buffer of {buf.shape[0]} samples is short for scan_len {scan_len}")
    if seg_stride is not None and (
        seg_valid is None
        or seg_stride < seg_valid + TRAILING_SAMPLES
        or scan_len % seg_stride
    ):
        raise ValueError(f"bad channel layout {seg_stride=} {seg_valid=} {scan_len=}")
    if USE_FUSED and not force_staged:
        return _demod_core_fused(
            buf, threshold, k=k, scan_len=scan_len,
            seg_stride=seg_stride, seg_valid=seg_valid, raw_uc8=raw_uc8,
        )
    corrbits, pwords, cs_hi, cs_lo = dense_stage(buf, threshold, raw_uc8=raw_uc8)
    offsets, n_cand, max_local, rows = candidate_rows(
        corrbits, pwords, k=k, l=l, scan_len=scan_len,
        seg_stride=seg_stride, seg_valid=seg_valid,
    )
    if known_tbl is not None:  # stage 4 with the gate's classification fused in
        comb = kernels.extract_classify_v3(rows, offsets, known_tbl, nfix=nfix, fix_df=fix_df)
        flags = comb[:, 83:88]
    else:
        comb = kernels.extract_syndromes(rows, offsets)  # stage 4
        flags = None
    bc = _candidates_of(comb, offsets, n_cand, max_local, offsets < scan_len)
    return bc._replace(flags=flags), cs_hi, cs_lo


def _candidates_of(comb, offsets, n_cand, max_local, fired_mask) -> BlockCandidates:
    """BlockCandidates from the extraction's int32[K,128] rows (zeroed sig
    fields); correlation bits count only where fired_mask bool[K] is set."""
    k = comb.shape[0]
    zeros2 = torch.zeros((k, 2), dtype=torch.int32, device=comb.device)
    return BlockCandidates(
        offsets=offsets,
        n_cand=n_cand,
        max_local=max_local,
        corr_fired=(comb[:, 80:83] != 0) & fired_mask[:, None],
        msg=comb[:, 10:80].reshape(k, NUM_PHASES, 14).to(torch.uint8),
        syn112=comb[:, 0:5],
        syn56=comb[:, 5:10],
        sig_long=zeros2,
        sig_short=zeros2,
    )


def _demod_core_fused(
    buf, threshold, *, k: int, scan_len: int, seg_stride, seg_valid, raw_uc8: bool
):
    """Stages 1-4 as one kernel per tile (the USE_FUSED route).

    The capacity is per tile, cap = max(128, k // ntiles); a tile with more
    candidates, or a 128-sample row with more than fused.L_ROW, reports
    fused_overflow > 0 and the caller redoes the block staged."""
    from . import fused

    mag = kernels.mag_uc8(buf) if raw_uc8 else buf
    ntiles = -(-scan_len // fused.TILE)
    # whole tiles over the scan range plus the last tile's halo: a window
    # that starts below scan_len reads the samples after it, not zeros
    padded = ntiles * fused.TILE + fused.HALO
    magp = torch.zeros(padded, dtype=torch.uint16, device=buf.device)
    m = min(padded, mag.shape[0])
    magp[:m] = mag[:m]
    cap = max(128, k // ntiles)
    comb, offsets, live, meta, cs_hi, cs_lo = fused.fused_demod_tiles(
        magp, threshold, cap=cap, seg_stride=seg_stride, seg_valid=seg_valid,
        scan_limit=scan_len,
    )
    overflow = torch.maximum(meta[:, 0].max() - cap, meta[:, 2].max() - fused.L_ROW)
    bc = _candidates_of(
        comb, offsets, meta[:, 0].sum(dtype=torch.int32), meta[:, 1].max(), live
    )
    return bc._replace(live=live, fused_overflow=overflow), cs_hi, cs_lo


def demod_block(
    buf: torch.Tensor,
    threshold: int = PREAMBLE_THRESHOLD_DEFAULT,
    *,
    k: int = 2048,
    scan_len: int | None = None,
    l: int = 64,
    force_staged: bool = False,
) -> BlockCandidates:
    """Demodulate one magnitude block (see _demod_core).

    buf: uint16[scan_len + TRAILING_SAMPLES] magnitudes.  Scan offsets
    0..scan_len-1 are candidate positions.  Under USE_FUSED the rows that
    are not `live` have no correlation bit set, so a finalizer passes over
    them.
    """
    if scan_len is None:
        scan_len = buf.shape[0] - TRAILING_SAMPLES
    bc, cs_hi, cs_lo = _demod_core(
        buf, threshold, k=k, scan_len=scan_len, l=l, force_staged=force_staged
    )
    sig_long, sig_short = window_sums(bc.offsets, cs_hi, cs_lo)
    return bc._replace(sig_long=sig_long, sig_short=sig_short)
