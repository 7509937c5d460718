"""Device-side score gate: transfer only plausibly-acceptable candidates.

The host finalizer (decode/score.py, native/finalizer.cpp) is the exact,
serial scoring stage.  This gate reproduces the *rejection* half of
scoreModesMessage (mode_s.c:309-419) on the device and keeps only
candidates that could possibly score > 0:

  kept    <=>  some fired phase satisfies one of
               - DF17/18 with zero or error-table-correctable syndrome
               - 1-bit-damaged DF17 (fixDF17msgtype syndrome match)
               - DF11 with clean high syndrome bits, or 1-bit-correctable
               - DF0/4/5/16/20/21 whose CRC residual is a *known* ICAO

"Known" is over-approximated by (device ICAO table at superblock start)
UNION (addresses any in-block clean DF17 / DF11-IID0 phase could teach the
filter).  The union is a superset of every filter state the host can reach
while finalizing this superblock, so a candidate dropped here is one the
host would provably reject (score -1/-2):

  - frame output is bit-identical with the ungated pipeline, and
  - the drop counters returned (pre/unknown/bad) are exactly the stats
    the host would have counted for the dropped candidates.

The in-block teach set is one sorted table with an entry per phase of the
dispatch: the phase's address where it learns, TBL_SENTINEL elsewhere.
It has no capacity to overflow, so the union is exact at any traffic and
any channel count.  (readsb_tpu holds 256 learning phases and past that
lets every ICAO-dependent candidate pass: more rows, the same frames.)
Table membership is a binary search (torch.searchsorted) in sorted tables.

When the candidates carry per-phase flags (kernels.extract_classify_v3
under pipeline.FUSE_CLASSIFY), the memberships in the static tables and in
the known table, fix_ok and zero7 come from the flags; classify_plain is
the same classification in PyTorch and gate_tables_np the kernel's tables.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import crc as crc_ops
from .demod import BlockCandidates, _compact_two_level, window_sums

_DF17_FIXABLE = (1, 25, 21, 19, 16)
TBL_SENTINEL = 0x1000000  # > any 24-bit address; never equals a residual


@functools.lru_cache(maxsize=None)
def _df_delta_np() -> np.ndarray:
    from ..decode.score import df_delta_syndromes

    return df_delta_syndromes().astype(np.int64).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _table_syndromes_np(bits: int, nfix: int) -> np.ndarray:
    """Sorted int32 syndrome values of the nfix-bit error table."""
    tab = crc_ops.error_table(bits, min(nfix, 2))
    return np.asarray(tab.syndromes, dtype=np.int64).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _table_syndromes_on(bits: int, nfix: int, device: torch.device) -> torch.Tensor:
    """_table_syndromes_np on the device, sent once per device: a pageable
    copy in every dispatch would wait for the work queued before it."""
    return torch.from_numpy(_table_syndromes_np(bits, nfix)).to(device)


def _isin_sorted(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Elementwise membership of int32 x in a sorted, non-empty int32 table."""
    i = torch.searchsorted(table, x.contiguous()).clamp(max=table.numel() - 1)
    return table[i] == x


GATE_SENTINEL = 0x2000000  # > any syndrome or residual: pads the static tables


@functools.lru_cache(maxsize=None)
def gate_tables_np(nfix: int, fix_df: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t112, t56, dfd) int32: the classifier's static tables, as
    readsb_tpu's _gate_tables_np.  t112 / t56: the sorted nfix-bit error
    table syndromes padded with GATE_SENTINEL to a multiple of 128 (all
    sentinel for nfix == 0).  dfd int32[128]: 0..4 the DF17-fixable delta
    syndromes, 5..9 their df values, 10 = nfix > 0, 11 = fix_df and
    nfix > 0, the rest sentinel."""

    def padded(a):
        out = np.full(max(128, -(-len(a) // 128) * 128), GATE_SENTINEL, np.int32)
        out[: len(a)] = a
        return out

    empty = np.zeros(0, np.int32)
    t112 = padded(_table_syndromes_np(112, nfix) if nfix > 0 else empty)
    t56 = padded(_table_syndromes_np(56, nfix) if nfix > 0 else empty)
    dfd = np.full(128, GATE_SENTINEL, np.int32)
    deltas = _df_delta_np()
    for i, d in enumerate(_DF17_FIXABLE):
        dfd[i] = int(deltas[d])
        dfd[5 + i] = d
    dfd[10] = 1 if nfix > 0 else 0
    dfd[11] = 1 if (fix_df and nfix > 0) else 0
    return t112, t56, dfd


def classify_plain(
    syn112: torch.Tensor,
    syn56: torch.Tensor,
    msg: torch.Tensor,
    known_tbl: torch.Tensor,
    nfix: int,
    fix_df: bool,
) -> torch.Tensor:
    """Per-phase classifier flags int32[K,5], readsb_tpu's _classify_block:
    1 in_t112, 2 in_t56, 4 in_tbl, 8 fix_ok, 16 zero7.

    syn112 / syn56 [K,5], msg [K,70] or [K,5,14] message bytes (any integer
    type), known_tbl sorted int32[T] padded with TBL_SENTINEL.
    """
    dev = syn112.device
    k = syn112.shape[0]
    s112 = syn112.to(torch.int32)
    s56 = syn56.to(torch.int32)
    msg = msg.reshape(k, 5, 14).to(torch.int32)
    df = msg[:, :, 0] >> 3
    t112, t56, dfd = gate_tables_np(nfix, fix_df)
    have_tab, have_fix = bool(dfd[10]), bool(dfd[11])
    in_t112 = _isin_sorted(s112, torch.from_numpy(t112).to(dev)) & have_tab
    in_t56 = _isin_sorted(s56, torch.from_numpy(t56).to(dev)) & have_tab
    residual = torch.where(df >= 16, s112, s56) & 0xFFFFFF
    in_tbl = _isin_sorted(residual, known_tbl)
    fix_ok = torch.zeros_like(df, dtype=torch.bool)
    if have_fix:
        for i in range(5):
            fix_ok |= (df == int(dfd[5 + i])) & (s112 == int(dfd[i]))
    zero7 = msg[:, :, :7].sum(2) == 0
    return (
        in_t112.to(torch.int32)
        | (in_t56.to(torch.int32) << 1)
        | (in_tbl.to(torch.int32) << 2)
        | (fix_ok.to(torch.int32) << 3)
        | (zero7.to(torch.int32) << 4)
    )


class GatedCandidates(NamedTuple):
    offsets: torch.Tensor  # int32[K2] scan offsets of kept candidates (sentinel scan_len)
    n_cand: torch.Tensor  # int32[] total candidates pre-gate (k-overflow check)
    max_local: torch.Tensor  # int32[] compaction watermark pre-gate
    n_keep: torch.Tensor  # int32[] kept count (may exceed K2 => escalate)
    keep_watermark: torch.Tensor  # int32[] kept-compaction per-block peak
    pre_drop: torch.Tensor  # int32[] dropped candidates (stats: preambles)
    unknown_drop: torch.Tensor  # int32[] dropped with best score -1
    bad_drop: torch.Tensor  # int32[] dropped with best score -2
    corr_fired: torch.Tensor  # bool[K2, 3]
    msg: torch.Tensor  # uint8[K2, 5, 14]
    syn112: torch.Tensor  # int32[K2, 5]
    syn56: torch.Tensor  # int32[K2, 5]
    sig_long: torch.Tensor  # int32[K2, 2]
    sig_short: torch.Tensor  # int32[K2, 2]
    # cumulative dropped-candidate counts (class 0 = unknown/-1, 1 = bad/-2)
    # evaluated below each kept offset o, o+113, o+225, and each
    # reset_every boundary — lets the host subtract drops that fall inside
    # NMS skip windows (which the serial finalizer never counts).
    drop_cum_q: torch.Tensor  # int32[2, 3, K2]
    drop_cum_bnd: torch.Tensor  # int32[2, C*NB]
    # cumulative (pre, unknown, bad) drop counts at channel starts — the
    # host derives exact per-channel stats by differencing
    drop_cum_chan: torch.Tensor  # int32[3, C+1]
    # the fused route's overflow scalar, passed through
    # (BlockCandidates.fused_overflow): > 0 => redo the block staged
    fused_overflow: torch.Tensor | None = None


def score_gate(
    bc: BlockCandidates,
    known_tbl: torch.Tensor,
    cs_hi: torch.Tensor,
    cs_lo: torch.Tensor,
    valid_len: int | None = None,
    *,
    scan_len: int,
    k2: int = 1024,
    nfix: int = 1,
    fix_df: bool = True,
    reset_every: int | None = None,
    seg_stride: int | None = None,
    keep_l: int = 64,
) -> GatedCandidates:
    """See the module docstring.

    known_tbl: sorted int32[T] known-ICAO addresses (cur+prev generation
    union), padded with TBL_SENTINEL.  cs_hi/cs_lo: the dense stage's
    exact split prefix sums; signal sums are computed for KEPT rows only.
    """
    dev = bc.offsets.device
    offs = bc.offsets
    k = offs.shape[0]
    if valid_len is None:
        valid_len = scan_len
    # candidates at/after valid_len (EOF padding) are dropped silently and
    # uncounted.  In the channel-batched layout valid_len is per-channel
    # and sentinels (== scan_len) must stay invalid despite the modulo.
    if seg_stride is not None:
        valid = (offs < scan_len) & ((offs % seg_stride) < valid_len)
    else:
        valid = offs < valid_len
    if bc.live is not None:
        # fused route: rows that are not live carry their tile's end as
        # offset (the list stays nondecreasing); only live rows are candidates
        valid = valid & bc.live
    msg = bc.msg.to(torch.int32)
    df = msg[:, :, 0] >> 3  # (K,5)
    aa = (msg[:, :, 1] << 16) | (msg[:, :, 2] << 8) | msg[:, :, 3]
    syn112 = bc.syn112
    syn56 = bc.syn56
    # phase -> corr_fired column (0, 0, 1, 1, 2) by views: a list index
    # would be a host-to-device copy that waits for the stream
    cf = bc.corr_fired
    fired = torch.stack([cf[:, 0], cf[:, 0], cf[:, 1], cf[:, 1], cf[:, 2]], dim=1)

    if bc.flags is not None:
        # the extraction kernel already classified each phase
        # (kernels.extract_classify_v3); unpack its per-phase flag bitmask
        fl = bc.flags
        in_t112 = (fl & 1) != 0
        in_t56 = (fl & 2) != 0
        in_tbl_pre = (fl & 4) != 0
        fix_ok = (fl & 8) != 0
        zero7 = (fl & 16) != 0
    else:
        in_tbl_pre = None
        zero7 = msg[:, :, :7].sum(2) == 0  # all-zero message

        # --- syndrome table membership -----------------------------------
        if nfix > 0:
            in_t112 = _isin_sorted(syn112, _table_syndromes_on(112, nfix, dev))
            in_t56 = _isin_sorted(syn56, _table_syndromes_on(56, nfix, dev))
        else:
            in_t112 = torch.zeros_like(syn112, dtype=torch.bool)
            in_t56 = torch.zeros_like(syn56, dtype=torch.bool)

        # --- 1-bit damaged DF17 (fixDF17msgtype) ---------------------------
        fix_ok = torch.zeros_like(df, dtype=torch.bool)
        if fix_df and nfix > 0:
            deltas = _df_delta_np()
            for d in _DF17_FIXABLE:
                fix_ok |= (df == d) & (syn112 == int(deltas[d]))

    # --- in-block teachable addresses (superset of host learns) ------------
    learn = fired & (
        ((df == 17) & (syn112 == 0))
        | ((df == 11) & (syn56 == 0))  # clean CRC and IID==0 <=> syn56 == 0
    )
    # TBL_SENTINEL is above every 24-bit residual: padding never matches
    s_tbl = torch.sort(torch.where(learn, aa, TBL_SENTINEL).reshape(-1)).values

    # --- known-ICAO test: residual in (known table U teach-set) ------------
    residual = torch.where(df >= 16, syn112, syn56) & 0xFFFFFF
    # with flags, the kernel probed the same table
    in_tbl = in_tbl_pre if in_tbl_pre is not None else _isin_sorted(residual, known_tbl)
    known = in_tbl | _isin_sorted(residual, s_tbl)

    # --- per-phase class: 2 pass / 1 reject-unknown (-1) / 0 reject-bad (-2)
    is_short_icao = (df == 0) | (df == 4) | (df == 5)
    is_long_icao = (df == 16) | (df == 20) | (df == 21)
    icao_dep = is_short_icao | is_long_icao

    long_ok = ((df == 17) | (df == 18)) & ((syn112 == 0) | in_t112)
    df11_clean = (df == 11) & ((syn56 & 0xFFFF80) == 0)
    df11_corr = (df == 11) & ((syn56 & 0xFFFF80) != 0) & in_t56

    pass_p = ~zero7 & (long_ok | fix_ok | df11_clean | df11_corr | (icao_dep & known))
    unk_p = ~zero7 & icao_dep & ~known
    cls = torch.where(pass_p, 2, torch.where(unk_p, 1, 0))
    cls = torch.where(fired, cls, -1)
    cand_cls = cls.max(dim=1).values  # (K,)

    keep = valid & (cand_cls == 2)
    dropped = valid & ~keep
    pre_drop = dropped.sum(dtype=torch.int32)
    unk_mask = (dropped & (cand_cls == 1)).to(torch.int32)
    bad_mask = (dropped & (cand_cls == 0)).to(torch.int32)
    unknown_drop = unk_mask.sum(dtype=torch.int32)
    bad_drop = pre_drop - unknown_drop

    # --- compact kept candidates to K2 rows --------------------------------
    kidx, keep_watermark = _compact_two_level(keep, k2, keep_l, k)
    n_keep = keep.sum(dtype=torch.int32)
    safe = kidx.clamp(max=k - 1).to(torch.int64)
    live = kidx < k

    def take(a):
        g = a[safe]
        return torch.where(live.reshape((k2,) + (1,) * (a.dim() - 1)), g, torch.zeros_like(g))

    offsets2 = torch.where(live, offs[safe], scan_len)

    # signal sums for kept rows only (K2 << K gathers)
    sig_long, sig_short = window_sums(offsets2, cs_hi, cs_lo)

    # --- skip-window drop accounting (see GatedCandidates) -----------------
    zero1 = torch.zeros(1, dtype=torch.int32, device=dev)
    cum_unk = torch.cat([zero1, torch.cumsum(unk_mask, 0, dtype=torch.int32)])
    cum_bad = torch.cat([zero1, torch.cumsum(bad_mask, 0, dtype=torch.int32)])

    def cumlt(x):  # number of dropped candidates with offset < x, per class
        r = torch.searchsorted(offs, x.contiguous(), side="left")
        return torch.stack([cum_unk[r], cum_bad[r]])  # (2, ...)

    q = torch.stack([offsets2, offsets2 + 113, offsets2 + 225])  # (3, K2)
    drop_cum_q = cumlt(q)  # (2, 3, K2)
    stride = seg_stride or scan_len
    n_chan = scan_len // stride
    re = reset_every or stride
    nb = (stride + re - 1) // re  # reset boundaries per channel segment
    local = torch.arange(1, nb + 1, dtype=torch.int32, device=dev) * re
    bnds = (torch.arange(n_chan, dtype=torch.int32, device=dev)[:, None] * stride + local[None, :])
    drop_cum_bnd = cumlt(bnds.reshape(-1).clamp(max=scan_len))  # (2, C*NB)

    # per-channel drop totals: cumulative (pre, unknown, bad) at channel starts
    cum_pre = torch.cat([zero1, torch.cumsum(dropped.to(torch.int32), 0, dtype=torch.int32)])
    cstarts = torch.arange(n_chan + 1, dtype=torch.int32, device=dev) * stride
    rch = torch.searchsorted(offs, cstarts, side="left")
    drop_cum_chan = torch.stack([cum_pre[rch], cum_unk[rch], cum_bad[rch]])

    return GatedCandidates(
        offsets=offsets2,
        n_cand=bc.n_cand,
        max_local=bc.max_local,
        n_keep=n_keep,
        keep_watermark=keep_watermark,
        pre_drop=pre_drop,
        unknown_drop=unknown_drop,
        bad_drop=bad_drop,
        corr_fired=take(bc.corr_fired),
        msg=take(bc.msg),
        syn112=take(bc.syn112),
        syn56=take(bc.syn56),
        sig_long=sig_long,
        sig_short=sig_short,
        drop_cum_q=drop_cum_q,
        drop_cum_bnd=drop_cum_bnd,
        drop_cum_chan=drop_cum_chan,
        fused_overflow=bc.fused_overflow,
    )


def skipped_drops(
    frames,
    offs: np.ndarray,
    drop_cum_q: np.ndarray,
    drop_cum_bnd: np.ndarray,
    *,
    block_scan_start: int,
    reset_every: int | None,
) -> tuple[int, int]:
    """(unknown, bad) device-dropped candidates inside NMS skip windows.

    Reconstructs the serial finalizer's skip windows from the accepted
    frames (windows are disjoint by construction) and evaluates the
    device-computed cumulative drop counts at their endpoints.
    """
    unk = bad = 0
    for f in frames:
        o = f.scan_offset - block_scan_start
        e = o + f.msgbits * 2 + 1
        row = int(np.searchsorted(offs, o))
        base_u = int(drop_cum_q[0, 0, row])
        base_b = int(drop_cum_q[1, 0, row])
        if reset_every is not None:
            bnd_i = o // reset_every
            bnd = (bnd_i + 1) * reset_every
            if bnd < e:
                unk += int(drop_cum_bnd[0, bnd_i]) - base_u
                bad += int(drop_cum_bnd[1, bnd_i]) - base_b
                continue
        qi = 1 if f.msgbits == 56 else 2
        unk += int(drop_cum_q[0, qi, row]) - base_u
        bad += int(drop_cum_q[1, qi, row]) - base_b
    return unk, bad


# ---------------------------------------------------------------------------
# Device mirror of the host's two-generation ICAO filter
# ---------------------------------------------------------------------------


class DeviceIcaoMirror:
    """Mirrors IcaoFilter / the native filter's generation clock on device.

    The device representation is a sorted, sentinel-padded int32 address
    table (cur U prev generation) consumed by score_gate's binary search.
    The swap schedule replicates IcaoFilter.expire (60 s TTL, initialized
    on first expire call) so the table always equals the host filter
    state at the start of each superblock.  Capacity grows by powers of
    two, as in readsb_tpu (state.py carries it across).
    """

    TTL_MS = 60_000

    def __init__(self, capacity: int = 2048, device: torch.device | str = "cuda"):
        self.capacity = capacity
        self.device = torch.device(device)
        self._cur_set: set[int] = set()
        self._prev_set: set[int] = set()
        self.next_swap_ms: int | None = None
        self._dirty = True
        self._tbl: torch.Tensor | None = None

    @property
    def tbl(self) -> torch.Tensor:
        if self._dirty or self._tbl is None:
            vals = sorted(self._cur_set | self._prev_set)
            while len(vals) > self.capacity:
                self.capacity *= 2
            size = max(128, -(-len(vals) // 128) * 128)
            a = np.full(size, TBL_SENTINEL, np.int32)
            a[: len(vals)] = vals
            self._tbl = torch.from_numpy(a).to(self.device)
            self._dirty = False
        return self._tbl

    def add_from_frames(self, frames) -> None:
        """Apply filter additions implied by accepted frames (mode_s.c:778)."""
        for f in frames:
            if f.correctedbits:
                continue
            d = f.msg[0] >> 3
            if d == 17 or (d == 11 and f.iid == 0):
                a = f.addr & 0xFFFFFF
                if a not in self._cur_set:
                    self._cur_set.add(a)
                    self._dirty = True

    def expire(self, now_ms: int) -> bool:
        if self.next_swap_ms is None:
            self.next_swap_ms = now_ms + self.TTL_MS
            return False
        if now_ms >= self.next_swap_ms:
            self.next_swap_ms = now_ms + self.TTL_MS
            self._prev_set = self._cur_set
            self._cur_set = set()
            self._dirty = True
            return True
        return False

    def load(self, cur, prev, next_swap_ms: int | None, capacity: int) -> None:
        """Set the generations and clock (stream-state hand-over)."""
        self._cur_set = {int(a) & 0xFFFFFF for a in cur}
        self._prev_set = {int(a) & 0xFFFFFF for a in prev}
        self.next_swap_ms = None if next_swap_ms is None else int(next_swap_ms)
        self.capacity = int(capacity)
        self._dirty = True
