"""Fused dense scan -> in-tile compaction -> extraction, per tile.

readsb_tpu.ops.fused in PyTorch + CUDA.  The staged route passes every
stage's result through device memory (correlation bits and plane words
written by the dense scan, read by the compaction and the win-row build,
candidate rows gathered back for the extraction) and takes some 300
launches per dispatch.  This kernel (csrc/fused_demod.cu: a memset, then
one launch of a cluster of eight blocks per 65536-sample tile) keeps a
tile in shared memory end to end:

  1. dense preamble / correlations and slicer sign planes over the tile
     and the samples past it that its windows reach
  2. in-tile compaction of the candidates to `cap` ascending offsets
  3. extraction of the live rows straight from the tile's plane words;
     the other rows are copies of the tile's offset-0 row

Per-tile outputs: comb (cap, 128) in the extraction's layout, global
offsets (cap,) + live mask, per-tile meta (count, most per 256-sample
block, most per 128-sample row) and the split mag^2 prefix sums (the
gate's window sums read those).  Capacity is per tile; rows that are not
live carry the tile's end as offset, so the concatenated list stays
nondecreasing for the gate's searchsorted accounting, and hold the
extraction at the tile's offset 0.

A candidate beyond `cap` in its tile, or beyond L_ROW in its 128-sample
row, is not live: the caller sees it in meta and redoes the block on the
staged route (ops.demod._demod_core_fused, pipeline's _force_staged).
readsb_tpu's kernel needs cap % 128 == 0; this one takes any cap >= 1.
"""

from __future__ import annotations

import torch

from . import kernels

TILE = 65536  # samples per tile
HALO = 1024  # lookahead samples >= 352-sample window + 31-bit shift
L_ROW = 16  # most live candidates within one 128-sample row, as readsb_tpu
_ROW = 128
_BLK = 256


def _check_args(buf, cap, seg_stride, seg_valid, scan_limit) -> int:
    if buf.dtype != torch.uint16 or buf.dim() != 1:
        raise ValueError(f"buf must be 1-D uint16, got {buf.dtype} {tuple(buf.shape)}")
    n = buf.shape[0]
    if n < TILE or n % TILE not in (0, HALO) or n >= 1 << 31:
        raise ValueError(
            f"buf length {n} is not T * {TILE} or T * {TILE} + {HALO} with T >= 1, below 2^31"
        )
    if cap < 1:
        raise ValueError(f"cap {cap} must be >= 1")
    if (seg_stride is None) != (seg_valid is None) or (seg_stride is not None and seg_stride < 1):
        raise ValueError(f"bad channel layout {seg_stride=} {seg_valid=}")
    tiled = n // TILE * TILE
    return tiled if scan_limit is None else min(int(scan_limit), tiled)


def fused_demod_tiles_plain(
    buf: torch.Tensor,
    threshold: int,
    *,
    cap: int,
    seg_stride: int | None = None,
    seg_valid: int | None = None,
    scan_limit: int | None = None,
):
    """Plain PyTorch version of fused_demod_tiles (same contract)."""
    limit = _check_args(buf, cap, seg_stride, seg_valid, scan_limit)
    dev = buf.device
    n = buf.shape[0]
    ntiles = n // TILE

    # 1. dense math; the halo past the end is zero magnitudes
    m = torch.zeros(ntiles * TILE + HALO, dtype=torch.int32, device=dev)
    m[:n] = buf.to(torch.int32)
    corrbits, pwords, cs_hi, cs_lo = kernels.dense_from_mag(m, threshold, tail=0)
    pos = torch.arange(ntiles * TILE, dtype=torch.int32, device=dev)
    cand = ((corrbits[: ntiles * TILE] & 8) != 0) & (pos < limit)
    if seg_stride is not None:
        cand &= (pos % seg_stride) < seg_valid

    # 2. per-tile ranks, and ranks within each 128-sample row
    c32 = cand.to(torch.int32)
    rank = torch.cumsum(c32.reshape(ntiles, TILE), 1).reshape(-1) - 1
    row_tot = c32.reshape(-1, _ROW).sum(1, dtype=torch.int32)
    row_excl = torch.cumsum(row_tot.reshape(ntiles, TILE // _ROW), 1).reshape(-1) - row_tot
    local_rank = rank - row_excl.repeat_interleave(_ROW)
    count = row_tot.reshape(ntiles, -1).sum(1, dtype=torch.int32)
    meta = torch.stack(
        [
            count,
            c32.reshape(ntiles, TILE // _BLK, _BLK).sum(2, dtype=torch.int32).max(1).values,
            row_tot.reshape(ntiles, -1).max(1).values,
        ],
        dim=1,
    )

    kept = (cand & (rank < cap)).nonzero()[:, 0]  # ascending positions
    tile_of = kept // TILE
    slot = tile_of * cap + rank[kept]
    is_live = local_rank[kept] < L_ROW
    live = torch.zeros(ntiles * cap, dtype=torch.bool, device=dev)
    live[slot] = is_live
    tile_base = (torch.arange(ntiles, dtype=torch.int32, device=dev) * TILE).repeat_interleave(cap)
    offsets = tile_base + TILE
    offsets[slot[is_live]] = kept[is_live].to(torch.int32)

    # 3. extraction at the live offsets, at the tile's offset 0 elsewhere
    g = torch.where(live, offsets, tile_base).to(torch.int64)
    p64 = pwords.to(torch.int64) & 0xFFFFFFFF
    idx = (g >> 5)[:, None] + torch.arange(12, device=dev)  # (K, 12) window words
    sw = kernels.funnel_align(p64[:, idx].permute(1, 0, 2), (g & 31)[:, None, None])
    corr = (corrbits[g].to(torch.int64)[:, None] >> torch.arange(3, device=dev)) & 1
    comb = kernels.pad_lanes(kernels.lanes_from_aligned(sw.reshape(-1, 55), corr))
    return comb, offsets, live, meta, cs_hi[:n], cs_lo[:n]


def fused_demod_tiles(
    buf: torch.Tensor,
    threshold: int,
    *,
    cap: int,
    seg_stride: int | None = None,
    seg_valid: int | None = None,
    scan_limit: int | None = None,
):
    """buf: uint16[n] magnitudes of T = n // TILE tiles, n = T * TILE or
    T * TILE + HALO.  The longer form brings the last tile's halo with it
    (readsb_tpu's kernel takes the shorter one only, where that halo is
    zeros); the prefix sums cover all n samples either way.

    A candidate is a sample with the pre-check and any correlation set,
    below scan_limit (default T * TILE) and, with seg_stride / seg_valid
    given, with (position % seg_stride) < seg_valid.  Samples past the end
    read as magnitude 0.  Returns

      comb     int32[T * cap, 128]  per row the lanes of extract_syndromes
      offsets  int32[T * cap]       position of a live row, else the end of
                                    its tile; nondecreasing
      live     bool[T * cap]        the first min(count, cap) candidates of
                                    a tile whose rank within their
                                    128-sample row is below L_ROW
      meta     int32[T, 3]          (count, most per 256-sample block, most
                                    per 128-sample row) over all candidates
      cs_hi, cs_lo  int32[n]        as kernels.dense_scan

    A row that is not live holds the extraction at its tile's offset 0.
    Any cap >= 1.
    """
    limit = _check_args(buf, cap, seg_stride, seg_valid, scan_limit)
    if kernels._on_cpu(buf):
        return fused_demod_tiles_plain(
            buf, threshold, cap=cap, seg_stride=seg_stride, seg_valid=seg_valid,
            scan_limit=scan_limit,
        )
    buf = buf.contiguous()
    if buf.data_ptr() % 16:  # the kernel reads 16-byte chunks
        buf = buf.clone()
    lib = kernels._launcher("fused_demod", buf)
    dev = buf.device
    n = buf.shape[0]
    rows = (n // TILE) * cap
    comb = torch.empty((rows, 128), dtype=torch.int32, device=dev)
    offsets = torch.empty(rows, dtype=torch.int32, device=dev)
    live = torch.empty(rows, dtype=torch.bool, device=dev)
    meta = torch.empty((n // TILE, 3), dtype=torch.int32, device=dev)
    cs_hi = torch.empty(n, dtype=torch.int32, device=dev)
    cs_lo = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(kernels.dense_scratch_words(n), dtype=torch.int32, device=dev)
    rc = lib.fused_demod(
        buf.data_ptr(), n, int(threshold), int(cap), int(L_ROW),
        int(seg_stride or 0), int(seg_valid or 0), limit,
        comb.data_ptr(), offsets.data_ptr(), live.data_ptr(), meta.data_ptr(),
        cs_hi.data_ptr(), cs_lo.data_ptr(), scratch.data_ptr(), kernels._stream(buf),
    )
    kernels._check(lib, rc, "fused_demod")
    fused_demod_tiles.launches += 1
    return comb, offsets, live, meta, cs_hi, cs_lo


fused_demod_tiles.launches = 0
