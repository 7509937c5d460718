"""Multi-device sharding of the demod pipeline.

readsb_tpu.parallel.mesh in PyTorch.  The sample stream is embarrassingly
parallel given a 326-sample halo: a Mode-S frame spans <= 288 samples, so
time-blocks are independent once each shard receives the previous shard's
tail (overlap-save).  Virtual receiver channels form a second, fully
independent `chan` axis.

Layout:
  mesh axes ("chan", "time"): a grid of torch.device, devices[c][t]
  stream: (C, T) magnitudes, shard (c, t) = rows c * C/n_chan ..., time
          slice t * T/n_time ... on devices[c][t] (P("chan", "time"))
  each shard scans its local T/n_time samples; the left halo is copied
  from the neighbour on the time axis

One process drives every shard, as JAX's single controller does under
shard_map: a grid may repeat a device (eight slots on one card, or
["cpu"] * 8), and on a box with several cards the halo is a peer copy.
A row of a shard runs ops.demod.demod_block (or _demod_core and the score
gate), the counterpart of jax.vmap: capacities, n_cand and max_local are
per row, as in readsb_tpu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import TRAILING_SAMPLES
from ..ops import demod as demod_ops
from ..ops import fused
from ..ops.gate import score_gate


class Mesh:
    """A (chan, time) grid of torch.device, as jax.sharding.Mesh with
    axis_names ("chan", "time"): devices[c][t] holds shard (c, t), and
    shape["time"] is the size of the time axis.  A grid may repeat a
    device."""

    axis_names = ("chan", "time")

    def __init__(self, devices):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = grid
        self.shape = {"chan": len(grid), "time": len(grid[0])}


class ShardedCandidates(NamedTuple):
    """Per-shard candidate tensors; global scan offset = local + shard base."""

    offsets: torch.Tensor  # int32[C, S, K] global scan offsets (-1 where none)
    n_cand: torch.Tensor  # int32[C, S]
    max_local: torch.Tensor  # int32[C, S] most candidates in a 256-sample block
    corr_fired: torch.Tensor  # bool[C, S, K, 3]
    msg: torch.Tensor  # uint8[C, S, K, 5, 14]
    syn112: torch.Tensor  # int32[C, S, K, 5]
    syn56: torch.Tensor  # int32[C, S, K, 5]
    sig_long: torch.Tensor  # int32[C, S, K, 2] exact (hi, lo) split mag^2 sums
    sig_short: torch.Tensor  # int32[C, S, K, 2]


class ShardedGated(NamedTuple):
    """Per-shard gated candidates (ops.gate.GatedCandidates' kept rows)."""

    offsets: torch.Tensor  # int32[C, S, K2] global (-1 where none)
    n_cand: torch.Tensor  # int32[C, S]
    n_keep: torch.Tensor  # int32[C, S]
    pre_drop: torch.Tensor  # int32[C, S]
    corr_fired: torch.Tensor  # bool[C, S, K2, 3]
    msg: torch.Tensor  # uint8[C, S, K2, 5, 14]
    syn112: torch.Tensor  # int32[C, S, K2, 5]
    syn56: torch.Tensor  # int32[C, S, K2, 5]
    sig_long: torch.Tensor  # int32[C, S, K2, 2]
    sig_short: torch.Tensor  # int32[C, S, K2, 2]


def make_mesh(n_chan: int, n_time: int, devices=None) -> Mesh:
    """The (n_chan, n_time) mesh over the first n_chan * n_time of `devices`
    (default: every CUDA device, once each).  Raises when there are fewer
    devices, and without a CUDA device unless `devices` is given; it never
    falls back to the CPU.  `devices` may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device (pass devices= for another device)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_chan * n_time:
        raise ValueError(f"make_mesh: {n_chan} x {n_time} needs {n_chan * n_time} devices, "
                         f"{len(devices)} given")
    return Mesh([devices[c * n_time : (c + 1) * n_time] for c in range(n_chan)])


def shard_stream(stream, mesh: Mesh) -> tuple[tuple[torch.Tensor, ...], ...]:
    """Place a (C, T) uint16 magnitude array (numpy or torch) with the
    (chan, time) sharding: shard [c][t] is the contiguous block of rows
    c * C / n_chan ... and samples t * T / n_time ... on mesh.devices[c][t].
    C and T must divide evenly by the axes' sizes."""
    x = torch.as_tensor(stream)
    n_chan, n_time = mesh.shape["chan"], mesh.shape["time"]
    if x.dtype != torch.uint16 or x.dim() != 2:
        raise ValueError(f"stream must be (C, T) uint16, got {x.dtype} {tuple(x.shape)}")
    c_all, t_all = x.shape
    if c_all % n_chan or t_all % n_time:
        raise ValueError(f"stream {tuple(x.shape)} does not divide over the mesh {mesh.shape}")
    c_l, t_l = c_all // n_chan, t_all // n_time
    if t_l < TRAILING_SAMPLES:
        raise ValueError(f"a time shard of {t_l} samples is shorter than the halo")
    return tuple(
        tuple(
            x[c * c_l : (c + 1) * c_l, t * t_l : (t + 1) * t_l].contiguous().to(mesh.devices[c][t])
            for t in range(n_time)
        )
        for c in range(n_chan)
    )


def _run(mesh: Mesh, stream, cls, one) -> NamedTuple:
    """Run one(buf_row, t_l, force_staged) over every row of every shard
    and assemble `cls` on mesh.devices[0][0].

    buf = [halo | shard], the halo being the left neighbour's last
    TRAILING_SAMPLES samples copied to this shard's device (zeros for
    t == 0).  Under ops.demod.USE_FUSED a row runs the fused kernel where
    that route gives it k rows (_fused_fits), and a row whose
    fused_overflow is > 0 is redone staged, as the pipeline does.
    Offsets become global: offset + t * t_l where offset < t_l (and the
    row is live), else -1."""
    shards = stream if isinstance(stream, tuple) else shard_stream(stream, mesh)
    out_dev = mesh.devices[0][0]
    grid = []
    for c, row in enumerate(shards):
        per_t = []
        for t, x in enumerate(row):
            dev = mesh.devices[c][t]
            c_l, t_l = x.shape
            if t == 0:
                halo = torch.zeros((c_l, TRAILING_SAMPLES), dtype=torch.uint16, device=dev)
            else:
                halo = row[t - 1][:, -TRAILING_SAMPLES:].to(dev)
            buf = torch.cat([halo, x], dim=1)
            res = [one(b, t_l, False) for b in buf]
            if res[0].fused_overflow is not None:
                over = torch.stack([r.fused_overflow for r in res]).tolist()
                res = [one(b, t_l, True) if o > 0 else r for b, r, o in zip(buf, res, over)]
            fields = {}
            for f in cls._fields:
                if f == "offsets":
                    parts = []
                    for r in res:
                        ok = r.offsets < t_l
                        if getattr(r, "live", None) is not None:
                            ok = ok & r.live
                        parts.append(torch.where(ok, r.offsets + t * t_l, -1))
                    fields[f] = torch.stack(parts)
                else:
                    fields[f] = torch.stack([getattr(r, f) for r in res])
            per_t.append(fields)
        grid.append(per_t)
    return cls(**{
        f: torch.cat(
            [torch.stack([s[f].to(out_dev) for s in per_t], dim=1) for per_t in grid], dim=0
        )
        for f in cls._fields
    })


def _fused_fits(t_l: int, k: int) -> bool:
    """The fused route returns ntiles * max(128, k // ntiles) rows: it is
    taken only where that is k, so that every row of a shard has k rows."""
    ntiles = -(-t_l // fused.TILE)
    return k % ntiles == 0 and k // ntiles >= 128


def build_sharded_demod(mesh: Mesh, *, k_per_shard: int = 256, threshold: int = 58):
    """Returns fn: (C, T) uint16 magnitudes (numpy, torch or shard_stream's
    output) -> ShardedCandidates, every field on mesh.devices[0][0].

    T must divide evenly by the `time` axis size; each local shard of
    length Tl scans offsets [0, Tl) of its padded buffer, with the halo
    (previous shard's last TRAILING_SAMPLES magnitudes) copied from its
    neighbour.  The very first shard sees zeros, matching the stream
    start semantics of the block pipeline.  On the card a row runs
    kernels #4 (dense_scan) and #2 (extract_syndromes), or #7 under
    ops.demod.USE_FUSED.
    """

    def one(b, t_l, staged):
        staged = staged or not _fused_fits(t_l, k_per_shard)
        return demod_ops.demod_block(b, threshold, k=k_per_shard, scan_len=t_l,
                                     force_staged=staged)

    def sharded_demod(stream) -> ShardedCandidates:
        return _run(mesh, stream, ShardedCandidates, one)

    return sharded_demod


def build_sharded_gated_demod(
    mesh: Mesh,
    *,
    k_per_shard: int = 512,
    threshold: int = 58,
    k2: int = 256,
    keep_l: int = 32,
    nfix: int = 1,
    fix_df: bool = True,
):
    """The production gated program per shard: the dense scan, the
    extraction with the gate's classification (kernels #4 and #5 on the
    card, #7 under ops.demod.USE_FUSED) and the device score gate, with
    the 326-sample halo copied from the left neighbour.  Returns fn:
    ((C, T) uint16 magnitudes, known_tbl int32[T128]) -> ShardedGated with
    GLOBAL offsets (sentinel -1), every field on mesh.devices[0][0].
    known_tbl is sorted and padded with gate.TBL_SENTINEL, as
    DeviceIcaoMirror.tbl; it is copied once to each device of the mesh.
    """

    def sharded_gated(stream, tbl) -> ShardedGated:
        tbl = torch.as_tensor(tbl)
        tbls = {}

        def one(b, t_l, staged):
            known = tbls.get(b.device)
            if known is None:
                known = tbls[b.device] = tbl.to(b.device)
            bc, cs_hi, cs_lo = demod_ops._demod_core(
                b, threshold, k=k_per_shard, scan_len=t_l, l=64,
                known_tbl=known, nfix=nfix, fix_df=fix_df,
                force_staged=staged or not _fused_fits(t_l, k_per_shard),
            )
            return score_gate(
                bc, known, cs_hi, cs_lo, t_l, scan_len=t_l, k2=k2,
                nfix=nfix, fix_df=fix_df, keep_l=keep_l,
            )

        return _run(mesh, stream, ShardedGated, one)

    return sharded_gated
