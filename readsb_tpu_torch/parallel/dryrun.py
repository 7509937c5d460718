"""The multi-chip dry run of the sharded demodulator, in PyTorch.

readsb_tpu's `__graft_entry__.dryrun_multichip` on the port: one full
sharded demod step, ungated and gated, over an n-slot (chan, time) mesh,
held to the unsharded demod_block frame for frame.

    python -m readsb_tpu_torch.parallel.dryrun [n_devices] [--device cpu]

On the card the n slots lie on the visible cards in turn, so eight slots
share one card where there is one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..constants import TRAILING_SAMPLES
from ..decode.score import Scorer, finalize_block
from ..ops import demod as demod_ops
from ..ops.gate import TBL_SENTINEL
from ..synth import encode_df17_position, frame_envelope
from . import mesh as pmesh

T_LOCAL = 8192  # samples per time shard


def mesh_slots(n: int, device) -> list[torch.device]:
    """n mesh slots on the CPU, or over the visible cards in turn ("cuda"):
    a card repeats when there are fewer cards than slots.  Raises on
    "cuda" without a CUDA device: there is no fallback to the CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device: a mesh on the CPU needs device='cpu'")
    return [torch.device("cuda", i % count) for i in range(n)]


def factor(n_devices: int) -> tuple[int, int]:
    """(n_chan, n_time) of n_devices slots: time 4, else 2, else all."""
    n_time = next(c for c in (4, 2, n_devices) if n_devices % c == 0)
    return n_devices // n_time, n_time


def place_frame(row: np.ndarray, start: int, addr: int, odd: int) -> None:
    """Write a DF17 position frame's envelope into row at `start`."""
    msg = encode_df17_position(addr, 51.0, 6.0, 32000, odd=odd)
    env = (frame_envelope(msg, 112, phase=0.0) * 38000).astype(np.uint16)
    row[start : start + len(env)] = env


def _sigsum(a) -> np.ndarray:
    s = np.asarray(a, dtype=np.int64)
    return ((s[:, 0] << 16) + s[:, 1]).astype(np.float64)


def frames_of(cols, scan_len: int) -> list[tuple[str, int]]:
    """(hex, scan offset) of the frames a fresh Scorer accepts from the
    candidate columns (offsets, corr_fired, msg, syn112, syn56, sigsum
    long, sigsum short)."""
    offs = cols[0]
    fr, _ = finalize_block(Scorer(), offs, len(offs), *cols[1:], scan_len=scan_len)
    return [(f.msg.hex(), f.scan_offset) for f in fr]


def sharded_columns(out, ch: int) -> list[np.ndarray]:
    """The candidate columns of channel row `ch` of a ShardedCandidates or
    ShardedGated, its shards merged (offsets are global and shard-major,
    so sorted), as frames_of takes them."""
    parts = []
    for s in range(out.offsets.shape[1]):
        offs = out.offsets[ch, s].cpu().numpy()
        keep = offs >= 0
        parts.append((
            offs[keep],
            out.corr_fired[ch, s].cpu().numpy()[keep],
            out.msg[ch, s].cpu().numpy()[keep],
            out.syn112[ch, s].cpu().numpy()[keep],
            out.syn56[ch, s].cpu().numpy()[keep],
            _sigsum(out.sig_long[ch, s].cpu().numpy()[keep]),
            _sigsum(out.sig_short[ch, s].cpu().numpy()[keep]),
        ))
    return [np.concatenate([p[i] for p in parts]) for i in range(7)]


def unsharded_columns(row, device, k: int = 4096) -> list[np.ndarray]:
    """The candidate columns of one channel (uint16 magnitudes, numpy or
    torch) through the unsharded demod_block, with a zero halo at the
    stream's start.  Raises when the channel has more than k candidates."""
    row = torch.as_tensor(row).to(device)
    scan_len = row.shape[0]
    buf = torch.cat([torch.zeros(TRAILING_SAMPLES, dtype=torch.uint16, device=row.device), row])
    ref = demod_ops.demod_block(buf, 58, k=k, scan_len=scan_len)
    if int(ref.n_cand) > k:
        raise AssertionError(f"the unsharded reference overflows k={k}: {int(ref.n_cand)}")
    roffs = ref.offsets.cpu().numpy()
    keep = roffs < scan_len
    return [roffs[keep], ref.corr_fired.cpu().numpy()[keep], ref.msg.cpu().numpy()[keep],
            ref.syn112.cpu().numpy()[keep], ref.syn56.cpu().numpy()[keep],
            ref.sigsum_long[keep], ref.sigsum_short[keep]]


def sharded_frames(out, ch: int, scan_len: int) -> list[tuple[str, int]]:
    """The frames of channel row `ch` of a sharded program's output."""
    return frames_of(sharded_columns(out, ch), scan_len)


def unsharded_frames(row, device, k: int = 4096) -> list[tuple[str, int]]:
    """The frames of one channel through the unsharded demod_block."""
    return frames_of(unsharded_columns(row, device, k), len(row))


def dryrun_multichip(n_devices: int, device="cuda"):
    """Run one full sharded demod step over an n_devices-slot mesh.

    Sharding layout: channel data-parallel axis x time-block sequence axis
    with the overlap-save halo copied from the left neighbour.  Holds the
    ungated and the gated program's frame sets to the unsharded
    demod_block on every channel, and returns (ShardedCandidates,
    ShardedGated)."""
    n_chan, n_time = factor(n_devices)
    mesh = pmesh.make_mesh(n_chan, n_time, mesh_slots(n_devices, device))
    total_t = T_LOCAL * n_time
    n_channels = n_chan * 2  # a couple of channels per shard

    rng = np.random.default_rng(1)
    stream = rng.integers(0, 3000, size=(n_channels, total_t), dtype=np.uint16)
    # real DF17 frames, one straddling a shard boundary, so the dry run
    # checks decoded-frame equality, not only candidate counts
    place_frame(stream[0], 1000, 0xA00001, 0)
    place_frame(stream[0], T_LOCAL - 80, 0xA00001, 1)  # straddles shard 0|1
    place_frame(stream[1], 3 * T_LOCAL // 2, 0xA00002, 0)

    ref_dev = mesh.devices[0][0]
    x = pmesh.shard_stream(stream, mesh)
    out = pmesh.build_sharded_demod(mesh, k_per_shard=512, threshold=58)(x)
    n = int(out.n_cand.sum())
    if int(out.n_cand.max()) > 512:
        raise AssertionError("k_per_shard overflow")
    want = [unsharded_frames(stream[ch], ref_dev) for ch in range(n_channels)]
    for ch in range(n_channels):
        got = sharded_frames(out, ch, total_t)
        if got != want[ch]:
            raise AssertionError(f"channel {ch}: sharded {got} != unsharded {want[ch]}")
        if ch == 0 and len(got) < 2:
            raise AssertionError("boundary frame must decode")

    # the gated production program under the same mesh
    tbl = np.full(128, TBL_SENTINEL, np.int32)
    gout = pmesh.build_sharded_gated_demod(mesh, k_per_shard=512, threshold=58)(x, tbl)
    total_drops = int(gout.pre_drop.sum())
    if total_drops <= 0:
        raise AssertionError("the gate must classify and drop noise candidates")
    for ch in range(n_channels):
        got = sharded_frames(gout, ch, total_t)
        if got != want[ch]:
            raise AssertionError(f"channel {ch}: gated {got} != unsharded {want[ch]}")

    print(
        f"dryrun_multichip OK: mesh=(chan={n_chan}, time={n_time}), "
        f"stream={stream.shape}, candidates={n}, "
        f"frame sets equal across {n_channels} channels; "
        f"gated production program (dense scan + extract/classify kernels + score gate) "
        f"sharded OK, {total_drops} candidates gate-dropped, frame parity preserved "
        f"on {[str(d) for row in mesh.devices for d in row]}",
        flush=True,
    )
    return out, gout


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, a.device)
