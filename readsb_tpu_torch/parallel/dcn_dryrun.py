"""Two-process run of the sharded demodulator: readsb_tpu's
tools/dcn_dryrun.py on the port.

Virtual receiver channels are split across processes (the DCN axis of a
multi-host deployment) and time-blocks across each process's local mesh,
so the 326-sample halo never leaves a process.  The only traffic between
processes is control: a gloo group over TCP, a gather of each rank's
verdict and a barrier.  No device tensor crosses a process, so gloo
carries it on the CPU and on the card alike.

Each rank holds frame-set equality between its channels' sharded run and
the unsharded demod_block; the launcher requires both ranks to succeed.

    python -m readsb_tpu_torch.parallel.dcn_dryrun [--device cpu]

With one card both ranks share it.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

N_PROC = 2
CHAN_PER_PROC = 2  # channel rows (and chan shards) per process
N_TIME = 2  # time shards of each process's local mesh
T_LOCAL = 8192
RANK_TIMEOUT_S = 300.0
MODULE = "readsb_tpu_torch.parallel.dcn_dryrun"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher(device: str = "cuda", fail_rank: int | None = None,
             timeout_s: float = RANK_TIMEOUT_S) -> int:
    """Start the N_PROC ranks, wait for them and return 0 if every rank
    succeeded, else 1.  A rank that fails, or that is still running after
    timeout_s, ends the run: every rank still running is killed.
    fail_rank: that rank holds its channels to a reference without the
    boundary frame, so its check fails (the launcher's own test)."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    procs = []
    try:
        for r in range(N_PROC):
            cmd = [sys.executable, "-m", MODULE, "--rank", str(r), "--port", str(port),
                   "--device", device]
            if r == fail_rank:
                cmd.append("--fail")
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        print(f"dcn_dryrun FAILED: ranks exited {rcs}", file=sys.stderr, flush=True)
        return 1
    print(f"dcn_dryrun OK: {N_PROC} processes x (chan={CHAN_PER_PROC}, time={N_TIME}) "
          f"meshes on {device}", flush=True)
    return 0


def worker(rank: int, port: int, device: str, fail: bool) -> None:
    import torch.distributed as dist

    from .dryrun import mesh_slots, place_frame, sharded_frames, unsharded_frames
    from .mesh import build_sharded_demod, make_mesh, shard_stream

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=N_PROC, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
    )
    try:
        n_channels = N_PROC * CHAN_PER_PROC
        total_t = T_LOCAL * N_TIME
        # every rank builds the same stream and takes its own channel rows
        rng = np.random.default_rng(7)
        stream = rng.integers(0, 3000, size=(n_channels, total_t), dtype=np.uint16)
        plain = stream.copy()
        for ch in range(n_channels):
            place_frame(stream[ch], 1000 + 37 * ch, 0xB00000 + ch, 0)
            place_frame(plain[ch], 1000 + 37 * ch, 0xB00000 + ch, 0)
            # one frame straddling a time-shard boundary per channel
            place_frame(stream[ch], T_LOCAL - 80, 0xB00000 + ch, 1)
        reference = plain if fail else stream

        mesh = make_mesh(CHAN_PER_PROC, N_TIME, mesh_slots(CHAN_PER_PROC * N_TIME, device))
        rows = slice(rank * CHAN_PER_PROC, (rank + 1) * CHAN_PER_PROC)
        out = build_sharded_demod(mesh, k_per_shard=512, threshold=58)(
            shard_stream(stream[rows], mesh))
        checked = 0
        for c in range(CHAN_PER_PROC):
            ch = rank * CHAN_PER_PROC + c
            got = sharded_frames(out, c, total_t)
            want = unsharded_frames(reference[ch], mesh.devices[0][0])
            if got != want:
                raise AssertionError(f"rank {rank}, channel {ch}: {got} != {want}")
            if len(got) < 2:
                raise AssertionError(f"rank {rank}, channel {ch}: boundary frame must decode")
            checked += 1
        counts = [None] * N_PROC
        dist.all_gather_object(counts, checked)
        dist.barrier()
        print(f"rank {rank}: {checked} local channels frame-equal (chan={CHAN_PER_PROC} x "
              f"time={N_TIME} on {mesh.devices[0][0]}); ranks checked {counts}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="two-process run of the sharded demodulator")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--fail", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is None:
        sys.exit(launcher(a.device))
    worker(a.rank, a.port, a.device, a.fail)
