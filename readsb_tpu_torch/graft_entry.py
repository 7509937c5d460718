"""Entry points of the single-device compile check and the multi-chip dry
run.

The port of the JAX repo's `__graft_entry__.py`:

    python3 -m readsb_tpu_torch.graft_entry [n_devices] [--device cpu]

runs `entry()`'s step once and then `dryrun_multichip` over n_devices mesh
slots, as the original's `__main__` does.  The slots lie on the visible
cards in turn (`parallel/dryrun.mesh_slots`), so the default of 8 slots
runs on one card as on eight (the original's `__main__` passes its
device count).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .constants import TRAILING_SAMPLES
from .ops import demod as demod_ops
from .parallel.dryrun import dryrun_multichip  # the original's second entry point
from .pipeline import _resolve_device

BLOCK = 32768
N_BLOCKS = 4
K = 256
THRESHOLD = 58


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship pipeline.

    The flagship "model" is the batched Mode-S demodulator: magnitude
    blocks in, compacted candidate frames (sliced bits, CRC syndromes,
    signal power) out.  fn(bufs, threshold) runs `ops.demod.demod_block`
    on each of the 4 blocks and stacks every field of the BlockCandidates
    along a leading axis of 4, as the original's `jax.vmap` does: the
    kernels go through ctypes, so the blocks run one after another."""
    dev = _resolve_device(device)

    def fn(bufs, threshold):
        outs = [demod_ops.demod_block(b, threshold, k=K, scan_len=BLOCK) for b in bufs]
        return demod_ops.BlockCandidates(*(
            None if fields[0] is None else torch.stack(fields) for fields in zip(*outs)
        ))

    rng = np.random.default_rng(0)
    bufs = rng.integers(0, 3000, size=(N_BLOCKS, BLOCK + TRAILING_SAMPLES), dtype=np.uint16)
    return fn, (torch.from_numpy(bufs).to(dev), THRESHOLD)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    if args[0].is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", {k: None if v is None else tuple(v.shape) for k, v in out._asdict().items()},
          flush=True)
    dryrun_multichip(a.n_devices, a.device)


if __name__ == "__main__":
    main()
