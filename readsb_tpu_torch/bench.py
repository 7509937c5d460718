"""Benchmark: sustained Mode-S demodulation throughput on one card.

The port of the JAX repo's `bench.py`:

    python3 -m readsb_tpu_torch.bench [n_chan]

The headline is the aggregate multichannel rate: n_chan (default 64)
virtual receiver channels of one 131072-sample block each (the reference's
SDR buffer cadence, readsb.c:228) demodulated by one dispatch of the
production channel-batched program, `pipeline.gated_dispatch` on the raw
route (raw UC8 words in, the gated candidates out), on words already on
the card.  The capture is bench.py's: `synth.build_standard_capture`, 8
aircraft, seed 3, quantized to UC8.

Timing: CUDA events around 10 back-to-back dispatches, 5 runs after a
warm-up; the median run per dispatch is the headline, with every run's ms
beside it.  bench.py's carry chain and its null-chain subtraction are gone:
they exist because a TPU reached through a relay can report a dispatch
done before it ran, so bench.py threaded a scalar through the dispatches
and subtracted the relay's per-dispatch cost.  On the card, events
recorded on the dispatches' stream time the device work itself, and there
is no relay cost to subtract.

Output: an extra line with `MultiDemodulator.feed()` end to end (upload,
dispatch, readback, host finalizer) and its frame count, then, last, one
JSON line {"metric": "demod_throughput", "value", "unit": "Msamples/s",
"vs_baseline", "device", "power_limit_w", "runs_ms", "n_chan", ...}.
vs_baseline is the value over 2.4 MS/s, the reference demodulator's
realtime rate on one core (BASELINE.md).  Without a card it raises: the
bench never times on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .constants import BLOCK_SAMPLES, PREAMBLE_THRESHOLD_DEFAULT, SAMPLE_RATE, TRAILING_SAMPLES
from .pipeline import SILENT_WORD, MultiDemodulator, gated_dispatch
from .synth import build_standard_capture, quantize_uc8
from .tools import device_fields, require_card

BASELINE_MSPS = 2.4  # the reference demodulator's realtime rate on one core
FRAME_SAMPLES = 288  # preamble (8 us) + 112 bits (112 us) at 2.4 MS/s


def render_workload(n_blocks: int, seed: int = 3) -> tuple[np.ndarray, list[dict]]:
    """bench.py's capture: the complex IQ of n_blocks demod blocks of 8
    aircraft, and the capture's truth (which runs 0.1 s past the blocks)."""
    total = n_blocks * BLOCK_SAMPLES
    cap = build_standard_capture(duration_s=total / SAMPLE_RATE + 0.1, n_aircraft=8, seed=seed)
    return cap.render_iq()[:total], cap.truth


def build_workload(n_blocks: int, seed: int = 3) -> tuple[np.ndarray, int, list[dict]]:
    """UC8 IQ bytes of n_blocks demod blocks with realistic traffic, the
    sample count, and the truth: the messages that lie whole inside it."""
    iq, truth = render_workload(n_blocks, seed)
    total = len(iq)
    inside = [t for t in truth if round(t["t"] * SAMPLE_RATE) + FRAME_SAMPLES <= total]
    return quantize_uc8(iq), total, inside


def dispatch_args(multi: MultiDemodulator) -> dict:
    """bench.py's static arguments of the dispatch, from a warm demodulator
    (the capacities its feed() escalated to)."""
    return dict(
        k=multi.k, scan_len=multi.scan_len, l=multi.compact_l, k2=multi.gate_k2,
        nfix=multi.nfix, fix_df=multi.fix_df, reset_every=multi.block_samples,
        seg_stride=multi.seg_stride, seg_valid=multi.seg_valid, keep_l=multi.gate_keep_l,
    )


def make_dispatch(multi: MultiDemodulator, words: torch.Tensor):
    """One dispatch of the raw route over words (n_chan, BLOCK_SAMPLES)
    uint16 staged on the demodulator's device, as a closure that returns
    the GatedCandidates; the overlap is the stream's first (silent) one, so
    it repeats feed()'s first dispatch of those words.  The routes' module
    constants (pipeline.FUSE_CLASSIFY, ops.demod.USE_FUSED) are read at
    each call."""
    overlap = torch.full((multi.n_chan, TRAILING_SAMPLES), SILENT_WORD, dtype=torch.uint16,
                         device=multi.device)
    kw = dispatch_args(multi)
    tbl = multi.mirror.tbl

    def dispatch():
        return gated_dispatch(
            words, overlap, multi.seg_valid, PREAMBLE_THRESHOLD_DEFAULT, tbl, raw_uc8=True, **kw
        )[0]

    return dispatch


def time_dispatch(dispatch, reps: int = 10, runs: int = 5, warm: int = 3) -> list[float]:
    """ms per dispatch of `runs` runs, each CUDA events around `reps`
    back-to-back dispatches, after `warm` dispatches."""
    for _ in range(warm):
        dispatch()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            dispatch()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return out


def run(n_chan: int = 64) -> dict:
    """Measure and print; returns the JSON line's object under "line", with
    the warm-up feed()'s frames per channel, the chunks, the truth, the
    demodulator and the dispatch closure (for the caller's checks)."""
    dev = require_card()
    raw, total, truth = build_workload(n_chan)
    chunks = [bytes(raw[c * BLOCK_SAMPLES * 2 : (c + 1) * BLOCK_SAMPLES * 2])
              for c in range(n_chan)]
    multi = MultiDemodulator(n_chan, blocks_per_batch=1, device=dev)
    frames = multi.feed(chunks)  # builds the kernels, escalates the capacities
    words = torch.from_numpy(raw.view("<u2").reshape(n_chan, BLOCK_SAMPLES).copy()).to(dev)
    dispatch = make_dispatch(multi, words)
    runs = time_dispatch(dispatch)
    ms = statistics.median(runs)
    msps = total / ms / 1e3

    # feed() end to end, continuing the stream: the second superblock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nframes = sum(len(f) for f in multi.feed(chunks))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"e2e multichannel feed: {total / dt / 1e6:.1f} MS/s ({dt * 1e3:.1f} ms for "
          f"{n_chan} x {BLOCK_SAMPLES} samples: upload, dispatch, readback, host finalizer), "
          f"{nframes} frames", flush=True)
    line = {
        "metric": "demod_throughput", "value": msps, "unit": "Msamples/s",
        "vs_baseline": msps / BASELINE_MSPS, **device_fields(dev),
        "runs_ms": runs, "ms": ms, "n_chan": n_chan, "samples": total,
        "dispatches_per_run": 10, "feed_msps": total / dt / 1e6, "feed_frames": nframes,
    }
    print(json.dumps(line), flush=True)
    return {"line": line, "frames": frames, "chunks": chunks, "truth": truth,
            "multi": multi, "dispatch": dispatch}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_chan", nargs="?", type=int, default=64,
                    help="channels of one block each per dispatch")
    return run(ap.parse_args(argv).n_chan)["line"]


if __name__ == "__main__":
    main()
