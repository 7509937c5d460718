"""Readings that the limits of `correct` are set from, in one process.

    python3 -m portbench.calibrate --workload sc16nodf_quiet --superblocks 240 \
        --seeds 11,12,13 --control-seeds 21,22,23

For each seed of --seeds it drives the program through the warm-up and
--superblocks more calls (as many as a run's window holds), untimed, and
compares every channel with the reference, as a run does.  For each seed
of --control-seeds the control takes the program's place: the reference
with its magnitudes rounded through float16, compared with the
reference.  One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--superblocks", type=int, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    os.environ["READSB_TPU_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "portbench",
                                                            "readsb_tpu_torch")
    import torch

    from . import compare, harness, reference

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = "cuda:0"
    cell = harness.load_cell(args.workload, ROOT)
    cfg = cell.cfg
    n_chan = int(cfg["channels"])
    n = int(cfg["warmup_superblocks"]) + args.superblocks

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    for kind, seed in [("program", s) for s in seeds(args.seeds)] + [
        ("control", s) for s in seeds(args.control_seeds)
    ]:
        t0 = time.perf_counter()
        pool, _ = harness.render(cell, seed, device)
        n_pool = len(pool[0])
        schedule = [i % n_pool for i in range(n)]
        channels = range(n_chan)
        frames, stats = {}, {}
        if kind == "program":
            program = harness.make_program(cfg, device)
            frames = {c: [] for c in channels}
            for i in schedule:
                out = program.feed([pool[c][i] for c in range(n_chan)])
                for c in channels:
                    frames[c].append(compare.pack_program(out[c]))
            stats = {c: harness.stats_of(program, c) for c in channels}
            del program, out
        else:
            for c in channels:
                fr, st = reference.run_channel(cfg, pool[c], schedule, device, "float16")
                frames[c] = [compare.pack_reference(f) for f in fr]
                stats[c] = st
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref_frames, ref_stats = {}, {}
        for c in channels:
            fr, st = reference.run_channel(cfg, pool[c], schedule, device)
            ref_frames[c] = [compare.pack_reference(f) for f in fr]
            ref_stats[c] = st
        cmp = compare.compare(frames, stats, ref_frames, ref_stats)
        stat_gaps = {c: [a - b for a, b in zip(stats[c], ref_stats[c])]
                     for c in channels if stats[c] != ref_stats[c]}
        print(json.dumps({
            "workload": args.workload, "kind": kind, "seed": seed, "superblocks": n,
            "checks": {k: v["value"] for k, v in cmp["checks"].items()},
            "failing_superblocks": cmp["failing"][:20], "stat_gaps": stat_gaps,
            "frames": sum(len(x[1]) for f in ref_frames.values() for x in f),
            "seconds": {"side": t1 - t0, "reference": time.perf_counter() - t1},
            "device": torch.cuda.get_device_name(0),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
