"""Second witness for a disagreement of a channel's counters.

    python3 -m portbench.witness --config ch64_uc8 --traffic quiet \
        --seed 5100000004 --superblocks 379 [--channels 9,13]

Feeds a configuration's channels, under a traffic mix, the same bytes a
run of that seed feeds, through the gated channel batch the benchmark
drives, and replays every channel through the reference.  For the
channels named, or else for the first two whose counters or
frames differ from the reference, it feeds the same bytes once more
through the program's ungated one-channel path (every candidate read back
and classified on the host), with the Python finalizer and with the
native one.  Prints one JSON line: the reference's six counters
(preambles, rejected bad, rejected unknown, accepted with 0/1/2 corrected
bits) and each path's counters and checks, channel by channel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--superblocks", type=int, required=True)
    p.add_argument("--channels", default="")
    args = p.parse_args(argv)
    os.environ["READSB_TPU_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "portbench",
                                                            "readsb_tpu_torch")
    import torch
    from readsb_tpu_torch.pipeline import Demodulator

    from . import compare, harness, reference

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = "cuda:0"
    cfg, traffic = harness.load_files(args.config, args.traffic, ROOT)
    cell = harness.Cell(f"{args.config}.{args.traffic}", 1, cfg, traffic, [], [])
    pool, _ = harness.render(cell, args.seed, dev)
    schedule = [i % len(pool[0]) for i in range(args.superblocks)]
    n_chan = len(pool)

    batch = harness.make_program(cfg, dev)
    gated: dict[int, list] = {c: [] for c in range(n_chan)}
    for i in schedule:
        out = batch.feed([ch[i] for ch in pool])
        for c in range(n_chan):
            gated[c].append(compare.pack_program(out[c]))
    gated_stats = {c: harness.stats_of(batch, c) for c in range(n_chan)}
    del batch, out

    ref, ref_stats = {}, {}
    for c in range(n_chan):
        frames, ref_stats[c] = reference.run_channel(cfg, pool[c], schedule, dev)
        ref[c] = [compare.pack_reference(f) for f in frames]

    def checks(frames, stats, c):
        cmp = compare.compare({c: frames}, {c: stats}, {c: ref[c]}, {c: ref_stats[c]})
        return {k: v["value"] for k, v in cmp["checks"].items()}

    differing = [c for c in range(n_chan)
                 if any(checks(gated[c], gated_stats[c], c)[k] for k in ("frames_differing",
                                                                         "stats_differing"))]
    named = [int(x) for x in args.channels.split(",") if x] or differing[:2]
    result = {"config": args.config, "traffic": args.traffic, "seed": args.seed,
              "superblocks": args.superblocks, "gated_differing_channels": differing,
              "channels": {}}
    for c in named:
        row = {"reference": ref_stats[c],
               "gated batch": {"counters": gated_stats[c],
                               "checks": checks(gated[c], gated_stats[c], c)}}
        for name, native in (("ungated python", False), ("ungated native", True)):
            d = Demodulator(fmt=cfg["fmt"], block_samples=int(cfg["block_samples"]),
                            blocks_per_batch=int(cfg["blocks_per_batch"]),
                            k_per_block=int(cfg["k_per_block"]), threshold=int(cfg["threshold"]),
                            nfix=int(cfg["nfix"]), fix_df=bool(cfg["fix_df"]),
                            use_gate=False, use_native=native, device=dev)
            frames = [compare.pack_program(d.feed(pool[c][i])) for i in schedule]
            s = d.stats
            st = [s.preambles, s.rejected_bad, s.rejected_unknown_icao, *s.accepted]
            row[name] = {"counters": st, "checks": checks(frames, st, c)}
        result["channels"][str(c)] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
