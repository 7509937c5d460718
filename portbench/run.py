"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Needs as many CUDA devices as the cell
asks for; without them it exits with code 2 and prints no result.  The
kernel libraries and any cache the program builds go to build/portbench/
inside the checkout, so only a checkout's first run builds them.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (--trace 0: the cell's end-to-end metrics; --trace 1:
its per-layer metrics), device, with --trace 1 a breakdown of device
operations and idle gaps, and last the numbers that decided `correct`,
each beside its limit, which also end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "portbench")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # fixed places inside the checkout, read by the program at import
    os.environ["READSB_TPU_TORCH_BUILD_DIR"] = os.path.join(CACHE, "readsb_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

    from . import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    lines = result.pop("stderr")
    order = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
    line = {k: result[k] for k in order if k in result}
    sys.stdout.flush()
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
