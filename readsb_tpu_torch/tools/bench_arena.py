"""Arena bulk-update throughput on the card (`track/arena.Arena.update_batch`).

The port of the JAX repo's `tools/bench_arena.py`:

    python3 -m readsb_tpu_torch.tools.bench_arena [n_msgs_per_batch] [n_batches]

B batches (default 20) of M messages (default 4096) over 10,000 aircraft,
built as the original builds them.  It measures the full path, the host's
batch build in Python and the device update, as msgs/s on the host clock
around a synchronize; and per update the CUDA-events ms of the device part
(`Arena._update`: the upload and `arena_update`) and, on a fresh arena
under torch.profiler, the device launches and device-busy ms.  The last
line is one JSON object {"metric": "arena_update_throughput", ...}.
Without a card it raises: it never times on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..decode.fields import ModesMessage, Source
from ..track.arena import Arena
from . import device_fields, require_card

N_AIRCRAFT = 10_000


def build_batches(m: int, b: int) -> list[list[ModesMessage]]:
    """b batches of m DF17 messages of 10,000 aircraft, default_rng(0), as
    the original builds them."""
    rng = np.random.default_rng(0)
    addrs = rng.integers(0x100000, 0x100000 + N_AIRCRAFT, m * b)
    t = 1_000_000
    batches = []
    for j in range(b):
        msgs = []
        for i in range(m):
            t += 1
            mm = ModesMessage(msgtype=17, addr=int(addrs[j * m + i]),
                              source=Source.ADSB, sys_timestamp_ms=t)
            mm.gs_selected = 450.0
            mm.baro_rate = -640.0
            mm.ias = 280.0
            msgs.append(mm)
        batches.append(msgs)
    return batches


class TimedArena(Arena):
    """An Arena that records CUDA events around each device update."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.events = []

    def _update(self, cols: dict, rounds: int) -> torch.Tensor:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ys = super()._update(cols, rounds)
        e1.record()
        self.events.append((e0, e1))
        return ys


def run(m: int = 4096, b: int = 20) -> dict:
    """Measure and print; returns the JSON line's object."""
    dev = require_card()
    batches = build_batches(m, b)

    arena = TimedArena(device=dev)
    arena.update_batch(batches[0])  # warm: the allocator, the first launches
    torch.cuda.synchronize()
    arena.events.clear()
    t0 = time.perf_counter()
    for msgs in batches:
        arena.update_batch(msgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    upd_ms = [e0.elapsed_time(e1) for e0, e1 in arena.events]

    # device launches and device-busy time per update: the same batches on
    # a fresh arena under torch.profiler
    fresh = Arena(device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for msgs in batches:
            fresh.update_batch(msgs)
        torch.cuda.synchronize()
    devs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not devs:
        raise RuntimeError("torch.profiler saw no device activity of the arena")

    total = m * b
    line = {
        "metric": "arena_update_throughput", "value": total / dt, "unit": "msgs/s",
        **device_fields(dev), "n_msgs": total, "m": m, "b": b, "seconds": dt,
        "aircraft": len(arena.slot_of), "slots": arena.n,
        "update_ms": {"median": statistics.median(upd_ms), "min": min(upd_ms),
                      "max": max(upd_ms), "n": len(upd_ms)},
        "device_launches_per_update": sum(e.count for e in devs) / b,
        "device_busy_ms_per_update": sum(e.self_device_time_total for e in devs) / b / 1e3,
    }
    upd = line["update_ms"]
    print(f"arena bulk update: {total} msgs in {dt * 1e3:.1f} ms -> {total / dt / 1e3:.0f}k "
          f"msgs/s ({len(arena.slot_of)} aircraft); device update by CUDA events median "
          f"{upd['median']:.3f} ms (min {upd['min']:.3f}, max {upd['max']:.3f}), "
          f"{line['device_launches_per_update']:.0f} device launches and "
          f"{line['device_busy_ms_per_update']:.3f} ms device busy per update", flush=True)
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", nargs="?", type=int, default=4096, help="messages per batch")
    ap.add_argument("b", nargs="?", type=int, default=20, help="batches")
    a = ap.parse_args(argv)
    return run(a.m, a.b)


if __name__ == "__main__":
    main()
