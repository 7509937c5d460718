"""One run of one cell: set-up, the measured window, the traced reading
and the check against the reference.

Everything that belongs to a cell is found by name: the cell in
BENCHMARK.json, its configuration in configs/<config>.json, its traffic
in traffic/<traffic>.json (whose "generator" names the module that
renders it), and each per-layer metric in metrics/<name>.py, a reader
`read(ctx) -> float | None` over a trace.Context.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from . import compare, reference, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "readsb_tpu"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its files."""
    bench = _read_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; one of {sorted(cells)}")
    w = cells[workload]
    cfg, traffic = load_files(w["config"], w["traffic"], root)
    return Cell(name=workload, chips=int(w["chips"]), cfg=cfg, traffic=traffic,
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def load_files(config: str, traffic: str, root: str = ROOT) -> tuple[dict, dict]:
    """configs/<config>.json and traffic/<traffic>.json."""
    return (_read_json(root, "portbench", "configs", config + ".json"),
            _read_json(root, "portbench", "traffic", traffic + ".json"))


def load_reader(name: str, root: str = ROOT):
    """The `read` function of metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_program(cfg: dict, device):
    """The system under test, built as App.run_ifile_multi builds it."""
    from readsb_tpu_torch.pipeline import MultiDemodulator

    return MultiDemodulator(
        int(cfg["channels"]), fmt=cfg["fmt"], block_samples=int(cfg["block_samples"]),
        blocks_per_batch=int(cfg["blocks_per_batch"]), k_per_block=int(cfg["k_per_block"]),
        threshold=int(cfg["threshold"]), nfix=int(cfg["nfix"]), fix_df=bool(cfg["fix_df"]),
        device=device,
    )


def stats_of(program, c: int) -> list[int]:
    s = program.channel_stats(c)
    return [s.preambles, s.rejected_bad, s.rejected_unknown_icao, *s.accepted]


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is that of JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def render(cell: Cell, seed: int, device):
    gen = importlib.import_module(cell.traffic["generator"])
    return gen.render(cell.traffic, cell.cfg, seed, device)


def reference_check(cell: Cell, pool, schedule, recorded, prog_stats, device) -> dict:
    """Replay every recorded channel through the reference and compare."""
    ref_frames, ref_stats = {}, {}
    for c in recorded:
        frames, stats = reference.run_channel(cell.cfg, pool[c], schedule, device)
        ref_frames[c] = [compare.pack_reference(f) for f in frames]
        ref_stats[c] = stats
    return compare.compare(recorded, prog_stats, ref_frames, ref_stats)


def candidates_per_call(cell: Cell, pool, schedule, device) -> list[int]:
    """Preamble candidates of every call in `schedule`, over all channels
    (the extraction's real work), from the reference's own scan."""
    cfg = cell.cfg
    tail = reference.TRAILING * (2 if cfg["fmt"] == "uc8" else 4)
    scan = int(cfg["block_samples"]) * int(cfg["blocks_per_batch"])
    per_key: dict = {}
    out = []
    for pos, idx in enumerate(schedule):
        prev = schedule[pos - 1] if pos else None
        if (prev, idx) not in per_key:
            n = 0
            for ch in pool:
                overlap = reference.silence(cfg["fmt"]) * reference.TRAILING if prev is None \
                    else ch[prev][-tail:]
                mag = reference.magnitudes(overlap + ch[idx], cfg["fmt"], device)
                n += reference.candidate_count(mag, scan, int(cfg["threshold"]))
            per_key[(prev, idx)] = n
        out.append(per_key[(prev, idx)])
    return out


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        program_factory=make_program) -> dict:
    """One run.  Returns the result's fields and, under "stderr", the lines
    to print last on standard error."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    cfg = cell.cfg
    n_chan = int(cfg["channels"])
    per_call = n_chan * int(cfg["block_samples"]) * int(cfg["blocks_per_batch"])

    t_render = time.perf_counter()
    pool, _ = render(cell, seed, device)
    t_render = time.perf_counter() - t_render
    n_pool = len(pool[0])
    feeds = [[pool[c][i] for c in range(n_chan)] for i in range(n_pool)]
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    program = program_factory(cfg, device)
    recorded: dict[int, list] = {c: [] for c in range(n_chan)}

    def record(out):
        for c in range(n_chan):
            recorded[c].append(compare.pack_program(out[c]))

    warm = int(cfg["warmup_superblocks"])
    t_warm = time.perf_counter()
    for i in range(warm):
        record(program.feed(feeds[i % n_pool]))
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    t_warm = time.perf_counter() - t_warm

    prof = None
    if traced and on_cuda:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    calls: list[tuple[int, int]] = []
    i = warm
    clock = time.perf_counter_ns
    packing = 0
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    with trace.GcClock() as gcs:
        t0 = clock()
        deadline = t0 + int(seconds * 1e9)
        while True:
            a = clock()
            if a >= deadline:
                break
            out = program.feed(feeds[i % n_pool])
            b = clock()
            calls.append((a, b))
            record(out)
            del out
            packing += clock() - b
            i += 1
        t_stop = clock()
        to_wall = time.time_ns() - clock()  # the profiler's clock is the wall clock
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        prof.stop()
    n_fed = i
    done = [b - a for a, b in calls if b <= deadline]
    memory_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    prog_stats = {c: stats_of(program, c) for c in recorded}
    del program
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    schedule = [j % n_pool for j in range(n_fed)]
    device_name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    result: dict = {"attempted": len(done)}
    if traced:
        events = trace.device_events(prof) if prof is not None else []
        del prof
        counts: list[int] = []

        def candidates():
            if not counts:
                counts.extend(candidates_per_call(cell, pool, schedule[warm:], device))
            return counts

        def wall(intervals):
            return [(a + to_wall, b + to_wall) for a, b in intervals]

        ctx = trace.Context(cfg, device_name, (t0 + to_wall, t_stop + to_wall),
                            wall(calls), wall(trace.clip(gcs.intervals, t0, t_stop)), events,
                            candidates)
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        busy = trace.length(ctx.busy())
        result["device_extra"] = {"busy_s": busy / 1e9, "window_s": ctx.window_s}
        result["breakdown"] = {"device_ops": trace.device_ops(ctx),
                               "idle_gaps": trace.idle_gaps(ctx)}
    else:
        d_ms = np.array(done, dtype=np.float64) / 1e6
        values = {
            "demod_msps": len(done) * per_call / seconds / 1e6,
            "superblock_p95_ms": float(np.percentile(d_ms, 95)) if len(d_ms) else float("nan"),
            "setup_s": setup_s,
        }
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}

    t_ref = time.perf_counter()
    cmp = reference_check(cell, pool, schedule, recorded, prog_stats, device)
    checks = cmp["checks"]
    window_pos = set(range(warm, warm + len(done)))
    result.update(
        correct=compare.passed(checks),
        failed=len(window_pos & set(cmp["failing"])),
        device={"platform": "gpu" if on_cuda else "cpu", "kind": device_name, "count": 1,
                "memory_peak_bytes": int(memory_peak), **result.pop("device_extra", {})},
        checks=checks,
    )
    result["stderr"] = [
        f"set-up {setup_s:.2f} s (traffic {t_render:.2f} s, warm-up {t_warm:.2f} s); "
        f"superblocks fed {n_fed} (warm-up {warm}, in the window {len(done)}); "
        f"packing the output between calls {packing / 1e6 / max(len(calls), 1):.2f} ms per call; "
        f"reference over all {n_chan} channels {time.perf_counter() - t_ref:.1f} s",
        f"process CPU over the window: user {use1.ru_utime - use0.ru_utime:.2f} s, "
        f"system {use1.ru_stime - use0.ru_stime:.2f} s",
        *(f"check {k}: {v['value']} limit {v['limit']}" for k, v in checks.items()),
    ]
    return result
