"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's seven CUDA kernels from readsb_tpu_torch/csrc with nvcc
and drives five paths on the card, each with the launch counts set to 0
just before and read just after:

  raw route        raw UC8 IQ -> MultiDemodulator(64) -> frames
  magnitude route  the same traffic as sc16 -> MultiDemodulator(64, fmt="sc16")
  ungated route    uc8 with Mode-S frames and Mode A/C replies ->
                   Demodulator(fmt="uc8", modeac=True)
  FUSE_CLASSIFY    the raw route with pipeline.FUSE_CLASSIFY set: the
                   extraction classifies for the score gate
                   (extract_classify_v3; once more with the plan-order
                   kernel extract_classify in its place)
  USE_FUSED        the raw route with ops.demod.USE_FUSED set: stages 1-4
                   are one cluster of eight blocks per tile (fused_demod), through
                   MultiDemodulator(64) and Demodulator(blocks_per_batch=4)

and then drives the app (readsb_tpu_torch.app.main, the user's path from
IQ files to aircraft.json) on the card:

  app              App.run_ifile over 64 uc8 receivers (run_ifile_multi),
                   one sc16 file, and one uc8 file under --modeac, each
                   held against the port's CPU app run of the same files;
                   the command line over the 64 files; and a timed run of
                   64 receivers x 2.0 s with 104 distinct aircraft, again
                   under torch.profiler

It holds every kernel against its plain PyTorch version on the card at
the shapes these paths give it, holds the card's frames, stats, levels
and Mode A/C messages against the port's own CPU run (the two new paths
against the staged card run, which that CPU run holds), and prints the
build's ptxas report (registers, shared memory, spills) and SASS
instruction counts, per-kernel times and bounds, and one dispatch under
each constant.  The last line is {"ok": true, "device": {...}}; any
failure exits non-zero before it.  Needs a CUDA device; imports nothing
of JAX.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import io
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from readsb_tpu_torch import BUILD_DIR, pipeline
from readsb_tpu_torch.app import main as app_main
from readsb_tpu_torch.constants import BLOCK_SAMPLES, PREAMBLE_THRESHOLD_DEFAULT
from readsb_tpu_torch.decode.mode_ac import modec_to_modea
from readsb_tpu_torch.io import json_out
from readsb_tpu_torch.ops import demod as demod_ops
from readsb_tpu_torch.ops import fused, kernels
from readsb_tpu_torch.ops.convert import mag_uc8_words, uc8_lut_np
from readsb_tpu_torch.synth import (
    build_standard_capture,
    build_traffic_capture,
    quantize_sc16,
    quantize_uc8,
)

N_CHAN = 64  # the benchmark width: 64 channels x 131072 UC8 samples per dispatch
DISPATCHES = 2  # so the carried overlap crosses a superblock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 memory rate
# no integer peak is used; the non-tensor float32 peak is the card's rate
# for CUDA-core arithmetic
CORE_OPS_PER_S = 67e12
# arithmetic per sample of the dense scan: convert ~8, pre-check and
# correlations ~35, five sign planes ~30, split mag^2 and two prefix sums ~12
DENSE_OPS_PER_SAMPLE = 85
# per candidate: 5 phases x 112 bits x (tap, funnel shift, shift, and, xor,
# byte shift), plus alignment and correlation bits
EXTRACT_OPS_PER_CAND = 5 * 112 * 6 + 50
# per sample of the uc8 magnitude: two table reads, add, min, sqrt, scale,
# add, cast, pack
MAG_OPS_PER_SAMPLE = 8
# per (candidate, phase) of the classifier: three binary searches, five
# delta compares, the flag word
CLASSIFY_OPS_PER_CAND = 5 * 60
MODEAC_CODES = (0x1200, 0x7700, 0x0030, 0x2644)
# every kernel's wrapper, which counts its launches
WRAPPERS = {
    "dense_scan_uc8": kernels.dense_scan_uc8,
    "extract_syndromes": kernels.extract_syndromes,
    "mag_uc8": kernels.mag_uc8,
    "dense_scan": kernels.dense_scan,
    "extract_classify_v3": kernels.extract_classify_v3,
    "extract_classify": kernels.extract_classify,
    "fused_demod": fused.fused_demod_tiles,
}
# the app phase: 64 receivers in 8 groups; the receivers of a group see
# the same 13 aircraft (one address base), so 104 distinct aircraft
APP_GROUPS = 8
APP_AIRCRAFT = 13
APP_PARITY_S = 0.6  # the captures held against the CPU app run
APP_TIMED_S = 2.0  # the timed run's captures
APP_EPOCH_MS = 1_760_000_000_000
APP_WALL_CLOCK = ("cpu", "start", "end")  # stats.json fields read off the host's clock
# the kernels each app route launches
APP_ROUTES = {
    "multi": ("dense_scan_uc8", "extract_syndromes"),
    "sc16": ("dense_scan", "extract_syndromes"),
    "modeac": ("mag_uc8", "dense_scan", "extract_syndromes"),
}

DEV = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 15, warm: int = 2, inner: int = 1) -> float:
    """Median over `reps` timings with CUDA events of `inner` back-to-back
    calls, per call.  inner > 1 keeps the device fed where one call's work
    is shorter than its enqueue on the host."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn, names: tuple[str, ...], reps: int = 5) -> tuple[float, float]:
    """(device ms, device launches) per call of fn, from torch.profiler:
    the time of the kernels and memsets whose names contain one of `names`,
    what the card spends without the host's enqueue, per launch of the
    first name's kernel (the profiler may drop an activity now and then),
    and the count of every device activity per call.  Raises when no
    activity matches the names."""
    fn()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    hits = [e for e in dev if any(n in e.key for n in names)]
    if not hits:
        raise SystemExit(f"chip_smoke: FAILED: no device activity named {names} in "
                         f"{[e.key[:60] for e in dev]}")
    main = sum(e.count for e in hits if names[0] in e.key)
    check(main > 0, f"no launch of {names[0]} under the profiler")
    return (sum(e.self_device_time_total for e in hits) / main / 1e3,
            sum(e.count for e in dev) / reps)


def sass_counts(lib: str) -> dict[str, int]:
    """{kernel: SASS instructions} of a built library, from cuobjdump -sass
    (the toolkit's, beside nvcc)."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    so = os.path.join(BUILD_DIR, f"lib{lib}.so")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    counts: dict[str, int] = {}
    func = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = 0
        elif func and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[func] += 1
    return counts


def ptxas_table(reports: dict[str, str]) -> list[tuple[str, str, int, int, int]]:
    """[(library, kernel, registers, static shared bytes, spill bytes)] from
    the build's `-Xptxas -v` reports; spill = spill stores + spill loads."""
    out = []
    for lib, rep in reports.items():
        func, spill = "?", 0
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                func, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                sh = re.search(r"(\d+) bytes smem", line)
                out.append((lib, func, int(m.group(1)), int(sh.group(1)) if sh else 0, spill))
    return out


def max_abs_err(xs, ys) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in zip(xs, ys))


def frame_key(frames):
    return [(f.msg.hex(), f.timestamp, f.phase, f.score, f.signal_power) for f in frames]


def stats_key(s):
    return (s.preambles, s.rejected_bad, s.rejected_unknown_icao, list(s.accepted))


def workload(n_blocks: int, seed: int = 3) -> tuple[np.ndarray, np.ndarray, list[dict]]:
    """bench.py's traffic: 8 aircraft, seed 3, n_blocks blocks of one
    rendering, as UC8 bytes and as sc16 bytes."""
    total = n_blocks * BLOCK_SAMPLES
    cap = build_standard_capture(duration_s=total / 2.4e6 + 0.1, n_aircraft=8, seed=seed)
    iq = cap.render_iq()[:total]
    return quantize_uc8(iq), quantize_sc16(iq).view(np.uint8), cap.truth


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def check_launched(launches: dict[str, int], used: tuple[str, ...], path: str) -> None:
    """Exactly the kernels in `used` were launched by the counted run."""
    for name, count in launches.items():
        if name in used:
            check(count > 0, f"kernel {name} was not launched by {path}")
        else:
            check(count == 0, f"{path} launched kernel {name} ({count} times)")


def run_multi(m, chunks) -> list[list]:
    got = m.feed(chunks)
    return [g + t for g, t in zip(got, m.flush())]


def host_median_s(fn, make=lambda: None, reps: int = 3) -> float:
    """Median host-clock seconds of fn(make()), device work included;
    make() (building a demodulator) is not timed."""
    times = []
    for _ in range(reps):
        arg = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def recovered(truth, frames) -> tuple[int, int]:
    want = {t["hex"] for t in truth}
    got = {f.msg.hex() for f in frames}
    return len(want & got), len(want)


def prefix_steps(cs: torch.Tensor) -> torch.Tensor:
    """Per-sample terms of a wraparound int32 prefix sum."""
    u = cs.to(torch.int64) & 0xFFFFFFFF
    return torch.diff(u, prepend=u.new_zeros(1)) & 0xFFFFFFFF


def profile_dispatch(dispatch, reps: int = 3) -> tuple[float, float, list]:
    """(wall ms, device-busy ms, [(ms, launches, name)]) per dispatch under
    torch.profiler; device time is the sum of the kernels' own times."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            dispatch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side entries only: the CPU op that launched a kernel
        # reports the same device time again
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total / reps / 1e3, e.count // reps, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows


def write_capture(job: tuple) -> list[str]:
    """Render one capture of the app phase to its file; the DF17 addresses
    it holds.  Runs in a worker process."""
    path, fmt, duration_s, seed, addr_base = job
    cap = build_traffic_capture(duration_s, APP_AIRCRAFT, seed, addr_base=addr_base)
    if fmt == "modeac":
        # Mode C replies at the first aircraft's altitude (3000 ft), and
        # Mode A replies of codes no aircraft squawks
        for i, t in enumerate(np.arange(0.013, duration_s - 0.01, 0.0419)):
            code = modec_to_modea(30) if i % 2 else MODEAC_CODES[i % 4]
            cap.add_modeac(code, float(t), amplitude=0.5, phase=0.05)
    if fmt == "sc16":
        cap.write_sc16(path)
    else:
        cap.write_uc8(path)
    return sorted({t["hex"][2:8] for t in cap.truth if t.get("hex", "").startswith("8d")})


def render_captures(jobs: list[tuple]) -> list[list[str]]:
    """write_capture over the jobs in worker processes, one per core."""
    workers = min(len(jobs), os.cpu_count() or 1)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        return list(pool.map(write_capture, jobs))


class RecordingApp(app_main.App):
    """The port's App, keeping the frames its executor thread demodulated."""

    def __init__(self, args):
        super().__init__(args)
        self.frames = []

    def handle_frame(self, frame) -> None:
        self.frames.append(frame)
        super().handle_frame(frame)


def make_app(argv: list[str], device: str, cls=app_main.App):
    """An App from argv, on the card or (device="cpu") on the CPU through
    READSB_TPU_PLATFORM, at APP_EPOCH_MS."""
    old = os.environ.pop("READSB_TPU_PLATFORM", None)
    if device == "cpu":
        os.environ["READSB_TPU_PLATFORM"] = "cpu"
    try:
        app = cls(app_main.parse_args(argv))
    finally:
        os.environ.pop("READSB_TPU_PLATFORM", None)
        if old is not None:
            os.environ["READSB_TPU_PLATFORM"] = old
    check(app.device.type == device, f"the app chose {app.device}, not {device}")
    app.epoch_ms = APP_EPOCH_MS
    return app


def run_app(app) -> float:
    """Seconds of app.run_ifile() on the host clock, device work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asyncio.run(app.run_ifile())
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def app_results(app) -> dict:
    """What the app gives a user: aircraft.json, receiver.json, the stats
    counters (stats.json without its wall-clock fields), the message count,
    the demod stats and print_stats' lines from the sample count on."""
    now = app.now_ms()
    if app.args.modeac:
        app.tracker.match_ac(now)  # what run_periodic does each tick
    app.stats_collector.sample(app, now / 1000.0)
    sj = app.stats_collector.stats_json(app, now / 1000.0)
    for window in sj.values():
        for k in APP_WALL_CLOCK:
            window.pop(k)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        app.print_stats()
    st = app._demod.stats
    return {
        "aircraft.json": json_out.generate_aircraft_json(app.tracker, now, app.messages),
        "receiver.json": json_out.generate_receiver_json(1000, app.args.lat, app.args.lon),
        "stats.json": sj,
        "messages": app.messages,
        "demod": (app._demod.scan_global, st.preambles, st.rejected_bad,
                  st.rejected_unknown_icao, list(st.accepted),
                  getattr(app._demod, "stats_modeac", 0)),
        "print_stats": err.getvalue().splitlines()[1:],
        "modeac": [x.tolist() for x in (app.tracker.modeac_count, app.tracker.modeac_match)],
    }


def first_diff(a, b, path: str = "") -> str:
    """Where two JSON-like values first differ, and the two values there."""
    if type(a) is not type(b):
        return f"{path}: {a!r:.200} != {b!r:.200}"
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b), key=str):
            if a.get(k, "<missing>") != b.get(k, "<missing>"):
                return first_diff(a.get(k, "<missing>"), b.get(k, "<missing>"), f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: {len(a)} items != {len(b)} items"
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_diff(x, y, f"{path}[{i}]")
    return f"{path}: {a!r:.200} != {b!r:.200}"


def with_positions(doc: dict) -> set[str]:
    return {a["hex"] for a in doc["aircraft"] if "lat" in a}


def app_phase(card: str) -> dict[str, int]:
    """The app on the card: parity with the CPU app run on three routes,
    the command line, and a timed run.  Returns the kernel launches of the
    three counted routes."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_app_")
    d = tmp.name
    n = N_CHAN
    group = n // APP_GROUPS
    parity = [os.path.join(d, f"rx{c:02d}.uc8.dat") for c in range(n)]
    timed = [os.path.join(d, f"timed{c:02d}.uc8.dat") for c in range(n)]
    one16, one_ac = os.path.join(d, "one.sc16.dat"), os.path.join(d, "ac.uc8.dat")
    base = [0x400000 + (c // group) * 0x10000 for c in range(n)]
    jobs = ([(parity[c], "uc8", APP_PARITY_S, 100 + c, base[c]) for c in range(n)]
            + [(timed[c], "uc8", APP_TIMED_S, 300 + c, base[c]) for c in range(n)]
            + [(one16, "sc16", 1.0, 500, 0x500000), (one_ac, "modeac", 1.0, 501, 0x510000)])
    t0 = time.perf_counter()
    addrs = render_captures(jobs)
    scene = set().union(*addrs[:n])
    scene_timed = set().union(*addrs[n: 2 * n])
    log(f"app: {n} captures of {APP_PARITY_S} s and {n} of {APP_TIMED_S} s ({APP_GROUPS} groups "
        f"of {group} receivers, {APP_AIRCRAFT} aircraft per group: {len(scene_timed)} distinct "
        f"aircraft), one sc16 and one Mode A/C capture of 1.0 s, rendered in "
        f"{time.perf_counter() - t0:.1f} s by {min(len(jobs), os.cpu_count() or 1)} processes")
    check(len(scene_timed) >= 100, f"the timed scene has {len(scene_timed)} aircraft, not 100")

    # --- parity: each route on the card against the CPU app run, counted -------
    routes = {
        "multi": ["--ifile", ",".join(parity)],
        "sc16": ["--ifile", one16, "--iformat", "sc16", "--lat", "46.5", "--lon", "6.8"],
        "modeac": ["--ifile", one_ac, "--modeac"],
    }
    app_launches = {name: 0 for name in WRAPPERS}
    card_multi = None
    for route, extra in routes.items():
        argv = ["--device-type", "ifile", "--blocks-per-batch", "1", *extra]
        card_app = make_app(argv, "cuda", RecordingApp)
        reset_counts()
        t_card = run_app(card_app)
        launches = read_counts()
        check_launched(launches, APP_ROUTES[route], f"the app's {route} route")
        for name, count in launches.items():
            app_launches[name] += count
        cpu_app = make_app(argv, "cpu")
        t0 = time.perf_counter()
        asyncio.run(cpu_app.run_ifile())
        t_cpu = time.perf_counter() - t0
        got, want = app_results(card_app), app_results(cpu_app)
        for key in want:
            check(got[key] == want[key], f"app {route}: {key} on the card differs from the CPU "
                                         f"run at {first_diff(got[key], want[key])}")
        doc = got["aircraft.json"]
        check(got["messages"] > 100 and len(with_positions(doc)) >= 5,
              f"app {route}: {got['messages']} messages, {len(with_positions(doc))} positions")
        what = ("aircraft.json, receiver.json, stats counters, demod stats, print_stats and "
                f"{got['messages']} messages on the card == CPU run")
        if route == "multi":
            card_multi = doc
            hexes = {a["hex"] for a in doc["aircraft"]}
            check(scene <= hexes, f"app multi: {len(scene - hexes)} scene aircraft missing")
            check(len(with_positions(doc) & scene) >= 0.9 * len(scene),
                  f"app multi: only {len(with_positions(doc) & scene)}/{len(scene)} with positions")
            what += f"; {len(scene)} scene aircraft, {len(with_positions(doc))} with positions"
        else:
            # the frames feed() gave in the executor thread == a direct call
            # in this thread, over the same chunks
            direct = pipeline.Demodulator(fmt=card_app._demod.fmt, blocks_per_batch=1,
                                          modeac=route == "modeac", device=DEV)
            raw = open(extra[1], "rb").read()
            step = direct.super_samples * (2 if route == "modeac" else 4)
            frames = [f for i in range(0, len(raw), step) for f in direct.feed(raw[i:i + step])]
            frames += direct.flush()
            check(frame_key(frames) == frame_key(card_app.frames),
                  f"app {route}: the executor thread's frames differ from a direct call's")
            what += f"; its {len(frames)} frames from the executor thread == a direct call's"
        if route == "modeac":
            check(got["demod"][5] > 10 and any(got["modeac"][1]),
                  f"app modeac: {got['demod'][5]} Mode A/C replies, none matched to an aircraft")
        log(f"app {route}: {what}; launches={launches}; card {t_card:.2f} s, CPU {t_cpu:.2f} s "
            f"on {card}")

    # --- the command line on the card over the 64 files ------------------------
    out = os.path.join(d, "json")
    env = {k: v for k, v in os.environ.items() if k != "READSB_TPU_PLATFORM"}
    cmd = [sys.executable, "-m", "readsb_tpu_torch.app.main", "--device-type", "ifile",
           "--ifile", ",".join(parity), "--blocks-per-batch", "1", "--write-json", out, "--stats"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                       capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    check(r.returncode == 0, f"the command line exited {r.returncode}: {r.stderr[-1500:]}")
    cli_doc = json.load(open(os.path.join(out, "aircraft.json")))
    check(os.path.exists(os.path.join(out, "receiver.json"))
          and os.path.exists(os.path.join(out, "stats.json")),
          "the command line wrote no receiver.json or stats.json")
    cli_doc.pop("now")
    want_doc = dict(card_multi)
    want_doc.pop("now")
    check(cli_doc == want_doc, "the command line's aircraft.json differs from the app run's")
    check(scene <= with_positions(cli_doc) | {a["hex"] for a in cli_doc["aircraft"]},
          "the command line's aircraft.json lacks scene aircraft")
    log(f"app command line: exit 0 in {t_cli:.1f} s; aircraft.json ({len(cli_doc['aircraft'])} "
        f"aircraft, {len(with_positions(cli_doc))} with positions) == the app run's apart from "
        f"now; receiver.json, stats.json written; {r.stderr.strip().splitlines()[-3].strip()} "
        f"on {card}")

    # --- timed: 64 receivers x APP_TIMED_S s, as a user runs it ------------------
    argv = ["--device-type", "ifile", "--blocks-per-batch", "1", "--ifile", ",".join(timed)]
    app = make_app(argv, "cuda")
    reset_counts()
    wall = run_app(app)
    timed_launches = read_counts()
    check_launched(timed_launches, APP_ROUTES["multi"], "the timed app run")
    res = app_results(app)
    samples = app._demod.scan_global * n
    cpu = app.stats_collector.cpu
    reader_s, demod_s = cpu["reader"] / 1e3, cpu["demod"] / 1e3
    n_ac = len(res["aircraft.json"]["aircraft"])
    check(len({a["hex"] for a in res["aircraft.json"]["aircraft"]} & scene_timed) >= 100,
          "the timed run's aircraft.json holds fewer than 100 scene aircraft")
    log(f"app timed: {n} receivers x {app._demod.scan_global} samples ({APP_TIMED_S} s each): "
        f"wall {wall:.3f} s = {samples / wall / 1e6:.1f} MS/s end to end (realtime at {n} "
        f"channels: {n * 2.4:.1f} MS/s) on {card}")
    log(f"app timed, host split: reader {reader_s:.3f} s, demod (feed() in the executor) "
        f"{demod_s:.3f} s, the rest (decode, track, loop) {wall - reader_s - demod_s:.3f} s "
        f"of {wall:.3f} s on {card}")
    log(f"app timed: {res['messages']} messages = {res['messages'] / wall:.0f} messages/s, "
        f"{n_ac} aircraft in aircraft.json ({len(with_positions(res['aircraft.json']))} with "
        f"positions); launches={timed_launches} on {card}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    app_p = make_app(argv, "cuda")
    with torch.profiler.profile(activities=acts) as prof:
        wall_p = run_app(app_p)
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    n_launch = sum(e.count for e in dev)
    check(busy > 0 and n_launch > 0, "the profiled app run shows no device activity")
    check(app_results(app_p)["aircraft.json"] == res["aircraft.json"],
          "the profiled app run's aircraft.json differs from the timed run's")
    log(f"app profiled (the timed run again under torch.profiler): wall {wall_p:.3f} s, device "
        f"busy {busy:.3f} s ({busy / wall_p * 100:.1f}%, idle {100 - busy / wall_p * 100:.1f}%), "
        f"{n_launch} device launches on {card}; top:")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:80]}")
    tmp.cleanup()
    return app_launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # --- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build(force=True)
    log(f"built {', '.join(reports)} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_table(reports)
    for lib, func, regs, smem, spill in ptxas:
        log(f"  ptxas {lib}: {func[:70]}: {regs} registers, {smem} B static shared, "
            f"{spill} B spilled")
    check(len(ptxas) >= len(kernels.SOURCES), "the ptxas report lists too few kernels")
    for lib in kernels.SOURCES:
        for func, count in sass_counts(lib).items():
            log(f"  sass {lib}: {func[:70]}: {count} instructions")

    # --- workload -------------------------------------------------------------
    t0 = time.perf_counter()
    raw, raw16, truth = workload(N_CHAN * DISPATCHES)
    per_chan = DISPATCHES * BLOCK_SAMPLES * 2
    chunks = [bytes(raw[c * per_chan : (c + 1) * per_chan]) for c in range(N_CHAN)]
    chunks16 = [bytes(raw16[2 * c * per_chan : 2 * (c + 1) * per_chan]) for c in range(N_CHAN)]
    log(f"workload: {N_CHAN} channels x {DISPATCHES} x {BLOCK_SAMPLES} UC8 samples "
        f"({len(truth)} truth frames) in {time.perf_counter() - t0:.1f} s")

    # --- main path on the card, counted ---------------------------------------
    multi = pipeline.MultiDemodulator(N_CHAN, blocks_per_batch=1, use_native=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_frames = run_multi(multi, chunks)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = read_counts()
    log(f"main path: MultiDemodulator({N_CHAN}) k={multi.k} k2={multi.gate_k2} "
        f"launches={launches} in {t_main:.3f} s (first run, builds included)")
    check_launched(launches, ("dense_scan_uc8", "extract_syndromes"), "the main path")
    n_frames = sum(len(f) for f in card_frames)
    check(n_frames > 0, "main path decoded no frames")

    # --- the port's CPU run of the same capture -------------------------------
    t0 = time.perf_counter()
    ref = pipeline.MultiDemodulator(N_CHAN, blocks_per_batch=1, use_native=True, device="cpu")
    ref_frames = run_multi(ref, chunks)
    log(f"CPU reference run in {time.perf_counter() - t0:.1f} s")
    for c in range(N_CHAN):
        check(frame_key(card_frames[c]) == frame_key(ref_frames[c]),
              f"channel {c}: card frames differ from the CPU run")
        check(stats_key(multi.channel_stats(c)) == stats_key(ref.channel_stats(c)),
              f"channel {c}: card stats differ from the CPU run")
    rec, tot = recovered(truth, [f for fr in card_frames for f in fr])
    log(f"frames: {n_frames} on the card == CPU run, per channel, with stats; "
        f"truth recovered {rec}/{tot}")
    check(rec >= 0.9 * tot, f"only {rec}/{tot} truth messages decoded")

    # --- single-channel Demodulator, 1 s / 4 aircraft / seed 7 ----------------
    cap1 = build_standard_capture(duration_s=1.0, n_aircraft=4, seed=7)
    raw1 = bytes(cap1.render_uc8())
    d_card = pipeline.Demodulator(blocks_per_batch=4, use_native=True)
    f_card = d_card.feed(raw1) + d_card.flush()
    d_cpu = pipeline.Demodulator(blocks_per_batch=4, use_native=True, device="cpu")
    f_cpu = d_cpu.feed(raw1) + d_cpu.flush()
    check(frame_key(f_card) == frame_key(f_cpu), "Demodulator: card frames differ from CPU run")
    check(stats_key(d_card.stats) == stats_key(d_cpu.stats), "Demodulator: stats differ")
    rec1, tot1 = recovered(cap1.truth, f_card)
    check(rec1 >= 0.9 * tot1, f"Demodulator: only {rec1}/{tot1} truth messages decoded")
    log(f"Demodulator(blocks_per_batch=4): {len(f_card)} frames == CPU run; "
        f"truth recovered {rec1}/{tot1}")

    # --- magnitude route at full width: the same traffic as sc16, counted -----
    multi16 = pipeline.MultiDemodulator(N_CHAN, fmt="sc16", blocks_per_batch=1, use_native=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card16 = run_multi(multi16, chunks16)
    torch.cuda.synchronize()
    t_main16 = time.perf_counter() - t0
    launches16 = read_counts()
    log(f"magnitude route: MultiDemodulator({N_CHAN}, fmt='sc16') k={multi16.k} "
        f"k2={multi16.gate_k2} launches={launches16} in {t_main16:.3f} s")
    check_launched(launches16, ("dense_scan", "extract_syndromes"), "the magnitude route")
    t0 = time.perf_counter()
    ref16 = pipeline.MultiDemodulator(
        N_CHAN, fmt="sc16", blocks_per_batch=1, use_native=True, device="cpu"
    )
    ref16_frames = run_multi(ref16, chunks16)
    log(f"CPU reference run (sc16) in {time.perf_counter() - t0:.1f} s")
    for c in range(N_CHAN):
        check(frame_key(card16[c]) == frame_key(ref16_frames[c]),
              f"sc16 channel {c}: card frames differ from the CPU run")
        check(stats_key(multi16.channel_stats(c)) == stats_key(ref16.channel_stats(c)),
              f"sc16 channel {c}: card stats differ from the CPU run")
    check(bool((multi16.mean_level == ref16.mean_level).all()
               and (multi16.mean_power == ref16.mean_power).all()),
          "sc16: mean_level / mean_power differ from the CPU run")
    check(bool((multi16.mean_level > 0).all()), "sc16: a channel's mean_level is 0")
    n16 = sum(len(f) for f in card16)
    rec16, tot16 = recovered(truth, [f for fr in card16 for f in fr])
    log(f"sc16 frames: {n16} on the card == CPU run, per channel, with stats and levels; "
        f"truth recovered {rec16}/{tot16}")
    check(rec16 >= 0.9 * tot16, f"sc16: only {rec16}/{tot16} truth messages decoded")

    # --- ungated route with Mode A/C: 1 s of Mode-S frames and replies --------
    cap_ac = build_standard_capture(duration_s=1.0, n_aircraft=4, seed=7)
    t_replies = np.arange(0.015, 0.98, 0.0137)
    for i, t in enumerate(t_replies):
        # near-zero sub-sample phase: the reference's clock-phase heuristic
        # (demod_2400.c:644-650) rejects unlucky phases
        cap_ac.add_modeac(MODEAC_CODES[i % 4], float(t), amplitude=0.5, phase=0.05)
    raw_ac = bytes(cap_ac.render_uc8())

    def run_ac(device):
        d = pipeline.Demodulator(fmt="uc8", modeac=True, blocks_per_batch=4, use_native=True,
                                 device=device)
        return d, d.feed(raw_ac) + d.flush()

    reset_counts()
    d_ac, f_ac = run_ac(DEV)
    torch.cuda.synchronize()
    launches_ac = read_counts()
    check_launched(launches_ac, ("mag_uc8", "dense_scan", "extract_syndromes"),
                   "the ungated route")
    r_ac, rf_ac = run_ac("cpu")
    check(frame_key(f_ac) == frame_key(rf_ac), "ungated route: card frames differ from CPU run")
    check(stats_key(d_ac.stats) == stats_key(r_ac.stats), "ungated route: stats differ")
    ac_key = [(m.squawk_hex, m.timestamp, m.addr, m.baro_alt) for m in d_ac.modeac_msgs]
    check(ac_key == [(m.squawk_hex, m.timestamp, m.addr, m.baro_alt) for m in r_ac.modeac_msgs],
          "ungated route: Mode A/C messages differ from the CPU run")
    check(d_ac.stats_modeac == r_ac.stats_modeac == len(ac_key), "stats_modeac differs")
    check((d_ac.mean_level, d_ac.mean_power, d_ac.k, d_ac.modeac_k)
          == (r_ac.mean_level, r_ac.mean_power, r_ac.k, r_ac.modeac_k),
          "ungated route: levels or capacities differ from the CPU run")
    rec_ac, tot_ac = recovered([t for t in cap_ac.truth if "hex" in t], f_ac)
    check(rec_ac >= 0.9 * tot_ac, f"ungated route: only {rec_ac}/{tot_ac} Mode-S messages")
    check({m.squawk_hex for m in d_ac.modeac_msgs} == set(MODEAC_CODES),
          "ungated route: not every Mode A code was decoded")
    check(len(ac_key) >= 0.5 * len(t_replies),
          f"ungated route: only {len(ac_key)}/{len(t_replies)} Mode A/C replies")
    log(f"ungated route: Demodulator(modeac=True, blocks_per_batch=4) k={d_ac.k} "
        f"modeac_k={d_ac.modeac_k} launches={launches_ac}; {len(f_ac)} frames "
        f"({rec_ac}/{tot_ac} truth) and {len(ac_key)}/{len(t_replies)} Mode A/C replies "
        f"== CPU run")

    # --- FUSE_CLASSIFY path at full width: the raw route, classifying kernel ----
    def same_as_staged(frames, m, what: str) -> None:
        """Per channel, frames and stats equal the staged card run's (which
        the CPU run above holds)."""
        for c in range(N_CHAN):
            check(frame_key(frames[c]) == frame_key(card_frames[c]),
                  f"{what} channel {c}: frames differ from the staged card run")
            check(stats_key(m.channel_stats(c)) == stats_key(multi.channel_stats(c)),
                  f"{what} channel {c}: stats differ from the staged card run")

    def counted_multi():
        m = pipeline.MultiDemodulator(N_CHAN, blocks_per_batch=1, use_native=True)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = run_multi(m, chunks)
        torch.cuda.synchronize()
        return m, frames, read_counts(), time.perf_counter() - t0

    pipeline.FUSE_CLASSIFY = True
    try:
        multi_fc, frames_fc, launches_fc, t_fc = counted_multi()
        # once more with the plan-order kernel in the classifying kernel's place
        v3 = kernels.extract_classify_v3
        kernels.extract_classify_v3 = kernels.extract_classify
        try:
            multi_v2, frames_v2, launches_v2, t_v2 = counted_multi()
        finally:
            kernels.extract_classify_v3 = v3
    finally:
        pipeline.FUSE_CLASSIFY = False
    check_launched(launches_fc, ("dense_scan_uc8", "extract_classify_v3"), "the FUSE_CLASSIFY path")
    check_launched(launches_v2, ("dense_scan_uc8", "extract_classify"),
                   "the FUSE_CLASSIFY path with the plan-order kernel")
    same_as_staged(frames_fc, multi_fc, "FUSE_CLASSIFY")
    same_as_staged(frames_v2, multi_v2, "FUSE_CLASSIFY (plan-order kernel)")
    log(f"FUSE_CLASSIFY path: MultiDemodulator({N_CHAN}) k={multi_fc.k} launches="
        f"{launches_fc} in {t_fc:.3f} s; with extract_classify in its place launches="
        f"{launches_v2} in {t_v2:.3f} s; frames and stats per channel == staged card run")

    # --- USE_FUSED path at full width: stages 1-4 in one kernel per tile --------
    demod_ops.USE_FUSED = True
    try:
        multi_fu, frames_fu, launches_fu, t_fu = counted_multi()
        d_fu = pipeline.Demodulator(blocks_per_batch=4, use_native=True)
        f_fu = d_fu.feed(raw1) + d_fu.flush()
        launches_fu1 = read_counts()
    finally:
        demod_ops.USE_FUSED = False
    check_launched(launches_fu, ("mag_uc8", "fused_demod"), "the USE_FUSED path")
    check(not multi_fu._force_staged, "the USE_FUSED path overflowed and went staged")
    same_as_staged(frames_fu, multi_fu, "USE_FUSED")
    check(launches_fu1["fused_demod"] > launches_fu["fused_demod"] and not d_fu._force_staged,
          "USE_FUSED Demodulator did not stay on the fused kernel")
    check(frame_key(f_fu) == frame_key(f_card) and stats_key(d_fu.stats) == stats_key(d_card.stats),
          "USE_FUSED Demodulator: frames or stats differ from the staged card run")
    log(f"USE_FUSED path: MultiDemodulator({N_CHAN}) k={multi_fu.k} "
        f"cap={max(128, multi_fu.k // -(-multi_fu.scan_len // fused.TILE))} launches="
        f"{launches_fu} in {t_fu:.3f} s; Demodulator(blocks_per_batch=4) "
        f"cap={max(128, d_fu.k // 8)}: {len(f_fu)} frames; both == staged card run, "
        f"neither went staged")

    # --- kernels against their plain versions at the main path's shapes -------
    first = np.stack([np.frombuffer(ch, dtype="<u2", count=BLOCK_SAMPLES) for ch in chunks])
    words = torch.from_numpy(first.copy()).to(DEV)
    overlap = torch.full((N_CHAN, 326), pipeline.SILENT_WORD, dtype=torch.uint16, device=DEV)
    buf = pipeline.multi_buffer(words, overlap, multi.seg_stride, multi.seg_valid)
    bufp = demod_ops.pad_raw_words(buf)
    thr = PREAMBLE_THRESHOLD_DEFAULT
    n = bufp.shape[0]
    dense_k = kernels.dense_scan_uc8(bufp, thr)
    dense_p = kernels.dense_scan_uc8_plain(bufp, thr)
    err_dense = max_abs_err(dense_k, dense_p)
    check(err_dense == 0, f"dense_scan_uc8 differs from its plain version (max {err_dense})")
    offsets, _, _, rows = demod_ops.candidate_rows(
        dense_k[0], dense_k[1], k=multi.k, l=multi.compact_l, scan_len=multi.scan_len,
        seg_stride=multi.seg_stride, seg_valid=multi.seg_valid,
    )
    ex_k = kernels.extract_syndromes(rows, offsets)
    ex_p = kernels.extract_syndromes_plain(rows, offsets)
    err_ex = max_abs_err([ex_k], [ex_p])
    check(err_ex == 0, f"extract_syndromes differs from its plain version (max {err_ex})")
    log(f"kernels == plain versions at n={n} samples, K={rows.shape[0]} rows")

    # kernels #5 and #6 at the same rows, against their plain versions and
    # each other; the known table is the one the main run ended with
    tbl = multi.mirror.tbl
    check(int((tbl < 0x1000000).sum()) > 0, "the known table is empty")
    cls_k = kernels.extract_classify_v3(rows, offsets, tbl, nfix=multi.nfix, fix_df=multi.fix_df)
    cls_p = kernels.extract_classify_v3_plain(rows, offsets, tbl, nfix=multi.nfix,
                                              fix_df=multi.fix_df)
    err_cls = max_abs_err([cls_k], [cls_p])
    check(err_cls == 0, f"extract_classify_v3 differs from its plain version (max {err_cls})")
    cls2_k = kernels.extract_classify(rows, offsets, tbl, nfix=multi.nfix, fix_df=multi.fix_df)
    cls2_p = kernels.extract_classify_plain(rows, offsets, tbl, nfix=multi.nfix,
                                            fix_df=multi.fix_df)
    err_cls2 = max(max_abs_err([cls2_k], [cls2_p]), max_abs_err([cls2_k], [cls_k]))
    check(err_cls2 == 0, f"extract_classify differs from its plain version or from "
                         f"extract_classify_v3 (max {err_cls2})")
    check(max_abs_err([cls_k[:, :83]], [ex_k[:, :83]]) == 0,
          "extract_classify_v3 lanes 0:83 differ from extract_syndromes")
    flag_counts = [int(((cls_k[:, 83:88] & b) != 0).sum()) for b in (1, 2, 4, 8, 16)]
    check(flag_counts[0] > 0 and flag_counts[2] > 0, f"no classifier flag fired: {flag_counts}")
    del cls_p, cls2_p, cls2_k
    log(f"extract_classify_v3 == extract_classify == plain versions at K={rows.shape[0]}, "
        f"T={tbl.shape[0]}; flags set (in_t112, in_t56, in_tbl, fix_ok, zero7): {flag_counts}")

    # kernel #7 at the USE_FUSED path's shape: the converted buffer, whole
    # tiles over the scan range plus the last tile's halo, the path's cap
    ntiles = -(-multi.scan_len // fused.TILE)
    cap = max(128, multi.k // ntiles)
    n_fused = ntiles * fused.TILE + fused.HALO
    mag_f = torch.zeros(n_fused, dtype=torch.uint16, device=DEV)
    mag_f[: buf.shape[0]] = kernels.mag_uc8(buf)
    fused_kw = dict(cap=cap, seg_stride=multi.seg_stride, seg_valid=multi.seg_valid,
                    scan_limit=multi.scan_len)
    fu_k = fused.fused_demod_tiles(mag_f, thr, **fused_kw)
    fu_p = fused.fused_demod_tiles_plain(mag_f, thr, **fused_kw)
    err_fu = max_abs_err(fu_k, fu_p)
    check(err_fu == 0, f"fused_demod differs from its plain version (max {err_fu})")
    meta = fu_k[3]
    n_live = int(fu_k[2].sum())
    check(n_live == int(meta[:, 0].sum()) > 0, "fused_demod: live rows != candidates")
    check(max_abs_err([fu_k[0][fu_k[2]][:, :83]], [ex_k[:n_live, :83]]) == 0
          and max_abs_err([fu_k[1][fu_k[2]]], [offsets[:n_live]]) == 0,
          "fused_demod's live rows differ from the staged extraction")
    log(f"fused_demod == plain at n={n_fused} ({ntiles} tiles + halo), cap={cap}: "
        f"{n_live} candidates, most per tile {int(meta[:, 0].max())}, per 256-sample block "
        f"{int(meta[:, 1].max())}, per 128-sample row {int(meta[:, 2].max())}; live rows == "
        f"staged offsets and extraction")
    del fu_p

    # kernel #4 at the magnitude route's shape: 64 channels of sc16 magnitudes
    first16 = np.stack([np.frombuffer(ch, dtype=np.uint8, count=BLOCK_SAMPLES * 4)
                        for ch in chunks16])
    mags = pipeline._to_mag(first16.reshape(-1), "sc16", DEV).reshape(N_CHAN, BLOCK_SAMPLES)
    overlap_mag = torch.zeros((N_CHAN, 326), dtype=torch.uint16, device=DEV)
    magp = demod_ops.pad_mag(
        pipeline.multi_buffer(mags, overlap_mag, multi16.seg_stride, multi16.seg_valid)
    )
    check(magp.shape[0] == n, f"magnitude buffer of {magp.shape[0]} samples, expected {n}")
    densem_k = kernels.dense_scan(magp, thr)
    densem_p = kernels.dense_scan_plain(magp, thr)
    err_densem = max_abs_err(densem_k, densem_p)
    check(err_densem == 0, f"dense_scan differs from its plain version (max {err_densem})")

    # kernel #3 at the ungated route's superblock and at 64 channels' words
    words_flat = words.reshape(-1)
    err_mag = 0
    for w in (words_flat[: 4 * BLOCK_SAMPLES], words_flat, words_flat[3:70004]):
        err_mag = max(err_mag, max_abs_err([kernels.mag_uc8(w)], [mag_uc8_words(w)]))
    check(err_mag == 0, f"mag_uc8 differs from its plain version (max {err_mag})")
    log(f"dense_scan == plain at n={n}; mag_uc8 == LUT gather at N={4 * BLOCK_SAMPLES}, "
        f"N={words_flat.shape[0]} and an unaligned N=70001")

    # every (I, Q) pair through the dense scan: mag^2 from prefix-sum steps
    ii, qq = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    pairs = torch.from_numpy((ii.ravel() | (qq.ravel() << 8)).astype(np.uint16)).to(DEV)
    _, _, hi, lo = kernels.dense_scan_uc8(pairs, thr)
    sq = ((prefix_steps(hi) << 16) + prefix_steps(lo)).cpu().numpy()
    lut = uc8_lut_np().astype(np.int64)[ii.ravel() * 256 + qq.ravel()]
    check(bool((sq == lut * lut).all()), "in-kernel magnitude differs from the LUT")
    mag_pairs = kernels.mag_uc8(pairs).cpu().numpy().astype(np.int64)
    check(bool((mag_pairs == lut).all()), "mag_uc8 differs from the LUT on some (I, Q) pair")
    log("magnitude: all 65536 (I, Q) pairs equal the LUT, in dense_scan_uc8 and in mag_uc8")

    # --- times ----------------------------------------------------------------
    ms_dense = time_ms(lambda: kernels.dense_scan_uc8(bufp, thr))
    plain_dense = time_ms(lambda: kernels.dense_scan_uc8_plain(bufp, thr), reps=10)
    ms_ex = time_ms(lambda: kernels.extract_syndromes(rows, offsets))
    plain_ex = time_ms(lambda: kernels.extract_syndromes_plain(rows, offsets), reps=10)
    ms_densem = time_ms(lambda: kernels.dense_scan(magp, thr))
    plain_densem = time_ms(lambda: kernels.dense_scan_plain(magp, thr), reps=10)
    n_mag = words_flat.shape[0]
    ms_mag = time_ms(lambda: kernels.mag_uc8(words_flat), inner=20)
    ms_mag_sb = time_ms(lambda: kernels.mag_uc8(words_flat[: 4 * BLOCK_SAMPLES]), inner=20)
    dev_mag, _ = device_ms(lambda: kernels.mag_uc8(words_flat), ("mag_uc8_kernel",))
    dev_mag_sb, _ = device_ms(
        lambda: kernels.mag_uc8(words_flat[: 4 * BLOCK_SAMPLES]), ("mag_uc8_kernel",)
    )
    # the dense scans: a memset of the tile ticket and flags, then dense_tile
    dev_densem, calls_densem = device_ms(lambda: kernels.dense_scan(magp, thr),
                                         ("dense_tile", "Memset"))
    dev_dense, calls_dense = device_ms(lambda: kernels.dense_scan_uc8(bufp, thr),
                                       ("dense_tile", "Memset"))
    # the plain version and the library call are the same thing here: one
    # LUT gather; the library call is timed with its index already built
    plain_mag = time_ms(lambda: mag_uc8_words(words_flat), reps=10)
    lut_dev = torch.from_numpy(uc8_lut_np().view(np.int16)).to(DEV)
    w64 = words_flat.to(torch.int64)
    lut_idx = (w64 & 0xFF) * 256 + (w64 >> 8)
    check(max_abs_err([lut_dev[lut_idx].to(torch.int32) & 0xFFFF],
                      [kernels.mag_uc8(words_flat)]) == 0, "the LUT gather differs from mag_uc8")
    lib_mag = time_ms(lambda: lut_dev[lut_idx], inner=20)
    del w64
    cls_args = (rows, offsets, tbl)
    cls_kw = dict(nfix=multi.nfix, fix_df=multi.fix_df)
    ms_cls = time_ms(lambda: kernels.extract_classify_v3(*cls_args, **cls_kw), inner=5)
    ms_cls2 = time_ms(lambda: kernels.extract_classify(*cls_args, **cls_kw), inner=5)
    ms_ex5 = time_ms(lambda: kernels.extract_syndromes(rows, offsets), inner=5)
    plain_cls = time_ms(lambda: kernels.extract_classify_v3_plain(*cls_args, **cls_kw), reps=5)
    plain_cls2 = time_ms(lambda: kernels.extract_classify_plain(*cls_args, **cls_kw), reps=5)
    # #2, #5 and #6 are one block kernel each (cand_rows); #7 a memset of
    # the ticket and flags, then the cluster kernel fused_tile
    dev_ex, calls_ex = device_ms(lambda: kernels.extract_syndromes(rows, offsets), ("cand_rows",))
    dev_cls, calls_cls = device_ms(lambda: kernels.extract_classify_v3(*cls_args, **cls_kw),
                                   ("cand_rows",))
    dev_cls2, calls_cls2 = device_ms(lambda: kernels.extract_classify(*cls_args, **cls_kw),
                                     ("cand_rows",))
    ms_fu = time_ms(lambda: fused.fused_demod_tiles(mag_f, thr, **fused_kw))
    plain_fu = time_ms(lambda: fused.fused_demod_tiles_plain(mag_f, thr, **fused_kw), reps=5)
    dev_fu, calls_fu = device_ms(lambda: fused.fused_demod_tiles(mag_f, thr, **fused_kw),
                                 ("fused_tile", "Memset"))
    k_rows = rows.shape[0]
    dense_bytes = n * 2 + n * 1 + 5 * (n // 32) * 4 + 2 * n * 4
    ex_bytes = k_rows * (128 * 4 + 4 + 128 * 4)
    mag_bytes = n_mag * 4
    cls_bytes = ex_bytes + tbl.shape[0] * 4
    fu_rows = ntiles * cap
    # magnitudes in; prefix sums, rows, offsets, live and meta out
    fu_bytes = n_fused * 2 + 2 * n_fused * 4 + fu_rows * (128 * 4 + 4 + 1) + ntiles * 12

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / CORE_OPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    b_dense, by_dense = bound(dense_bytes, n * DENSE_OPS_PER_SAMPLE)
    b_ex, by_ex = bound(ex_bytes, k_rows * EXTRACT_OPS_PER_CAND)
    b_mag, by_mag = bound(mag_bytes, n_mag * MAG_OPS_PER_SAMPLE)
    b_cls, by_cls = bound(cls_bytes, k_rows * (EXTRACT_OPS_PER_CAND + CLASSIFY_OPS_PER_CAND))
    b_fu, by_fu = bound(
        fu_bytes, ntiles * (fused.TILE + fused.HALO) * DENSE_OPS_PER_SAMPLE
        + fu_rows * EXTRACT_OPS_PER_CAND,
    )
    for name, ms, pms, b, nbytes in (
        ("dense_scan_uc8", ms_dense, plain_dense, b_dense, dense_bytes),
        ("extract_syndromes", ms_ex, plain_ex, b_ex, ex_bytes),
        ("mag_uc8", ms_mag, plain_mag, b_mag, mag_bytes),
        ("dense_scan", ms_densem, plain_densem, b_dense, dense_bytes),
        ("extract_classify_v3", ms_cls, plain_cls, b_cls, cls_bytes),
        ("extract_classify", ms_cls2, plain_cls2, b_cls, cls_bytes),
        ("fused_demod", ms_fu, plain_fu, b_fu, fu_bytes),
    ):
        log(f"{name}: {ms:.4f} ms (plain {pms:.3f} ms, bound {b:.4f} ms for "
            f"{nbytes / 1e6:.1f} MB, {b / ms * 100:.1f}% of the bound) on {card}")

    log(f"mag_uc8 at N={4 * BLOCK_SAMPLES} (one ungated superblock): {ms_mag_sb:.4f} ms; "
        f"one LUT gather lut[idx] at N={n_mag}: {lib_mag:.4f} ms on {card}")
    log(f"device time alone (torch.profiler): mag_uc8 {dev_mag:.4f} ms at N={n_mag}, "
        f"{dev_mag_sb:.4f} ms at N={4 * BLOCK_SAMPLES} on {card}")
    for name, ms, dms, calls, b in (
        ("dense_scan_uc8", ms_dense, dev_dense, calls_dense, b_dense),
        ("dense_scan", ms_densem, dev_densem, calls_densem, b_dense),
        ("extract_syndromes", ms_ex, dev_ex, calls_ex, b_ex),
        ("extract_classify_v3", ms_cls, dev_cls, calls_cls, b_cls),
        ("extract_classify", ms_cls2, dev_cls2, calls_cls2, b_cls),
        ("fused_demod", ms_fu, dev_fu, calls_fu, b_fu),
    ):
        log(f"{name}: {ms:.4f} ms by events ({b / ms * 100:.1f}% of the bound), "
            f"{dms:.4f} ms of device time ({b / dms * 100:.1f}%), bound {b:.4f} ms, "
            f"{calls:g} device launches per call on {card}")
    log(f"dense_scan / dense_scan_uc8 = {ms_densem / ms_dense:.3f} by events, "
        f"{dev_densem / dev_dense:.3f} by device time (same bytes, no convert)")

    log(f"extraction A/B at K={k_rows}, 5 back-to-back launches: extract_syndromes "
        f"{ms_ex5:.4f} ms, extract_classify_v3 {ms_cls:.4f} ms ({ms_cls / ms_ex5:.3f}x), "
        f"extract_classify {ms_cls2:.4f} ms ({ms_cls2 / ms_cls:.3f}x of v3); device time alone "
        f"{dev_ex:.4f} / {dev_cls:.4f} / {dev_cls2:.4f} ms on {card}")
    log(f"device time against extract_syndromes: extract_classify_v3 {dev_cls / dev_ex:.3f}x, "
        f"extract_classify {dev_cls2 / dev_ex:.3f}x on {card}")
    log(f"fused_demod: device time alone {dev_fu:.4f} ms against dense_scan + "
        f"extract_syndromes {dev_densem + dev_ex:.4f} ms of the stages it replaces (their "
        f"torch stages not counted) on {card}")

    # --- end to end -----------------------------------------------------------
    def dispatch():
        return pipeline._demod_and_gate_multi_raw(
            words, overlap, multi.seg_valid, thr, multi.mirror.tbl,
            k=multi.k, scan_len=multi.scan_len, l=multi.compact_l, k2=multi.gate_k2,
            nfix=multi.nfix, fix_df=multi.fix_df, reset_every=multi.block_samples,
            seg_stride=multi.seg_stride, seg_valid=multi.seg_valid,
            keep_l=multi.gate_keep_l,
        )

    ms_dispatch = time_ms(dispatch, reps=10)
    wall, busy, rows = profile_dispatch(dispatch)
    log(f"profile of one dispatch: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / wall * 100:.1f}%), {sum(r[1] for r in rows)} device launches; top:")
    for ms, cnt, name in rows[:12]:
        log(f"  {ms:8.4f} ms  x{cnt:<4d} {name[:90]}")
    # the same dispatch under each constant, beside the staged one
    pipeline.FUSE_CLASSIFY = True
    try:
        ms_dispatch_fc = time_ms(dispatch, reps=10)
        wall_fc, busy_fc, rows_fc = profile_dispatch(dispatch)
    finally:
        pipeline.FUSE_CLASSIFY = False
    demod_ops.USE_FUSED = True
    try:
        check(int(dispatch().fused_overflow) <= 0, "the fused dispatch overflowed")
        ms_dispatch_fu = time_ms(dispatch, reps=10)
        wall_fu, busy_fu, rows_fu = profile_dispatch(dispatch)
    finally:
        demod_ops.USE_FUSED = False
    ms_dispatch_again = time_ms(dispatch, reps=10)
    for what, ms_d, wall_d, busy_d, rows_d in (
        ("staged", ms_dispatch, wall, busy, rows),
        ("FUSE_CLASSIFY", ms_dispatch_fc, wall_fc, busy_fc, rows_fc),
        ("USE_FUSED", ms_dispatch_fu, wall_fu, busy_fu, rows_fu),
    ):
        log(f"dispatch {what}: {ms_d:.3f} ms by events (median of 10); under the profiler "
            f"wall {wall_d:.3f} ms, device busy {busy_d:.3f} ms ({busy_d / wall_d * 100:.1f}%), "
            f"{sum(r[1] for r in rows_d)} device launches on {card}")
    log(f"dispatch staged, timed again after the two: {ms_dispatch_again:.3f} ms")
    log("profile of one USE_FUSED dispatch, top:")
    for ms, cnt, name in rows_fu[:8]:
        log(f"  {ms:8.4f} ms  x{cnt:<4d} {name[:90]}")
    samples = N_CHAN * BLOCK_SAMPLES
    feeds = []
    for _ in range(3):
        m2 = pipeline.MultiDemodulator(N_CHAN, blocks_per_batch=1, use_native=True)
        # the capacities the main run escalated to, so no dispatch is redone
        m2.k, m2.compact_l = multi.k, multi.compact_l
        m2.gate_k2, m2.gate_keep_l = multi.gate_k2, multi.gate_keep_l
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m2.feed(chunks)
        torch.cuda.synchronize()
        feeds.append(time.perf_counter() - t0)
    t_feed = statistics.median(feeds)
    log(f"one dispatch (device, pre-staged words): {ms_dispatch:.3f} ms = "
        f"{samples / ms_dispatch / 1e3:.1f} MS/s aggregate on {card}")
    log(f"feed() of {DISPATCHES} superblocks (upload, dispatch, readback, host "
        f"finalize): {t_feed * 1e3:.1f} ms = {DISPATCHES * samples / t_feed / 1e6:.1f} MS/s "
        f"aggregate (median of 3) on {card}")

    # the magnitude route: one dispatch from pre-staged magnitudes, and feed()
    def dispatch16():
        return pipeline._demod_and_gate_multi(
            mags, overlap_mag, multi16.seg_valid, thr, multi16.mirror.tbl,
            k=multi16.k, scan_len=multi16.scan_len, l=multi16.compact_l, k2=multi16.gate_k2,
            nfix=multi16.nfix, fix_df=multi16.fix_df, reset_every=multi16.block_samples,
            seg_stride=multi16.seg_stride, seg_valid=multi16.seg_valid,
            keep_l=multi16.gate_keep_l,
        )

    ms_dispatch16 = time_ms(dispatch16, reps=10)
    ms_tomag16 = time_ms(lambda: pipeline._to_mag(first16.reshape(-1), "sc16", DEV), reps=5)

    def make16():
        m2 = pipeline.MultiDemodulator(N_CHAN, fmt="sc16", blocks_per_batch=1, use_native=True)
        # the capacities the counted run escalated to, so no dispatch is redone
        m2.k, m2.compact_l = multi16.k, multi16.compact_l
        m2.gate_k2, m2.gate_keep_l = multi16.gate_k2, multi16.gate_keep_l
        return m2

    t_feed16 = host_median_s(lambda m2: m2.feed(chunks16), make16)
    t_tomag16 = host_median_s(lambda _: pipeline._to_mag(first16.reshape(-1), "sc16", DEV))
    t_stack16 = host_median_s(lambda _: np.stack(
        [np.frombuffer(p, dtype=np.uint8, count=BLOCK_SAMPLES * 4) for p in chunks16]))
    log(f"sc16: one dispatch (device, pre-staged magnitudes): {ms_dispatch16:.3f} ms = "
        f"{samples / ms_dispatch16 / 1e3:.1f} MS/s aggregate; upload + convert of one "
        f"superblock (33.6 MB of sc16): {ms_tomag16:.3f} ms on {card}")
    log(f"sc16: feed() of {DISPATCHES} superblocks: {t_feed16 * 1e3:.1f} ms = "
        f"{DISPATCHES * samples / t_feed16 / 1e6:.1f} MS/s aggregate (median of 3); of it per "
        f"superblock on the host clock: stacking the channels' bytes {t_stack16 * 1e3:.1f} ms, "
        f"upload + convert {t_tomag16 * 1e3:.1f} ms on {card}")

    # the ungated route: one superblock of 4 blocks, all K rows read back
    sb_bytes = 4 * BLOCK_SAMPLES * 2

    def make_ungated():
        d = pipeline.Demodulator(fmt="uc8", modeac=True, blocks_per_batch=4, use_native=True)
        d.k, d.compact_l, d.modeac_k = d_ac.k, d_ac.compact_l, d_ac.modeac_k
        return d

    t_ungated = host_median_s(lambda d: d.feed(raw_ac[:sb_bytes]), make_ungated)
    log(f"ungated + Mode A/C: one superblock of {4 * BLOCK_SAMPLES} samples (upload, "
        f"mag_uc8, Mode A/C pass, demod_block, readback of K={d_ac.k} rows, host finalize): "
        f"{t_ungated * 1e3:.1f} ms = {4 * BLOCK_SAMPLES / t_ungated / 1e6:.1f} MS/s "
        f"(median of 3) on {card}")

    # --- the app on the card ---------------------------------------------------
    app_launches = app_phase(card)

    entries = [
        {
            "name": "dense_scan_uc8", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/dense_scan_uc8.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:400",
            "launches": launches["dense_scan_uc8"], "max_abs_err": err_dense,
            "ms": ms_dense, "plain_ms": plain_dense, "bound_ms": b_dense,
            "bound_by": by_dense, "library_ms": None, "device_ms": dev_dense,
            "device_launches_per_call": calls_dense,
        },
        {
            "name": "extract_syndromes", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/extract_syndromes.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:579",
            "launches": launches["extract_syndromes"], "max_abs_err": err_ex,
            "ms": ms_ex, "plain_ms": plain_ex, "bound_ms": b_ex,
            "bound_by": by_ex, "library_ms": None, "device_ms": dev_ex,
            "device_launches_per_call": calls_ex,
        },
        {
            "name": "mag_uc8", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/mag_uc8.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:999",
            "launches": launches_ac["mag_uc8"], "max_abs_err": err_mag,
            "ms": ms_mag, "plain_ms": plain_mag, "bound_ms": b_mag,
            "bound_by": by_mag, "library_ms": lib_mag,
            "samples": n_mag, "ms_at_path_shape": ms_mag_sb, "device_ms": dev_mag,
        },
        {
            "name": "dense_scan", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/dense_scan.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:335",
            "launches": launches16["dense_scan"], "max_abs_err": err_densem,
            "ms": ms_densem, "plain_ms": plain_densem, "bound_ms": b_dense,
            "bound_by": by_dense, "library_ms": None, "device_ms": dev_densem,
            "device_launches_per_call": calls_densem,
        },
        {
            "name": "extract_classify_v3", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/extract_classify_v3.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:847",
            "launches": launches_fc["extract_classify_v3"], "max_abs_err": err_cls,
            "ms": ms_cls, "plain_ms": plain_cls, "bound_ms": b_cls,
            "bound_by": by_cls, "library_ms": None, "device_ms": dev_cls,
            "device_launches_per_call": calls_cls,
        },
        {
            "name": "extract_classify", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/extract_classify.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:928",
            "launches": launches_v2["extract_classify"], "max_abs_err": err_cls2,
            "ms": ms_cls2, "plain_ms": plain_cls2, "bound_ms": b_cls,
            "bound_by": by_cls, "library_ms": None, "device_ms": dev_cls2,
            "device_launches_per_call": calls_cls2,
        },
        {
            "name": "fused_demod", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/fused_demod.cu",
            "replaces": "readsb_tpu/ops/fused.py:304",
            "launches": launches_fu["fused_demod"], "max_abs_err": err_fu,
            "ms": ms_fu, "plain_ms": plain_fu, "bound_ms": b_fu,
            "bound_by": by_fu, "library_ms": None, "device_ms": dev_fu,
            "device_launches_per_call": calls_fu,
        },
    ]
    for entry in entries:
        # the launches of the app phase's three counted routes
        entry["app_launches"] = app_launches[entry["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
