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

and then the network layer:

  net              a feeder App on the card over 8 uc8 receivers x 1.0 s
                   serves Beast, raw and SBS to clients that connect
                   before the replay, and the /re-api server; its lanes'
                   bytes, its API answers and aircraft.json equal the same
                   run on the CPU; two aggregator Apps take the feeder's
                   Beast lane through --net-connector, one on the scalar
                   drain (--no-net-bulk-drain) and one on the columnar
                   drain (the default), and hold its aircraft; 200 timed
                   ?all queries and the host split

and then the aggregator's device parts:

  cpr              the three device CPR cores (ops/cpr_device.py) on the
                   card against the CPU, bit for bit, over 32768 pairs per
                   mode
  agg              an aggregator App (--net-only --lat --lon) fed 240,000
                   Beast frames of 10,000 aircraft as wire bytes through
                   BeastIn.feed (the columnar drain), with and without
                   --device-arena: the arena's state and device CPR fixes
                   on the card equal a CPU arena's over the same updates,
                   aircraft.json with the arena equals it without, every
                   aircraft at its encoded position; frames/s, the arena's
                   per-update device ms, rounds, launches and readback,
                   the per-tick sweep and materialize_arena, and the
                   card's idle share

and then the SDR sources and persistence:

  sdr              App._run_sdr_source (the path of --device-type rtlsdr,
                   soapy and bladerf) fed by an in-process stand-in of an
                   SDR source: one receiver of 10 s of traffic (13
                   aircraft) at the default --blocks-per-batch, as uc8,
                   sc16 and sc16q11; each route on the card equals its CPU
                   run and run_ifile over the same whole superblocks and
                   launches exactly its kernels; then the uc8 route paced
                   at 2.4 MS/s through the sources' shedding queue, read
                   (dropped buffers, feed() ms per superblock, the app's
                   share of realtime) without checks
  state            whether libzstd.so.1 is on the machine; if it is, the
                   uc8 SDR App's --write-state directory restores into a
                   fresh card App, --dump-beast decompresses to the frames
                   taken, and &binCraft&zstd to the plain answer

and then history:

  history          (a) App.amain over the network phase's scene (8 uc8
                   receivers x 1.0 s) with --json-globe-index
                   --json-trace-interval 1 --globe-history-dir --heatmap 1
                   --write-prom --db-file --write-state: trace files, globe
                   tiles, heatmap, Prometheus text, receivers,
                   aircraft.json and the state directory equal its CPU run,
                   and only kernels #1 and #2 launch; (b) the aggregator
                   phase's 240,000 frames with --json-globe-index
                   --write-state --write-prom --db-file, host only and with
                   --device-arena, card against CPU, no kernel launched;
                   the trace sweep, the writers and state with traces timed
                   at 10,000 aircraft, and the aggregator's frames/s with
                   and without --json-globe-index

and then the sharded mesh (readsb_tpu_torch/parallel):

  mesh             (a) dryrun_multichip(8) on eight slots of the card:
                   both programs' frames == the unsharded demod_block and
                   every field == the CPU run's; (b) the gated program at
                   k_per_shard=4096, k2=512 on a (chan=2, time=4) mesh over
                   64 channels x 524,288 samples of the app phase's
                   104-aircraft scene (converted by mag_uc8): no overflow,
                   frames == the unsharded demod_block per channel, >= 90%
                   of the truth, the step timed (CUDA events, median of 5)
                   and profiled beside MultiDemodulator(64) on the same
                   samples; (c) the two-process run, two ranks on the card
                   with gloo for control

and then the repo's measurement and compile-check entry points, in process:

  bench            readsb_tpu_torch.bench at C = 64 x 131072, run in
                   the end-to-end section before the app phase (its
                   demod_throughput JSON line, five runs of ten dispatches
                   by CUDA events, is the staged dispatch's reading; the
                   same dispatch is timed by bench.time_dispatch under
                   each constant); checked here: only #1 and #2 launched,
                   one each per dispatch; its frames == the CPU run of the
                   same chunks, >= 90% of the truth; graft_entry.entry()
                   == its CPU run in every field, launching only #4 and
                   #2; the four readsb_tpu_torch.tools benches at reduced
                   sizes (arena 4096 x 5, net 50,000 frames, serving
                   10,000 aircraft, state 100,000 aircraft), each JSON
                   line parsed

and then the packaging (packaging/):

  packaging        the systemd unit's ExecStart (readsb-tpu-torch.service)
                   with the $GROUPs of readsb-tpu-torch.default, as its
                   first start runs it: a child process on the card with
                   a fresh, empty READSB_TPU_TORCH_BUILD_DIR, fed one uc8
                   receiver of the network phase's scene (1.0 s) on
                   stdin; it exits 0, builds the seven kernels and the
                   finalizer into that directory and changes no library
                   beside the repo, and its aircraft.json equals an
                   in-process card App's over the same capture with the
                   same options; its build and wall seconds

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
import shlex
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from readsb_tpu_torch import BUILD_DIR, bench, graft_entry, pipeline
from readsb_tpu_torch.app import main as app_main
from readsb_tpu_torch.constants import (
    BLOCK_SAMPLES,
    PREAMBLE_THRESHOLD_DEFAULT,
    SAMPLE_RATE,
    TRAILING_SAMPLES,
)
from readsb_tpu_torch.decode.mode_ac import modec_to_modea
from readsb_tpu_torch.io import beast as beast_io
from readsb_tpu_torch.io import json_out, sdr, zstd
from readsb_tpu_torch.io import state as state_io
from readsb_tpu_torch.ops import demod as demod_ops
from readsb_tpu_torch.ops import fused, kernels
from readsb_tpu_torch.ops.convert import mag_uc8_words, uc8_lut_np
from readsb_tpu_torch import tools as port_tools
from readsb_tpu_torch.tools import bench_arena, bench_net, bench_serving, state_scale_1m
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


class MessageRecordingApp(app_main.App):
    """The port's App, keeping (message, 12 MHz timestamp) of each message
    it hands to its output lanes."""

    def __init__(self, args):
        super().__init__(args)
        self.sent = []

    def handle_message(self, mm, raw_ts: int = 0, signal: float = 0.0) -> None:
        self.sent.append((bytes(mm.msg), raw_ts))
        super().handle_message(mm, raw_ts=raw_ts, signal=signal)


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


# the network phase: a feeder on 8 receivers of 13 aircraft each (one
# address base per receiver, so 104 aircraft), and an aggregator on its
# Beast lane
NET_RECEIVERS = 8
NET_S = 1.0
NET_QUERIES = 200
NET_TIMEOUT = 60.0  # seconds for any one network read or await
# aircraft.json keys that readsb_tpu's columnar drain does not produce
COLUMNAR_NOT_OWNED = ("type", "category", "version", "nac_p", "nac_v", "sil", "sil_type",
                      "alert", "spi")
SBS_CLOCK_FIELDS = slice(6, 10)  # SBS fields 7-10: the message's and the line's date and time


def free_port_block(n: int) -> int:
    """A base port where base..base+n-1 are all bindable on 127.0.0.1 now."""
    import socket

    for _ in range(200):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        socks = []
        try:
            for k in range(n):
                t = socket.socket()
                t.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                t.bind(("127.0.0.1", base + k))
                socks.append(t)
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
        if len(socks) == n:
            return base
    raise RuntimeError("no free block of ports")


async def read_to_eof(reader) -> bytes:
    out = bytearray()
    while True:
        data = await asyncio.wait_for(reader.read(1 << 16), NET_TIMEOUT)
        if not data:
            return bytes(out)
        out += data


async def api_get(reader, writer, target: str) -> bytes:
    """One GET on a keep-alive connection to the API; the body."""
    writer.write(b"GET %s HTTP/1.1\r\nHost: localhost\r\n\r\n" % target.encode())
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), NET_TIMEOUT)
    check(head.startswith(b"HTTP/1.1 200 OK"), f"API {target}: {head[:60]!r}")
    length = int(head.lower().split(b"content-length:")[1].split(b"\r\n")[0])
    return await asyncio.wait_for(reader.readexactly(length), NET_TIMEOUT)


async def _noop() -> None:
    pass


async def net_run(paths: list[str], device: str, d: str, aggregate: bool) -> dict:
    """The feeder App over `paths` on `device`, its Beast, raw and SBS
    lanes read by clients that connect before the replay, the API queried
    after it; with `aggregate`, an aggregator App on the feeder's Beast
    lane and 200 timed `?all` queries.  The kernel launch counts are set
    to 0 just before the feeder's replay and read just after."""
    base = free_port_block(8)
    sbs, bo, ro, api_port = base, base + 5, base + 6, base + 7  # sbs+1..+4: its variant lanes
    out_dir = os.path.join(d, f"feeder_{device}")
    argv = ["--device-type", "ifile", "--ifile", ",".join(paths), "--blocks-per-batch", "1",
            "--net", "--net-bind-address", "127.0.0.1", "--net-bo-port", str(bo),
            "--net-ro-port", str(ro), "--net-sbs-port", str(sbs), "--net-api-port", str(api_port),
            "--write-json", out_dir, "--write-json-every", "0.25"]
    feeder = make_app(argv, device, MessageRecordingApp)
    await asyncio.wait_for(feeder.setup_net(), NET_TIMEOUT)
    feeder.setup_net = _noop  # bound above, so that the clients connect before the replay
    clients = {}
    for name, port in (("beast", bo), ("raw", ro), ("sbs", sbs)):
        clients[name] = await asyncio.wait_for(
            asyncio.open_connection("127.0.0.1", port), NET_TIMEOUT)
    aggregators, agg_tasks = {}, []
    if aggregate:
        # the scalar drain, and readsb_tpu's default for this command: the
        # columnar drain
        for name, drain in (("aggregator", ["--no-net-bulk-drain"]), ("columnar", [])):
            aggregators[name] = app_main.App(app_main.parse_args([
                "--net-only", *drain, "--net-connector", f"127.0.0.1,{bo},beast_in",
                "--write-json", os.path.join(d, name), "--write-json-every", "0.25"]))
            agg_tasks.append(asyncio.ensure_future(aggregators[name].amain()))
        check(aggregators["aggregator"].bulk is None and aggregators["columnar"].bulk is not None,
              "the two aggregators did not take the scalar and the columnar drain")
    res = {"feeder": feeder, **aggregators}
    try:
        async def connected():
            while (len(feeder.out_beast.clients) < 1 + 2 * aggregate or not feeder.out_raw.clients
                   or not feeder.out_sbs.clients):
                await asyncio.sleep(0.01)

        await asyncio.wait_for(connected(), NET_TIMEOUT)
        reads = {k: asyncio.ensure_future(read_to_eof(r)) for k, (r, _) in clients.items()}
        reset_counts()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = await asyncio.wait_for(feeder.amain(), 600)
        if device == "cuda":
            torch.cuda.synchronize()
        res["wall"] = time.perf_counter() - t0
        res["launches"] = read_counts()
        check(rc == 0, f"the feeder on {device} exited {rc}")
        res["streams"] = {k: await asyncio.wait_for(t, NET_TIMEOUT) for k, t in reads.items()}
        feeder.api_server.update(feeder.now_ms())  # the API over the final tracker state
        r, w = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", api_port), NET_TIMEOUT)
        try:
            res["all"] = json.loads(await api_get(r, w, "/?all"))
            ac = [a for a in res["all"]["aircraft"] if "lat" in a]
            check(len(ac) >= 2, f"the feeder on {device}: {len(ac)} aircraft with positions")
            res["circle"] = json.loads(await api_get(
                r, w, "/?circle=%.4f,%.4f,30" % (ac[0]["lat"], ac[0]["lon"])))
            res["find_hex"] = json.loads(await api_get(
                r, w, "/?find_hex=%s,%s" % (ac[0]["hex"], ac[1]["hex"])))
            if aggregate:
                lat = []
                for _ in range(NET_QUERIES):
                    t1 = time.perf_counter()
                    await api_get(r, w, "/?all")
                    lat.append((time.perf_counter() - t1) * 1e3)
                res["api_ms"] = sorted(lat)
        finally:
            w.close()
        def taken(agg):  # frames read off the feeder's Beast lane
            return (len(agg._net_queue) + sum(len(b["ts"]) for b in agg._net_cols_queue)
                    + agg.remote_modes)

        async def aggregated():
            while any(taken(agg) < feeder.messages for agg in aggregators.values()):
                await asyncio.sleep(0.01)

        await asyncio.wait_for(aggregated(), NET_TIMEOUT)
    finally:
        if feeder.api_server is not None and feeder.api_server.server is not None:
            feeder.api_server.server.close()
        for agg in aggregators.values():
            agg._exit_event.set()
        for task in agg_tasks:
            await asyncio.wait_for(task, NET_TIMEOUT)
        for _, w in clients.values():
            w.close()
    res["aircraft.json"] = json.load(open(os.path.join(out_dir, "aircraft.json")))
    for name in aggregators:
        res[name + ".json"] = json.load(open(os.path.join(d, name, "aircraft.json")))
    return res


def sbs_without_clock(stream: bytes) -> list[list[str]]:
    lines = [ln.split(",") for ln in stream.decode().split("\r\n") if ln]
    for f in lines:
        f[SBS_CLOCK_FIELDS] = []
    return lines


def without_ptime(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "ptime"}


def net_phase(card: str) -> dict[str, int]:
    """The network layer on the card: a feeder App demodulating on the card
    serves Beast, raw and SBS and the API, each held against the same run
    on the CPU; an aggregator App on its Beast lane holds its aircraft.
    Returns the feeder's kernel launches."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_net_")
    d = tmp.name
    paths = [os.path.join(d, f"net{c}.uc8.dat") for c in range(NET_RECEIVERS)]
    jobs = [(paths[c], "uc8", NET_S, 700 + c, 0x600000 + c * 0x10000)
            for c in range(NET_RECEIVERS)]
    scene = set().union(*render_captures(jobs))
    card_run = asyncio.run(net_run(paths, "cuda", d, aggregate=True))
    cpu_run = asyncio.run(net_run(paths, "cpu", d, aggregate=False))
    feeder, launches = card_run["feeder"], card_run["launches"]
    check_launched(launches, APP_ROUTES["multi"], "the network phase's feeder")
    got, want = card_run["streams"], cpu_run["streams"]
    check(got["beast"] == want["beast"] and len(got["beast"]) > 0,
          "the Beast lane's bytes on the card differ from the CPU run's")
    check(got["raw"] == want["raw"] and len(got["raw"]) > 0,
          "the raw lane's bytes on the card differ from the CPU run's")
    check(sbs_without_clock(got["sbs"]) == sbs_without_clock(want["sbs"]) and got["sbs"],
          "the SBS lane's lines on the card differ from the CPU run's")
    deframed = list(beast_io.BeastDeframer().feed(got["beast"]))
    check([(f.msg, f.timestamp) for f in deframed] == feeder.sent,
          "the Beast lane's frames differ from the feeder's accepted frames")
    for q in ("all", "circle", "find_hex"):
        check(without_ptime(card_run[q]) == without_ptime(cpu_run[q]),
              f"API ?{q} on the card differs from the CPU run: "
              f"{first_diff(without_ptime(card_run[q]), without_ptime(cpu_run[q]))}")
    check(card_run["aircraft.json"] == cpu_run["aircraft.json"],
          "the feeder's aircraft.json on the card differs from the CPU run's")
    hexes = {a["hex"] for a in card_run["all"]["aircraft"]}
    check(hexes == {a["hex"] for a in card_run["aircraft.json"]["aircraft"]} and scene <= hexes,
          f"?all: {len(hexes)} aircraft, {len(scene - hexes)} scene aircraft missing")
    check(len(card_run["find_hex"]["aircraft"]) == 2 and card_run["circle"]["aircraft"],
          "?find_hex or ?circle answered no aircraft")

    # the aggregator stamps messages with its own clock ("seen", "seen_pos")
    # and keeps the signal as the Beast lane's byte ("rssi")
    def strip(doc):
        return {a["hex"]: {k: v for k, v in a.items() if k not in ("seen", "seen_pos", "rssi")}
                for a in doc["aircraft"]}

    agg = card_run["aggregator"]
    check(strip(card_run["aggregator.json"]) == strip(card_run["aircraft.json"]),
          "the aggregator's aircraft differ from the feeder's: " + first_diff(
              strip(card_run["aggregator.json"]), strip(card_run["aircraft.json"])))
    check(agg.remote_modes == len(feeder.sent),
          f"the aggregator took {agg.remote_modes} of {len(feeder.sent)} frames")
    # readsb_tpu's columnar drain keeps the field groups it owns
    # (app/bulk_drain.py): it leaves out what the scalar decoder takes from
    # ident and position frames beyond them, and serves the callsign
    # without its padding
    def owned(doc):
        return {h: {k: (v.rstrip() if k == "flight" else v) for k, v in a.items()
                    if k not in COLUMNAR_NOT_OWNED}
                for h, a in strip(doc).items()}

    col = card_run["columnar"]
    check(owned(card_run["columnar.json"]) == owned(card_run["aircraft.json"]),
          "the columnar aggregator's aircraft differ from the feeder's: " + first_diff(
              owned(card_run["columnar.json"]), owned(card_run["aircraft.json"])))
    check(col.remote_modes == len(feeder.sent),
          f"the columnar aggregator took {col.remote_modes} of {len(feeder.sent)} frames")
    wall, msgs = card_run["wall"], feeder.messages
    lat = card_run["api_ms"]
    log(f"net feeder: {NET_RECEIVERS} uc8 receivers x {NET_S} s, {len(scene)} scene aircraft; "
        f"Beast ({len(got['beast'])} B), raw ({len(got['raw'])} B) and SBS "
        f"({got['sbs'].count(b'\n')} lines) on the card == CPU run (SBS clock fields aside); "
        f"the Beast lane's {len(deframed)} frames == the accepted frames; ?all, ?circle, "
        f"?find_hex and aircraft.json == CPU run; launches={launches} on {card}")
    log(f"net feeder: replay wall {wall:.3f} s, {msgs} messages = {msgs / wall:.0f} messages/s "
        f"through the lanes; Beast {len(got['beast']) / wall / 1e3:.1f} kB/s, raw "
        f"{len(got['raw']) / wall / 1e3:.1f} kB/s, SBS {len(got['sbs']) / wall / 1e3:.1f} kB/s "
        f"on {card}")
    log(f"net API: {NET_QUERIES} sequential ?all ({len(hexes)} aircraft, "
        f"{len(json.dumps(card_run['all'])) / 1e3:.1f} kB) on one connection over 127.0.0.1: "
        f"median {statistics.median(lat):.3f} ms, p99 {lat[int(0.99 * len(lat)) - 1]:.3f} ms "
        f"(host clock) on {card}")
    split = ", ".join(f"{k} {v:.1f}" for k, v in feeder.stats_collector.cpu.items())
    agg_split = ", ".join(f"{k} {v:.1f}" for k, v in agg.stats_collector.cpu.items())
    col_split = ", ".join(f"{k} {v:.1f}" for k, v in col.stats_collector.cpu.items())
    log(f"net host split, ms (stats_collector.cpu): feeder {split}; aggregator {agg_split}; "
        f"columnar aggregator {col_split}; "
        f"the CPU run's replay wall {cpu_run['wall']:.3f} s on {card}")
    log(f"net aggregators: {agg.remote_modes} frames over --net-connector beast_in to each; "
        f"the scalar drain's {len(card_run['aggregator.json']['aircraft'])} aircraft == the "
        f"feeder's (seen, seen_pos, rssi aside), the columnar drain's "
        f"{len(card_run['columnar.json']['aircraft'])} == the feeder's on the keys it owns on "
        f"{card}")
    tmp.cleanup()
    return launches


# the aggregator phase: 10,000 aircraft, 24 Beast frames each (12 DF17
# airborne positions of both CPR parities, 3 velocities, 3 idents, 3 DF5,
# 3 DF11), each frame behind a 0xE8 synthetic-time prefix at epoch ms,
# fed as wire bytes in 64 KiB chunks to an in-process App (--net-only
# --lat --lon), which takes the columnar drain
AGG_AIRCRAFT = 10_000
AGG_PER_AIRCRAFT = 24
AGG_FRAMES_PER_MS = 4  # 240,000 frames over 60 s of synthetic time
AGG_CHUNK = 65536
AGG_TICK_CHUNKS = 8  # a maintenance tick (materialize, sweep) every 8 chunks
AGG_LAT, AGG_LON = 45.0, -95.0  # the receiver; the aircraft fill a 6 x 6 degree box around it
AGG_ARGV = ["--net-only", "--quiet", "--lat", str(AGG_LAT), "--lon", str(AGG_LON)]
# the keys of readsb_tpu's tests/test_bulk_app.py::test_device_arena_app_equivalence
AGG_KEYS = ("hex", "flight", "alt_baro", "gs", "track", "baro_rate", "squawk", "lat",
            "lon", "seen", "messages")
CPR_FUZZ = 32768  # pairs per mode, card against CPU
AGG_DEVICE = "cuda"


def agg_track(i: int, n_ac: int) -> tuple[float, float]:
    """Where the aircraft of frame `i` is at that frame's time: due north
    at 1e-6 degrees per ms (216 kt, as its velocity frames say)."""
    ac = i % n_ac
    return (AGG_LAT - 3.0 + (ac % 100) * 0.06 + 1e-6 * (i / AGG_FRAMES_PER_MS),
            AGG_LON - 3.0 + (ac // 100) * 0.06)


def agg_wire(job: tuple) -> bytes:
    """Beast wire bytes of frames lo..hi-1 of the aggregator's stream.
    Runs in a worker process."""
    from readsb_tpu_torch import synth

    lo, hi, n_ac = job
    out = []
    for i in range(lo, hi):
        ac, seq = i % n_ac, i // n_ac
        addr = 0xA00000 + ac
        k = seq % 8
        if k < 4:
            lat, lon = agg_track(i, n_ac)
            msg = synth.encode_df17_position(addr, lat, lon, 20000 + (ac % 300) * 100, seq & 1)
        elif k == 4:
            msg = synth.encode_df17_velocity(addr, 216, 0, 64 * (ac % 9 - 4))
        elif k == 5:
            msg = synth.encode_df17_ident(addr, f"AGG{ac:05d}")
        elif k == 6:
            msg = synth.encode_df5(addr, 0x1000 + (ac % 1000) * 4 % 0x7777)
        else:
            msg = synth.encode_df11(addr)
        out.append(beast_io.encode_synthetic_ts(APP_EPOCH_MS + i // AGG_FRAMES_PER_MS)
                   + beast_io.encode_frame(msg, i * 3000, 0.2 + (i % 20) * 0.01))
    return b"".join(out)


def agg_stream(n_ac: int, per_ac: int) -> list[bytes]:
    """The aggregator's stream as 64 KiB chunks, rendered in worker processes."""
    n = n_ac * per_ac
    step = -(-n // 64)
    jobs = [(lo, min(n, lo + step), n_ac) for lo in range(0, n, step)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                                                mp_context=ctx) as pool:
        wire = b"".join(pool.map(agg_wire, jobs))
    return [wire[i:i + AGG_CHUNK] for i in range(0, len(wire), AGG_CHUNK)]


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def agg_replay(chunks: list[bytes], device: str, arena: bool, hooks=None, extra=()):
    """One aggregator App (AGG_ARGV and `extra`) fed the chunks through
    BeastIn.feed (the cols_mode path, drain_cols), with a maintenance tick
    (drain, materialize, materialize_arena, the arena's sweep) every
    AGG_TICK_CHUNKS chunks and at the end.  The App's clock reads the
    stream's synthetic time.  Returns (app, host seconds)."""
    app = make_app(AGG_ARGV + (["--device-arena"] if arena else []) + list(extra), device)
    check((app.arena is not None) == arena and app.bulk is not None,
          "the aggregator did not take the columnar drain (and the arena)")
    if hooks is not None:
        hooks(app)
    conn = app._beast_input_factory()()
    check(conn.cols_mode, "the aggregator's Beast input is not in columnar mode")
    clock = [APP_EPOCH_MS]

    def now():
        return max(clock[0], int(conn.deframer.synthetic_ms))

    app.now_ms = now

    def tick():
        app.drain_net_queue()
        t = now()
        app._materialize(t)
        if app.arena is not None:
            app.arena.sweep(t)

    async def pump():
        for k, chunk in enumerate(chunks):
            await conn.feed(chunk)
            if (k + 1) % AGG_TICK_CHUNKS == 0:
                tick()
        tick()

    sync(device)
    t0 = time.perf_counter()
    asyncio.run(pump())
    sync(device)
    return app, time.perf_counter() - t0


def cpr_phase(card: str) -> None:
    """The three device CPR cores on the card against the CPU, bit for bit,
    over CPR_FUZZ random pairs per mode (surface and relative at seven
    reference points)."""
    from readsb_tpu_torch.ops import cpr_device

    rng = np.random.default_rng(23)
    n = CPR_FUZZ
    elat = rng.integers(0, 1 << 17, n)
    elon = rng.integers(0, 1 << 17, n)
    olat = np.where(rng.random(n) < 0.5,
                    np.clip(elat + rng.integers(-600, 600, n), 0, (1 << 17) - 1),
                    rng.integers(0, 1 << 17, n))
    olon = np.clip(elon + rng.integers(-600, 600, n), 0, (1 << 17) - 1)
    fflag = rng.integers(0, 2, n)
    surface = rng.integers(0, 2, n)
    cols = [torch.from_numpy(np.asarray(a, np.int32)) for a in (elat, elon, olat, olon, fflag)]

    def same(fn, what):
        a = fn([c.to(DEV) for c in cols])
        b = fn(cols)
        for k in b:
            check(torch.equal(a[k].cpu(), b[k]), f"{what}: {k} on the card differs from the CPU")
        return int(b["ok"].sum())

    oks = [same(lambda c: cpr_device.decode_airborne_core(*c), "airborne")]
    refs = [(-60.0, 10.0), (-44.9, -170.0), (0.0, 0.0), (30.0, 100.0), (46.0, 5.0),
            (52.0, -1.0), (80.0, 179.5)]
    surf_ok = rel_ok = 0
    for reflat, reflon in refs:
        q = cpr_device.surface_quadrant_consts(reflat)
        surf_ok += same(lambda c: cpr_device.decode_surface_core(
            *c, q["zneg"], q["zpos"], q["t0"], q["t1"]), f"surface at {reflat}")
        consts = cpr_device.relative_consts(reflat, reflon)
        s = torch.from_numpy(np.asarray(surface, np.int32))

        def rel(c):
            tabs = cpr_device.relative_consts_on(consts, c[0].device)
            return cpr_device.decode_relative_core(c[0], c[1], c[4], s.to(c[0].device), tabs)

        rel_ok += same(rel, f"relative at {reflat}")
    log(f"cpr: the airborne, surface and relative cores on the card == CPU over {n} pairs "
        f"each (surface and relative at {len(refs)} reference points); accepted: airborne "
        f"{oks[0]}, surface {surf_ok}, relative {rel_ok} on {card}")


def agg_phase(card: str) -> list[bytes]:
    """The aggregator on the card: the columnar drain with and without
    --device-arena; the arena's state and device CPR fixes on the card
    equal a CPU arena's over the same updates and sweeps; aircraft.json
    with the arena equals aircraft.json without it; readings.  Returns the
    stream's chunks."""
    from readsb_tpu_torch.app import bulk_drain
    from readsb_tpu_torch.track import arena as arena_mod

    t0 = time.perf_counter()
    chunks = agg_stream(AGG_AIRCRAFT, AGG_PER_AIRCRAFT)
    n_frames = AGG_AIRCRAFT * AGG_PER_AIRCRAFT
    wire_bytes = sum(len(c) for c in chunks)
    log(f"agg: {n_frames} frames of {AGG_AIRCRAFT} aircraft, {wire_bytes} B in "
        f"{len(chunks)} chunks, rendered in {time.perf_counter() - t0:.1f} s")

    # timed runs, in turns: host only, then with the arena on the card
    walls = {False: [], True: []}
    for _ in range(3):
        for arena in (False, True):
            reset_counts()
            app, wall = agg_replay(chunks, AGG_DEVICE, arena)
            check_launched(read_counts(), (), "the aggregator phase")
            check(app.messages == n_frames, f"the aggregator accepted {app.messages} of {n_frames}")
            walls[arena].append(wall)

    # the instrumented run: every update and sweep recorded, arena_update
    # timed with CUDA events, sweep and materialize_arena per tick on the
    # host clock around a synchronize
    rec = {"ops": [], "upd": [], "sweep_ms": [], "mat_ms": [], "popped": [], "readback": []}
    orig_update, orig_mat = arena_mod.arena_update, bulk_drain.materialize_arena

    def timed_update(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_update(*a, **k)
        e1.record()
        rec["upd"].append((e0, e1, a[2]))
        return out

    def timed_mat(app, now):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig_mat(app, now)
        rec["mat_ms"].append((time.perf_counter() - t) * 1e3)

    def hooks(app):
        ar = app.arena
        up, sw, pop = ar.update_cols, ar.sweep, ar.pop_cpr_decodes

        def update_cols(cols):
            rec["ops"].append(("update", dict(cols)))
            up(cols)
            # the CPR rows' decode records: 12 int32 each
            rec["readback"].append(48 * int(np.count_nonzero(cols["cpr_valid"])))

        def sweep(now, *a):
            rec["ops"].append(("sweep", now))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = sw(now, *a)
            rec["sweep_ms"].append((time.perf_counter() - t) * 1e3)
            return out

        def pop_cpr_decodes():
            out = pop()
            rec["popped"] += out
            return out

        ar.update_cols, ar.sweep, ar.pop_cpr_decodes = update_cols, sweep, pop_cpr_decodes

    arena_mod.arena_update, bulk_drain.materialize_arena = timed_update, timed_mat
    try:
        reset_counts()
        app_a, _ = agg_replay(chunks, AGG_DEVICE, True, hooks)
        check_launched(read_counts(), (), "the aggregator phase")
    finally:
        arena_mod.arena_update, bulk_drain.materialize_arena = orig_update, orig_mat
    upd_ms = [e0.elapsed_time(e1) for e0, e1, _ in rec["upd"]]
    rounds = [r for _, _, r in rec["upd"]]
    ar = app_a.arena
    check(not ar.cpr_decodes, "the arena's cpr_decodes was not drained by the last tick")

    # the same updates and sweeps on a CPU arena: every tensor and every
    # popped device CPR fix equal
    cpu = arena_mod.Arena(receiver_lat=AGG_LAT, receiver_lon=AGG_LON, device="cpu")
    t0 = time.perf_counter()
    for kind, arg in rec["ops"]:
        if kind == "update":
            cpu.update_cols(arg)
        else:
            cpu.sweep(arg)
    cpu_popped = cpu.pop_cpr_decodes()
    cpu_s = time.perf_counter() - t0
    for name, a, b in zip(arena_mod.ArenaState._fields, ar.state, cpu.state):
        check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
              f"the arena's {name} on the card differs from the CPU arena's")
    check(ar.slot_of == cpu.slot_of, "the arena's slot map differs from the CPU arena's")
    check(rec["popped"] == cpu_popped and len(cpu_popped) > AGG_AIRCRAFT,
          f"the device CPR fixes on the card ({len(rec['popped'])}) differ from the CPU "
          f"arena's ({len(cpu_popped)})")

    # aircraft.json with the arena == without it: the test's keys, then all
    app_h, _ = agg_replay(chunks, AGG_DEVICE, False)
    now = app_a.now_ms()
    check(now == app_h.now_ms(), "the two aggregators end at different times")
    doc_a = json_out.generate_aircraft_json(app_a.tracker, now, app_a.messages)
    doc_h = json_out.generate_aircraft_json(app_h.tracker, now, app_h.messages)
    keyed = [{k: a.get(k) for k in AGG_KEYS} for a in doc_a["aircraft"]]
    check(keyed == [{k: a.get(k) for k in AGG_KEYS} for a in doc_h["aircraft"]],
          "aircraft.json with --device-arena differs from the host path on the test's keys")
    check(doc_a == doc_h, "aircraft.json with --device-arena differs from the host path: "
          + first_diff(doc_a, doc_h))

    # right answers: every aircraft, at its last encoded position
    served = {a["hex"]: a for a in doc_a["aircraft"]}
    check(len(served) == AGG_AIRCRAFT, f"aircraft.json holds {len(served)} aircraft")
    last_seq = max(q for q in range(AGG_PER_AIRCRAFT) if q % 8 < 4)
    far = 0
    for ac in range(AGG_AIRCRAFT):
        a = served.get(f"{0xA00000 + ac:06x}", {})
        lat, lon = agg_track(last_seq * AGG_AIRCRAFT + ac, AGG_AIRCRAFT)
        if "lat" not in a or abs(a["lat"] - lat) > 1e-3 or abs(a["lon"] - lon) > 1e-3:
            far += 1
    check(far == 0, f"{far} aircraft are not at their last encoded position")
    last_fix = {}
    for addr, _ts, _f, lat, lon, _nic, _rc in rec["popped"]:
        last_fix[addr] = (lat, lon)
    match = sum(1 for addr, (lat, lon) in last_fix.items()
                if (app_a.tracker.aircraft[addr].lat, app_a.tracker.aircraft[addr].lon) == (lat, lon))
    check(match == len(last_fix) == AGG_AIRCRAFT,
          f"{match} of {len(last_fix)} last device CPR fixes are the served positions")

    # launches per update and device busy per update: the recorded updates
    # on a fresh card arena under torch.profiler
    fresh = arena_mod.Arena(receiver_lat=AGG_LAT, receiver_lon=AGG_LON, device=AGG_DEVICE)
    updates = [arg for kind, arg in rec["ops"] if kind == "update"]
    fresh.update_cols(updates[0])
    fresh = arena_mod.Arena(receiver_lat=AGG_LAT, receiver_lon=AGG_LON, device=AGG_DEVICE)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for cols in updates:
            fresh.update_cols(cols)
        torch.cuda.synchronize()
    devs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(devs, "torch.profiler saw no device activity of the arena")
    launches_upd = sum(e.count for e in devs) / len(updates)
    busy_upd = sum(e.self_device_time_total for e in devs) / len(updates) / 1e3
    top = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in devs), reverse=True)[:5]

    # the card's idle share over an arena replay, under torch.profiler
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_p = agg_replay(chunks, AGG_DEVICE, True)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6

    nbytes = sum(t.numel() * t.element_size() for t in ar.state)
    fps = {k: n_frames / statistics.median(v) for k, v in walls.items()}
    log(f"agg checks: {AGG_AIRCRAFT} aircraft at their encoded positions; the arena's "
        f"{len(arena_mod.ArenaState._fields)} tensors and {len(cpu_popped)} popped device CPR "
        f"fixes on the card == a CPU arena over the same {len(updates)} updates and "
        f"{len(rec['ops']) - len(updates)} sweeps (CPU replay {cpu_s:.1f} s); aircraft.json "
        f"with --device-arena == without it; every last device fix == the served position; "
        f"no kernel launched on {card}")
    log(f"agg columnar drain: {fps[False]:.0f} frames/s host only "
        f"({', '.join(f'{w:.3f}' for w in walls[False])} s), {fps[True]:.0f} frames/s with "
        f"--device-arena ({', '.join(f'{w:.3f}' for w in walls[True])} s); median of 3, "
        f"host clock, {n_frames} frames incl. {len(rec['sweep_ms'])} ticks, on {card}")
    log(f"agg arena: {nbytes} B of state on the card for {ar.n} slots "
        f"({torch.cuda.memory_allocated() / 1e6:.1f} MB allocated); {len(updates)} updates of "
        f"{min(len(c['addr']) for c in updates)}-{max(len(c['addr']) for c in updates)} rows, "
        f"rounds {min(rounds)}-{max(rounds)} (median {statistics.median(rounds)}); "
        f"arena_update by CUDA events median {statistics.median(upd_ms):.3f} ms "
        f"(min {min(upd_ms):.3f}, max {max(upd_ms):.3f}); under torch.profiler per update "
        f"{busy_upd:.3f} ms device busy, {launches_upd:.0f} device launches; read back per "
        f"update median {statistics.median(rec['readback']):.0f} B; on {card}")
    log(f"agg ticks: arena_sweep median {statistics.median(rec['sweep_ms']):.3f} ms, "
        f"materialize_arena median {statistics.median(rec['mat_ms']):.3f} ms (host clock, "
        f"synchronized) over {len(rec['sweep_ms'])} ticks; materialize_arena reads back "
        f"{nbytes // ar.n * len(ar.slot_of)} B per tick; profiled replay wall "
        f"{wall_p:.3f} s, device busy {busy:.3f} s, idle {100 * (1 - busy / wall_p):.1f}% on "
        f"{card}")
    log("agg largest device items per update: " + "; ".join(
        f"{ms / len(updates):.3f} ms x{c // len(updates)} {k[:50]}" for ms, c, k in top))
    return chunks


# the SDR phase: one receiver at full width through App._run_sdr_source,
# fed by an in-process stand-in of an SDR source: 10 s of traffic at
# 2.4 MS/s, 13 aircraft, the default --blocks-per-batch
SDR_S = 10.0
SDR_AIRCRAFT = 13
SDR_ROUTES = {
    # route: (argv, source format, scale of the rendered scene, its kernels)
    "uc8": (["--device-type", "rtlsdr"], "uc8", 1.0, APP_ROUTES["multi"]),
    "sc16": (["--device-type", "soapy"], "sc16", 1.0, APP_ROUTES["sc16"]),
    # sc16q11's full scale is 2048: the sc16 scene at 1/16 of its scale
    "sc16q11": (["--device-type", "bladerf"], "sc16q11", 1 / 16, APP_ROUTES["sc16"]),
}


def write_sdr_capture(job: tuple) -> list[str]:
    """Render one capture of the SDR phase to its file; the DF17 addresses
    it holds.  Runs in a worker process."""
    path, fmt, scale, seed, duration_s = job
    cap = build_traffic_capture(duration_s, SDR_AIRCRAFT, seed)
    iq = cap.render_iq() * scale
    (quantize_uc8(iq) if fmt == "uc8" else quantize_sc16(iq)).tofile(path)
    return sorted({t["hex"][2:8] for t in cap.truth if t.get("hex", "").startswith("8d")})


class TimedQueue(asyncio.Queue):
    """An asyncio.Queue that adds up the time its consumer waits in get()."""

    waited = 0.0

    async def get(self):
        t0 = time.perf_counter()
        try:
            return await super().get()
        finally:
            self.waited += time.perf_counter() - t0


class FakeSdrSource:
    """The interface of io/sdr.py's sources (open, start(loop), queue,
    dropped_buffers, close) over a capture's bytes: SDR_BUF_BYTES pieces,
    then the b"" end marker.  Lossless, it waits for room in the queue;
    realtime, a thread hands each piece to the loop when the sample clock
    reaches its end, through the sources' own shedding _push."""

    _push = sdr.RtlSdrSource._push

    def __init__(self, data: bytes, bps: int, realtime: bool = False):
        self.data, self.bps, self.realtime = data, bps, realtime
        self.queue = TimedQueue(maxsize=sdr.SDR_N_BUFFERS)
        self.dropped_buffers = 0
        self.opened = self.closed = False
        self._stop = threading.Event()
        self._thread = self._task = None

    def open(self) -> None:
        self.opened = True

    def start(self, loop) -> None:
        if self.realtime:
            self._thread = threading.Thread(target=self._paced, args=(loop,), daemon=True)
            self._thread.start()
        else:
            self._task = loop.create_task(self._lossless())

    async def _lossless(self) -> None:
        for i in range(0, len(self.data), sdr.SDR_BUF_BYTES):
            await self.queue.put(self.data[i:i + sdr.SDR_BUF_BYTES])
        await self.queue.put(b"")

    def _paced(self, loop) -> None:
        t0 = time.perf_counter()
        for i in range(0, len(self.data), sdr.SDR_BUF_BYTES):
            piece = self.data[i:i + sdr.SDR_BUF_BYTES]
            wait = t0 + (i + len(piece)) / self.bps / SAMPLE_RATE - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if self._stop.is_set():
                return
            loop.call_soon_threadsafe(self._push, piece)
        loop.call_soon_threadsafe(self._push, b"")

    def close(self) -> None:
        self._stop.set()
        self.closed = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            check(not self._thread.is_alive(), "the paced source's thread did not stop")


def sdr_run(app, fmt: str, src: FakeSdrSource) -> float:
    """Seconds of app._run_sdr_source(src) on the host clock, device work
    included."""
    async def go():
        app._exit_event = asyncio.Event()
        await asyncio.wait_for(app._run_sdr_source(src, fmt), 600)

    if app.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    asyncio.run(go())
    if app.device.type == "cuda":
        torch.cuda.synchronize()
    check(src.opened and src.closed, "_run_sdr_source did not open and close its source")
    return time.perf_counter() - t0


def sdr_phase(card: str):
    """The SDR sources' path on the card: each route's fake source through
    _run_sdr_source equals the same run on the CPU and run_ifile over the
    same whole superblocks, launching exactly its kernels; then the uc8
    route at realtime pace.  Returns the counted routes' launches and the
    uc8 card App."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sdr_")
    d = tmp.name
    paths = {r: os.path.join(d, f"{r}.dat") for r in SDR_ROUTES}
    jobs = [(paths[r], fmt, scale, 900, SDR_S) for r, (_, fmt, scale, _) in SDR_ROUTES.items()]
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(jobs), mp_context=ctx) as pool:
        scene = set(list(pool.map(write_sdr_capture, jobs))[0])  # one scene, one seed
    log(f"sdr: {len(jobs)} captures of {SDR_S} s ({SDR_AIRCRAFT} aircraft) rendered in "
        f"{time.perf_counter() - t0:.1f} s")
    sdr_launches = {name: 0 for name in WRAPPERS}
    uc8_app = None
    for route, (argv, fmt, _, used) in SDR_ROUTES.items():
        data = open(paths[route], "rb").read()
        bps = 2 if fmt == "uc8" else 4
        card_app = make_app(argv, "cuda", RecordingApp)
        src = FakeSdrSource(data, bps)
        reset_counts()
        t_card = sdr_run(card_app, fmt, src)
        launches = read_counts()
        check_launched(launches, used, f"the SDR phase's {route} route")
        for name, count in launches.items():
            sdr_launches[name] += count
        cpu_app = make_app(argv, "cpu", RecordingApp)
        t_cpu = sdr_run(cpu_app, fmt, FakeSdrSource(data, bps))
        got, want = app_results(card_app), app_results(cpu_app)
        for key in want:
            check(got[key] == want[key], f"sdr {route}: {key} on the card differs from the CPU "
                                         f"run at {first_diff(got[key], want[key])}")
        check(frame_key(card_app.frames) == frame_key(cpu_app.frames),
              f"sdr {route}: the card's frames differ from the CPU run's")
        # run_ifile over the whole superblocks that _run_sdr_source fed,
        # without its final flush (the SDR runner does not flush)
        step = card_app._demod.super_samples * bps
        whole = os.path.join(d, f"{route}.whole.dat")
        with open(whole, "wb") as f:
            f.write(data[: len(data) // step * step])
        ifile_app = make_app(["--device-type", "ifile", "--ifile", whole, "--iformat", fmt],
                             "cuda", RecordingApp)
        flush = pipeline.Demodulator.flush
        pipeline.Demodulator.flush = lambda self: []
        try:
            run_app(ifile_app)
        finally:
            pipeline.Demodulator.flush = flush
        ref = app_results(ifile_app)
        for key in ref:
            check(got[key] == ref[key], f"sdr {route}: {key} differs from run_ifile's at "
                                        f"{first_diff(got[key], ref[key])}")
        check(frame_key(card_app.frames) == frame_key(ifile_app.frames),
              f"sdr {route}: the frames differ from run_ifile's")
        doc = got["aircraft.json"]
        check(scene <= with_positions(doc),
              f"sdr {route}: {len(scene - with_positions(doc))} of the scene's aircraft "
              f"have no position")
        n_sb = len(data) // step
        log(f"sdr {route}: {len(card_app.frames)} frames, {got['messages']} messages, "
            f"{len(with_positions(doc))} aircraft with positions, aircraft.json, stats and demod "
            f"stats on the card == CPU run == run_ifile over the {n_sb} whole superblocks; "
            f"launches={launches}; lossless: card {t_card:.3f} s ({len(data) // bps / t_card / 1e6:.1f}"
            f" MS/s, {got['messages'] / t_card:.0f} messages/s), feed() "
            f"{card_app.stats_collector.cpu['demod'] / n_sb:.2f} ms per superblock of "
            f"{step // bps / SAMPLE_RATE * 1e3:.1f} ms; CPU {t_cpu:.2f} s on {card}")
        if route == "uc8":
            uc8_app = card_app
            uc8_data, uc8_step = data, step

    # --- realtime: the uc8 route paced at 2.4 MS/s, read without checks --------
    rt_app = make_app(SDR_ROUTES["uc8"][0], "cuda")
    src = FakeSdrSource(uc8_data, 2, realtime=True)
    wall = sdr_run(rt_app, "uc8", src)
    dropped = rt_app.stats_collector.samples_dropped_buffers + src.dropped_buffers
    fed = (len(uc8_data) - dropped * sdr.SDR_BUF_BYTES) // uc8_step
    feed_ms = rt_app.stats_collector.cpu["demod"]
    busy = wall - src.queue.waited
    log(f"sdr realtime (uc8, paced at {SAMPLE_RATE / 1e6} MS/s, {len(uc8_data) // 2} samples "
        f"in {len(range(0, len(uc8_data), sdr.SDR_BUF_BYTES))} buffers of "
        f"{sdr.SDR_BUF_BYTES} B): dropped buffers {dropped}; {fed} superblocks fed; feed() "
        f"{feed_ms / max(fed, 1):.2f} ms per superblock of {uc8_step // 2 / SAMPLE_RATE * 1e3:.1f}"
        f" ms of signal; the app busy {busy:.3f} s of the {wall:.3f} s wall = "
        f"{busy / SDR_S * 100:.1f}% of realtime ({feed_ms / 1e3:.3f} s in feed()); "
        f"{rt_app.messages} messages = {rt_app.messages / SDR_S:.0f} messages/s of signal on "
        f"{card}")
    tmp.cleanup()
    return sdr_launches, uc8_app


def state_phase(card: str, app) -> None:
    """Persistence on the card's machine: the uc8 SDR App's --write-state
    directory restores into a fresh card App; --dump-beast output
    decompresses to the frames taken; &binCraft&zstd decompresses to the
    plain answer.  Needs libzstd.so.1, and says so where it is absent."""
    have = zstd.available()
    log(f"state: {zstd.LIBRARY} on this machine: {'found' if have else 'not found'}")
    if not have:
        log(f"state phase: did not run: {zstd.LIBRARY} is not on this machine, and the port's "
            f"zstd codec (state blobs, the Beast dump, &binCraft&zstd) loads it")
        return
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_state_")
    d = tmp.name
    sd = os.path.join(d, "state")
    t0 = time.perf_counter()
    n = state_io.save_state(app.tracker, sd, app.now_ms())
    save_ms = (time.perf_counter() - t0) * 1e3
    check(n == len(app.tracker.aircraft) >= SDR_AIRCRAFT, f"state: {n} aircraft saved")
    t0 = time.perf_counter()
    fresh = make_app(SDR_ROUTES["uc8"][0] + ["--write-state", sd], "cuda")
    load_ms = (time.perf_counter() - t0) * 1e3
    check(sorted(repr(a) for a in fresh.tracker.aircraft.values())
          == sorted(repr(a) for a in app.tracker.aircraft.values()),
          "state: a fresh App restored from --write-state differs from the App that wrote it")

    dump = os.path.join(d, "dump")
    dump_app = make_app(["--net-only", "--dump-beast", f"{dump},30"], "cuda")
    conn = dump_app._beast_input_factory()()
    check(dump_app.bulk is not None and conn.cols_mode is False,
          "--dump-beast: the Beast input did not take the object deframer")
    stream = b"".join(
        beast_io.encode_synthetic_ts(APP_EPOCH_MS + f.timestamp // 12000)
        + beast_io.encode_frame(f.msg, f.timestamp, f.signal_power) for f in app.frames)
    for i in range(0, len(stream), 65536):
        asyncio.run(conn.feed(stream[i:i + 65536]))
    dump_app.drain_net_queue()
    dump_app.beast_dump.close()
    (name,) = os.listdir(dump)
    check(name.endswith(".zst"), f"--dump-beast wrote {name}, not a .zst chunk")
    back = beast_io.BeastDeframer().feed(zstd.decompress(open(os.path.join(dump, name), "rb").read()))
    check([(f.msg, f.timestamp) for f in back] == [(f.msg, f.timestamp) for f in app.frames],
          "--dump-beast: the dump does not decompress to the frames taken")

    from readsb_tpu_torch.io.api import ApiServer

    api = ApiServer(app)
    api.update(app.now_ms())
    body, status, ctype = api.respond("/?all&binCraft&zstd")
    plain = api.respond("/?all&binCraft")[0]
    check(status == "200 OK" and ctype == "application/zstd" and zstd.decompress(body) == plain,
          "&binCraft&zstd does not decompress to the &binCraft answer")
    log(f"state: {n} aircraft saved in {save_ms:.2f} ms, a fresh App restored them in "
        f"{load_ms:.2f} ms (its construction) == the writer's, field by field; --dump-beast "
        f"{len(app.frames)} frames -> {os.path.getsize(os.path.join(dump, name))} B of zstd == the "
        f"frames taken; &binCraft&zstd {len(body)} B -> {len(plain)} B == &binCraft on {card}")
    tmp.cleanup()


# the history phase: the app with every history option.  Part (a): the
# network phase's scene (8 uc8 receivers x 1.0 s, 104 aircraft) through
# App.amain; part (b): the aggregator phase's stream through the columnar
# drain, host only and with --device-arena
HIST_MIL = 0x3F4ABC  # a military address (track/acdb.MIL_RANGES), in the database only
HIST_HALF_HOUR = 30 * 60_000
# Prometheus lines that read the host's clock, or a window that its ticks
# pace: the signal since the last stats tick, the trace sweeps
HIST_HOST_CLOCK = ("readsb_cpu_", "readsb_uptime", "readsb_signal_", "readsb_tracewrites_")
HIST_BY_TICK = ("stats.json", "clients.json", "receivers.json")  # rewritten each tick


def write_db(path: str, addrs) -> None:
    """A seeded tar1090 aircraft.csv.gz over `addrs`."""
    import gzip

    rng = np.random.default_rng(29)
    types = ("A320", "B738", "E190", "C172")
    with gzip.open(path, "wt") as f:
        for addr in addrs:
            f.write(f"{addr:06X};N{addr & 0xFFFFF:05X};{types[int(rng.integers(4))]};"
                    f"{'01'[int(rng.integers(2))]}{'01'[int(rng.integers(2))]};;2004;Op\n")


def history_files(root: str, skip=()) -> dict[str, bytes]:
    """{relative path: content} under root, gunzipped (trace files,
    heatmaps) or zstd-decompressed (globe tiles): compressed bytes need
    not be equal.  State blobs and names in `skip` are left out."""
    import gzip

    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            if rel.split(os.sep)[0] == "state" or n in skip:
                continue
            data = open(os.path.join(d, n), "rb").read()
            if data[:2] == b"\x1f\x8b":
                data = gzip.decompress(data)
            elif data[:4] == b"\x28\xb5\x2f\xfd":
                data = zstd.decompress(data)
            out[rel] = data
    return out


def reloaded_state(directory: str) -> tuple:
    """A state directory loaded into a fresh tracker: (aircraft, each
    aircraft's repr without its trace, {addr: the trace's points}), and
    the load's ms."""
    import dataclasses

    from readsb_tpu_torch.track.tracker import Tracker

    t = Tracker()
    t0 = time.perf_counter()
    n = state_io.load_state(t, directory)
    load_ms = (time.perf_counter() - t0) * 1e3
    full = {a.addr: [dataclasses.asdict(s) for s in a.trace.full()]
            for a in t.aircraft.values() if a.trace is not None}
    for a in t.aircraft.values():
        a.trace = None
    return (n, sorted(repr(a) for a in t.aircraft.values()), full), load_ms


def prom_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.split(" ")[0].startswith(HIST_HOST_CLOCK)]


def history_outputs(app, root: str, now: int) -> dict:
    """What the history writers give over `app` at `now`: the exit sweep's
    trace files, the globe tiles, the half hour's heatmap, the Prometheus
    text, the state directory reloaded; each writer's ms on the host clock."""
    from readsb_tpu_torch.io import history as history_io
    from readsb_tpu_torch.io import stats as stats_io

    os.makedirs(os.path.join(root, "traces"))
    os.makedirs(os.path.join(root, "tiles"))
    ms = {}
    t0 = time.perf_counter()
    ms["files"], _ = history_io.write_traces(app.tracker, os.path.join(root, "traces"), now,
                                             time_budget_s=None)
    ms["traces"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ms["n_tiles"] = history_io.write_globe_bincraft(app.tracker, os.path.join(root, "tiles"), now)
    ms["tiles"] = (time.perf_counter() - t0) * 1e3
    start = now // HIST_HALF_HOUR * HIST_HALF_HOUR
    t0 = time.perf_counter()
    history_io.write_heatmap(app.tracker, os.path.join(root, "heat"), start,
                             start + HIST_HALF_HOUR, interval_ms=1000)
    ms["heatmap"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    prom = stats_io.generate_prom(app, now)
    ms["prom"] = (time.perf_counter() - t0) * 1e3
    sd = os.path.join(root, "state")
    t0 = time.perf_counter()
    state_io.save_state(app.tracker, sd, now)
    ms["save"] = (time.perf_counter() - t0) * 1e3
    ms["state_bytes"] = sum(os.path.getsize(os.path.join(sd, n)) for n in os.listdir(sd))
    st, ms["load"] = reloaded_state(sd)
    return {"files": history_files(root), "prom": prom_lines(prom), "state": st,
            "receivers": app.tracker.receivers.receivers_json(now),
            "aircraft.json": json_out.generate_aircraft_json(app.tracker, now, app.messages),
            "ms": ms}


def hist_ifile_run(paths: list[str], device: str, d: str, db: str) -> dict:
    """Part (a): App.amain over the IQ files on `device` with every history
    option; the launch counts are set to 0 just before and read just after."""
    out = os.path.join(d, f"ifile_{device}")
    argv = ["--device-type", "ifile", "--ifile", ",".join(paths), "--blocks-per-batch", "1",
            "--write-json", os.path.join(out, "json"), "--json-globe-index",
            "--json-trace-interval", "1", "--globe-history-dir", os.path.join(out, "hist"),
            "--heatmap", "1", "--write-prom", os.path.join(out, "status.prom"),
            "--db-file", db, "--write-state", os.path.join(out, "state")]
    app = make_app(argv, device)
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    rc = asyncio.run(app.amain())
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(rc == 0, f"history: the --ifile App on {device} exited {rc}")
    now = app.now_ms()
    res = history_outputs(app, os.path.join(d, f"writers_{device}"), now)
    # the periodic block's globe tiles carry the clock of their tick
    res["json"] = {k: v for k, v in history_files(os.path.join(out, "json"), HIST_BY_TICK).items()
                   if not k.startswith("globe_")}
    res["exit_state"] = reloaded_state(os.path.join(out, "state"))[0]
    check(os.path.exists(os.path.join(out, "status.prom")), f"history: no status.prom on {device}")
    res.update(app=app, launches=launches, wall=wall)
    return res


def history_phase(card: str, chunks: list[bytes]) -> dict[str, int]:
    """History on the card: (a) the --ifile App on 8 uc8 receivers with
    every history option equals its CPU run, launching kernels #1 and #2
    only; (b) the aggregator's 240,000 frames with --json-globe-index,
    --write-state, --write-prom and --db-file, host only and with
    --device-arena, equal between the card and the CPU, launching no
    kernel; readings at 10,000 aircraft.  Returns part (a)'s launches."""
    from readsb_tpu_torch.io import history as history_io

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_hist_")
    d = tmp.name
    paths = [os.path.join(d, f"hist{c}.uc8.dat") for c in range(NET_RECEIVERS)]
    jobs = [(paths[c], "uc8", NET_S, 700 + c, 0x600000 + c * 0x10000)
            for c in range(NET_RECEIVERS)]
    scene = sorted(set().union(*render_captures(jobs)))
    db = os.path.join(d, "aircraft.csv.gz")
    write_db(db, [int(h, 16) for h in scene] + [HIST_MIL])

    # (a) the demodulator path
    card_run = hist_ifile_run(paths, "cuda", d, db)
    cpu_run = hist_ifile_run(paths, "cpu", d, db)
    check_launched(card_run["launches"], APP_ROUTES["multi"], "the history phase's --ifile App")
    for k in ("files", "prom", "state", "receivers", "aircraft.json", "json", "exit_state"):
        check(card_run[k] == cpu_run[k], f"history (a): {k} on the card differs from the CPU run: "
              + first_diff(card_run[k], cpu_run[k]))
    acs = {a["hex"]: a for a in card_run["aircraft.json"]["aircraft"]}
    with_db = sum(1 for a in acs.values() if a.get("r", "").startswith("N") and "t" in a)
    flagged = sum(1 for a in acs.values() if a.get("dbFlags"))
    # the trace files of amain's periodic and exit sweeps (which left none dirty)
    traces_a = [k for k in card_run["json"] if k.startswith("traces" + os.sep)]
    check(with_db >= len(scene) - 2 and flagged > 0 and len(traces_a) >= 2 * 0.9 * len(scene),
          f"history (a): {with_db} aircraft with the database's fields, {len(traces_a)} "
          f"trace files for {len(scene)} scene aircraft")
    check(card_run["state"][0] == card_run["exit_state"][0] == len(card_run["app"].tracker.aircraft)
          and len(card_run["state"][2]) >= 0.9 * len(scene),
          "history (a): the state directory lost aircraft or traces")
    log(f"history (a): --ifile App.amain on {NET_RECEIVERS} uc8 receivers x {NET_S} s "
        f"({len(scene)} scene aircraft) with --write-json --json-globe-index "
        f"--json-trace-interval 1 --globe-history-dir --heatmap 1 --write-prom --db-file "
        f"--write-state: {len(traces_a)} trace files, {card_run['ms']['n_tiles']} globe tiles, "
        f"the heatmap, the Prometheus text (host-clock lines aside), receivers, aircraft.json "
        f"({with_db} with r and t, {flagged} with dbFlags), the exit's state directory (reloaded: "
        f"{card_run['exit_state'][0]} aircraft, {len(card_run['exit_state'][2])} traces) == CPU "
        f"run; launches={card_run['launches']}; wall {card_run['wall']:.3f} s on the card, "
        f"{cpu_run['wall']:.3f} s on the CPU, on {card}")

    # (b) the aggregator path: parity, card against CPU, host only and with the arena
    n_frames = AGG_AIRCRAFT * AGG_PER_AIRCRAFT
    db_b = os.path.join(d, "aircraft_agg.csv.gz")
    write_db(db_b, [0xA00000 + ac for ac in range(AGG_AIRCRAFT)] + [HIST_MIL])
    extra = ["--json-globe-index", "--write-state", os.path.join(d, "agg_state"),
             "--write-prom", os.path.join(d, "agg.prom"), "--db-file", db_b]
    runs = {}
    for arena in (False, True):
        for device in ("cuda", "cpu"):
            reset_counts()
            app, wall = agg_replay(chunks, device, arena, extra=extra)
            if device == "cuda":
                check_launched(read_counts(), (), "the history phase's aggregator")
            check(app.messages == n_frames and app.tracker.keep_traces,
                  f"history (b): the aggregator took {app.messages} of {n_frames}")
            now = app.now_ms()
            runs[arena, device] = (app, wall, history_outputs(
                app, os.path.join(d, f"agg_{int(arena)}_{device}"), now))
    for arena in (False, True):
        got, want = runs[arena, "cuda"][2], runs[arena, "cpu"][2]
        for k in ("files", "prom", "state", "aircraft.json"):
            check(got[k] == want[k], f"history (b){' with the arena' * arena}: {k} on the card "
                  f"differs from the CPU run: " + first_diff(got[k], want[k]))
    host, dev = runs[False, "cuda"][2], runs[True, "cuda"][2]
    check(dev["files"] == host["files"] and dev["state"][2] == host["state"][2],
          "history (b): the traces with --device-arena differ from the host path's")
    n_traces = len(host["state"][2])
    check(n_traces == AGG_AIRCRAFT and host["ms"]["files"] == AGG_AIRCRAFT,
          f"history (b): {n_traces} traces, {host['ms']['files']} written, of {AGG_AIRCRAFT}")

    # the periodic sweep: the default budget of 0.05 s per tick, over every
    # trace made dirty again, as readsb_tpu's run_periodic calls it
    app = runs[True, "cuda"][0]
    traced = [a.trace for a in app.tracker.aircraft.values() if a.trace is not None]
    for tr in traced:
        tr.dirty = True
    per_tick, cursor = [], 0
    bdir = os.path.join(d, "budgeted")
    os.makedirs(bdir)
    t0 = time.perf_counter()
    while any(tr.dirty for tr in traced):
        n, cursor = history_io.write_traces(app.tracker, bdir, app.now_ms(), cursor=cursor)
        per_tick.append(n)
        check(len(per_tick) < 10 * AGG_AIRCRAFT, "history (b): the budgeted sweep does not end")
    budget_s = time.perf_counter() - t0

    # frames/s of the aggregator with and without --json-globe-index (host only)
    walls = {False: [], True: []}
    for _ in range(3):
        for globe_index in (False, True):
            _, wall = agg_replay(chunks, "cuda", False,
                                 extra=["--json-globe-index"] if globe_index else [])
            walls[globe_index].append(wall)
    fps = {k: n_frames / statistics.median(v) for k, v in walls.items()}
    m = dev["ms"]
    log(f"history (b): the aggregator's {n_frames} frames of {AGG_AIRCRAFT} aircraft with "
        f"--json-globe-index --write-state --write-prom --db-file: the exit sweep's trace files, "
        f"the globe tiles, the heatmap of the half hour, the Prometheus text (host-clock lines "
        f"aside), aircraft.json and the reloaded state on the card == the CPU run, host only "
        f"and with --device-arena; the arena's traces == the host path's; no kernel launched; "
        f"on {card}")
    log(f"history (b) trace sweep at {AGG_AIRCRAFT} aircraft (with --device-arena): the full "
        f"sweep {m['traces']:.1f} ms for {m['files']} aircraft ({2 * m['files']} files), host "
        f"only {host['ms']['traces']:.1f} ms; budgeted (0.05 s per tick): "
        f"{statistics.median(per_tick):.0f} aircraft written per tick (min {min(per_tick)}, "
        f"max {max(per_tick)}) over {len(per_tick)} ticks, {budget_s:.3f} s in all; host clock "
        f"on {card}")
    log(f"history (b) writers at {AGG_AIRCRAFT} aircraft: write_globe_bincraft {m['tiles']:.1f} "
        f"ms ({m['n_tiles']} tiles), write_heatmap {m['heatmap']:.1f} ms, generate_prom "
        f"{m['prom']:.2f} ms; host only {host['ms']['tiles']:.1f}, {host['ms']['heatmap']:.1f}, "
        f"{host['ms']['prom']:.2f} ms; host clock on {card}")
    log(f"history (b) state with traces at {AGG_AIRCRAFT} aircraft: save {m['save']:.1f} ms, "
        f"load {m['load']:.1f} ms, {m['state_bytes']} B on disk (host only: save "
        f"{host['ms']['save']:.1f} ms, load {host['ms']['load']:.1f} ms, "
        f"{host['ms']['state_bytes']} B); host clock on {card}")
    log(f"history (b) aggregator frames/s (host only, median of 3): {fps[False]:.0f} without "
        f"--json-globe-index ({', '.join(f'{w:.3f}' for w in walls[False])} s), {fps[True]:.0f} "
        f"with it ({', '.join(f'{w:.3f}' for w in walls[True])} s), {n_frames} frames; host "
        f"clock on {card}")
    tmp.cleanup()
    return card_run["launches"]


# the mesh phase: the sharded demodulator (readsb_tpu_torch/parallel) on a
# (chan=2, time=4) mesh of eight slots on the card.  Part (b) is
# BASELINE.json's 64-channel long-capture configuration: the app phase's
# 104-aircraft scene, 64 channels x 4 x 131072 samples, the gated program
# at the TPU's shape (k_per_shard=4096, k2=512)
MESH_SLOTS = 8
MESH_T = 4 * BLOCK_SAMPLES  # samples per channel: 0.218 s
MESH_S = 0.22  # seconds rendered per channel
MESH_K, MESH_K2 = 4096, 512
MESH_REF_K = 32768  # the unsharded reference's capacity per channel
MESH_USED = ("mag_uc8", "dense_scan", "extract_classify_v3")  # (b): conversion + gated step
MESH_DRYRUN_USED = ("dense_scan", "extract_syndromes", "extract_classify_v3")  # (a)


def native_frames(cols, scan_len: int) -> list[tuple[str, int]]:
    """parallel.dryrun.frames_of through the native finalizer: the same
    frames as the Scorer, fast enough for (b)'s 64 channels."""
    from readsb_tpu_torch.native import NativeFinalizer

    fr, _ = NativeFinalizer().finalize_block(cols[0], len(cols[0]), *cols[1:], scan_len=scan_len)
    return [(f.msg.hex(), f.scan_offset) for f in fr]


def check_mesh_kernels(shards, tbl: torch.Tensor, card: str) -> None:
    """#4, #5 and #2 at the mesh phase's shapes (one row of shard (0, 1)
    with its halo; K = MESH_K and 512 candidate rows) == their plain
    versions on the card."""
    buf = torch.cat([shards[0][0][0, -TRAILING_SAMPLES:], shards[0][1][0]])
    magp = demod_ops.pad_mag(buf)
    err_dense = max_abs_err(kernels.dense_scan(magp, PREAMBLE_THRESHOLD_DEFAULT),
                            kernels.dense_scan_plain(magp, PREAMBLE_THRESHOLD_DEFAULT))
    corr, pw, _, _ = demod_ops.dense_stage(buf, PREAMBLE_THRESHOLD_DEFAULT, raw_uc8=False)
    t_l = MESH_T // 4
    offs, _, _, rows = demod_ops.candidate_rows(corr, pw, k=MESH_K, l=64, scan_len=t_l)
    err_cls = max_abs_err([kernels.extract_classify_v3(rows, offs, tbl)],
                          [kernels.extract_classify_v3_plain(rows, offs, tbl)])
    err_ex = max_abs_err([kernels.extract_syndromes(rows[:512], offs[:512])],
                         [kernels.extract_syndromes_plain(rows[:512], offs[:512])])
    check(err_dense == 0 and err_cls == 0 and err_ex == 0,
          f"mesh: a kernel differs from its plain version at the mesh's shapes "
          f"(dense_scan {err_dense}, extract_classify_v3 {err_cls}, extract_syndromes {err_ex})")
    log(f"mesh: dense_scan at n={magp.shape[0]}, extract_classify_v3 at K={MESH_K} and "
        f"extract_syndromes at K=512 == their plain versions on {card}")


def mesh_phase(card: str) -> dict[str, int]:
    """(a) dryrun_multichip(8) on the card, both programs == their CPU run
    bit for bit; (b) the gated program over 64 channels x 524,288 samples,
    frames == the unsharded demod_block per channel, >= 90% of the truth,
    the step's time and device-busy share beside MultiDemodulator(64) on
    the same samples; (c) the two-process run on the card.  Returns the
    launches of (a)'s dryrun_multichip call and of (b)'s conversion and
    first step, each counted from 0 on its own."""
    from readsb_tpu_torch.ops.gate import TBL_SENTINEL
    from readsb_tpu_torch.parallel import mesh as pmesh
    from readsb_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
        mesh_slots,
        sharded_columns,
        unsharded_columns,
    )

    # (b)'s traffic first: rendered in worker processes, converted on the card
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    n = N_CHAN
    group = n // APP_GROUPS
    paths = [os.path.join(tmp.name, f"mesh{c:02d}.uc8.dat") for c in range(n)]
    jobs = [(paths[c], "uc8", MESH_S, 900 + c, 0x400000 + (c // group) * 0x10000)
            for c in range(n)]
    t0 = time.perf_counter()
    addrs = sorted({int(h, 16) for a in render_captures(jobs) for h in a})
    truth = [{t["hex"] for t in build_traffic_capture(MESH_S, APP_AIRCRAFT, seed, addr_base=b).truth
              if t["t"] * SAMPLE_RATE + 300 < MESH_T} for _, _, _, seed, b in jobs]
    words = np.stack([np.fromfile(p, dtype=np.uint16, count=MESH_T) for p in paths])
    tmp.cleanup()
    t_render = time.perf_counter() - t0
    check(len(addrs) >= 100, f"the mesh scene has {len(addrs)} aircraft, not 100")
    tbl_np = np.full(-(-len(addrs) // 128) * 128, TBL_SENTINEL, np.int32)
    tbl_np[: len(addrs)] = addrs
    tbl = torch.from_numpy(tbl_np).to(DEV)
    mesh = pmesh.make_mesh(2, 4, mesh_slots(MESH_SLOTS, "cuda"))
    gfn = pmesh.build_sharded_gated_demod(mesh, k_per_shard=MESH_K, k2=MESH_K2)

    # (a) the dry run on the card, counted on its own (its unsharded
    # reference included), the CPU run beside it
    reset_counts()
    t0 = time.perf_counter()
    out, gout = dryrun_multichip(MESH_SLOTS)
    torch.cuda.synchronize()
    t_dry = time.perf_counter() - t0
    dry_launches = read_counts()
    check_launched(dry_launches, MESH_DRYRUN_USED, "mesh (a) dryrun_multichip")
    cpu, gcpu = dryrun_multichip(MESH_SLOTS, device="cpu")
    for what, a, b in (("ungated", out, cpu), ("gated", gout, gcpu)):
        for f in a._fields:
            x = getattr(a, f)
            check(x.device.type == "cuda" and torch.equal(x.cpu(), getattr(b, f)),
                  f"mesh (a): the {what} program's {f} on the card differs from the CPU run")
    log(f"mesh (a): dryrun_multichip({MESH_SLOTS}) on {MESH_SLOTS} slots of the card in "
        f"{t_dry:.2f} s: both programs' frames == the unsharded demod_block, every field == "
        f"the CPU run's; launches {dry_launches} on {card}")

    # (b) the 64-channel gated step: its conversion and first step counted
    # from 0; the kernels at the mesh's shapes against their plain versions
    # come after the counts are read
    def step():
        return gfn(shards, tbl)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words_dev = torch.from_numpy(words).to(DEV)
    shards = pmesh.shard_stream(kernels.mag_uc8(words_dev.reshape(-1)).reshape(n, MESH_T), mesh)
    g = step()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = read_counts()
    check_launched(launches, MESH_USED, "mesh (b)'s counted step")
    row_calls = n * mesh.shape["time"]
    check(launches["mag_uc8"] == 1 and launches["dense_scan"] == row_calls
          and launches["extract_classify_v3"] == row_calls,
          f"mesh (b): expected 1 conversion and {row_calls} dense_scan and extract_classify_v3 "
          f"launches (one per row of each shard), got {launches}")
    check_mesh_kernels(shards, tbl, card)
    n_cand, n_keep = g.n_cand.cpu(), g.n_keep.cpu()
    check(int(n_cand.max()) <= MESH_K and int(n_keep.max()) <= MESH_K2,
          f"mesh (b): a shard overflows (n_cand {int(n_cand.max())} > {MESH_K} or n_keep "
          f"{int(n_keep.max())} > {MESH_K2})")
    mags = torch.cat([torch.cat(row, dim=1) for row in shards], dim=0)
    t0 = time.perf_counter()
    got_n = want_n = 0
    for ch in range(n):
        got = native_frames(sharded_columns(g, ch), MESH_T)
        want = native_frames(unsharded_columns(mags[ch], DEV, k=MESH_REF_K), MESH_T)
        check(got == want, f"mesh (b): channel {ch}: {len(got)} sharded frames != {len(want)} "
                           f"unsharded")
        got_n += len({h for h, _ in got} & truth[ch])
        want_n += len(truth[ch])
    t_check = time.perf_counter() - t0
    check(got_n >= 0.9 * want_n, f"mesh (b): {got_n} of {want_n} frames of the truth recovered")

    steps = [time_ms(step, reps=1, warm=0) for _ in range(5)]
    ms_step = statistics.median(steps)
    wall, busy, prof_rows = profile_dispatch(step, reps=1)
    samples = n * MESH_T
    raw_chunks = [words[c].tobytes() for c in range(n)]

    def make_multi():
        return pipeline.MultiDemodulator(n, blocks_per_batch=4, use_native=True, device=DEV)

    m0 = make_multi()
    run_multi(m0, raw_chunks)  # escalates the capacities once

    def make_warm():
        m = make_multi()
        m.k, m.compact_l, m.gate_k2, m.gate_keep_l = m0.k, m0.compact_l, m0.gate_k2, m0.gate_keep_l
        return m

    t_multi = host_median_s(lambda m: run_multi(m, raw_chunks), make_warm)
    log(f"mesh (b): {n} channels x {MESH_T} samples ({samples / 1e6:.1f} M magnitudes, "
        f"{len(addrs)} aircraft, rendered in {t_render:.1f} s), gated program at k_per_shard="
        f"{MESH_K}, k2={MESH_K2} on (chan=2, time=4), {MESH_SLOTS} slots of the card: n_cand per "
        f"shard {int(n_cand.min())}-{int(n_cand.max())}, n_keep {int(n_keep.min())}-"
        f"{int(n_keep.max())}, gate-dropped {int(g.pre_drop.sum())}; frames == the unsharded "
        f"demod_block on every channel (checked in {t_check:.1f} s); {got_n} of {want_n} frames "
        f"of the truth recovered ({got_n / want_n * 100:.1f}%) on {card}")
    log(f"mesh (b) step: {ms_step:.1f} ms by CUDA events (median of 5: "
        f"{', '.join(f'{x:.1f}' for x in steps)}), {samples / ms_step / 1e3:.1f} MS/s; first "
        f"step with its conversion {t_first * 1e3:.1f} ms on the host clock; launches of the "
        f"counted conversion and step: {launches}; under torch.profiler wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / wall * 100:.1f}%), {sum(r[1] for r in prof_rows)} device launches on {card}")
    log(f"mesh (b) beside it: MultiDemodulator({n}, blocks_per_batch=4) over the same samples "
        f"(upload, convert, dispatch, readback, host finalize): {t_multi * 1e3:.1f} ms = "
        f"{samples / t_multi / 1e6:.1f} MS/s (median of 3) on {card}")

    # (c) the two-process run: two ranks on the card, gloo for control
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "readsb_tpu_torch.parallel.dcn_dryrun"],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=300)
    t_dcn = time.perf_counter() - t0
    check(r.returncode == 0 and "dcn_dryrun OK" in r.stdout,
          f"mesh (c): the two-process run exited {r.returncode}: {r.stdout[-1500:]} "
          f"{r.stderr[-1500:]}")
    for line in r.stdout.splitlines():
        log(f"mesh (c): {line}")
    log(f"mesh (c): two ranks on the card with gloo for control in {t_dcn:.1f} s on {card}")
    return dry_launches, launches


# the bench phase: the four tools at reduced sizes, as their command lines
BENCH_TOOLS = (
    (bench_arena, ["4096", "5"]),
    (bench_net, ["50000"]),
    (bench_serving, ["10000"]),
    (state_scale_1m, ["100000"]),
)
BENCH_LINE_KEYS = {"metric", "value", "unit", "device", "power_limit_w"}


def captured(fn, *args):
    """(fn(*args), what it printed to standard output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def bench_line(out: str, what: str) -> dict:
    """The JSON object on the last line a tool printed, with the card's
    name and power limit."""
    line = json.loads(out.strip().splitlines()[-1])
    check(BENCH_LINE_KEYS <= set(line), f"{what}: the JSON line lacks {BENCH_LINE_KEYS - set(line)}")
    check(line["device"] == torch.cuda.get_device_name(0) and line["power_limit_w"] > 0,
          f"{what}: the JSON line names {line['device']}, {line['power_limit_w']} W")
    return line


def same_fields(got, want, what: str) -> None:
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        check((g is None) == (w is None), f"{what}: field {f} is None on one side only")
        check(w is None or (g.is_cuda and torch.equal(g.cpu(), w)),
              f"{what}: field {f} on the card differs from the CPU run")


def run_bench() -> tuple[dict, dict[str, int], float]:
    """readsb_tpu_torch.bench at full width, counted from 0: (its result,
    its launches, its seconds).  Only #1 and #2 are launched, as often."""
    reset_counts()
    t0 = time.perf_counter()
    res, out = captured(bench.run, N_CHAN)
    t_bench = time.perf_counter() - t0
    launches = read_counts()
    check_launched(launches, ("dense_scan_uc8", "extract_syndromes"), "readsb_tpu_torch.bench")
    check(launches["dense_scan_uc8"] == launches["extract_syndromes"],
          f"the bench launched #1 and #2 unequally: {launches}")
    for text in out.strip().splitlines():
        log(f"bench: {text}")
    line = bench_line(out, "readsb_tpu_torch.bench")
    check(line == res["line"] and line["metric"] == "demod_throughput"
          and line["unit"] == "Msamples/s" and line["n_chan"] == N_CHAN
          and len(line["runs_ms"]) == 5 and line["value"] > 0,
          f"the bench's line is not the demod_throughput line: {line}")
    return res, launches, t_bench


def bench_phase(card: str, bench_run: tuple) -> dict[str, int]:
    """The bench run's checks: one dispatch counted alone; its frames ==
    the CPU run and >= 90% of the truth; graft_entry.entry() == its CPU
    run, counted from 0; the four tools at reduced sizes.  Returns the
    bench run's launches."""
    res, launches, t_bench = bench_run
    reset_counts()
    res["dispatch"]()
    torch.cuda.synchronize()
    one = read_counts()
    check(one == {**{n: 0 for n in WRAPPERS}, "dense_scan_uc8": 1, "extract_syndromes": 1},
          f"one bench dispatch launched {one}")

    t0 = time.perf_counter()
    cpu = pipeline.MultiDemodulator(N_CHAN, blocks_per_batch=1, device="cpu")
    want = cpu.feed(res["chunks"])
    for c in range(N_CHAN):
        check(frame_key(res["frames"][c]) == frame_key(want[c]),
              f"bench channel {c}: card frames differ from the CPU run")
    frames = [f for fr in res["frames"] for f in fr]
    rec, tot = recovered(res["truth"], frames)
    check(rec >= 0.9 * tot, f"the bench decoded only {rec}/{tot} truth messages")
    log(f"bench: {t_bench:.1f} s (workload, build, warm feed, 5 x 10 timed dispatches, a feed) "
        f"launching only #1 and #2 ({launches['dense_scan_uc8']} each), one dispatch counted "
        f"alone = one of each; {len(frames)} frames == the CPU run per channel (CPU "
        f"{time.perf_counter() - t0:.1f} s), truth recovered {rec}/{tot}, on {card}")

    fn, args = graft_entry.entry()
    reset_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    entry_launches = read_counts()
    check_launched(entry_launches, ("dense_scan", "extract_syndromes"), "graft_entry.entry()")
    cfn, cargs = graft_entry.entry("cpu")
    same_fields(got, cfn(*cargs), "graft_entry.entry()")
    log(f"graft_entry.entry(): every field == its CPU run; launches {entry_launches}; "
        f"n_cand {got.n_cand.tolist()} at k=256")

    for mod, argv in BENCH_TOOLS:
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        _, out = captured(mod.main, argv)
        for text in out.strip().splitlines():
            log(f"{name}: {text}")
        tool_line = bench_line(out, name)
        log(f"{name} {' '.join(argv)}: {tool_line['metric']} = {tool_line['value']:.6g} "
            f"{tool_line['unit']} in {time.perf_counter() - t0:.1f} s on {card}")
    return launches


# the packaging phase: packaging/readsb-tpu-torch.service's first start on
# the card, its ExecStart with the $GROUPs of its defaults file, fed one
# uc8 receiver of the network phase's scene on stdin
ROOT = os.path.dirname(os.path.abspath(__file__))
UNIT = os.path.join(ROOT, "packaging", "readsb-tpu-torch.service")
UNIT_DEFAULTS = os.path.join(ROOT, "packaging", "readsb-tpu-torch.default")
UNIT_TIMEOUT_S = 600  # the child's limit, its build of eight libraries included


def unit_command() -> list[str]:
    """The unit's ExecStart with each $GROUP of its defaults file split on
    whitespace, as systemd expands an unbraced $VAR."""
    groups = {}
    for line in open(UNIT_DEFAULTS):
        line = line.strip()
        if line and not line.startswith("#"):
            key, value = shlex.split(line)[0].split("=", 1)
            groups[key] = value
    exec_start = next(line.strip().split("=", 1)[1] for line in open(UNIT)
                      if line.startswith("ExecStart="))
    argv = []
    for word in shlex.split(exec_start):
        argv += groups[word[1:]].split() if word.startswith("$") else [word]
    return argv


def lib_mtimes(d: str) -> dict[str, float]:
    if not os.path.isdir(d):
        return {}
    return {f: os.path.getmtime(os.path.join(d, f)) for f in os.listdir(d)}


def packaging_phase(card: str) -> dict[str, int]:
    """The unit's command line in a child process, as systemd first starts
    it: a fresh READSB_TPU_TORCH_BUILD_DIR, this interpreter for
    /usr/bin/python3, --write-json and the listeners moved to a temporary
    directory and free ports.  It exits 0, builds the seven kernels and the
    finalizer into that directory and nothing beside the repo, and its
    aircraft.json equals an in-process card App's over the same capture
    with the same options.  Returns that App's kernel launches."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_unit_")
    d = tmp.name
    capture = os.path.join(d, "net0.uc8.dat")
    scene = set(write_capture((capture, "uc8", NET_S, 700, 0x600000)))
    build_dir, out, cwd = (os.path.join(d, x) for x in ("cache", "json", "cwd"))
    os.makedirs(build_dir)
    os.makedirs(cwd)
    argv = unit_command()
    check(argv[:3] == ["/usr/bin/python3", "-m", "readsb_tpu_torch.app.main"]
          and argv.count("/dev/stdin") == 1, f"the unit runs {argv}")
    argv[0] = sys.executable
    port_opts = [i for i, w in enumerate(argv[:-1]) if w.startswith("--net-") and w.endswith("-port")]
    # an SBS port ending in 5 listens on the next four too: give it five
    port = free_port_block(sum(len(argv[i + 1].split(",")) for i in port_opts) + 4)
    for i in port_opts:
        ports = []
        for _ in argv[i + 1].split(","):
            ports.append(str(port))
            port += 5 if argv[i] == "--net-sbs-port" else 1
        argv[i + 1] = ",".join(ports)
    argv[argv.index("--write-json") + 1] = out
    env = {k: v for k, v in os.environ.items()
           if k not in ("READSB_TPU_PLATFORM", "READSB_TPU_TORCH_BUILD_DIR")}
    env.update(READSB_TPU_TORCH_BUILD_DIR=build_dir, PYTHONPATH=ROOT)
    repo_build = os.path.join(ROOT, "build", "readsb_tpu_torch")
    before = {p: lib_mtimes(p) for p in {repo_build, BUILD_DIR}}

    log(f"packaging: the unit's command line as run: {' '.join(argv[1:])} < one uc8 receiver "
        f"of {NET_S} s, cwd and READSB_TPU_TORCH_BUILD_DIR fresh temporary directories")
    t_start = time.time()
    with open(capture, "rb") as stdin:
        r = subprocess.run(argv, cwd=cwd, env=env, stdin=stdin, capture_output=True, text=True,
                           timeout=UNIT_TIMEOUT_S)
    wall = time.time() - t_start
    check(r.returncode == 0, f"the unit's command line exited {r.returncode} in {wall:.1f} s: "
                             f"{r.stderr[-1500:]}")
    got = json.load(open(os.path.join(out, "aircraft.json")))
    built = lib_mtimes(build_dir)
    want_libs = {f"lib{name}.so" for name in kernels.SOURCES} | {"libfinalizer.so"}
    check(set(built) == want_libs, f"the unit's build directory holds {sorted(built)}")
    t_fin = built.pop("libfinalizer.so") - t_start
    t_kern = max(built.values()) - t_start
    check({p: lib_mtimes(p) for p in before} == before,
          "the unit's first start changed a library beside the repo")

    opts = argv[3:]
    opts[opts.index("/dev/stdin")] = capture
    app = make_app(opts, "cuda")
    reset_counts()
    t_app = run_app(app)
    launches = read_counts()
    check_launched(launches, APP_ROUTES["multi"], "the packaging phase's in-process App")
    want = json_out.generate_aircraft_json(app.tracker, app.now_ms(), app.messages)
    got.pop("now")
    want.pop("now")
    check(got == want, f"the unit's aircraft.json differs from the in-process card App's at "
                       f"{first_diff(got, want)}")
    hexes = {a["hex"] for a in got["aircraft"]}
    check(scene <= hexes and len(with_positions(got)) >= 5,
          f"the unit's aircraft.json: {len(scene - hexes)} scene aircraft missing, "
          f"{len(with_positions(got))} with positions")
    log(f"packaging: exit 0, wall {wall:.1f} s; its first start built the {len(want_libs)} "
        f"libraries into the fresh directory: the finalizer in place {t_fin:.1f} s and the last "
        f"of the {len(built)} kernels {t_kern:.1f} s after the child started (the kernels "
        f"{t_kern - t_fin:.1f} s after the finalizer); no library beside the repo changed; "
        f"aircraft.json ({len(got['aircraft'])} aircraft, {len(with_positions(got))} with "
        f"positions) == the in-process card App's ({t_app:.2f} s, launches {launches}) apart "
        f"from now, on {card}")
    tmp.cleanup()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    card = port_tools.card_line(DEV)
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
    iq, truth = bench.render_workload(N_CHAN * DISPATCHES)
    raw, raw16 = quantize_uc8(iq), quantize_sc16(iq).view(np.uint8)
    del iq
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

    def staged_upload16():
        """first16 written into multi16's staging buffer and sent to the
        card as magnitudes (N_CHAN, BLOCK_SAMPLES), as feed() stages it."""
        multi16._copied.synchronize()
        multi16._staging_np[:] = first16
        return multi16._upload_staged()

    mags = staged_upload16()
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

    # --- end to end: readsb_tpu_torch.bench at full width, counted from 0 ---------
    # its demod_throughput line is the staged dispatch's reading; the same
    # dispatch is then timed by the same instrument under each constant
    bench_run = run_bench()
    dispatch = bench_run[0]["dispatch"]
    runs_dispatch = bench_run[0]["line"]["runs_ms"]
    wall, busy, rows = profile_dispatch(dispatch)
    log(f"profile of one dispatch: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / wall * 100:.1f}%), {sum(r[1] for r in rows)} device launches; top:")
    for ms, cnt, name in rows[:12]:
        log(f"  {ms:8.4f} ms  x{cnt:<4d} {name[:90]}")
    # the same dispatch under each constant, beside the staged one
    pipeline.FUSE_CLASSIFY = True
    try:
        runs_dispatch_fc = bench.time_dispatch(dispatch)
        wall_fc, busy_fc, rows_fc = profile_dispatch(dispatch)
    finally:
        pipeline.FUSE_CLASSIFY = False
    demod_ops.USE_FUSED = True
    try:
        check(int(dispatch().fused_overflow) <= 0, "the fused dispatch overflowed")
        runs_dispatch_fu = bench.time_dispatch(dispatch)
        wall_fu, busy_fu, rows_fu = profile_dispatch(dispatch)
    finally:
        demod_ops.USE_FUSED = False
    runs_dispatch_again = bench.time_dispatch(dispatch)
    for what, runs_d, wall_d, busy_d, rows_d in (
        ("staged", runs_dispatch, wall, busy, rows),
        ("FUSE_CLASSIFY", runs_dispatch_fc, wall_fc, busy_fc, rows_fc),
        ("USE_FUSED", runs_dispatch_fu, wall_fu, busy_fu, rows_fu),
        ("staged, again after the two", runs_dispatch_again, None, None, None),
    ):
        prof = "" if rows_d is None else (
            f"; under the profiler wall {wall_d:.3f} ms, device busy {busy_d:.3f} ms "
            f"({busy_d / wall_d * 100:.1f}%), {sum(r[1] for r in rows_d)} device launches")
        log(f"dispatch {what}: {statistics.median(runs_d):.3f} ms by events ({min(runs_d):.3f}-"
            f"{max(runs_d):.3f}; bench.time_dispatch, 5 runs of 10 back to back){prof} on {card}")
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
    log(f"feed() of {DISPATCHES} superblocks (upload, dispatch, readback, host "
        f"finalize): {t_feed * 1e3:.1f} ms = {DISPATCHES * samples / t_feed / 1e6:.1f} MS/s "
        f"aggregate (median of 3) on {card}")

    # the magnitude route: one dispatch from pre-staged magnitudes, and feed()
    def dispatch16():
        return pipeline.gated_dispatch(
            mags, overlap_mag, multi16.seg_valid, thr, multi16.mirror.tbl,
            raw_uc8=False, k=multi16.k, scan_len=multi16.scan_len, l=multi16.compact_l,
            k2=multi16.gate_k2,
            nfix=multi16.nfix, fix_df=multi16.fix_df, reset_every=multi16.block_samples,
            seg_stride=multi16.seg_stride, seg_valid=multi16.seg_valid,
            keep_l=multi16.gate_keep_l,
        )

    ms_dispatch16 = statistics.median(bench.time_dispatch(dispatch16))
    ms_tomag16 = time_ms(staged_upload16, reps=5)

    def make16():
        m2 = pipeline.MultiDemodulator(N_CHAN, fmt="sc16", blocks_per_batch=1, use_native=True)
        # the capacities the counted run escalated to, so no dispatch is redone
        m2.k, m2.compact_l = multi16.k, multi16.compact_l
        m2.gate_k2, m2.gate_keep_l = multi16.gate_k2, multi16.gate_keep_l
        return m2

    t_feed16 = host_median_s(lambda m2: m2.feed(chunks16), make16)
    t_tomag16 = host_median_s(lambda _: staged_upload16())
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
    net_launches = net_phase(card)

    # --- the aggregator on the card: device CPR, columnar drain, arena -------
    cpr_phase(card)
    agg_chunks = agg_phase(card)

    # --- the SDR sources and persistence on the card ----------------------------
    sdr_launches, sdr_app = sdr_phase(card)
    state_phase(card, sdr_app)

    # --- history on the card: traces, tiles, heatmaps, database, Prometheus --------
    history_launches = history_phase(card, agg_chunks)

    # --- the sharded mesh on the card: dry run, 64 channels, two processes ----------
    mesh_dryrun_launches, mesh_launches = mesh_phase(card)

    # --- the measurement and compile-check entry points: bench, graft_entry, tools ----------
    bench_launches = bench_phase(card, bench_run)

    # --- the packaging: the systemd unit's first start on the card -------------------
    packaging_launches = packaging_phase(card)

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
        # the launches of the app phase's three counted routes, of the
        # network phase's feeder, of the SDR phase's three routes, of the
        # history phase's --ifile App, of the mesh phase's dry run (a), of
        # its 64-channel conversion and step (b), of the bench phase's
        # readsb_tpu_torch.bench run and of the packaging phase's in-process App
        entry["app_launches"] = app_launches[entry["name"]]
        entry["net_launches"] = net_launches[entry["name"]]
        entry["sdr_launches"] = sdr_launches[entry["name"]]
        entry["history_launches"] = history_launches[entry["name"]]
        entry["mesh_dryrun_launches"] = mesh_dryrun_launches[entry["name"]]
        entry["mesh_launches"] = mesh_launches[entry["name"]]
        entry["bench_launches"] = bench_launches[entry["name"]]
        entry["packaging_launches"] = packaging_launches[entry["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
