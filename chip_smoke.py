"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from readsb_tpu_torch/csrc with nvcc,
drives the main path (raw UC8 IQ -> MultiDemodulator(64) -> frames) at
full width, holds every kernel against its plain PyTorch version on the
card, holds the card's frames and stats against the port's own CPU run,
and prints per-kernel times and bounds.  The last line is
{"ok": true, "device": {...}}; any failure exits non-zero before it.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from readsb_tpu_torch import pipeline
from readsb_tpu_torch.constants import BLOCK_SAMPLES, PREAMBLE_THRESHOLD_DEFAULT
from readsb_tpu_torch.ops import demod as demod_ops
from readsb_tpu_torch.ops import kernels
from readsb_tpu_torch.ops.convert import uc8_lut_np
from readsb_tpu_torch.synth import build_standard_capture

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


def time_ms(fn, reps: int = 15, warm: int = 2) -> float:
    """Median over `reps` launches, each timed with CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(xs, ys) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in zip(xs, ys))


def frame_key(frames):
    return [(f.msg.hex(), f.timestamp) for f in frames]


def stats_key(s):
    return (s.preambles, s.rejected_bad, s.rejected_unknown_icao, list(s.accepted))


def workload(n_blocks: int, seed: int = 3) -> tuple[np.ndarray, list[dict]]:
    """bench.py's traffic: 8 aircraft, seed 3, as UC8 bytes of n_blocks blocks."""
    total = n_blocks * BLOCK_SAMPLES
    cap = build_standard_capture(duration_s=total / 2.4e6 + 0.1, n_aircraft=8, seed=seed)
    return cap.render_uc8()[: total * 2], cap.truth


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # --- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build(force=True)
    log(f"built {', '.join(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line:
                log(f"  {name}: {line.strip()}")

    # --- workload -------------------------------------------------------------
    t0 = time.perf_counter()
    raw, truth = workload(N_CHAN * DISPATCHES)
    per_chan = DISPATCHES * BLOCK_SAMPLES * 2
    chunks = [bytes(raw[c * per_chan : (c + 1) * per_chan]) for c in range(N_CHAN)]
    log(f"workload: {N_CHAN} channels x {DISPATCHES} x {BLOCK_SAMPLES} UC8 samples "
        f"({len(truth)} truth frames) in {time.perf_counter() - t0:.1f} s")

    # --- main path on the card, counted ---------------------------------------
    multi = pipeline.MultiDemodulator(N_CHAN, blocks_per_batch=1, use_native=True)
    kernels.dense_scan_uc8.launches = 0
    kernels.extract_syndromes.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = multi.feed(chunks)
    tail = multi.flush()
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = {
        "dense_scan_uc8": kernels.dense_scan_uc8.launches,
        "extract_syndromes": kernels.extract_syndromes.launches,
    }
    log(f"main path: MultiDemodulator({N_CHAN}) k={multi.k} k2={multi.gate_k2} "
        f"launches={launches} in {t_main:.3f} s (first run, builds included)")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    card_frames = [g + t for g, t in zip(got, tail)]
    n_frames = sum(len(f) for f in card_frames)
    check(n_frames > 0, "main path decoded no frames")

    # --- the port's CPU run of the same capture -------------------------------
    t0 = time.perf_counter()
    ref = pipeline.MultiDemodulator(N_CHAN, blocks_per_batch=1, use_native=True, device="cpu")
    rgot = ref.feed(chunks)
    rtail = ref.flush()
    log(f"CPU reference run in {time.perf_counter() - t0:.1f} s")
    for c in range(N_CHAN):
        check(frame_key(card_frames[c]) == frame_key(rgot[c] + rtail[c]),
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

    # --- kernels against their plain versions at the main path's shapes -------
    first = np.stack([np.frombuffer(ch, dtype="<u2", count=BLOCK_SAMPLES) for ch in chunks])
    words = torch.from_numpy(first.copy()).to(DEV)
    overlap = torch.full((N_CHAN, 326), pipeline.SILENT_WORD, dtype=torch.uint16, device=DEV)
    buf = pipeline.multi_raw_buffer(words, overlap, multi.seg_stride, multi.seg_valid)
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

    # every (I, Q) pair through the dense scan: mag^2 from prefix-sum steps
    ii, qq = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    pairs = torch.from_numpy((ii.ravel() | (qq.ravel() << 8)).astype(np.uint16)).to(DEV)
    _, _, hi, lo = kernels.dense_scan_uc8(pairs, thr)
    sq = ((prefix_steps(hi) << 16) + prefix_steps(lo)).cpu().numpy()
    lut = uc8_lut_np().astype(np.int64)[ii.ravel() * 256 + qq.ravel()]
    check(bool((sq == lut * lut).all()), "in-kernel magnitude differs from the LUT")
    log("magnitude: all 65536 (I, Q) pairs equal the LUT")

    # --- times ----------------------------------------------------------------
    ms_dense = time_ms(lambda: kernels.dense_scan_uc8(bufp, thr))
    plain_dense = time_ms(lambda: kernels.dense_scan_uc8_plain(bufp, thr), reps=10)
    ms_ex = time_ms(lambda: kernels.extract_syndromes(rows, offsets))
    plain_ex = time_ms(lambda: kernels.extract_syndromes_plain(rows, offsets), reps=10)
    k_rows = rows.shape[0]
    dense_bytes = n * 2 + n * 1 + 5 * (n // 32) * 4 + 2 * n * 4
    ex_bytes = k_rows * (128 * 4 + 4 + 128 * 4)

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / CORE_OPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    b_dense, by_dense = bound(dense_bytes, n * DENSE_OPS_PER_SAMPLE)
    b_ex, by_ex = bound(ex_bytes, k_rows * EXTRACT_OPS_PER_CAND)
    for name, ms, pms, b, nbytes in (
        ("dense_scan_uc8", ms_dense, plain_dense, b_dense, dense_bytes),
        ("extract_syndromes", ms_ex, plain_ex, b_ex, ex_bytes),
    ):
        log(f"{name}: {ms:.4f} ms (plain {pms:.3f} ms, bound {b:.4f} ms for "
            f"{nbytes / 1e6:.1f} MB, {b / ms * 100:.1f}% of the bound) on {card}")

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

    print(json.dumps({"kernels": [
        {
            "name": "dense_scan_uc8", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/dense_scan_uc8.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:400",
            "launches": launches["dense_scan_uc8"], "max_abs_err": err_dense,
            "ms": ms_dense, "plain_ms": plain_dense, "bound_ms": b_dense,
            "bound_by": by_dense, "library_ms": None,
        },
        {
            "name": "extract_syndromes", "route": "cuda",
            "source": "readsb_tpu_torch/csrc/extract_syndromes.cu",
            "replaces": "readsb_tpu/ops/pallas_kernels.py:579",
            "launches": launches["extract_syndromes"], "max_abs_err": err_ex,
            "ms": ms_ex, "plain_ms": plain_ex, "bound_ms": b_ex,
            "bound_by": by_ex, "library_ms": None,
        },
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
