"""The readers of the program's spans and counters: a traced run that
records them reads every one, a run that records none (as a program
without the recorder) reads none and does not fail, and idle gaps inside
feed() take the name of the innermost program span.

    python -m pytest -q portbench/tests

The card test at the end runs only where a CUDA device is present.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import pytest
import torch

from portbench import harness, programspans, trace
from portbench.tests.test_portbench_harness import SEED, tiny
from readsb_tpu_torch import spans

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"]
                if m["source"] in ("program_span", "program_counter")]


def test_eleven_readers_of_spans_and_counters():
    assert len(SPAN_METRICS) == 11
    for name in SPAN_METRICS:
        assert callable(harness.load_reader(name))


def _traced(cell):
    return harness.run(cell, SEED, 1.0, True, "cpu", time.perf_counter())


def _profiled():
    """A torch profiler of host ops, under which the program records spans."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("config", ["ch64_sc16_nodf", "ch64_uc8_nodf"])
def test_a_traced_run_reads_every_span_metric(config):
    """On the CPU the harness starts no profiler, so one runs around the
    whole run here; the readers then take the window's spans alone."""
    with _profiled():
        r = _traced(tiny(config))
    assert r["correct"], r["checks"]
    got = r["metrics"]
    assert set(SPAN_METRICS) <= set(got), sorted(set(SPAN_METRICS) - set(got))
    assert 0.0 <= got["feed.unspanned_pct"]["value"] <= 100.0
    assert 0.0 < got["dispatch.kept_pct"]["value"] <= 100.0
    assert got["dispatch.redo_per_sb"]["value"] == 0.0
    for name in SPAN_METRICS:
        assert got[name]["value"] >= 0.0, name


def test_a_run_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "readsb_tpu_torch.spans", None)  # import fails
    r = _traced(tiny())
    assert r["correct"] and "python.gc_ms_per_s" in r["metrics"]
    assert not set(SPAN_METRICS) & set(r["metrics"])


def test_spans_of_other_calls_are_not_read():
    """Spans left from an earlier recording lie outside the window's calls."""
    with _profiled():
        _traced(tiny())
    r = _traced(tiny())  # no profiler: the last recording is the one above
    assert not set(SPAN_METRICS) & set(r["metrics"])


def test_a_recording_that_dropped_spans_is_not_read(monkeypatch, capsys):
    """Past the recorder's capacity the window's spans are incomplete: the
    readers read none, and the run says why on standard error."""
    monkeypatch.setattr(spans, "CAPACITY", 50)
    with _profiled():
        r = _traced(tiny())
    assert r["correct"] and not set(SPAN_METRICS) & set(r["metrics"])
    assert f"{spans.dropped()} dropped past the recorder's capacity" in capsys.readouterr().err
    assert spans.dropped() > 0


def _span(name, a, b, parent, sb=-1, ch=-1, counts=None):
    return (name, a, b, parent, sb, ch, counts)


def test_idle_gaps_take_the_innermost_span():
    """Device busy 0-10, 100-110 and 300-305; the gap 10-100 lies in a
    finalize span inside feed, 110-300 in feed's own time, 305-400 outside
    every call."""
    ms = 1_000_000
    ctx = trace.Context({}, "cpu", (0, 400 * ms), [(0, 299 * ms)], [], [
        ("k", 0, 10 * ms, "kernel"), ("k", 100 * ms, 110 * ms, "kernel"),
        ("k", 300 * ms, 305 * ms, "kernel")], lambda: [])
    w = programspans.Window([
        _span("feed", 1 * ms, 298 * ms, -1),
        _span("superblock", 2 * ms, 100 * ms, 0, sb=0,
              counts={"candidates": 10, "kept": 1, "redispatches": 0}),
        _span("finalize", 5 * ms, 95 * ms, 1, sb=0, ch=0),
    ], 1)
    gaps = programspans.idle_gaps(ctx, w)
    assert [g[0] for g in gaps] == ["feed", "harness", "feed/superblock/finalize"]
    assert gaps[2][1] == pytest.approx(0.09)
    assert programspans.busy_in_superblocks_pct(ctx, w) == pytest.approx(100 * 8 / 25)
    assert w.unspanned_pct() == pytest.approx(100 * (297 - 90) / 297)
    assert w.count("candidates") == 10 and w.ms_per_sb("finalize") == pytest.approx(90)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only on the card")
    return "cuda:0"


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_program_spans(card, capsys):
    """The harness's profiler turns the recorder on; nearly all device work
    lies inside superblock spans, so spans and device events share a clock."""
    cell = harness.load_cell("sc16nodf_quiet")
    cell.cfg.update(warmup_superblocks=2)
    cell.traffic["pool_superblocks"] = 2
    r = harness.run(cell, SEED, 2.0, True, card, time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(SPAN_METRICS) <= set(r["metrics"])
    assert r["metrics"]["feed.unspanned_pct"]["value"] <= 3.0
    err = capsys.readouterr().err
    share = float(err.split("device-busy time inside superblock spans: ")[1].split("%")[0])
    assert share >= 99.0
    named = json.loads(err.split("idle gaps by program span: ")[1].splitlines()[0])
    assert all(name != "feed" for name, _ in named)
