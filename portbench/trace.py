"""Reduction of a torch.profiler trace of the window to device intervals,
and the context that per-layer metric readers read.

The profiler records CUDA activity only (kernels, memsets, copies), with
timestamps on the host's wall clock in ns; the harness records its own
boundaries (each feed() call, each garbage collection) on the same clock.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

KINDS = (("Memcpy HtoD", "h2d"), ("Memcpy DtoH", "d2h"), ("Memcpy DtoD", "d2d"),
         ("Memcpy", "copy"), ("Memset", "memset"))


def kind_of(name: str) -> str:
    for prefix, kind in KINDS:
        if name.startswith(prefix):
            return kind
    return "kernel"


def device_events(prof) -> list[tuple[str, int, int, str]]:
    """(name, start ns, end ns, kind) of every device activity in the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns(), kind_of(e.name())))
    out.sort(key=lambda x: x[1])
    return out


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, merged (start, end) intervals."""
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def length(intervals) -> int:
    return sum(b - a for a, b in intervals)


class GcClock:
    """Intervals (time.perf_counter_ns) of the interpreter's collections,
    from gc.callbacks, while installed."""

    def __init__(self):
        self.intervals: list[tuple[int, int]] = []
        self._start = 0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter_ns()
        else:
            self.intervals.append((self._start, time.perf_counter_ns()))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader reads: the traced window, its feed()
    calls and collections on the host's clock, and the device's events."""

    cfg: dict
    device_name: str
    window: tuple[int, int]  # ns, host wall clock
    calls: list[tuple[int, int]]  # each feed() call in the window, ns
    gcs: list[tuple[int, int]]
    events: list[tuple[str, int, int, str]]
    candidates: Callable[[], list[int]]  # candidates per call, all channels

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self, kinds=None) -> list[tuple[int, int]]:
        """Merged device intervals inside the window (all kinds, or those named)."""
        ev = [(a, b) for _, a, b, k in self.events if kinds is None or k in kinds]
        return clip(union(ev), *self.window)

    def kernels(self, names) -> list[tuple[str, int, int, str]]:
        """Kernel events whose name holds one of `names`."""
        return [e for e in self.events if e[3] == "kernel" and any(n in e[0] for n in names)]


def idle_gaps(ctx: Context, top: int = 10) -> list[list]:
    """The longest spans in which the device ran nothing, each named by
    what the harness was doing at its middle: gc, feed or harness."""
    busy = ctx.busy()
    edges = [ctx.window[0]] + [x for ab in busy for x in ab] + [ctx.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def name(mid: int) -> str:
        if any(a <= mid < b for a, b in ctx.gcs):
            return "gc"
        if any(a <= mid < b for a, b in ctx.calls):
            return "feed"
        return "harness"

    return [[name((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:top]]


def device_ops(ctx: Context, top: int = 10) -> list[list]:
    """The device operations that took most time in the window, by name."""
    total: dict[str, int] = {}
    for name, a, b, _ in ctx.events:
        total[name] = total.get(name, 0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]
