"""Spans of the port's own host work, recorded while a torch profiler runs.

A torch.profiler window (the benchmark's `--trace 1` window, or the app's
`--write-profile`) then holds the program's spans beside the device work
it traced, and recorded() hands them over after the window.  With no
profiler running, span() returns one shared object that reads no clock,
allocates nothing and records nothing.

A recording begins at the first span opened while a profiler runs, and
ends when a span is opened, or recorded() read, while none runs: each
window whose spans are read after it is one recording.

A span records its name, its start and end on time.perf_counter_ns(),
the index of its parent (the innermost span open on the same thread when
it began; -1 at the top), `sb`, the sequence number of the superblock it
belongs to on its demodulator (the parent's when not given), and `ch`,
the channel of a per-channel span (-1 where none).  A superblock's work
lies inside its superblock span, save the uploads that a single-channel
feed makes ahead of their superblocks: those lie in feed's span and name
their superblock by `sb`.  A recording keeps at most CAPACITY spans and
counts those past it in dropped(), which the app's profile and the
benchmark's traced run report.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 20  # ~7,000 superblocks of 64 channels


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start: int  # ns, time.perf_counter_ns()
    end: int  # 0 while open
    parent: int  # index of the parent in the recording, -1 at the top
    sb: int
    ch: int
    counts: dict | None = None  # counters of the work inside, from note()


class _Off:
    """The span opened while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def note(self, **counts) -> None:
        pass


OFF = _Off()


class _Recording:
    """One column per field of Span: a long recording then holds no object
    that the garbage collector traverses, and adds no collection to the
    work it times."""

    def __init__(self):
        self.names: list[str] = []
        self.starts: list[int] = []
        self.ends: list[int] = []
        self.parents: list[int] = []
        self.sbs: list[int] = []
        self.chs: list[int] = []
        self.counts: dict[int, dict] = {}
        self.dropped = 0

    def spans(self) -> list[Span]:
        rows = zip(self.names, self.starts, self.ends, self.parents, self.sbs, self.chs)
        return [Span(*row, self.counts.get(i)) for i, row in enumerate(rows)]


_on: _Recording | None = None  # the recording that is on
_last = _Recording()  # the recording that is on, or the last one
_local = threading.local()  # .stack: (recording, index) of the open spans
_lock = threading.Lock()  # appends to a recording from several threads


def recorded() -> list[Span]:
    """The spans of the recording that is on, or of the last one; read
    while no profiler runs, it ends that recording."""
    global _on
    if not _profiler._is_profiler_enabled:
        _on = None
    return _last.spans()


def dropped() -> int:
    """Spans past CAPACITY in the recording that is on, or the last one."""
    return _last.dropped


class _Open:
    __slots__ = ("rec", "name", "sb", "ch", "index")

    def __init__(self, rec: _Recording, name: str, sb: int, ch: int):
        self.rec, self.name, self.sb, self.ch, self.index = rec, name, sb, ch, -1

    def __enter__(self):
        rec = self.rec
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1][1] if stack and stack[-1][0] is rec else -1
        sb = self.sb
        if sb < 0 and parent >= 0:
            sb = rec.sbs[parent]
        with _lock:
            if len(rec.names) >= CAPACITY:
                rec.dropped += 1
                return self
            self.index = len(rec.names)
            rec.names.append(self.name)
            rec.starts.append(0)
            rec.ends.append(0)
            rec.parents.append(parent)
            rec.sbs.append(sb)
            rec.chs.append(self.ch)
        stack.append((rec, self.index))
        rec.starts[self.index] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            self.rec.ends[self.index] = time.perf_counter_ns()
            _local.stack.pop()
        return None

    def note(self, **counts) -> None:
        if self.index >= 0:
            self.rec.counts[self.index] = counts


def span(name: str, sb: int = -1, ch: int = -1):
    """A context manager that records `name` while a torch profiler runs."""
    global _on, _last
    # the flag torch keeps for such fast checks, set while any profiler runs
    if not _profiler._is_profiler_enabled:
        _on = None
        return OFF
    if _on is None:
        _on = _last = _Recording()
    return _Open(_on, name, sb, ch)


def add_to_chrome_trace(path: str, recorded: list[Span], dropped: int = 0) -> None:
    """Append `recorded` to the chrome trace that torch.profiler exported to
    `path`, as complete events on that file's time base (us after its
    baseTimeNanoseconds, or after the epoch where it has none), with sb, ch
    and a superblock's counts in their args; and a metadata event
    `program_spans` with the number recorded and the number dropped."""
    with open(path) as f:
        doc = json.load(f)
    shift = time.time_ns() - time.perf_counter_ns() - doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "readsb_tpu_torch spans"}})
    events.append({"ph": "M", "name": "program_spans", "pid": pid, "tid": 0,
                   "args": {"recorded": len(recorded), "dropped": dropped,
                            "capacity": CAPACITY}})
    for s in recorded:
        if not s.end:
            continue
        args = {k: v for k, v in (("sb", s.sb), ("ch", s.ch)) if v >= 0}
        events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": 0,
                       "ts": (s.start + shift) / 1e3, "dur": (s.end - s.start) / 1e3,
                       "args": {**args, **(s.counts or {})}})
    with open(path, "w") as f:
        json.dump(doc, f)
