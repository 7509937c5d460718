"""The program's own spans and counters over the traced window, for the
readers of the pipeline's host side and its dispatch (metrics/feed.*,
metrics/dispatch.* that read spans or counters).

The program records its spans (readsb_tpu_torch/spans.py) while a torch
profiler runs, as the harness's profiler does over the window of a
--trace 1 run, and counts those past its capacity as dropped; the
superblock spans carry the counters' gains inside them.  Spans are on time.perf_counter_ns(), the clock the harness times
each feed() call on before it moves the calls onto the profiler's wall
clock: each feed span lies inside its call, so the offset between the two
clocks is read off those pairs, and spans and device events share one
clock.  A program without the recorder, or a window in which it recorded
nothing, gives None, and so does every reader here.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from . import trace


@dataclasses.dataclass
class Window:
    """The window's spans on the wall clock: (name, start, end, parent, sb,
    ch, counts) with parent an index into `spans`, -1 at a feed span."""

    spans: list[tuple]
    n_sb: int  # superblock spans

    def ms_per_sb(self, name: str) -> float:
        return sum(s[2] - s[1] for s in self.spans if s[0] == name) / self.n_sb / 1e6

    def count(self, key: str) -> int:
        return sum(s[6][key] for s in self.spans if s[0] == "superblock" and s[6])

    def intervals(self, name: str) -> list[tuple[int, int]]:
        return [(s[1], s[2]) for s in self.spans if s[0] == name]

    def unspanned_pct(self) -> float:
        """Share of the time in feed spans that lies outside every leaf."""
        parents = {s[3] for s in self.spans}
        leaves = [(s[1], s[2]) for i, s in enumerate(self.spans) if i not in parents]
        feeds = self.intervals("feed")
        inside = sum(trace.length(trace.clip(trace.union(leaves), a, b)) for a, b in feeds)
        total = trace.length(feeds)
        return 100.0 * (total - inside) / total

    def innermost(self, t: int) -> str | None:
        """The path of span names open at time t, e.g. feed/superblock/finalize."""
        best = None
        for i, s in enumerate(self.spans):
            if s[1] <= t < s[2]:
                best = i  # spans begin in order, so a later open one is deeper
        if best is None:
            return None
        path = []
        while best >= 0:
            path.append(self.spans[best][0])
            best = self.spans[best][3]
        return "/".join(reversed(path))


def _recorded():
    """The program's last recording and the number of spans it dropped."""
    try:
        from readsb_tpu_torch import spans
    except ImportError:  # a program without the recorder
        return None, 0
    return spans.recorded(), spans.dropped()


def _window(ctx) -> Window | None:
    rec, dropped = _recorded()
    if dropped:
        print(f"program spans: {dropped} dropped past the recorder's capacity; "
              "the window's spans are not read", file=sys.stderr)
        return None
    if not rec or not ctx.calls:
        return None
    feeds = [i for i, s in enumerate(rec) if s.name == "feed" and s.parent == -1 and s.end]
    pairs = list(zip(ctx.calls[-len(feeds):], feeds[-len(ctx.calls):]))
    if not pairs:
        return None
    offset = max(a - rec[i].start for (a, _), i in pairs)
    if any(not (a <= rec[i].start + offset and rec[i].end + offset <= b) for (a, b), i in pairs):
        return None  # spans of other calls than the window's
    local: dict[int, int] = {}
    out: list[tuple] = []
    for i in range(pairs[0][1], len(rec)):
        s = rec[i]
        top = s.parent == -1 and s.name == "feed"
        if s.end and (top or s.parent in local):
            local[i] = len(out)
            out.append((s.name, s.start + offset, s.end + offset, local.get(s.parent, -1),
                        s.sb, s.ch, s.counts))
    n_sb = sum(s[0] == "superblock" for s in out)
    return Window(out, n_sb) if n_sb else None


def idle_gaps(ctx, w: Window, top: int = 10) -> list[list]:
    """trace.idle_gaps, with each gap inside a feed() call named by the
    innermost program span open at its middle."""
    busy = ctx.busy()
    edges = [ctx.window[0]] + [x for ab in busy for x in ab] + [ctx.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def name(mid: int) -> str:
        if any(a <= mid < b for a, b in ctx.gcs):
            return "gc"
        if any(a <= mid < b for a, b in ctx.calls):
            return w.innermost(mid) or "feed"
        return "harness"

    return [[name((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:top]]


def busy_in_superblocks_pct(ctx, w: Window) -> float | None:
    """Share of device-busy time in the window that lies inside superblock spans."""
    busy = ctx.busy()
    total = trace.length(busy)
    if not total:
        return None
    sbs = trace.union(w.intervals("superblock"))
    return 100.0 * sum(trace.length(trace.clip(sbs, a, b)) for a, b in busy) / total


def of(ctx) -> Window | None:
    """The window's program spans, once per context; the first call prints
    on standard error how much device work lies inside superblock spans and
    the longest idle gaps named by program span."""
    if not hasattr(ctx, "_program_spans"):
        w = ctx._program_spans = _window(ctx)
        if w is not None:
            share = busy_in_superblocks_pct(ctx, w)
            print(f"program spans: {len(w.spans)} in the window, {w.n_sb} superblocks; "
                  "device-busy time inside superblock spans: "
                  + ("not measured (no device events)" if share is None else f"{share:.2f}%"),
                  file=sys.stderr)
            if ctx.events:
                print("idle gaps by program span: " + json.dumps(idle_gaps(ctx, w)),
                      file=sys.stderr)
    return ctx._program_spans
