"""The span recorder (readsb_tpu_torch/spans.py) and the demodulators'
counters, on the CPU: with no profiler running it records nothing and
reads no clock; under a torch profiler the spans of each superblock nest
and share its sequence number, with one finalize and one drops span per
channel; frames and stats are the same either way; the counters count
what the dispatches did.
"""

import contextlib
import gc
import sys
import threading
import time

import pytest
import torch

from readsb_tpu_torch import spans
from readsb_tpu_torch.pipeline import BYTES_PER_SAMPLE, Demodulator, MultiDemodulator
from readsb_tpu_torch.synth import build_standard_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

N_CHAN = 3
N_SB = 3


@contextlib.contextmanager
def _profiled():
    """A torch profiler of host ops: the spans opened inside are recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        yield


@pytest.fixture(scope="module")
def streams():
    """N_CHAN receivers of N_SB superblocks each, as uc8 and as sc16."""
    caps = [build_standard_capture(0.17, 3, 40 + c) for c in range(N_CHAN)]
    return {"uc8": [c.render_uc8().tobytes() for c in caps],
            "sc16": [c.render_sc16().tobytes() for c in caps]}


def _feed(fmt, raws, record, **kw):
    m = MultiDemodulator(N_CHAN, fmt=fmt, blocks_per_batch=1, device="cpu", **kw)
    step = m.seg_valid * BYTES_PER_SAMPLE[fmt]
    with _profiled() if record else contextlib.nullcontext():
        frames = [m.feed([r[i * step:(i + 1) * step] for r in raws]) for i in range(N_SB)]
    return m, frames, spans.recorded() if record else None


def _stats(m):
    return [vars(m.channel_stats(c)) for c in range(m.n_chan)]


def test_off_records_nothing_and_reads_no_clock(streams, monkeypatch):
    with _profiled():
        with spans.span("last"):
            pass
    assert [s.name for s in spans.recorded()] == ["last"]

    def no_clock():
        raise AssertionError("a clock was read with recording off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert spans.span("feed") is spans.span("finalize", ch=1) is spans.OFF
    with spans.span("superblock", sb=0) as s:
        s.note(candidates=1)
    _feed("sc16", streams["sc16"], record=False)
    assert [s.name for s in spans.recorded()] == ["last"] and spans.dropped() == 0


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_on_spans_nest_per_superblock(streams, fmt):
    m, _, rec = _feed(fmt, streams[fmt], record=True)
    assert all(s.end >= s.start > 0 for s in rec)
    for s in rec:
        if s.parent >= 0:
            p = rec[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            if p.name != "feed":
                assert s.sb == p.sb, (s, p)
    feeds = [s for s in rec if s.name == "feed"]
    assert len(feeds) == N_SB and all(s.parent == -1 for s in feeds)
    sbs = [s for s in rec if s.name == "superblock"]
    assert [s.sb for s in sbs] == list(range(N_SB)) == list(range(m.superblocks))
    for sb in range(N_SB):
        for name in ("finalize", "drops"):
            chans = sorted(s.ch for s in rec if s.name == name and s.sb == sb)
            assert chans == list(range(N_CHAN)), (name, sb)
        inside = {s.name for s in rec if s.sb == sb}
        assert {"stage", "upload", "upload.copy", "upload.h2d", "upload.free", "dispatch",
                "sync", "fetch", "icao"} <= inside
    assert ("upload.convert" in {s.name for s in rec}) == (fmt == "sc16")
    assert sum(s.counts["candidates"] for s in sbs) == m.candidates
    assert sum(s.counts["kept"] for s in sbs) == m.kept


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_frames_and_stats_are_the_same_on_and_off(streams, fmt):
    m_off, frames_off, _ = _feed(fmt, streams[fmt], record=False)
    m_on, frames_on, _ = _feed(fmt, streams[fmt], record=True)
    assert frames_on == frames_off
    assert sum(len(f) for sb in frames_on for f in sb) > 0
    assert _stats(m_on) == _stats(m_off)
    assert (m_on.superblocks, m_on.candidates, m_on.kept) == \
        (m_off.superblocks, m_off.candidates, m_off.kept)


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_counters_count_the_dispatches(streams, fmt):
    m, frames, _ = _feed(fmt, streams[fmt], record=False)
    assert m.superblocks == N_SB
    assert 0 < m.kept <= m.candidates
    assert m.redispatches == 0
    small, frames_small, rec = _feed(fmt, streams[fmt], record=True, k_per_block=64)
    assert small.redispatches >= 1
    assert frames_small == frames and _stats(small) == _stats(m)
    assert (small.candidates, small.kept) == (m.candidates, m.kept)
    sbs = [s for s in rec if s.name == "superblock"]
    assert sum(s.counts["redispatches"] for s in sbs) == small.redispatches
    syncs = sum(s.name == "sync" for s in rec)
    assert syncs == N_SB + small.redispatches  # a redone dispatch syncs again


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
@pytest.mark.parametrize("at_once", [False, True])
def test_a_single_channel_demodulator_records_upload_sync_and_fetch(streams, fmt, at_once):
    """Fed one superblock at a time, every upload lies in its superblock;
    fed the whole stream at once, the gated magnitude route uploads each
    superblock ahead of it, in feed's span, naming it by sb."""
    d = Demodulator(fmt=fmt, blocks_per_batch=1, device="cpu")
    raw = streams[fmt][0]
    step = d.super_samples * BYTES_PER_SAMPLE[fmt]
    with _profiled():
        if at_once:
            d.feed(raw)
        else:
            for i in range(0, len(raw), step):
                d.feed(raw[i:i + step])
    rec = spans.recorded()
    names = {s.name for s in rec}
    assert {"feed", "superblock", "upload", "sync", "fetch", "finalize"} <= names
    sbs = [s.sb for s in rec if s.name == "superblock"]
    assert sbs == list(range(d.superblocks)) and d.superblocks >= 2
    assert 0 < d.kept <= d.candidates and d.redispatches == 0
    ahead = at_once and fmt == "sc16"
    for s in rec:
        if s.name in ("feed", "stage", "superblock") or s.parent < 0:
            continue
        p = rec[s.parent]
        assert p.start <= s.start and s.end <= p.end and s.sb in sbs, (s, p)
        if s.name == "upload" and ahead:
            assert p.name == "feed", (s, p)
        elif p.name == "feed":
            raise AssertionError(f"{s} is outside its superblock")
        else:
            assert s.sb == p.sb, (s, p)
    uploads = [s.sb for s in rec if s.name == "upload"]
    assert sorted(uploads) == sbs


def test_recording_follows_a_torch_profiler():
    with spans.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("inside", sb=4):
            pass
    with spans.span("after"):
        pass
    assert [(s.name, s.sb) for s in spans.recorded()] == [("inside", 4)]
    assert spans.span("after") is spans.OFF


def test_spans_past_the_capacity_are_dropped(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)
    with _profiled():
        for _ in range(5):
            with spans.span("x"):
                pass
    assert len(spans.recorded()) == 3 and spans.dropped() == 2
    with _profiled():
        with spans.span("y"):
            pass
    assert [s.name for s in spans.recorded()] == ["y"] and spans.dropped() == 0


def test_each_window_read_after_it_is_a_recording():
    """Two profiler windows with no span between them: reading the first
    window's spans ends its recording, so the second begins anew."""
    with _profiled():
        with spans.span("first"):
            pass
    assert [s.name for s in spans.recorded()] == ["first"]
    with _profiled():
        with spans.span("second"):
            pass
        assert [s.name for s in spans.recorded()] == ["second"]  # read inside: still on
        with spans.span("third"):
            pass
    assert [s.name for s in spans.recorded()] == ["second", "third"]


def test_a_recording_adds_nothing_the_collector_tracks():
    """Spans are kept in columns of ints and strings, so a long recording
    does not drive the garbage collector (whose pauses the traced run times)."""
    gc.disable()
    try:
        with _profiled():
            before = gc.get_count()[0]
            for i in range(5000):
                with spans.span("outer", sb=i) as s:
                    with spans.span("inner", ch=1):
                        pass
                    if i % 100 == 0:  # as a superblock's counts, once per ~150 spans
                        s.note(candidates=i)
            grown = gc.get_count()[0] - before
        assert len(spans.recorded()) == 10000
    finally:
        gc.enable()
    assert grown < 100, grown


def test_threads_nest_their_own_spans():
    """Eight threads, more than the cores given to torch here, open spans in
    one recording at a short switch interval: each child's parent is its
    own thread's outer span."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for _ in range(200):
                with spans.span("outer", sb=t):
                    with spans.span("inner"):
                        pass

        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        with _profiled():
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    rec = spans.recorded()
    assert len(rec) == 8 * 200 * 2
    for s in rec:
        if s.name == "inner":
            p = rec[s.parent]
            assert p.name == "outer" and p.sb == s.sb and p.start <= s.start <= s.end <= p.end
