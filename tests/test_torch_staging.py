"""MultiDemodulator's staging on the CPU: each superblock's IQ is written
once into one reused host buffer and goes to the device from it.  Frames
and per-channel stats equal readsb_tpu's MultiDemodulator over the same
bytes; the buffer stays the same one; `pinned` and the superblock spans
count every superblock staged so, the flushed one too; nothing that
outlives a call aliases the buffer or the caller's bytes.  The card's half
(a pinned buffer, the asynchronous copy) is in tests/test_torch_cuda.py.
"""

import pytest
import torch

from readsb_tpu.pipeline import MultiDemodulator as JaxMultiDemodulator
from readsb_tpu_torch import spans
from readsb_tpu_torch.pipeline import BYTES_PER_SAMPLE, MultiDemodulator
from readsb_tpu_torch.synth import build_standard_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

N_CHAN = 3
N_SB = 3  # whole superblocks per channel; a partial one is left to flush()


@pytest.fixture(scope="module")
def streams():
    caps = [build_standard_capture(0.17, 3, 50 + c) for c in range(N_CHAN)]
    return {"uc8": [c.render_uc8().tobytes() for c in caps],
            "sc16": [c.render_sc16().tobytes() for c in caps]}


def _key(frames):
    return [(f.msg, f.timestamp, f.phase, f.score, f.signal_power, f.scan_offset) for f in frames]


@pytest.fixture(scope="module")
def reference(streams):
    """readsb_tpu's MultiDemodulator over the same bytes, fed at once and
    flushed: frame keys and stats per channel, per format."""
    out = {}
    for fmt, raws in streams.items():
        j = JaxMultiDemodulator(N_CHAN, fmt=fmt, blocks_per_batch=1, use_native=False)
        frames = j.feed(raws)
        for c, got in enumerate(j.flush()):
            frames[c].extend(got)
        out[fmt] = ([_key(f) for f in frames], [vars(j.channel_stats(c)) for c in range(N_CHAN)])
    return out


def _demod(fmt):
    return MultiDemodulator(N_CHAN, fmt=fmt, blocks_per_batch=1, use_native=False, device="cpu")


def _stats(m):
    return [vars(m.channel_stats(c)) for c in range(m.n_chan)]


def _shares_memory(t: torch.Tensor, buf: torch.Tensor) -> bool:
    a, n = t.untyped_storage().data_ptr(), t.untyped_storage().nbytes()
    b, k = buf.untyped_storage().data_ptr(), buf.untyped_storage().nbytes()
    return a < b + k and b < a + n


@pytest.mark.parametrize("at_once", [False, True], ids=["per_superblock", "at_once"])
@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_staged_feed_equals_fresh_copies(streams, reference, fmt, at_once):
    raws = streams[fmt]
    m = _demod(fmt)
    step = m.seg_valid * BYTES_PER_SAMPLE[fmt]
    ptr = m._staging.data_ptr()
    calls = [raws] if at_once else [[r[i * step:(i + 1) * step] for r in raws]
                                    for i in range(N_SB)] + [[r[N_SB * step:] for r in raws]]
    out = [[] for _ in range(N_CHAN)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for call in calls:
            for c, got in enumerate(m.feed(call)):
                out[c].extend(got)
            assert m._staging.data_ptr() == ptr
            assert not _shares_memory(m._overlap_words, m._staging)
            assert not _shares_memory(m._overlap_dev, m._staging)
        assert m.pinned == m.superblocks == N_SB
        for c, got in enumerate(m.flush()):
            out[c].extend(got)
    assert m.superblocks == m.pinned == N_SB + 1
    assert m._staging.data_ptr() == ptr
    sbs = [s for s in spans.recorded() if s.name == "superblock"]
    assert [s.counts["pinned"] for s in sbs] == [1] * (N_SB + 1)

    ref_frames, ref_stats = reference[fmt]
    assert sum(map(len, out)) > 0
    assert [_key(f) for f in out] == ref_frames
    assert _stats(m) == ref_stats


@pytest.mark.parametrize("first", [0.5, 1.5], ids=["half", "one_and_a_half"])
@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_bytes_changed_after_feed_change_nothing(streams, reference, fmt, first):
    """A caller's bytearray, written over once feed() has returned, leaves
    the superblocks still to come as they were: the demodulator keeps the
    part it has not staged yet as bytes of its own."""
    raws = streams[fmt]
    m = _demod(fmt)
    cut = int(first * m.seg_valid) * BYTES_PER_SAMPLE[fmt]
    heads = [bytearray(r[:cut]) for r in raws]
    out = [[] for _ in range(N_CHAN)]
    for c, got in enumerate(m.feed(heads)):
        out[c].extend(got)
    for h in heads:
        h[:] = bytes(len(h))  # the caller reuses its buffers
    for c, got in enumerate(m.feed([r[cut:] for r in raws])):
        out[c].extend(got)
    for c, got in enumerate(m.flush()):
        out[c].extend(got)
    ref_frames, ref_stats = reference[fmt]
    assert sum(map(len, out)) > 0
    assert [_key(f) for f in out] == ref_frames
    assert _stats(m) == ref_stats
