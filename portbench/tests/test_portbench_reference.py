"""The reference against itself and against the program, on the CPU."""

from __future__ import annotations

import json
import pathlib

import pytest

from portbench import compare, gen, reference

ROOT = pathlib.Path(__file__).resolve().parents[2]


def setup(name: str, fmt: str, channels: int = 2, blocks: int = 1):
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    t["pool_superblocks"] = 3
    cfg = {"channels": channels, "fmt": fmt, "block_samples": 131072, "blocks_per_batch": blocks,
           "threshold": 58, "nfix": 1, "fix_df": True, "k_per_block": 2048}
    pool, _ = gen.render(t, cfg, 2**32 + 17, "cpu")
    return cfg, pool


@pytest.mark.parametrize("name,fmt", [("busy", "uc8"), ("quiet", "sc16")])
def test_the_fast_serial_pass_is_the_plain_one(name, fmt):
    cfg, pool = setup(name, fmt, channels=1)
    schedule = [0, 1, 2, 0, 1, 2, 0]
    fast = reference.run_channel(cfg, pool[0], schedule, "cpu")
    plain = reference.run_channel(cfg, pool[0], schedule, "cpu", plain=True)
    assert fast == plain
    assert fast[1][3] > 0


@pytest.mark.parametrize("name,fmt", [("busy", "uc8"), ("quiet", "sc16")])
def test_the_reference_agrees_with_the_program(name, fmt):
    """Frames against the program's channel-batched demodulator; counters
    against its ungated one-channel path with the Python finalizer, which
    classifies every candidate on the host."""
    from readsb_tpu_torch.pipeline import Demodulator, MultiDemodulator

    cfg, pool = setup(name, fmt)
    schedule = [0, 1, 2, 0]
    multi = MultiDemodulator(2, fmt=fmt, blocks_per_batch=1, device="cpu")
    single = Demodulator(fmt=fmt, blocks_per_batch=1, use_gate=False, use_native=False,
                         device="cpu")
    got = {0: [], 1: []}
    for i in schedule:
        out = multi.feed([pool[0][i], pool[1][i]])
        single.feed(pool[0][i])
        for c in (0, 1):
            got[c].append(compare.pack_program(out[c]))
    s = single.stats
    for c in (0, 1):
        frames, stats = reference.run_channel(cfg, pool[c], schedule, "cpu")
        checks = compare.compare({c: got[c]}, {c: stats}, {c: [compare.pack_reference(f)
                                                                for f in frames]}, {c: stats})
        assert compare.passed(checks["checks"]), checks
        if c == 0:
            assert stats == [s.preambles, s.rejected_bad, s.rejected_unknown_icao, *s.accepted]
