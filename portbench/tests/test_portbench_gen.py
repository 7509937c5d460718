"""The traffic generator: deterministic in the seed, the recipe's message
counts and CRCs, and frames that readsb's rules decode."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from portbench import crc24, gen, reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
CFG = {"channels": 3, "fmt": "uc8", "block_samples": 131072, "blocks_per_batch": 1,
       "threshold": 58, "nfix": 1, "fix_df": True}


def traffic(name: str, pool: int = 2) -> dict:
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    t["pool_superblocks"] = pool
    return t


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_the_same_seed_gives_the_same_bytes(fmt):
    cfg = {**CFG, "fmt": fmt}
    a, na = gen.render(traffic("busy"), cfg, 2**33 + 5, "cpu")
    b, nb = gen.render(traffic("busy"), cfg, 2**33 + 5, "cpu")
    c, _ = gen.render(traffic("busy"), cfg, 2**33 + 6, "cpu")
    assert a == b and list(na) == list(nb)
    assert a != c
    assert len(a) == 3 and len(a[0]) == 2
    assert {len(x) for ch in a for x in ch} == {131072 * (2 if fmt == "uc8" else 4)}


@pytest.mark.parametrize("name,per_s", [("busy", (1600, 2100)), ("quiet", (60, 110))])
def test_message_counts_follow_the_recipe(name, per_s):
    t = traffic(name)
    duration = 4.0
    s = gen.schedule(t, 16, duration, 11)
    rate = np.bincount(s["chan"], minlength=16) / duration
    assert per_s[0] < rate.mean() < per_s[1], rate.mean()
    ac = s["aircraft"].reshape(-1)
    assert len(np.unique(ac[s["chan"] == 0])) == t["aircraft_per_receiver"]
    assert s["amp"].min() >= t["amplitude"]["base"] - 1e-6
    # neighbouring receivers share the fleet's indexes stride apart
    first = {c: set(ac[s["chan"] == c].tolist()) for c in (0, 1)}
    shared = len(first[0] & first[1])
    assert shared == max(0, t["aircraft_per_receiver"] - t["fleet_stride"])


def test_every_message_carries_its_crc():
    s = gen.schedule(traffic("quiet"), 4, 2.0, 3)
    bits = gen.encode(s)
    addr = gen.fleet(s["aircraft"])["addr"]
    for k in range(len(bits)):
        long_ = s["kind"][k] >= gen.KINDS.index("pos_even")
        n = 112 if long_ else 56
        msg = np.packbits(bits[k, :n]).tobytes()
        want = int(addr[k]) if s["kind"][k] == gen.KINDS.index("df4") else 0
        assert crc24.checksum(msg, n) == want
        df = msg[0] >> 3
        assert df == {0: 11, 1: 4}.get(int(s["kind"][k]), 17)


def test_the_reference_decodes_what_was_sent():
    """Every DF11 and DF17 of a quiet pool comes out of the reference
    once its address is known (the first messages teach the filter)."""
    t = traffic("quiet")
    pool, counts = gen.render(t, CFG, 21, "cpu")
    frames, stats = reference.run_channel(CFG, pool[0], [0, 1], "cpu")
    got = [f for sb in frames for f in sb]
    assert stats[3] > 0.8 * counts[0]
    assert {f[0][0] >> 3 for f in got} <= {4, 11, 17}
