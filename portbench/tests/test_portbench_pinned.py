"""The reader of the program's counter `pinned` (metrics/feed.pinned_pct.py):
100.0 on a recording whose superblock spans note the counter, and None,
with the metric left out of the result, on one whose spans do not (as a
program without the counter records them).

    python -m pytest -q portbench/tests/test_portbench_pinned.py
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.tests.test_portbench_harness import SEED, tiny
from readsb_tpu_torch import pipeline


@pytest.mark.parametrize("noted", [True, False], ids=["with_the_counter", "without_it"])
def test_pinned_pct_reads_the_counter_where_it_is_noted(monkeypatch, noted):
    if not noted:
        monkeypatch.setattr(pipeline, "_NOTED", ("candidates", "kept", "redispatches"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r = harness.run(tiny(), SEED, 1.0, True, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    got = r["metrics"]
    assert "dispatch.kept_pct" in got  # the window's spans were read
    if noted:
        assert got["feed.pinned_pct"] == {"value": 100.0, "unit": "%"}
    else:
        assert "feed.pinned_pct" not in got
