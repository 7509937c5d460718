"""The harness on the CPU: cells load from their files alone, a run at a
tiny size is correct, and a run over a broken program is not.

    python -m pytest -q portbench/tests

The card test at the end runs only where a CUDA device is present.
"""

from __future__ import annotations

import ast
import copy
import json
import pathlib
import time

import pytest
import torch

from portbench import compare, harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 987_654_321  # wider than 32 signed bits


def tiny(config: str = "ch64_sc16_nodf", traffic: str = "quiet") -> harness.Cell:
    """A cell at a size the CPU runs in seconds: 4 channels, one block per
    superblock, a pool of 2 superblocks."""
    cfg, mix = harness.load_files(config, traffic)
    cell = harness.Cell(f"{config}.{traffic}", 1, cfg, mix, BENCH["end_to_end"], BENCH["per_layer"])
    cell.cfg.update(channels=4, blocks_per_batch=1, warmup_superblocks=3)
    cell.traffic["pool_superblocks"] = 2
    return cell


def test_every_cell_loads_from_its_files():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.cfg["name"] == w["config"]
        assert cell.chips == w["chips"] == 1
        assert cell.traffic["generator"] == "portbench.gen"
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "demod_msps", "superblock_p95_ms"} <= names
        for m in cell.per_layer:
            assert callable(harness.load_reader(m["name"]))


def test_config_files_match_benchmark():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A mix added as a data file and a cell added to BENCHMARK.json are
    found by name, with no edit of the harness."""
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "uc8_noisy", "config": "ch64_uc8_nodf", "traffic": "noisy",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub, name in (("configs", "ch64_uc8_nodf"), ("traffic", "quiet")):
        src = ROOT / "portbench" / sub / f"{name}.json"
        dst = name if sub == "configs" else "noisy"
        (tmp_path / "portbench" / sub / f"{dst}.json").write_text(src.read_text())
    cell = harness.load_cell("uc8_noisy", root=str(tmp_path))
    assert cell.cfg["fmt"] == "uc8" and cell.traffic["aircraft_per_receiver"] == 8


def test_every_metric_is_read_in_every_cell():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.end_to_end == BENCH["end_to_end"] and cell.per_layer == BENCH["per_layer"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "readsb_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "readsb_tpu.pipeline", object())
    assert harness.forbidden_modules() == ["readsb_tpu"]


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for path in files:
        assert not _imports(path) & harness.FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "crc24.py", "compare.py", "gen.py"):
        assert "readsb_tpu_torch" not in _imports(ROOT / "portbench" / name), name


def _run(cell, seconds=1.0, program_factory=harness.make_program, traced=False):
    return harness.run(cell, SEED, seconds, traced, "cpu", time.perf_counter(),
                       program_factory=program_factory)


@pytest.mark.parametrize("config", ["ch64_sc16_nodf", "ch64_uc8_nodf"])
def test_a_sound_run_is_correct(config):
    r = _run(tiny(config), traced=True)
    assert r["correct"], r["checks"]
    assert r["checks"]["signal_rel_gap"]["value"] > 0  # the program keeps float32
    assert list(r["checks"]) == ["frames_differing", "stats_differing", "signal_rel_gap"]
    assert "python.gc_ms_per_s" in r["metrics"]


class _Broken:
    """The program with one fault planted under feed()."""

    def __init__(self, cfg, device, fault):
        self.inner = harness.make_program(cfg, device)
        self.fault = fault
        self.first = None

    def feed(self, raws):
        out = self.inner.feed(raws)
        if self.fault == "state_unchanged":  # every call answers as the first
            self.first = self.first or out
            return [list(x) for x in self.first]
        if self.fault == "half_left_out":  # the second half of the channels dropped
            return [x if c < len(out) // 2 else [] for c, x in enumerate(out)]
        if self.fault == "answer_altered":  # one frame's timestamp moved by a tick
            for frames in out:
                self._alter(frames)
            return out
        if self.fault == "one_channel_altered":  # the same, in the last channel alone
            self._alter(out[-1])
            return out
        raise ValueError(self.fault)

    @staticmethod
    def _alter(frames):
        if frames:
            f = frames[0]
            frames[0] = type(f)(**{**f.__dict__, "timestamp": f.timestamp + 1})

    def channel_stats(self, c):
        return self.inner.channel_stats(c)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered",
                                   "one_channel_altered"])
def test_a_broken_program_is_not_correct(fault):
    r = _run(tiny(), program_factory=lambda cfg, dev: _Broken(cfg, dev, fault))
    assert not r["correct"], r["checks"]
    assert r["checks"]["frames_differing"]["value"] > 0


def test_the_control_is_not_correct():
    """The reference with its magnitudes rounded through float16, put in
    the program's place, fails the comparison with the reference."""
    cell = tiny("ch64_uc8_nodf")
    cell.traffic = {**json.loads((ROOT / "portbench" / "traffic" / "busy.json").read_text()),
                    "pool_superblocks": 2}
    pool, _ = harness.render(cell, SEED, "cpu")
    schedule = [0, 1, 0, 1]
    ctrl_frames, ctrl_stats = {}, {}
    for c in range(4):
        frames, stats = harness.reference.run_channel(
            cell.cfg, pool[c], schedule, "cpu", mag_round="float16")
        ctrl_frames[c] = [compare.pack_reference(f) for f in frames]
        ctrl_stats[c] = stats
    checks = harness.reference_check(cell, pool, schedule, ctrl_frames, ctrl_stats, "cpu")["checks"]
    assert not compare.passed(checks)
    assert checks["signal_rel_gap"]["value"] > 10 * compare.LIMITS["signal_rel_gap"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only on the card")
    return "cuda:0"


@pytest.mark.cuda
def test_a_run_on_the_card_is_correct(card):
    cell = harness.load_cell("sc16nodf_quiet")
    cell.cfg.update(warmup_superblocks=2)
    cell.traffic["pool_superblocks"] = 2
    r = harness.run(cell, SEED, 2.0, True, card, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert "kernel.scan_roofline_pct" in r["metrics"]
