"""The port's sharded mesh (readsb_tpu_torch/parallel) against readsb_tpu's.

Both packages get the same numpy streams.  readsb_tpu's mesh runs on
conftest's eight virtual CPU devices, the port's on ["cpu"] * 8: the
ungated program's fields are equal at tolerance 0 but for one known
difference of the reference (ROADMAP Queue 3), which the test counts:
readsb_tpu's CPU path cuts the long signal window of a row in the last
SHARD_TAIL offsets of a shard (the sentinel rows past the candidates
included), where the port sums the whole window.  The gated program is
compared with readsb_tpu's kernels #4 and #5 in the Mosaic interpreter,
every field equal.  Then the sharded frame sets against the unsharded
path on several mesh shapes, the dry run, the two-process run, and the
kernel libraries' per-device loading with a stand-in library.
"""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from readsb_tpu.ops import pallas_kernels as pk
from readsb_tpu.parallel import mesh as jax_mesh
from readsb_tpu_torch.constants import TRAILING_SAMPLES
from readsb_tpu_torch.ops import demod, fused, kernels
from readsb_tpu_torch.ops.demod import SIG_LONG
from readsb_tpu_torch.ops.gate import TBL_SENTINEL
from readsb_tpu_torch.parallel import dcn_dryrun
from readsb_tpu_torch.parallel import mesh as pmesh
from readsb_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    place_frame,
    sharded_frames,
    unsharded_frames,
)
from tests.conftest import REPO
from tools.synth import encode_df17_position, frame_envelope

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

T_LOCAL = 8192
SHARD_TAIL = 19 + SIG_LONG  # shard offsets whose long window readsb_tpu's CPU path may cut
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def stream():
    """tests/test_sharding.py's stream: seed 0, 2 x 4 shards of 8192
    samples, a strong DF17 frame across the boundary of shards 1|2."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 2500, size=(2, 4 * T_LOCAL), dtype=np.uint16)
    msg = encode_df17_position(0xABCDEF, 50.0, 9.0, 30000, odd=0)
    env = (frame_envelope(msg, 112, phase=0.0) * 40000).astype(np.uint16)
    start = 2 * T_LOCAL - 100
    s[0, start - TRAILING_SAMPLES : start - TRAILING_SAMPLES + len(env)] = env
    return s


@pytest.fixture(scope="module")
def jax_8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jax_mesh.make_mesh(2, 4)


def test_sharded_demod_equals_readsb_tpu(stream, jax_8):
    j = jax_mesh.build_sharded_demod(jax_8, k_per_shard=512, threshold=58)(
        jax_mesh.shard_stream(stream, jax_8))
    p = pmesh.build_sharded_demod(pmesh.make_mesh(2, 4, CPU8), k_per_shard=512, threshold=58)(
        stream)
    assert set(p._fields) == set(j._fields)
    offs = p.offsets.numpy()
    assert int(p.n_cand.sum()) > 0 and (offs >= 0).any()
    # local scan offset of each row; sentinel rows sit at the shard's end
    local = np.where(offs >= 0, offs % T_LOCAL, T_LOCAL)
    tail = local >= T_LOCAL - SHARD_TAIL
    for f in p._fields:
        got, want = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        if f in ("sig_long", "sig_short"):
            diff = (got != want).any(-1)
            assert not (diff & ~tail).any(), f  # equal outside the band
            np.testing.assert_array_equal(got[~tail], want[~tail], err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    # the band shows on this stream: count the candidate rows it touches
    cut = (p.sig_long.numpy() != np.asarray(j.sig_long)).any(-1)
    assert 0 < int((cut & (offs >= 0)).sum()) <= int((tail & (offs >= 0)).sum())


def test_sharded_gated_demod_equals_readsb_tpu(stream, jax_8, monkeypatch):
    """#4 and #5 of readsb_tpu in the Mosaic interpreter, as its dry run
    runs them on the CPU; every field equal."""
    import jax.numpy as jnp

    tbl = np.full(128, TBL_SENTINEL, np.int32)
    monkeypatch.setattr(pk, "INTERPRET", True)
    j = jax_mesh.build_sharded_gated_demod(jax_8, k_per_shard=512, threshold=58)(
        jax_mesh.shard_stream(stream, jax_8), jnp.asarray(tbl))
    monkeypatch.undo()
    p = pmesh.build_sharded_gated_demod(pmesh.make_mesh(2, 4, CPU8), k_per_shard=512,
                                        threshold=58)(stream, tbl)
    assert list(p._fields) == list(j._fields)
    assert int(p.pre_drop.sum()) > 0 and int(p.n_keep.sum()) > 0
    for f in p._fields:
        got, want = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _stream_for(n_chan: int, n_time: int, seed: int) -> np.ndarray:
    """n_chan channels of n_time shards: a frame per channel, one across
    the boundary of shards 0|1 (the stream's end when n_time == 1)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 3000, size=(n_chan, n_time * T_LOCAL), dtype=np.uint16)
    for ch in range(n_chan):
        place_frame(s[ch], 700 + 53 * ch, 0xC00000 + ch, 0)
        place_frame(s[ch], T_LOCAL - 80 if n_time > 1 else T_LOCAL - 400, 0xC00000 + ch, 1)
    return s


@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (2, 4), (4, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_frames_equal_unsharded(shape):
    n_chan, n_time = shape
    s = _stream_for(n_chan, n_time, seed=11 + n_time)
    mesh = pmesh.make_mesh(n_chan, n_time, ["cpu"] * (n_chan * n_time))
    total = n_time * T_LOCAL
    out = pmesh.build_sharded_demod(mesh, k_per_shard=512)(s)
    gout = pmesh.build_sharded_gated_demod(mesh, k_per_shard=512)(
        s, np.full(128, TBL_SENTINEL, np.int32))
    assert tuple(out.offsets.shape) == (n_chan, n_time, 512)
    assert tuple(gout.offsets.shape) == (n_chan, n_time, 256)
    assert int(out.n_cand.max()) <= 512
    for ch in range(n_chan):
        want = unsharded_frames(s[ch], "cpu")
        assert {hx for hx, _ in want} >= {encode_df17_position(0xC00000 + ch, 51.0, 6.0, 32000,
                                                               odd=o).hex() for o in (0, 1)}
        assert sharded_frames(out, ch, total) == want
        assert sharded_frames(gout, ch, total) == want


@pytest.mark.parametrize("l_row", [fused.L_ROW, 1], ids=["fits", "overflows"])
def test_sharded_use_fused_equals_staged(l_row, monkeypatch):
    """Under ops.demod.USE_FUSED a shard runs the fused route; with
    fused.L_ROW = 1 its rows overflow and are redone staged.  Frames and
    gate counts equal the staged run's."""
    s = _stream_for(2, 4, seed=5)
    mesh = pmesh.make_mesh(2, 4, CPU8)
    tbl = np.full(128, TBL_SENTINEL, np.int32)
    staged = pmesh.build_sharded_demod(mesh, k_per_shard=512)(s)
    gstaged = pmesh.build_sharded_gated_demod(mesh, k_per_shard=512)(s, tbl)
    calls = {"fused": 0, "staged": 0}

    def counted(fn, what):
        def call(*a, **k):
            calls[what] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(fused, "fused_demod_tiles", counted(fused.fused_demod_tiles, "fused"))
    for name in ("extract_syndromes", "extract_classify_v3"):  # stage 4 of the staged route
        monkeypatch.setattr(kernels, name, counted(getattr(kernels, name), "staged"))
    monkeypatch.setattr(fused, "L_ROW", l_row)
    demod.USE_FUSED = True
    try:
        got = pmesh.build_sharded_demod(mesh, k_per_shard=512)(s)
        ggot = pmesh.build_sharded_gated_demod(mesh, k_per_shard=512)(s, tbl)
    finally:
        demod.USE_FUSED = False
    # every row of both programs (8 shards of one row each) went fused first;
    # with L_ROW = 1 some were redone staged
    assert calls["fused"] == 2 * 8
    assert (calls["staged"] > 0) == (l_row == 1)
    for ch in range(2):
        assert sharded_frames(got, ch, 4 * T_LOCAL) == sharded_frames(staged, ch, 4 * T_LOCAL)
        assert sharded_frames(ggot, ch, 4 * T_LOCAL) == sharded_frames(gstaged, ch, 4 * T_LOCAL)
    assert torch.equal(got.n_cand, staged.n_cand)
    for f in ("n_cand", "n_keep", "pre_drop"):
        assert torch.equal(getattr(ggot, f), getattr(gstaged, f)), f


def test_dryrun_multichip_on_the_cpu(capsys):
    out, gout = dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip OK: mesh=(chan=2, time=4)" in capsys.readouterr().out
    assert tuple(out.offsets.shape) == (4, 4, 512) and tuple(gout.offsets.shape) == (4, 4, 256)
    assert out.offsets.device.type == "cpu" and int(gout.pre_drop.sum()) > 0


def test_dcn_two_process_run_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "readsb_tpu_torch.parallel.dcn_dryrun", "--device", "cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=240,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dcn_dryrun OK" in r.stdout
    assert r.stdout.count("local channels frame-equal") == 2


def test_dcn_launcher_fails_when_a_rank_fails(capfd):
    assert dcn_dryrun.launcher("cpu", fail_rank=1, timeout_s=240) == 1
    assert "dcn_dryrun FAILED" in capfd.readouterr().err


def test_mesh_shape_and_shard_layout():
    mesh = pmesh.make_mesh(2, 3, ["cpu"] * 7)
    assert mesh.axis_names == ("chan", "time") and mesh.shape == {"chan": 2, "time": 3}
    assert mesh.shape["time"] == 3 and len(mesh.devices) == 2 and len(mesh.devices[0]) == 3
    x = np.arange(4 * 3 * 400, dtype=np.uint16).reshape(4, 1200)
    shards = pmesh.shard_stream(x, mesh)
    for c in range(2):
        for t in range(3):
            assert torch.equal(shards[c][t], torch.from_numpy(x[2 * c : 2 * c + 2,
                                                                400 * t : 400 * t + 400]))
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_stream(x[:3], mesh)
    with pytest.raises(ValueError, match="uint16"):
        pmesh.shard_stream(x.astype(np.int32), mesh)


def test_make_mesh_raises_with_too_few_devices():
    with pytest.raises(ValueError, match="needs 8 devices, 7 given"):
        pmesh.make_mesh(2, 4, ["cpu"] * 7)


def test_make_mesh_needs_a_card_unless_devices_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(8)  # device="cuda" by default: no fallback to the CPU
    assert pmesh.make_mesh(1, 1, ["cpu"]).devices == ((torch.device("cpu"),),)


# --- per-device loading of the kernel libraries, with a stand-in library ------


class FakeLib:
    """The C interface of a kernel library: rtpu_init reports the current
    device, the table setters and the entry point record it."""

    def __init__(self, current):
        self.current = current
        self.calls = []

    def _record(self, what):
        def fn(*args):
            if what == "rtpu_init":
                args[0]._obj.value = self.current[0]
            self.calls.append((what, self.current[0]))
            return 0
        return fn

    def __getattr__(self, name):
        return self._record(name)


@pytest.fixture
def fake_libs(monkeypatch):
    """kernels with fresh library caches, a FakeLib for every library and a
    stand-in for torch.cuda.device that sets the current device."""
    current = [0]
    libs = {}

    @contextlib.contextmanager
    def device(index):
        prev, current[0] = current[0], index
        try:
            yield
        finally:
            current[0] = prev

    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_ready", set())
    monkeypatch.setattr(kernels, "_load", lambda name: libs.setdefault(name, FakeLib(current)))
    monkeypatch.setattr(kernels, "_stream", lambda t: 1234)
    monkeypatch.setattr(torch.cuda, "device", device)
    return libs


class FakeTensor:
    def __init__(self, device):
        self.device = torch.device(device)


@pytest.mark.parametrize("name,setter", [("extract_syndromes", "rtpu_extract_set_tables"),
                                         ("dense_scan_uc8", "rtpu_dense_set_table"),
                                         ("fused_demod", "rtpu_extract_set_tables")])
def test_tables_are_set_once_per_device(fake_libs, name, setter):
    for dev in ("cuda:0", "cuda:1", "cuda:0", "cuda:3", "cuda:1"):
        kernels._launch(name, FakeTensor(dev), 7)
    calls = fake_libs[name].calls
    assert [d for w, d in calls if w == "rtpu_init"] == [0, 1, 3]
    assert [d for w, d in calls if w == setter] == [0, 1, 3]
    # every launch ran with its tensor's device current
    assert [d for w, d in calls if w == name] == [0, 1, 0, 3, 1]
    assert kernels._ready == {(name, 0), (name, 1), (name, 3)}


def test_a_library_without_tables_is_prepared_once_per_device(fake_libs):
    for dev in ("cuda:2", "cuda:2", "cuda:0"):
        kernels._launch("mag_uc8", FakeTensor(dev), 1, 2)
    assert fake_libs["mag_uc8"].calls == [("rtpu_init", 2), ("mag_uc8", 2), ("mag_uc8", 2),
                                          ("rtpu_init", 0), ("mag_uc8", 0)]


def test_a_cpu_tensor_is_refused_before_any_library_loads(fake_libs):
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernels._launch("dense_scan", FakeTensor("cpu"), 1)
    assert fake_libs == {} and kernels._ready == set()
