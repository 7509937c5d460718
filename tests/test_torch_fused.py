"""The fused per-tile demodulator and the USE_FUSED route against readsb_tpu.

fused_demod_tiles' plain version is held to readsb_tpu.ops.fused's Pallas
kernel in the Mosaic interpreter (interpret=True) on two tiles of a 0.12 s
capture: comb on every row, offsets, live, meta and the prefix sums; and the
pipeline under ops.demod.USE_FUSED to readsb_tpu's under the same constant,
as tests/test_fused.py runs it.  Where readsb_tpu cannot run (a capacity
that is no multiple of 128, the channel-batched demodulator's widths) the
port's fused route is held to the port's own staged route.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import readsb_tpu.ops.demod as jax_demod
import readsb_tpu.ops.fused as jax_fused
import readsb_tpu.ops.pallas_kernels as pk
import readsb_tpu.pipeline as jax_pipeline
from readsb_tpu.ops import convert as jax_convert
from readsb_tpu_torch import pipeline, state
from readsb_tpu_torch.constants import TRAILING_SAMPLES
from readsb_tpu_torch.ops import demod, fused, kernels
from readsb_tpu_torch.synth import build_standard_capture, quantize_sc16, quantize_uc8

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

TILE = fused.TILE
OUTPUTS = ("comb", "offsets", "live", "meta", "cs_hi", "cs_lo")


def frame_key(frames):
    return [(f.msg.hex(), f.timestamp) for f in frames]


def stats_key(s):
    return (s.preambles, s.rejected_bad, s.rejected_unknown_icao, list(s.accepted))


@pytest.fixture(scope="module")
def capture():
    """(magnitudes of whole tiles, raw uc8 bytes) of a 0.12 s capture."""
    raw = quantize_uc8(build_standard_capture(duration_s=0.12, n_aircraft=4, seed=13).render_iq())
    mag = np.asarray(jax_convert.mag_uc8(jnp.asarray(raw)), np.uint16)
    return mag[: len(mag) // TILE * TILE], raw


@pytest.fixture
def use_fused():
    demod.USE_FUSED = True
    try:
        yield
    finally:
        demod.USE_FUSED = False
        fused.L_ROW = 16


def _both(mag, **kw):
    want = jax_fused.fused_demod_tiles(jnp.asarray(mag), 58, interpret=True, **kw)
    before = fused.fused_demod_tiles.launches
    got = fused.fused_demod_tiles(torch.from_numpy(mag.copy()), 58, **kw)
    assert fused.fused_demod_tiles.launches == before  # a CPU tensor launches nothing
    return got, [np.asarray(w) for w in want]


def _offset0_rows(mag: np.ndarray) -> torch.Tensor:
    """int32[T, 128]: per tile the staged route's extraction (the port's
    plain dense scan, win rows and extract_syndromes) at the tile's first
    sample; magnitudes past the buffer are 0."""
    ntiles = len(mag) // TILE
    m = torch.zeros(ntiles * TILE + fused.HALO, dtype=torch.int32)
    m[: len(mag)] = torch.from_numpy(mag.astype(np.int32))
    corrbits, pwords, _, _ = kernels.dense_from_mag(m, 58, tail=0)
    win, _ = demod.win_rows(corrbits, pwords, ntiles * TILE)
    starts = torch.arange(ntiles, dtype=torch.int64) * TILE
    return kernels.extract_syndromes_plain(win[starts // 256], starts.to(torch.int32))


def _dead_rows_are_offset0_rows(comb, live, offset0, cap: int) -> int:
    """Every row that is not live equals its tile's offset-0 row; returns
    how many there are."""
    comb = np.asarray(comb).reshape(len(offset0), cap, 128)
    dead = ~np.asarray(live).astype(bool).reshape(len(offset0), cap)
    for t in range(len(offset0)):
        np.testing.assert_array_equal(comb[t][dead[t]], np.broadcast_to(
            offset0[t].numpy(), (int(dead[t].sum()), 128)), err_msg=f"tile {t}")
    return int(dead.sum())


def test_constants_equal():
    assert (fused.TILE, fused.L_ROW) == (jax_fused.TILE, jax_fused.L_ROW)
    assert fused.HALO == jax_fused.HALO_ROWS * jax_fused.LANES
    assert demod.USE_FUSED is False and jax_demod.USE_FUSED is False


@pytest.mark.parametrize(
    "kw",
    [dict(cap=1024), dict(cap=1024, seg_stride=40000, seg_valid=39000, scan_limit=120000)],
    ids=["plain", "layout"],
)
def test_fused_plain_equals_pallas(capture, kw):
    mag = capture[0][: 2 * TILE]
    got, want = _both(mag, **kw)
    assert int(want[3][:, 0].sum()) > 20 and want[2].any() and not want[2].all()
    for name, g, w in zip(OUTPUTS, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)  # every row
    assert got[2].dtype == torch.bool and got[0].dtype == torch.int32
    assert (np.diff(got[1].numpy()) >= 0).all()
    # readsb_tpu's dead rows: each tile's offset-0 row, what the kernel
    # extracts once per tile and copies
    assert _dead_rows_are_offset0_rows(want[0], want[2], _offset0_rows(mag), kw["cap"]) > 0


def test_fused_rows_equal_the_staged_extraction(capture):
    """Live rows are the staged route's candidates, in order, with its
    syndromes, bytes and correlation bits; any cap (1000 here, which
    readsb_tpu's kernel refuses)."""
    mag = capture[0]
    n = len(mag)
    comb, offsets, live, meta, cs_hi, cs_lo = fused.fused_demod_tiles(
        torch.from_numpy(mag.copy()), 58, cap=1000
    )
    buf = torch.cat([torch.from_numpy(mag.copy()),
                     torch.zeros(TRAILING_SAMPLES + 512, dtype=torch.uint16)])
    k = (n // TILE) * 1000
    bc, hi_s, lo_s = demod._demod_core(buf, 58, k=k, scan_len=n, l=64)
    nc = int(bc.n_cand)
    assert nc > 50 and int(meta[:, 0].sum()) == nc and int(meta[:, 2].max()) <= fused.L_ROW
    assert int(meta[:, 1].max()) == int(bc.max_local)
    assert torch.equal(offsets[live], bc.offsets[:nc])
    assert torch.equal(comb[live][:, 0:5], bc.syn112[:nc])
    assert torch.equal(comb[live][:, 5:10], bc.syn56[:nc])
    assert torch.equal(comb[live][:, 10:80].reshape(nc, 5, 14).to(torch.uint8), bc.msg[:nc])
    assert torch.equal(comb[live][:, 80:83] != 0, bc.corr_fired[:nc])
    assert torch.equal(cs_hi, hi_s[:n]) and torch.equal(cs_lo, lo_s[:n])
    tile_of_row = torch.arange(len(live)) // 1000
    for t in range(n // TILE):  # rows that are not live: the tile's offset 0
        dead = comb[~live & (tile_of_row == t)]
        assert len(dead) > 0 and (dead == dead[0]).all()
        assert (offsets[~live & (tile_of_row == t)] == (t + 1) * TILE).all()


def test_fused_row_and_tile_overflow_keep_meta(capture):
    """Beyond cap or L_ROW a candidate is not live; meta still counts it."""
    mag = torch.from_numpy(capture[0][: 2 * TILE].copy())
    full = fused.fused_demod_tiles(mag, 58, cap=1024)
    small = fused.fused_demod_tiles(mag, 58, cap=7)
    assert torch.equal(small[3], full[3]) and int(full[3][:, 0].min()) > 7
    assert small[2].all() and tuple(small[0].shape) == (14, 128)
    for t in range(2):
        assert torch.equal(small[0][7 * t : 7 * t + 7], full[0][1024 * t : 1024 * t + 7])
    fused.L_ROW = 1
    try:
        rows1 = fused.fused_demod_tiles(mag, 58, cap=1024)
    finally:
        fused.L_ROW = 16
    assert torch.equal(rows1[3], full[3]) and int(full[3][:, 2].max()) > 1
    assert 0 < int(rows1[2].sum()) < int(full[2].sum())


@pytest.mark.parametrize("halo", [False, True])
def test_fused_plain_dead_rows_are_the_offset0_row_when_it_overflows(halo):
    """Noise, cap 777 and L_ROW 4 (the card test's overflow case): rows past
    the tile's candidates and crowded rows' candidates are dead, and each
    is its tile's offset-0 row."""
    rng = np.random.default_rng(9)
    n = 3 * TILE + (fused.HALO if halo else 0)
    mag = rng.integers(0, 4000, n, dtype=np.int64).astype(np.uint16)
    fused.L_ROW = 4
    try:
        comb, _, live, meta, _, _ = fused.fused_demod_tiles(torch.from_numpy(mag), 58, cap=777)
    finally:
        fused.L_ROW = 16
    assert int(meta[:, 0].min()) > 777 and live.any() and not live.all()
    assert _dead_rows_are_offset0_rows(comb, live, _offset0_rows(mag), 777) > 0


@pytest.mark.parametrize(
    "call",
    [lambda b: fused.fused_demod_tiles(b[:1000], 58, cap=128),
     lambda b: fused.fused_demod_tiles(b.to(torch.int32), 58, cap=128),
     lambda b: fused.fused_demod_tiles(b, 58, cap=0),
     lambda b: fused.fused_demod_tiles(b, 58, cap=128, seg_stride=4096),
     lambda b: fused.fused_demod_tiles_plain(b.reshape(2, -1), 58, cap=128)],
    ids=["length", "dtype", "cap", "layout", "rank"],
)
def test_fused_wrapper_rejects_bad_input(call):
    with pytest.raises(ValueError):
        call(torch.zeros(TILE, dtype=torch.uint16))


# ---------------------------------------------------------------------------
# The USE_FUSED route through the pipeline
# ---------------------------------------------------------------------------


def _port_process_mag(mag, **kw):
    d = pipeline.Demodulator(blocks_per_batch=len(mag) // 131072, use_native=False,
                             device="cpu", **kw)
    frames = d.process_mag(mag) + d.flush()
    return frame_key(frames), stats_key(d.stats), d


def _jax_process_mag(mag, monkeypatch, l_row=None):
    """readsb_tpu's Demodulator under USE_FUSED, its kernels interpreted."""
    def clear():
        jax_fused.fused_demod_tiles.clear_cache()
        jax_pipeline._demod_and_gate.clear_cache()

    monkeypatch.setattr(pk, "INTERPRET", True)
    monkeypatch.setattr(jax_demod, "USE_FUSED", True)
    if l_row is not None:
        monkeypatch.setattr(jax_fused, "L_ROW", l_row)
    clear()  # the constants are read when tracing
    try:
        d = jax_pipeline.Demodulator(blocks_per_batch=len(mag) // 131072, use_gate=True,
                                     use_native=False)
        frames = d.process_mag(mag) + d.flush()
    finally:
        monkeypatch.undo()
        clear()
    return frame_key(frames), stats_key(d.stats), d


def test_pipeline_use_fused_equals_readsb_tpu(capture, monkeypatch, use_fused):
    """2 blocks = 4 tiles, cap 1024: frames, timestamps and stats equal
    readsb_tpu's under USE_FUSED and the port's own staged run.  The last
    326 samples are silent: readsb_tpu's fused route reads zeros after
    scan_len, the port (as both staged routes) the samples that are there."""
    mag = capture[0][: 2 * 131072].copy()
    mag[-TRAILING_SAMPLES:] = 0
    want = _jax_process_mag(mag, monkeypatch)
    calls = []
    real = fused.fused_demod_tiles
    monkeypatch.setattr(fused, "fused_demod_tiles",
                        lambda *a, **k: calls.append(k["cap"]) or real(*a, **k))
    got = _port_process_mag(mag)
    assert calls == [1024] and got[2]._force_staged is False
    assert len(got[0]) > 0 and got[:2] == want[:2]
    demod.USE_FUSED = False
    assert _port_process_mag(mag)[:2] == got[:2]


def test_pipeline_fused_overflow_goes_staged(capture, monkeypatch, use_fused):
    """L_ROW = 1 overflows a row: the block is redone staged, the frames
    stay, and the demodulator stays staged, as readsb_tpu's."""
    mag = capture[0][: 2 * 131072]
    want = _jax_process_mag(mag, monkeypatch, l_row=1)
    assert getattr(want[2], "_force_staged", False)
    fused.L_ROW = 1
    got = _port_process_mag(mag)
    assert got[2]._force_staged is True
    assert len(got[0]) > 0 and got[:2] == want[:2]
    calls = []
    monkeypatch.setattr(fused, "fused_demod_tiles", lambda *a, **k: calls.append(1))
    got[2].process_mag(mag)  # sticky: the fused kernel is not asked again
    assert not calls


def _run_raw(raw):
    d = pipeline.Demodulator(blocks_per_batch=2, use_native=False, device="cpu")
    assert d.raw_route
    frames = d.feed(bytes(raw)) + d.flush()
    return frame_key(frames), stats_key(d.stats), d


def test_pipeline_use_fused_reads_the_samples_after_scan_len(capture, use_fused):
    """A window that starts in a superblock's last 326 samples reads the
    samples that follow, on the fused route as on the staged one."""
    mag = capture[0][: 2 * 131072]
    got = _port_process_mag(mag)
    assert got[2]._force_staged is False
    demod.USE_FUSED = False
    assert _port_process_mag(mag)[:2] == got[:2]


def test_raw_route_use_fused_equals_staged(capture, monkeypatch):
    base = _run_raw(capture[1])
    seen = []
    real = kernels.mag_uc8
    monkeypatch.setattr(kernels, "mag_uc8", lambda w: seen.append(len(w)) or real(w))
    demod.USE_FUSED = True
    try:
        got = _run_raw(capture[1])
    finally:
        demod.USE_FUSED = False
    assert seen and got[2]._force_staged is False  # raw words are converted first
    assert got[:2] == base[:2] and len(base[0]) > 0


def _run_multi(fmt, k_per_block=2048):
    caps = [build_standard_capture(0.12, 3, s).render_iq() for s in (5, 6, 7, 8)]
    quant = quantize_uc8 if fmt == "uc8" else quantize_sc16
    chunks = [quant(iq).tobytes() for iq in caps]
    m = pipeline.MultiDemodulator(4, fmt=fmt, blocks_per_batch=1, use_native=False,
                                  device="cpu", k_per_block=k_per_block)
    out = m.feed(chunks)
    for c, t in enumerate(m.flush()):
        out[c].extend(t)
    return [frame_key(f) for f in out], [stats_key(m.channel_stats(c)) for c in range(4)], m


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_multidemodulator_use_fused_equals_staged(fmt, use_fused, monkeypatch):
    """MultiDemodulator(4): 9 tiles, cap 1820, no multiple of 128."""
    caps_seen = []
    real = fused.fused_demod_tiles
    monkeypatch.setattr(fused, "fused_demod_tiles",
                        lambda *a, **k: caps_seen.append(k["cap"]) or real(*a, **k))
    got = _run_multi(fmt, k_per_block=4096)
    assert caps_seen and set(caps_seen) == {1820} and got[2]._force_staged is False
    demod.USE_FUSED = False
    base = _run_multi(fmt, k_per_block=4096)
    assert got[:2] == base[:2] and sum(map(len, base[0])) > 0
    if fmt == "sc16":
        assert (got[2].mean_level == base[2].mean_level).all()


@pytest.mark.parametrize("fmt", ["sc16", "uc8"])
def test_multi_route_ends_after_a_fused_overflow(fmt, use_fused):
    """A fused overflow on the channel-batched routes: the loop ends (the
    magnitude route of readsb_tpu does not pass force_staged on and would
    not), staged from then on, frames as the staged run's."""
    fused.L_ROW = 1
    got = _run_multi(fmt)
    assert got[2]._force_staged is True
    demod.USE_FUSED = False
    assert _run_multi(fmt)[:2] == got[:2]


def test_ungated_route_use_fused_equals_staged(capture, use_fused):
    """use_gate=False reads all rows back: under USE_FUSED the rows between
    the tiles' candidates have no correlation bit and the finalizer passes
    over them, so the frames and stats are the staged run's; a fused
    overflow is redone staged here too (readsb_tpu's ungated loop does not
    look at it)."""
    mag = capture[0][: 2 * 131072]
    got = _port_process_mag(mag, use_gate=False)
    assert got[2]._force_staged is False
    fused.L_ROW = 1
    over = _port_process_mag(mag, use_gate=False)
    assert over[2]._force_staged is True
    demod.USE_FUSED = False
    base = _port_process_mag(mag, use_gate=False)
    assert len(base[0]) > 0 and got[:2] == base[:2] == over[:2]


def test_force_staged_is_stream_state():
    base = dict(
        overlap_mag=np.zeros(TRAILING_SAMPLES, np.uint16), scan_global=0, k=8192, compact_l=64,
        gate_k2=1024, gate_keep_l=64,
        mirror=dict(cur=[], prev=[], next_swap_ms=None, capacity=2048),
        icao=[dict(cur=[], prev=[], next_swap_ms=None)],
    )
    assert state.demod_state_from_numpy(base)["force_staged"] is False
    d = pipeline.Demodulator(fmt="sc16", use_native=False, device="cpu")
    assert d._force_staged is False
    d.load_state(state.demod_state_from_numpy({**base, "force_staged": True}))
    assert d._force_staged is True
