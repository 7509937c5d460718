"""The port's CUDA kernels and pipeline on the card, against the plain
versions and the CPU run.  Marked `cuda`; they skip without a CUDA device.
This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from readsb_tpu_torch import pipeline
from readsb_tpu_torch.ops import convert, demod, fused, gate, kernels, modeac
from readsb_tpu_torch.pipeline import Demodulator, MultiDemodulator
from readsb_tpu_torch.synth import CaptureBuilder, build_standard_capture, quantize_sc16

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_dense_scan_kernel_equals_plain(dev):
    rng = np.random.default_rng(2)
    words = torch.from_numpy(rng.integers(0, 65536, 4 * 65536, dtype=np.int64).astype(np.uint16))
    before = kernels.dense_scan_uc8.launches
    got = kernels.dense_scan_uc8(words.to(dev), 58)
    assert kernels.dense_scan_uc8.launches == before + 1
    for g, w in zip(got, kernels.dense_scan_uc8_plain(words, 58)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", ["random-65536", "unaligned-65536", "random-full",
                                  "zeros-full", "silence-full"])
@pytest.mark.parametrize("name", ["dense_scan_uc8", "dense_scan"])
def test_dense_kernels_equal_plain_at_scale(dev, name, case):
    """n = 65536 (also from a view that is not 16-byte aligned) and the main
    path's n = 8,454,144 (1032 tiles of 8192): random words; all-zero words
    (uc8: full-scale magnitudes, so the prefix sums wrap and the look-back
    crosses every tile); all-0x8080 words (near silence).  The plain
    version runs on the card too."""
    n = 65536 if case.endswith("65536") else 8454144
    if case.startswith("zeros"):
        words = torch.zeros(n, dtype=torch.uint16, device=dev)
    elif case.startswith("silence"):
        words = torch.full((n,), 0x8080, dtype=torch.uint16, device=dev)
    else:
        rng = np.random.default_rng(n)
        words = torch.from_numpy(rng.integers(0, 65536, n + 1, dtype=np.int64).astype(np.uint16))
        words = words.to(dev)[1:] if case.startswith("unaligned") else words[:n].to(dev)
    fn = getattr(kernels, name)
    before = fn.launches
    got = fn(words, 58)
    assert fn.launches == before + 1
    for g, w in zip(got, getattr(kernels, name + "_plain")(words, 58)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 4097, 5000, 131072])
def test_extract_kernel_equals_plain(dev, k):
    rng = np.random.default_rng(k)
    rows = torch.from_numpy(rng.integers(-(2**31), 2**31, (k, 128), dtype=np.int64).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, 2**24, k, dtype=np.int64).astype(np.int32))
    got = kernels.extract_syndromes(rows.to(dev), offs.to(dev))
    assert torch.equal(got.cpu(), kernels.extract_syndromes_plain(rows, offs))


def test_multidemodulator_card_equals_cpu(dev):
    caps = [bytes(build_standard_capture(0.4, 3, s).render_uc8()) for s in (5, 6, 7, 8)]

    def run(device):
        m = MultiDemodulator(4, blocks_per_batch=1, use_native=False, device=device)
        out = m.feed(caps)
        for c, t in enumerate(m.flush()):
            out[c].extend(t)
        return [[(f.msg, f.timestamp) for f in fr] for fr in out], [
            (s.preambles, s.rejected_bad, s.rejected_unknown_icao, s.accepted)
            for s in map(m.channel_stats, range(4))
        ]

    card, cpu = run(dev), run("cpu")
    assert sum(map(len, card[0])) > 10
    assert card == cpu


def test_mag_uc8_kernel_equals_lut_on_all_pairs(dev):
    ii, qq = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    words = torch.from_numpy((ii.ravel() | (qq.ravel() << 8)).astype(np.uint16))
    before = kernels.mag_uc8.launches
    got = kernels.mag_uc8(words.to(dev))
    assert kernels.mag_uc8.launches == before + 1
    lut = torch.from_numpy(convert.uc8_lut_np().astype(np.int32))
    assert torch.equal(got.cpu().to(torch.int32), lut)


@pytest.mark.parametrize("n,shift", [(1, 0), (7, 0), (8, 0), (70001, 0), (70001, 3)])
def test_mag_uc8_kernel_odd_sizes(dev, n, shift):
    """Ragged tails, and a view that is not 16-byte aligned."""
    rng = np.random.default_rng(n + shift)
    words = torch.from_numpy(rng.integers(0, 65536, n + shift, dtype=np.int64).astype(np.uint16))
    got = kernels.mag_uc8(words.to(dev)[shift:])
    assert torch.equal(got.cpu(), kernels.mag_uc8(words[shift:]))


def test_dense_scan_mag_kernel_equals_plain(dev):
    rng = np.random.default_rng(4)
    mag = torch.from_numpy(rng.integers(0, 65536, 3 * 65536, dtype=np.int64).astype(np.uint16))
    before = kernels.dense_scan.launches
    got = kernels.dense_scan(mag.to(dev), 58)
    assert kernels.dense_scan.launches == before + 1
    for g, w in zip(got, kernels.dense_from_mag(mag.to(torch.int32), 58, tail=0)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("fmt", ["sc16", "sc16q11"])
def test_sc16_converters_card_equals_cpu(dev, fmt):
    axis = np.concatenate([np.arange(-32768, 32768, 53), [32767, -2048, 2047, 2048, 0]])
    ii, qq = np.meshgrid(axis.astype(np.int16), axis.astype(np.int16), indexing="ij")
    iq = torch.from_numpy(np.stack([ii.ravel(), qq.ravel()], axis=1).reshape(-1))
    fn = convert.CONVERTERS[fmt]
    assert torch.equal(fn(iq.to(dev)).cpu(), fn(iq))


def test_modeac_block_card_equals_cpu(dev):
    rng = np.random.default_rng(3)
    scan = 262144
    mag = np.abs(rng.normal(0, 800, scan + 326)).astype(np.uint16)
    pos = rng.integers(400, scan - 200, 15000)
    amp = rng.integers(3000, 30000, 15000)
    for d in (0, 1, 48, 49, 50):
        mag[pos + d] = np.maximum(mag[pos + d], (amp * rng.uniform(0.3, 1, 15000)).astype(np.uint16))
    buf = torch.from_numpy(mag)
    card = modeac.modeac_block(buf.to(dev), 300, k=32768, scan_len=scan)
    cpu = modeac.modeac_block(buf, 300, k=32768, scan_len=scan)
    assert int(cpu.n_cand) > 5000
    for c, h in zip(card, cpu):
        assert torch.equal(c.cpu(), h)


def test_multidemodulator_sc16_card_equals_cpu(dev):
    caps = [quantize_sc16(build_standard_capture(0.4, 3, s).render_iq()).tobytes()
            for s in (5, 6, 7, 8)]

    def run(device):
        m = MultiDemodulator(4, fmt="sc16", blocks_per_batch=1, use_native=False, device=device)
        out = m.feed(caps)
        for c, t in enumerate(m.flush()):
            out[c].extend(t)
        return [[(f.msg, f.timestamp) for f in fr] for fr in out], [
            (s.preambles, s.rejected_bad, s.rejected_unknown_icao, s.accepted)
            for s in map(m.channel_stats, range(4))
        ], m.mean_level.tolist(), m.mean_power.tolist()

    before = kernels.dense_scan.launches
    card, cpu = run(dev), run("cpu")
    assert kernels.dense_scan.launches > before
    assert sum(map(len, card[0])) > 10
    assert card == cpu


def test_ungated_modeac_card_equals_cpu(dev):
    cap = CaptureBuilder(duration_s=0.35, noise_rms=0.012, seed=11)
    for code, t in zip([0x1200, 0x7700, 0x0030, 0x2644], [0.02, 0.09, 0.17, 0.25]):
        cap.add_modeac(code, t, amplitude=0.5, phase=0.05)
    raw = bytes(cap.render_uc8())

    def run(device):
        d = Demodulator(fmt="uc8", blocks_per_batch=2, modeac=True, use_native=False,
                        device=device)
        frames = d.feed(raw) + d.flush()
        return ([(f.msg, f.timestamp) for f in frames],
                [(m.squawk_hex, m.timestamp) for m in d.modeac_msgs],
                d.stats_modeac, d.mean_level, d.mean_power)

    before = (kernels.mag_uc8.launches, kernels.dense_scan.launches)
    card, cpu = run(dev), run("cpu")
    assert kernels.mag_uc8.launches > before[0] and kernels.dense_scan.launches > before[1]
    assert {c for c, _ in card[1]} == {0x1200, 0x7700, 0x0030, 0x2644}
    assert card == cpu


# ---------------------------------------------------------------------------
# Kernels 5, 6 and 7 and the two routes they serve
# ---------------------------------------------------------------------------


def _known_table(values, t: int) -> torch.Tensor:
    vals = sorted({int(v) & 0xFFFFFF for v in values})[: t - 1]
    tbl = np.full(t, gate.TBL_SENTINEL, np.int32)
    tbl[: len(vals)] = vals
    return torch.from_numpy(tbl)


@pytest.fixture(scope="module")
def capture_rows():
    """(rows, offsets, magnitudes) of a 0.4 s capture at K = 131072, on the CPU."""
    raw = build_standard_capture(0.4, 6, 17).render_uc8()
    words = torch.from_numpy(np.ascontiguousarray(raw).view("<u2").copy())
    mag = kernels.mag_uc8(words)
    scan_len = (mag.shape[0] - 326) // 512 * 512
    corrbits, pwords, _, _ = demod._dense_stages(mag[: scan_len + 326], 58)
    offsets, n_cand, _, rows = demod.candidate_rows(corrbits, pwords, k=131072, l=64,
                                                    scan_len=scan_len)
    assert 1000 < int(n_cand) < 131072
    rows[-64:] = 0  # all-zero messages, for the zero7 flag
    return rows, offsets, mag


def test_extract_kernel_equals_plain_on_capture_rows(dev, capture_rows):
    rows, offsets, _ = capture_rows
    before = kernels.extract_syndromes.launches
    got = kernels.extract_syndromes(rows.to(dev), offsets.to(dev))
    assert kernels.extract_syndromes.launches == before + 1
    assert torch.equal(got.cpu(), kernels.extract_syndromes_plain(rows, offsets))
    assert got[:, 10:80].any()


@pytest.mark.parametrize("name", ["extract_classify_v3", "extract_classify"])
@pytest.mark.parametrize("nfix,fix_df", [(0, False), (1, True), (2, True)])
@pytest.mark.parametrize("t", [128, 2048, 4096])
def test_classify_kernels_equal_plain_on_a_capture(dev, capture_rows, name, nfix, fix_df, t):
    rows, offsets, _ = capture_rows
    tbl = _known_table([0x400000 + a * 0x1111 for a in range(6)] + list(range(7, 9000, 3)), t)
    fn = getattr(kernels, name)
    before = fn.launches
    args = (rows.to(dev), offsets.to(dev), tbl.to(dev))
    got = fn(*args, nfix=nfix, fix_df=fix_df)
    assert fn.launches == before + 1
    # the plain version on the card too: 131072 rows are slow on the host
    want = getattr(kernels, name + "_plain")(*args, nfix=nfix, fix_df=fix_df)
    assert torch.equal(got, want)
    assert (want[:, 83:88] & 4).any() and (want[:, 83:88] & 16).any()
    if nfix:
        assert (want[:, 83:88] & 1).any()


@pytest.mark.parametrize("k", [1, 31, 33, 5001])
def test_classify_kernels_equal_plain_on_ragged_random_rows(dev, k):
    rng = np.random.default_rng(k)
    rows = torch.from_numpy(rng.integers(-(2**31), 2**31, (k, 128), dtype=np.int64).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, 2**24, k, dtype=np.int64).astype(np.int32))
    blank = torch.full((128,), gate.TBL_SENTINEL, dtype=torch.int32)
    first = kernels.extract_classify_v3_plain(rows, offs, blank, nfix=2)
    tbl = _known_table(first[:, 0:10].reshape(-1)[::3].tolist(), 1024)
    want = kernels.extract_classify_v3_plain(rows, offs, tbl, nfix=2)
    assert (want[:, 83:88] & 4).any()
    v3 = kernels.extract_classify_v3(rows.to(dev), offs.to(dev), tbl.to(dev), nfix=2)
    v2 = kernels.extract_classify(rows.to(dev), offs.to(dev), tbl.to(dev), nfix=2)
    assert torch.equal(v3.cpu(), want)
    assert torch.equal(v2, v3)
    assert torch.equal(kernels.extract_classify_plain(rows, offs, tbl, nfix=2), want)


@pytest.mark.parametrize("cap", [1024, 1016])
@pytest.mark.parametrize("layout", [None, (131584, 131072)], ids=["flat", "channels"])
def test_fused_kernel_equals_plain_on_a_capture(dev, capture_rows, cap, layout):
    mag = capture_rows[2]
    n = mag.shape[0] // fused.TILE * fused.TILE
    kw = dict(cap=cap)
    if layout:
        kw.update(seg_stride=layout[0], seg_valid=layout[1], scan_limit=n - 70000)
    before = fused.fused_demod_tiles.launches
    got = fused.fused_demod_tiles(mag[:n].to(dev), 58, **kw)
    assert fused.fused_demod_tiles.launches == before + 1
    want = fused.fused_demod_tiles_plain(mag[:n].to(dev), 58, **kw)
    assert want[2].any() and int(want[3][:, 0].max()) <= cap
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("halo", [False, True])
def test_fused_kernel_equals_plain_when_it_overflows(dev, halo):
    """Noise: thousands of candidates per tile and crowded rows; with and
    without the last tile's halo in the buffer."""
    rng = np.random.default_rng(9)
    n = 3 * fused.TILE + (fused.HALO if halo else 0)
    mag = torch.from_numpy(rng.integers(0, 4000, n, dtype=np.int64).astype(np.uint16))
    fused.L_ROW = 4
    try:
        want = fused.fused_demod_tiles_plain(mag, 58, cap=777)
        got = fused.fused_demod_tiles(mag.to(dev), 58, cap=777)
    finally:
        fused.L_ROW = 16
    assert int(want[3][:, 0].min()) > 777 and int(want[3][:, 2].max()) > 4
    assert want[2].any() and not want[2].all()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _multi_run(device, fmt):
    caps = [build_standard_capture(0.4, 3, s) for s in (5, 6, 7, 8)]
    if fmt == "sc16":
        chunks = [quantize_sc16(c.render_iq()).tobytes() for c in caps]
    else:
        chunks = [bytes(c.render_uc8()) for c in caps]
    m = MultiDemodulator(4, fmt=fmt, blocks_per_batch=1, use_native=False, device=device,
                         k_per_block=4096)
    out = m.feed(chunks)
    for c, t in enumerate(m.flush()):
        out[c].extend(t)
    return [[(f.msg, f.timestamp) for f in fr] for fr in out], [
        (s.preambles, s.rejected_bad, s.rejected_unknown_icao, s.accepted)
        for s in map(m.channel_stats, range(4))
    ], m._force_staged


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
@pytest.mark.parametrize("route", ["FUSE_CLASSIFY", "USE_FUSED"])
def test_routes_on_the_card_equal_the_staged_cpu_run(dev, fmt, route):
    cpu = _multi_run("cpu", fmt)
    wrapper = kernels.extract_classify_v3 if route == "FUSE_CLASSIFY" else fused.fused_demod_tiles
    before = wrapper.launches
    module = pipeline if route == "FUSE_CLASSIFY" else demod
    setattr(module, route, True)
    try:
        card = _multi_run(dev, fmt)
    finally:
        setattr(module, route, False)
    assert wrapper.launches > before
    assert card == cpu and card[2] is False and sum(map(len, card[0])) > 10


@pytest.mark.parametrize("name", ["extract_classify_v3", "extract_classify"])
@pytest.mark.parametrize("nfix,fix_df", [(0, False), (1, True), (2, True)])
@pytest.mark.parametrize("t", [128, 4096])
def test_classify_kernels_at_every_table_size_on_ragged_rows(dev, name, nfix, fix_df, t):
    """K = 4099 (no multiple of 32) random rows: every nfix, a known table
    small enough for shared memory (128) and one that is not (4096)."""
    k = 4099
    rng = np.random.default_rng(nfix * 10 + t)
    rows = torch.from_numpy(rng.integers(-(2**31), 2**31, (k, 128), dtype=np.int64).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, 2**24, k, dtype=np.int64).astype(np.int32))
    blank = torch.full((128,), gate.TBL_SENTINEL, dtype=torch.int32)
    first = kernels.extract_classify_v3_plain(rows, offs, blank, nfix=nfix, fix_df=fix_df)
    tbl = _known_table(first[:, 0:10].reshape(-1)[::5].tolist(), t)
    want = getattr(kernels, name + "_plain")(rows, offs, tbl, nfix=nfix, fix_df=fix_df)
    assert (want[:, 83:88] & 4).any()
    fn = getattr(kernels, name)
    before = fn.launches
    got = fn(rows.to(dev), offs.to(dev), tbl.to(dev), nfix=nfix, fix_df=fix_df)
    assert fn.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_wrappers_accept_the_device_their_library_was_loaded_on(dev):
    """A cuda:0 tensor launches; the library records device 0."""
    words = torch.full((65536,), 0x8080, dtype=torch.uint16, device=dev)
    before = kernels.mag_uc8.launches
    kernels.mag_uc8(words)
    assert kernels.mag_uc8.launches == before + 1
    assert kernels._devices["mag_uc8"] == torch.cuda.current_device() == words.device.index
    kernels.check_device(words.device.index, words.device, "mag_uc8")


def _bursty_noise(tiles: int, halo: bool, seed: int) -> torch.Tensor:
    """Uniform noise in 512-sample bursts over a constant floor, with tile t
    holding bursts in a share (2%, 100%, 0, 20%)[t % 4] of its segments:
    from tiles with no candidate (every row dead) to tiles over any cap
    here (about 1,350 candidates)."""
    rng = np.random.default_rng(seed)
    n = tiles * fused.TILE + (fused.HALO if halo else 0)
    mag = np.full(n, 900, np.uint16)
    share = np.array([0.02, 1.0, 0.0, 0.2])[(np.arange(n // 512) * 512 // fused.TILE) % 4]
    noisy = np.repeat(rng.random(n // 512) < share, 512)
    mag[noisy] = rng.integers(0, 4000, int(noisy.sum()), dtype=np.int64).astype(np.uint16)
    return torch.from_numpy(mag)


@pytest.mark.parametrize("tiles,cap", [(1, 1), (1, 777), (3, 1), (3, 777), (3, 1016),
                                       (129, 1), (129, 777), (129, 1016)])
@pytest.mark.parametrize("halo", [False, True])
def test_fused_kernel_equals_plain_on_bursty_noise(dev, tiles, cap, halo):
    """T = 1, 3 and 129 tiles, cap = 1, 777 and 1016, with and without the
    last tile's halo (windows cross every tile's end)."""
    mag = _bursty_noise(tiles, halo, tiles + cap).to(dev)
    before = fused.fused_demod_tiles.launches
    got = fused.fused_demod_tiles(mag, 58, cap=cap)
    assert fused.fused_demod_tiles.launches == before + 1
    want = fused.fused_demod_tiles_plain(mag, 58, cap=cap)
    count = want[3][:, 0]
    assert int(count[0]) > 0 and (tiles == 1 or int(count.max()) > cap)
    assert tiles == 1 or int(count.min()) == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("halo", [False, True])
def test_fused_kernel_equals_plain_across_the_cluster_seams(dev, halo):
    """Live candidates within a window's reach (352 samples) of each of the
    seven seams between a tile's 8192-sample blocks, and of the tile's end:
    their windows read the next block's planes.  Noise everywhere; cap =
    4096 keeps every candidate."""
    tiles = 2
    rng = np.random.default_rng(5)
    n = tiles * fused.TILE + (fused.HALO if halo else 0)
    mag = torch.from_numpy(rng.integers(0, 4000, n, dtype=np.int64).astype(np.uint16)).to(dev)
    got = fused.fused_demod_tiles(mag, 58, cap=4096)
    want = fused.fused_demod_tiles_plain(mag, 58, cap=4096)
    assert int(want[3][:, 0].max()) < 4096
    offs = want[1][want[2]].cpu().numpy()
    for seam in range(8192, tiles * fused.TILE + 1, 8192):
        assert ((offs >= seam - 352) & (offs < seam)).any(), seam
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("halo", [False, True])
def test_fused_kernel_equals_plain_with_a_channel_layout(dev, halo):
    """seg_stride / seg_valid cut candidates per channel; scan_limit ends
    the scan inside the last tile."""
    tiles = 9
    mag = _bursty_noise(tiles, halo, 11).to(dev)
    kw = dict(cap=1016, seg_stride=131584, seg_valid=131072, scan_limit=tiles * fused.TILE - 70000)
    got = fused.fused_demod_tiles(mag, 58, **kw)
    want = fused.fused_demod_tiles_plain(mag, 58, **kw)
    assert want[2].any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
