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
    """A tensor on each card launches there: the library is made ready on
    every device a tensor reaches it on, whatever device is current."""
    for index in range(torch.cuda.device_count()):
        words = torch.full((65536,), 0x8080, dtype=torch.uint16, device=f"cuda:{index}")
        before = kernels.mag_uc8.launches
        with torch.cuda.device(torch.cuda.device_count() - 1 - index):
            mag = kernels.mag_uc8(words)
        assert kernels.mag_uc8.launches == before + 1
        assert mag.device == words.device and mag.tolist() == [363] * 65536
        assert ("mag_uc8", index) in kernels._ready
        kernels.check_device(words.device, "mag_uc8")


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


# --- the device arena and the device CPR cores --------------------------------


def _arena_msgs(seed=3, n_ac=30, n_msgs=1500, t0=1_760_000_000_000):
    """A time-ordered stream of ModesMessages with lattice fields, altitude
    excursions, squawk churn, callsigns and CPR pairs, at epoch ms."""
    from readsb_tpu_torch.decode.cpr import encode_cpr
    from readsb_tpu_torch.decode.fields import CprType, ModesMessage, Source
    from readsb_tpu_torch.track.arena import ATTR_OF, FIELDS

    rng = np.random.default_rng(seed)
    addrs = [0x4A0000 + i for i in range(n_ac)]
    msgs, t = [], t0
    for i in range(n_msgs):
        t += int(rng.integers(5, 120))
        # two thirds of the aircraft fall silent halfway (the sweep frees them)
        k = int(rng.integers(len(addrs) if 2 * i < n_msgs else len(addrs) // 3))
        src = Source(int(rng.choice([Source.MODE_S, Source.ADSB, Source.MLAT])))
        mm = ModesMessage(msgtype=17, addr=addrs[k], source=src, sys_timestamp_ms=t)
        for name in FIELDS:
            if rng.random() < 0.2:
                setattr(mm, ATTR_OF[name], float(np.float32(rng.uniform(-500, 500))))
        if rng.random() < 0.3:
            mm.baro_alt = 10_000 + 50 * i + int(rng.choice([0, 0, 0, 30_000]))
            mm.alt_q_bit, mm.crc = 1, int(rng.random() < 0.3)
        if rng.random() < 0.2:
            mm.squawk_hex = int(rng.choice([0x1200, 0x7700, 0x2000]))
        if rng.random() < 0.1:
            mm.callsign = "CS" + str(int(rng.integers(100, 999)))
        if rng.random() < 0.5:
            odd = int(rng.integers(2))
            surf = rng.random() < 0.2
            lat, lon = 47.0 + 0.05 * k + 1e-5 * i, 8.0 + 0.05 * k
            mm.cpr_lat, mm.cpr_lon = encode_cpr(lat, lon, odd, surface=surf)
            mm.cpr_valid, mm.cpr_odd = True, bool(odd)
            mm.cpr_type = CprType.SURFACE if surf else CprType.AIRBORNE
            mm.metype = 6 if surf else 11
        msgs.append(mm)
    return msgs


def test_arena_update_and_sweep_on_the_card_equal_the_cpu(dev):
    from readsb_tpu_torch.track.arena import Arena

    msgs = _arena_msgs()
    arenas = [Arena(n=4096, receiver_lat=47.5, receiver_lon=8.5, device=d) for d in (dev, "cpu")]
    for ar in arenas:
        i = 0
        rng = np.random.default_rng(1)
        while i < len(msgs):
            j = min(len(msgs), i + int(rng.integers(30, 400)))
            ar.update_batch(msgs[i:j])
            i = j
    card, cpu = arenas
    for a, b in zip(card.state, cpu.state):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a.cpu(), b)
    decodes = card.pop_cpr_decodes()
    assert decodes == cpu.pop_cpr_decodes() and len(decodes) > 100
    now = msgs[-1].sys_timestamp_ms + 5 * 60_000 - 20_000
    assert card.sweep(now) == cpu.sweep(now) > 0
    for a, b in zip(card.state, cpu.state):
        assert torch.equal(a.cpu(), b)
    assert card.slot_of == cpu.slot_of and card.free == cpu.free


def test_cpr_cores_on_the_card_equal_the_cpu(dev):
    from readsb_tpu_torch.ops import cpr_device

    rng = np.random.default_rng(5)
    n = 1 << 15
    cols = [torch.from_numpy(rng.integers(0, 1 << 17, n).astype(np.int32)) for _ in range(4)]
    f = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    s = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    q = cpr_device.surface_quadrant_consts(46.0)
    c = cpr_device.relative_consts(46.0, 7.0)
    runs = (
        lambda x, d: cpr_device.decode_airborne_core(*x, f.to(d)),
        lambda x, d: cpr_device.decode_surface_core(*x, f.to(d), q["zneg"], q["zpos"], q["t0"], q["t1"]),
        lambda x, d: cpr_device.decode_relative_core(
            x[0], x[1], f.to(d), s.to(d), cpr_device.relative_consts_on(c, d)),
    )
    for run in runs:
        got = run([x.to(dev) for x in cols], dev)
        want = run(cols, torch.device("cpu"))
        for k in want:
            assert got[k].device.type == "cuda" and torch.equal(got[k].cpu(), want[k]), k


def test_arena_refuses_a_batch_on_another_device(dev):
    from readsb_tpu_torch.track import arena as arena_mod

    st = arena_mod.empty_arena(512, dev)
    cols = {k: np.zeros((256,) + ((arena_mod.NFIELDS,) if k in ("fmask", "fval") else
                                 (2,) if k == "cs" else ()), dt)
            for k, dt in arena_mod._BATCH_DTYPES.items()}
    cols["slot"][:] = -1
    with pytest.raises(ValueError, match="on the arena's device"):
        arena_mod.arena_update(st, arena_mod.upload_batch(cols, "cpu"), 1)
    st, ys = arena_mod.arena_update(st, arena_mod.upload_batch(cols, dev), 1)
    assert ys.device.type == "cuda" and tuple(ys.shape) == (1, 512, 12)


# --- the SDR sources and persistence ------------------------------------------


class FakeSource:
    """The interface of io/sdr.py's sources (open, start(loop), queue,
    dropped_buffers, close) over a capture's bytes: SDR_BUF_BYTES pieces,
    then the b"" end marker.  Lossless: it waits for room in the queue."""

    def __init__(self, data: bytes):
        import asyncio

        from readsb_tpu_torch.io.sdr import SDR_BUF_BYTES, SDR_N_BUFFERS

        self.data, self.piece = data, SDR_BUF_BYTES
        self.queue = asyncio.Queue(maxsize=SDR_N_BUFFERS)
        self.dropped_buffers = 0
        self.opened = self.closed = False
        self.task = None

    def open(self) -> None:
        self.opened = True

    def start(self, loop) -> None:
        self.task = loop.create_task(self._feed())

    async def _feed(self) -> None:
        for i in range(0, len(self.data), self.piece):
            await self.queue.put(self.data[i:i + self.piece])
        await self.queue.put(b"")

    def close(self) -> None:
        self.closed = True


def _sdr_app(device: str, fmt_argv: list[str], data: bytes, fmt: str, monkeypatch, extra=()):
    """The port's App on `device` through _run_sdr_source over `data`."""
    import asyncio

    from readsb_tpu_torch.app import main

    if device == "cpu":
        monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    else:
        monkeypatch.delenv("READSB_TPU_PLATFORM", raising=False)
    app = main.App(main.parse_args([*fmt_argv, "--blocks-per-batch", "1", *extra]))
    app.epoch_ms = 1_760_000_000_000
    frames = []

    def keep(fr, epoch_ms, _decode=main.decode_frame):
        frames.append((fr.msg, fr.timestamp, fr.phase, fr.score, fr.signal_power))
        return _decode(fr, epoch_ms=epoch_ms)

    async def go():
        app._exit_event = asyncio.Event()
        await asyncio.wait_for(app._run_sdr_source(FakeSource(data), fmt), 300)

    with monkeypatch.context() as m:
        m.setattr(main, "decode_frame", keep)
        asyncio.run(go())
    return app, frames


SDR_ROUTES = {"uc8": (["--device-type", "rtlsdr"], 1.0),
              "sc16": (["--device-type", "soapy"], 1.0),
              "sc16q11": (["--device-type", "bladerf"], 1 / 16)}


def _sdr_bytes(route: str) -> bytes:
    from readsb_tpu_torch.synth import build_traffic_capture, quantize_sc16, quantize_uc8

    iq = build_traffic_capture(1.0, 8, 71).render_iq() * SDR_ROUTES[route][1]
    return (quantize_uc8(iq) if route == "uc8" else quantize_sc16(iq)).tobytes()


@pytest.mark.parametrize("route", list(SDR_ROUTES))
def test_sdr_source_on_the_card_equals_the_cpu(dev, route, monkeypatch):
    from readsb_tpu_torch.io import json_out

    data = _sdr_bytes(route)
    runs = [_sdr_app(d, SDR_ROUTES[route][0], data, route, monkeypatch) for d in ("cuda", "cpu")]
    (card, card_frames), (cpu, cpu_frames) = runs
    assert card._demod.device.type == "cuda" and cpu._demod.device.type == "cpu"
    assert card_frames == cpu_frames and len(card_frames) > 50
    now = card.now_ms()
    assert now == cpu.now_ms()
    assert (json_out.generate_aircraft_json(card.tracker, now, card.messages)
            == json_out.generate_aircraft_json(cpu.tracker, now, cpu.messages))


def test_state_saved_on_the_card_loads_into_a_fresh_card_app(dev, tmp_path, monkeypatch):
    from readsb_tpu_torch.app import main
    from readsb_tpu_torch.io import state as state_io

    d = str(tmp_path / "state")
    app, _ = _sdr_app("cuda", SDR_ROUTES["uc8"][0], _sdr_bytes("uc8"), "uc8", monkeypatch,
                      extra=("--write-state", d))
    n = state_io.save_state(app.tracker, d, app.now_ms())
    assert n == len(app.tracker.aircraft) >= 8
    monkeypatch.delenv("READSB_TPU_PLATFORM", raising=False)
    fresh = main.App(main.parse_args(["--device-type", "rtlsdr", "--write-state", d]))
    assert fresh.device.type == "cuda"
    assert (sorted(repr(a) for a in fresh.tracker.aircraft.values())
            == sorted(repr(a) for a in app.tracker.aircraft.values()))


# --- history ------------------------------------------------------------------------


def _history_files(root) -> dict:
    """{relative path: content} under root, trace files and heatmaps
    gunzipped and globe tiles zstd-decompressed (their bytes need not be
    equal: gzip stamps the time); state blobs are left out."""
    import gzip
    import os

    from readsb_tpu_torch.io import zstd

    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            rel = os.path.relpath(p, root)
            if rel.startswith("state"):
                continue
            data = open(p, "rb").read()
            if data[:2] == b"\x1f\x8b":
                data = gzip.decompress(data)
            elif data[:4] == b"\x28\xb5\x2f\xfd":
                data = zstd.decompress(data)
            out[rel] = data
    return out


def _history_outputs(app, root) -> dict:
    """The exit sweep's trace files, the globe tiles, the half hour's
    heatmap and the reloaded state of `app`, at its clock."""
    import os

    from readsb_tpu_torch.io import history, state
    from readsb_tpu_torch.track import tracker

    now = app.now_ms()
    os.makedirs(os.path.join(root, "json"))
    history.write_traces(app.tracker, os.path.join(root, "json"), now, time_budget_s=None)
    history.write_globe_bincraft(app.tracker, os.path.join(root, "json"), now)
    start = now // 1_800_000 * 1_800_000
    history.write_heatmap(app.tracker, os.path.join(root, "hist"), start, start + 1_800_000,
                          interval_ms=1000)
    state.save_state(app.tracker, os.path.join(root, "state"), now)
    back = tracker.Tracker()
    n = state.load_state(back, os.path.join(root, "state"))
    full = {a.addr: [vars(s) for s in a.trace.full()] for a in back.aircraft.values()
            if a.trace is not None}
    return {"files": _history_files(root), "state": (n, full)}


def test_history_of_the_sdr_app_on_the_card_equals_the_cpu(dev, tmp_path, monkeypatch):
    """The uc8 SDR route with --json-globe-index, --heatmap and --db-file on
    the card and on the CPU: traces, trace files, tiles, heatmap, state."""
    import gzip

    from readsb_tpu_torch.io import json_out

    db = str(tmp_path / "aircraft.csv.gz")
    with gzip.open(db, "wt") as f:
        for k in range(8):
            f.write(f"{0x400000 + 0x101 * (k + 1):06X};HB-{k:03d};A320;1;;;\n")
    extra = ("--json-globe-index", "--json-trace-interval", "1", "--heatmap", "1", "--db-file", db)
    data = _sdr_bytes("uc8")
    outs = []
    for device in ("cuda", "cpu"):
        app, frames = _sdr_app(device, SDR_ROUTES["uc8"][0], data, "uc8", monkeypatch, extra)
        assert app.tracker.keep_traces and len(frames) > 50
        now = app.now_ms()
        outs.append((json_out.generate_aircraft_json(app.tracker, now, app.messages),
                     _history_outputs(app, str(tmp_path / device))))
    assert outs[0] == outs[1]
    doc, hist = outs[0]
    assert sum(a.get("r", "").startswith("HB-") for a in doc["aircraft"]) >= 6
    assert sum(k.startswith("json/traces/") for k in hist["files"]) >= 2 * 6
    assert any("/heatmap/" in k for k in hist["files"]) and hist["state"][0] >= 8


def test_device_arena_traces_on_the_card_equal_the_cpu(dev, tmp_path, monkeypatch):
    """An aggregator on the columnar drain with --device-arena and
    --json-globe-index, its arena on the card and on the CPU: traces,
    trace files, tiles and state are equal."""
    import asyncio

    from readsb_tpu_torch import synth
    from readsb_tpu_torch.app import bulk_drain, main
    from readsb_tpu_torch.io import beast
    from readsb_tpu_torch.track import arena as arena_mod

    t0 = 1_760_000_000_000
    wire = []
    for i in range(4000):
        ac, seq = i % 80, i // 80
        addr = 0x4A0000 + ac
        if seq % 5 < 3:
            msg = synth.encode_df17_position(addr, 49.0 + ac * 0.01 + i * 1e-5, 3.0 + ac * 0.01,
                                             20000 + ac * 100, seq & 1)
        elif seq % 5 == 3:
            msg = synth.encode_df17_velocity(addr, 300, 10.0, 0)
        else:
            msg = synth.encode_df17_ident(addr, f"AR{ac:04d}")
        wire.append(beast.encode_synthetic_ts(t0 + 250 * i)
                    + beast.encode_frame(msg, i * 3000, 0.3))
    wire = b"".join(wire)
    now = t0 + 250 * 4000
    outs = []
    for device in ("cuda", "cpu"):
        if device == "cpu":
            monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
        else:
            monkeypatch.delenv("READSB_TPU_PLATFORM", raising=False)
        app = main.App(main.parse_args(["--net-only", "--quiet", "--lat", "49.5", "--lon", "3.5",
                                        "--device-arena", "--json-globe-index"]))
        app.arena = arena_mod.Arena(n=1024, receiver_lat=49.5, receiver_lon=3.5,
                                    device=app.device)
        app.now_ms = lambda: now
        conn = app._beast_input_factory()()

        async def pump():
            for k in range(0, len(wire), 8192):
                await asyncio.wait_for(conn.feed(wire[k:k + 8192]), 60)
                app.drain_net_queue()
                bulk_drain.materialize(app, now)
                bulk_drain.materialize_arena(app, now)

        asyncio.run(pump())
        assert app.arena.state.seen.device.type == device
        outs.append(_history_outputs(app, str(tmp_path / device)))
    assert outs[0] == outs[1]
    assert len(outs[0]["state"][1]) == 80


# --- the sharded mesh ------------------------------------------------------------


def _mesh_stream():
    from readsb_tpu_torch.parallel.dryrun import place_frame

    rng = np.random.default_rng(3)
    s = rng.integers(0, 3000, size=(4, 4 * 8192), dtype=np.uint16)
    for ch in range(4):
        place_frame(s[ch], 900 + 41 * ch, 0xD00000 + ch, 0)
        place_frame(s[ch], 8192 - 80, 0xD00000 + ch, 1)
    return s


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_mesh_on_the_card_equals_the_cpu(dev, gated):
    """Both programs on eight slots of cuda:0 equal their run on
    ["cpu"] * 8, every field; the card run launches #4 and #2 (ungated) or
    #4 and #5 (gated) and no other kernel."""
    from readsb_tpu_torch.parallel import mesh as pmesh

    s = _mesh_stream()
    tbl = np.full(128, gate.TBL_SENTINEL, np.int32)

    def run(devices):
        mesh = pmesh.make_mesh(2, 4, devices)
        if gated:
            return pmesh.build_sharded_gated_demod(mesh, k_per_shard=512)(s, tbl)
        return pmesh.build_sharded_demod(mesh, k_per_shard=512)(s)

    want = run(["cpu"] * 8)
    wrappers = {n: getattr(kernels, n) for n in ("dense_scan_uc8", "extract_syndromes", "mag_uc8",
                                                 "dense_scan", "extract_classify_v3",
                                                 "extract_classify")}
    wrappers["fused_demod"] = fused.fused_demod_tiles
    before = {n: w.launches for n, w in wrappers.items()}
    got = run(["cuda:0"] * 8)
    launched = {n for n, w in wrappers.items() if w.launches > before[n]}
    assert launched == ({"dense_scan", "extract_classify_v3"} if gated
                        else {"dense_scan", "extract_syndromes"})
    assert wrappers["dense_scan"].launches - before["dense_scan"] == 8 * 2  # one per row
    for f in got._fields:
        g = getattr(got, f)
        assert g.device.type == "cuda" and torch.equal(g.cpu(), getattr(want, f)), f


def test_mesh_dryrun_on_the_card(dev):
    from readsb_tpu_torch.parallel.dryrun import dryrun_multichip

    out, gout = dryrun_multichip(8)
    cpu, gcpu = dryrun_multichip(8, device="cpu")
    for a, b in ((out, cpu), (gout, gcpu)):
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


def test_mesh_two_process_run_on_the_card(dev):
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-m", "readsb_tpu_torch.parallel.dcn_dryrun"],
                       cwd=str(root), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dcn_dryrun OK" in r.stdout and "on cuda" in r.stdout


def test_mesh_over_two_cards_equals_one_card(dev):
    """Unverified on a one-card machine: it skips there."""
    from readsb_tpu_torch.parallel import mesh as pmesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    s = _mesh_stream()
    tbl = np.full(128, gate.TBL_SENTINEL, np.int32)
    two = ["cuda:0", "cuda:1"] * 4
    one = ["cuda:0"] * 8
    for build in (lambda m: pmesh.build_sharded_demod(m, k_per_shard=512)(s),
                  lambda m: pmesh.build_sharded_gated_demod(m, k_per_shard=512)(s, tbl)):
        a = build(pmesh.make_mesh(2, 4, two))
        b = build(pmesh.make_mesh(2, 4, one))
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f


def _wrapper_counts() -> dict:
    wrappers = {n: getattr(kernels, n) for n in ("dense_scan_uc8", "extract_syndromes", "mag_uc8",
                                                 "dense_scan", "extract_classify_v3",
                                                 "extract_classify")}
    wrappers["fused_demod"] = fused.fused_demod_tiles
    return {n: w.launches for n, w in wrappers.items()}


def test_graft_entry_on_the_card_equals_the_cpu(dev):
    """entry()'s step on the card equals its CPU run in every field, and
    launches #4 and #2 once per block and no other kernel."""
    from readsb_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    assert args[0].is_cuda
    before = _wrapper_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    after = _wrapper_counts()
    launched = {n: after[n] - before[n] for n in after if after[n] > before[n]}
    assert launched == {"dense_scan": 4, "extract_syndromes": 4}
    cfn, cargs = graft_entry.entry(device="cpu")
    want = cfn(*cargs)
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        assert w is None or (g.is_cuda and torch.equal(g.cpu(), w)), f


def test_bench_dispatch_on_the_card_equals_the_cpu(dev):
    """One dispatch of the bench (4 channels) on the card equals the same
    dispatch on the CPU in every field and launches #1 and #2 once each."""
    from readsb_tpu_torch import bench

    raw, _, _ = bench.build_workload(4)
    chunks = [bytes(raw[c * 262144 : (c + 1) * 262144]) for c in range(4)]
    outs = {}
    for device in ("cpu", dev):
        multi = MultiDemodulator(4, blocks_per_batch=1, device=device)
        multi.feed(chunks)
        words = torch.from_numpy(raw.view("<u2").reshape(4, -1).copy()).to(device)
        dispatch = bench.make_dispatch(multi, words)
        before = _wrapper_counts()
        outs[device] = dispatch()
        after = _wrapper_counts()
    torch.cuda.synchronize()
    assert {n: after[n] - before[n] for n in after if after[n] > before[n]} == {
        "dense_scan_uc8": 1, "extract_syndromes": 1}
    got, want = outs[dev], outs["cpu"]
    assert int(want.n_keep) > 0
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        assert w is None or (g.is_cuda and torch.equal(g.cpu(), w)), f


def test_the_staging_buffer_is_pinned_and_kept(dev):
    m = MultiDemodulator(4, fmt="sc16", blocks_per_batch=1, use_native=False, device=dev)
    ptr = m._staging.data_ptr()
    assert m._staging.is_pinned() and m._copied is not None
    caps = [quantize_sc16(build_standard_capture(0.2, 2, s).render_iq()).tobytes()
            for s in range(4)]
    m.feed(caps)
    assert m.pinned == m.superblocks >= 3 and m._staging.data_ptr() == ptr
    assert m._copied.query()


@pytest.mark.parametrize("at_once", [False, True], ids=["per_superblock", "at_once"])
@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_staged_card_run_equals_the_cpu_run(dev, fmt, at_once):
    """Four channels over five superblocks and a flush, fed one superblock
    per call or all in one call (the buffer is written again while the
    call goes on: after the event of its last copy)."""
    caps = [build_standard_capture(0.3, 3, s) for s in (11, 12, 13, 14)]
    if fmt == "sc16":
        raws = [quantize_sc16(c.render_iq()).tobytes() for c in caps]
    else:
        raws = [bytes(c.render_uc8()) for c in caps]

    def run(device):
        m = MultiDemodulator(4, fmt=fmt, blocks_per_batch=1, use_native=False, device=device)
        step = m.seg_valid * pipeline.BYTES_PER_SAMPLE[fmt]
        n = len(raws[0]) // step
        calls = [raws] if at_once else [[r[i * step:(i + 1) * step] for r in raws]
                                        for i in range(n + 1)]
        out = [[] for _ in range(4)]
        for call in calls:
            for c, got in enumerate(m.feed(call)):
                out[c].extend(got)
        assert m.pinned == m.superblocks == n >= 3
        for c, got in enumerate(m.flush()):
            out[c].extend(got)
        return out, [vars(m.channel_stats(c)) for c in range(4)]

    card = run(dev)
    assert card == run("cpu") and sum(map(len, card[0])) > 10


@pytest.fixture(scope="module")
def quiet64():
    """The benchmark's quiet kind of traffic on 64 sc16 receivers, eight
    aircraft each: two superblocks of four blocks per receiver."""
    n = 2 * 4 * 131072
    return [quantize_sc16(build_standard_capture(n / 2.4e6 + 0.01, 8, 300 + c).render_iq())
            .tobytes()[: n * 4] for c in range(64)]


def test_score_gate_at_64_channels_does_not_sync(dev, quiet64):
    """One 64-channel score_gate call under sync debug mode "error": the
    exact teach set (a sort and a binary search) adds no host sync."""
    m = MultiDemodulator(64, fmt="sc16", blocks_per_batch=4, device=dev)
    step = m.seg_valid * 4
    first = [r[:step] for r in quiet64]
    m.feed(first)  # builds the kernels and sends the gate's tables
    words = torch.from_numpy(np.stack([np.frombuffer(r, np.int16) for r in first])).to(dev)
    mags = convert.mag_sc16(words).reshape(64, m.seg_valid)
    buf = pipeline.multi_buffer(mags, torch.zeros((64, 326), dtype=torch.uint16, device=dev),
                                m.seg_stride, m.seg_valid)
    bc, hi, lo = demod._demod_core(buf, m.threshold, k=m.k, scan_len=m.scan_len, l=m.compact_l,
                                   seg_stride=m.seg_stride, seg_valid=m.seg_valid,
                                   nfix=m.nfix, fix_df=m.fix_df)
    tbl = m.mirror.tbl
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gc = gate.score_gate(bc, tbl, hi, lo, m.seg_valid, scan_len=m.scan_len, k2=m.gate_k2,
                             nfix=m.nfix, fix_df=m.fix_df, reset_every=m.block_samples,
                             seg_stride=m.seg_stride, keep_l=m.gate_keep_l)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_keep, n_cand = int(gc.n_keep), int(gc.n_cand)
    assert n_cand > 100_000 and 0 < n_keep < 0.02 * n_cand


def test_multidemodulator_64_quiet_keeps_its_first_gate_k2(dev, quiet64):
    """64 quiet sc16 receivers over two superblocks: the gate keeps under
    2% of the candidates, within the first gate_k2 (4096), never redone."""
    m = MultiDemodulator(64, fmt="sc16", blocks_per_batch=4, device=dev)
    assert m.gate_k2 == 4096
    frames = m.feed(quiet64)
    assert m.superblocks == 2 and m.redispatches == 0 and m.gate_k2 == 4096
    assert 0 < m.kept < 0.02 * m.candidates and sum(map(len, frames)) > 1000
