"""The classifying extractions and the FUSE_CLASSIFY route against readsb_tpu.

extract_classify_v3's and extract_classify's plain versions are held to
extract_classify_v3_pallas and extract_classify_pallas in the Mosaic
interpreter (interpret=True) on a 0.2 s capture's win rows, on every row
and lane, as tests/test_pallas.py holds the Pallas kernels to the jnp
formulas; the static tables and the pick plan to readsb_tpu's; score_gate
fed the flags to score_gate computing the memberships and to readsb_tpu's;
and the pipeline under pipeline.FUSE_CLASSIFY to readsb_tpu's under the
same constant.  Tolerance 0 everywhere.
"""

import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import readsb_tpu.pipeline as jax_pipeline
from readsb_tpu.constants import TRAILING_SAMPLES
from readsb_tpu.ops import convert as jax_convert
from readsb_tpu.ops import demod as jax_demod
from readsb_tpu.ops import gate as jax_gate
from readsb_tpu.ops import pallas_kernels as pk
from readsb_tpu_torch import pipeline
from readsb_tpu_torch.ops import demod, gate, kernels
from readsb_tpu_torch.synth import build_standard_capture, quantize_sc16, quantize_uc8

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

PAIRS = [(1, True), (0, False)]
JAX_KERNELS = {
    "extract_classify_v3": pk.extract_classify_v3_pallas,
    "extract_classify": pk.extract_classify_pallas,
}


def frame_key(frames):
    return [(f.msg.hex(), f.timestamp) for f in frames]


def stats_key(s):
    return (s.preambles, s.rejected_bad, s.rejected_unknown_icao, list(s.accepted))


@pytest.fixture(scope="module")
def case():
    """Win rows, offsets and a known table of a 0.2 s capture, with the
    Pallas kernels' results made on demand, once each."""
    raw = quantize_uc8(build_standard_capture(duration_s=0.2, n_aircraft=3, seed=13).render_iq())
    mag = jax_convert.mag_uc8(jnp.asarray(raw))
    scan_len = (int(mag.shape[0]) - TRAILING_SAMPLES) // 512 * 512
    buf = mag[: scan_len + TRAILING_SAMPLES]
    k = 8192
    bc, cs_hi, cs_lo = jax_demod._demod_core(buf, 58, k=k, scan_len=scan_len, l=64)
    corrbits, pwords, _, _ = jax_demod._dense_stages_jnp(buf, 58)
    win, nv = jax_demod.win_rows(corrbits, pwords, scan_len)
    rows = win[jnp.clip(bc.offsets >> 8, 0, nv - 1)]
    # three live addresses (they occur as residuals) + sentinel padding
    tbl = np.full(256, jax_gate.TBL_SENTINEL, np.int32)
    tbl[:3] = [0x400000, 0x401111, 0x402222]

    @functools.lru_cache(maxsize=None)
    def pallas(name, nfix, fix_df):
        return np.asarray(JAX_KERNELS[name](
            rows, bc.offsets, jnp.asarray(tbl), nfix=nfix, fix_df=fix_df, interpret=True
        ))

    return dict(
        rows=np.asarray(rows), offsets=np.asarray(bc.offsets), tbl=tbl, n=int(bc.n_cand),
        scan_len=scan_len, bc=bc, cs_hi=cs_hi, cs_lo=cs_lo, pallas=pallas,
    )


@pytest.mark.parametrize("nfix,fix_df", [(1, True), (0, False), (2, True)])
def test_gate_tables_equal(nfix, fix_df):
    for got, want in zip(gate.gate_tables_np(nfix, fix_df), pk._gate_tables_np(nfix, fix_df)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert gate.GATE_SENTINEL == 0x2000000 and gate.TBL_SENTINEL == jax_gate.TBL_SENTINEL


def test_extract_plan_equals():
    plan, m = demod._extract_plan()
    jplan, jm = jax_demod._extract_plan()
    assert len(plan) == len(jplan)
    for (p, j, sh), (jp, jj, jsh) in zip(plan, jplan):
        assert (p, j) == (jp, jj)
        np.testing.assert_array_equal(sh, jsh)
    np.testing.assert_array_equal(m, jm)


def test_plan_words_decode_to_the_plan():
    """The kernel's packed plan is readsb_tpu's selection matrix, shifts and
    column permutation."""
    words = kernels.extract_plan_words_np()
    assert words.shape == (kernels.PLAN_WORDS,) and (words[560:] >> 18 == 7).all()
    w, sh = words[:560] & 63, (words[:560] >> 6) & 31
    bit, phase = (words[:560] >> 11) & 127, words[:560] >> 18
    sel, jsh, m1p, _ = pk._extract_v2_mats()
    np.testing.assert_array_equal(sel.argmax(0), w)
    np.testing.assert_array_equal(jsh, sh)
    comb = jax_demod._combined_matrix()
    for e in range(560):
        np.testing.assert_array_equal(m1p[e, phase[e] * 62 : phase[e] * 62 + 62], comb[bit[e]])


def test_plan_picks_the_taps_of_the_compile_time_schedule():
    """The plan-order datapath and cand_rows pick the same 560 (phase, bit)
    -> (plane, sample) taps: the packed plan, decoded, equals
    csrc/extract_taps.cuh read as text, as a map per (phase, bit)."""
    text = (pathlib.Path(kernels.CSRC) / "extract_taps.cuh").read_text()
    body = text[text.index("kTaps[5][112] = {"):]
    body = body[body.index("{"):body.index("};")]
    header = np.array([int(v) for v in re.findall(r"\d+", body)]).reshape(5, 112)
    words = kernels.extract_plan_words_np()[:560].astype(np.int64)
    w, sh = words & 63, (words >> 6) & 31
    bit, phase = (words >> 11) & 127, words >> 18
    taps = ((w // 11) << 9) | (32 * (w % 11) + sh)
    plan = {(int(p), int(b)): int(t) for p, b, t in zip(phase, bit, taps)}
    assert len(plan) == 560
    assert plan == {(p, b): int(header[p, b]) for p in range(5) for b in range(112)}


@pytest.mark.parametrize("nfix,fix_df", PAIRS)
@pytest.mark.parametrize("name", sorted(JAX_KERNELS))
def test_classify_plain_equals_pallas(case, name, nfix, fix_df):
    want = case["pallas"](name, nfix, fix_df)
    before = getattr(kernels, name).launches
    got = getattr(kernels, name)(
        torch.from_numpy(case["rows"].copy()), torch.from_numpy(case["offsets"].copy()),
        torch.from_numpy(case["tbl"].copy()), nfix=nfix, fix_df=fix_df,
    )
    assert getattr(kernels, name).launches == before  # a CPU tensor launches nothing
    assert 0 < case["n"] < len(case["offsets"])
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (8192, 128)
    np.testing.assert_array_equal(got.numpy(), want)  # sentinel rows included
    fl = got.numpy()[: case["n"], 83:88]
    if nfix == 1:
        assert (fl & 4).any() or (fl & 1).any()  # flags do fire on a real capture
    else:
        assert not (fl & 0b1011).any()


@pytest.mark.parametrize("k", [1, 33, 1000])
def test_classify_any_k(case, k):
    """K need not be a multiple of 512 or 1024 (the Pallas kernels' steps),
    and the two datapaths agree."""
    args = [torch.from_numpy(case[key][:k].copy()) for key in ("rows", "offsets")]
    tbl = torch.from_numpy(case["tbl"].copy())
    v3 = kernels.extract_classify_v3(*args, tbl)
    np.testing.assert_array_equal(v3.numpy(), case["pallas"]("extract_classify_v3", 1, True)[:k])
    assert torch.equal(kernels.extract_classify(*args, tbl), v3)
    assert torch.equal(v3[:, :83], kernels.extract_syndromes(*args)[:, :83])


def test_classify_nfix2_matches_gate_formulas(case):
    """nfix = 2 (thousands of table entries): flags equal the score gate's
    own membership formulas."""
    n = case["n"]
    rows, offs = (torch.from_numpy(case[key][:n].copy()) for key in ("rows", "offsets"))
    out = kernels.extract_classify_v3(rows, offs, torch.from_numpy(case["tbl"].copy()),
                                      nfix=2, fix_df=True).numpy()
    syn112, syn56, df = out[:, 0:5], out[:, 5:10], out[:, 10:80:14] >> 3
    fl = out[:, 83:88]
    np.testing.assert_array_equal((fl & 1) != 0, np.isin(syn112, gate._table_syndromes_np(112, 2)))
    np.testing.assert_array_equal((fl & 2) != 0, np.isin(syn56, gate._table_syndromes_np(56, 2)))
    resid = np.where(df >= 16, syn112, syn56) & 0xFFFFFF
    np.testing.assert_array_equal((fl & 4) != 0, np.isin(resid, case["tbl"][:3]))
    assert ((fl & 1) != 0).sum() > ((case["pallas"]("extract_classify_v3", 1, True)[:n, 83:88] & 1) != 0).sum()


def test_score_gate_with_flags_equals_without_and_jax(case):
    """score_gate fed the kernel's flags == score_gate computing the
    memberships == readsb_tpu's, every field."""
    jbc = case["bc"]
    comb = kernels.extract_classify_v3(
        torch.from_numpy(case["rows"].copy()), torch.from_numpy(case["offsets"].copy()),
        torch.from_numpy(case["tbl"].copy()),
    )
    bc = demod.BlockCandidates(**{
        f: torch.from_numpy(np.asarray(getattr(jbc, f)).copy())
        for f in demod.BlockCandidates._fields if getattr(jbc, f) is not None
    })
    np.testing.assert_array_equal(comb[:, 0:5].numpy(), bc.syn112.numpy())
    kw = dict(scan_len=case["scan_len"], k2=1024, nfix=1, fix_df=True, reset_every=131072)
    cs = [torch.from_numpy(np.asarray(case[c]).copy()) for c in ("cs_hi", "cs_lo")]
    tbl = torch.from_numpy(case["tbl"].copy())
    g0 = gate.score_gate(bc, tbl, *cs, case["scan_len"], **kw)
    g1 = gate.score_gate(bc._replace(flags=comb[:, 83:88]), tbl, *cs, case["scan_len"], **kw)
    jflags = jnp.asarray(case["pallas"]("extract_classify", 1, True)[:, 83:88])
    jg = jax_gate.score_gate(
        jbc._replace(flags=jflags), jnp.asarray(case["tbl"]), case["cs_hi"], case["cs_lo"],
        case["scan_len"], **kw,
    )
    assert int(g0.n_keep) > 0
    for f in g0._fields:
        a, b, j = getattr(g0, f), getattr(g1, f), getattr(jg, f)
        if a is None:
            assert b is None and j is None, f
            continue
        assert torch.equal(a, b), f
        np.testing.assert_array_equal(b.numpy(), np.asarray(j), err_msg=f)


@pytest.fixture(scope="module")
def blocks():
    """Two blocks of magnitudes of a 0.12 s capture, as numpy."""
    raw = quantize_uc8(build_standard_capture(duration_s=0.12, n_aircraft=4, seed=13).render_iq())
    mag = np.asarray(jax_convert.mag_uc8(jnp.asarray(raw)), np.uint16)
    return mag[: 2 * 131072], raw[: 4 * 131072]


def _port_process_mag(mag, **kw):
    d = pipeline.Demodulator(blocks_per_batch=2, use_gate=True, use_native=False,
                             device="cpu", **kw)
    frames = d.process_mag(mag) + d.flush()
    return frame_key(frames), stats_key(d.stats), d


def test_pipeline_fuse_classify_equals_readsb_tpu(blocks, monkeypatch):
    """Demodulator.process_mag under FUSE_CLASSIFY: the port's frames,
    timestamps and stats equal readsb_tpu's under the same constant (its
    kernels in the interpreter), and the port's own with the constant off."""
    mag, _ = blocks
    base = _port_process_mag(mag)
    monkeypatch.setattr(pk, "INTERPRET", True)
    monkeypatch.setattr(jax_pipeline, "FUSE_CLASSIFY", True)
    jax_pipeline._demod_and_gate.clear_cache()  # the constant is read when tracing
    try:
        jd = jax_pipeline.Demodulator(blocks_per_batch=2, use_gate=True, use_native=False)
        jframes = jd.process_mag(mag) + jd.flush()
    finally:
        monkeypatch.undo()
        jax_pipeline._demod_and_gate.clear_cache()
    calls = []
    real = kernels.extract_classify_v3
    monkeypatch.setattr(kernels, "extract_classify_v3",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pipeline.FUSE_CLASSIFY = True
    try:
        got = _port_process_mag(mag)
    finally:
        pipeline.FUSE_CLASSIFY = False
    assert calls, "the FUSE_CLASSIFY route did not reach extract_classify_v3"
    assert len(got[0]) > 0
    assert got[0] == frame_key(jframes) and got[1] == stats_key(jd.stats)
    assert got[:2] == base[:2]


@pytest.mark.parametrize("nfix,fix_df", [(0, False), (2, True)])
def test_pipeline_fuse_classify_other_tables(blocks, nfix, fix_df):
    mag, _ = blocks
    base = _port_process_mag(mag, nfix=nfix, fix_df=fix_df)
    pipeline.FUSE_CLASSIFY = True
    try:
        got = _port_process_mag(mag, nfix=nfix, fix_df=fix_df)
    finally:
        pipeline.FUSE_CLASSIFY = False
    assert got[:2] == base[:2] and len(base[0]) > 0


def _run_raw(raw, **kw):
    d = pipeline.Demodulator(blocks_per_batch=2, use_native=False, device="cpu", **kw)
    assert d.raw_route
    frames = d.feed(bytes(raw)) + d.flush()
    return frame_key(frames), stats_key(d.stats)


def _run_multi(fmt):
    caps = [build_standard_capture(0.12, 3, s).render_iq() for s in (5, 6, 7, 8)]
    quant = quantize_uc8 if fmt == "uc8" else quantize_sc16
    chunks = [quant(iq).tobytes() for iq in caps]
    m = pipeline.MultiDemodulator(4, fmt=fmt, blocks_per_batch=1, use_native=False, device="cpu")
    out = m.feed(chunks)
    for c, t in enumerate(m.flush()):
        out[c].extend(t)
    return [frame_key(f) for f in out], [stats_key(m.channel_stats(c)) for c in range(4)], m


def test_raw_route_fuse_classify_equals_staged(blocks):
    _, raw = blocks
    base = _run_raw(raw)
    pipeline.FUSE_CLASSIFY = True
    try:
        got = _run_raw(raw)
    finally:
        pipeline.FUSE_CLASSIFY = False
    assert got == base and len(base[0]) > 0


@pytest.mark.parametrize("fmt", ["uc8", "sc16"])
def test_multidemodulator_fuse_classify_equals_staged(fmt):
    base = _run_multi(fmt)
    pipeline.FUSE_CLASSIFY = True
    try:
        got = _run_multi(fmt)
    finally:
        pipeline.FUSE_CLASSIFY = False
    assert got[:2] == base[:2] and sum(map(len, base[0])) > 0


@pytest.mark.parametrize(
    "call",
    [lambda r, o, t: kernels.extract_classify_v3(r, o, t[:100]),
     lambda r, o, t: kernels.extract_classify_v3(r, o, t.to(torch.int64)),
     lambda r, o, t: kernels.extract_classify_v3(r[:, :64], o, t),
     lambda r, o, t: kernels.extract_classify(r, o[:2], t),
     lambda r, o, t: kernels.extract_classify(r.to(torch.int64), o, t),
     lambda r, o, t: kernels.extract_classify(r, o, t.reshape(2, 64))],
    ids=["v3-table-length", "v3-table-dtype", "v3-rows-shape", "v2-offsets-shape",
         "v2-rows-dtype", "v2-table-rank"],
)
def test_classify_wrappers_reject_bad_input(call):
    rows = torch.zeros((4, 128), dtype=torch.int32)
    offs = torch.zeros(4, dtype=torch.int32)
    tbl = torch.full((128,), gate.TBL_SENTINEL, dtype=torch.int32)
    with pytest.raises(ValueError):
        call(rows, offs, tbl)
