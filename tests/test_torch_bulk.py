"""The port's columnar ingest against readsb_tpu's, at tolerance 0: the
columnar Beast deframer (native and bridged), the CRC / accept stage
(`accept_columns`), the batch decoder (`decode_columns`), the vectorized
globe index and the columnar `BulkTracker` with its receiver store.

The streams are those of readsb_tpu's own tests (test_native_beast.py,
test_netaccept.py, test_batch_fuzz.py, test_bulk.py,
test_bulk_aggregator.py, test_bulk_adversarial.py), made from numpy
seeds; the same columns go through both packages.
"""

import copy

import numpy as np
import pytest
import torch

from readsb_tpu.decode import batch as jax_batch
from readsb_tpu.decode import netaccept as jax_netaccept
from readsb_tpu.decode.score import Scorer as JaxScorer
from readsb_tpu.io import beast as jax_beast
from readsb_tpu.track import bulk as jax_bulk
from readsb_tpu.track import globe as jax_globe
from readsb_tpu.track.receiver import ReceiverStore as JaxReceiverStore
from readsb_tpu_torch.decode import batch, netaccept
from readsb_tpu_torch.decode.score import Scorer
from readsb_tpu_torch.io import beast
from readsb_tpu_torch.ops import crc
from readsb_tpu_torch.track import bulk, globe
from readsb_tpu_torch.track.receiver import ReceiverStore
from tests import test_bulk_adversarial, test_bulk_aggregator, test_netaccept

torch.set_num_threads(1)


# --- the columnar Beast deframer ----------------------------------------------


def _beast_stream(rng, n_frames=600):
    """Beast bytes: frames of 2 ('1', Mode A/C), 7 and 14 bytes with random
    payloads (so 0x1A escapes), receiver-id and 0xE8 synthetic-time
    prefixes, UUID frames, 'P' and 'W' command tokens and junk."""
    out = b""
    for _ in range(n_frames):
        k = int(rng.integers(10))
        if k == 0:
            out += jax_beast.encode_receiver_id(int(rng.integers(1, 1 << 60)))
        elif k == 1:
            out += jax_beast.encode_synthetic_ts(int(rng.integers(1, 1 << 45)))
        elif k == 2:
            out += b"\x1aP" + bytes(rng.integers(0, 256, 3, np.int64).astype(np.uint8))
        elif k == 3:
            out += b"\x1aW" + bytes(rng.integers(0, 256, 1, np.int64).astype(np.uint8))
        elif k == 4:
            out += b"\x1a\xe4" + bytes(16)
        elif k == 5:
            out += bytes(rng.integers(0, 256, rng.integers(1, 6), np.int64).astype(np.uint8))
        else:
            mlen = [2, 7, 14, 14][int(rng.integers(4))]
            msg = bytes(rng.integers(0, 256, mlen, np.int64).astype(np.uint8))
            out += jax_beast.encode_frame(msg, int(rng.integers(0, 1 << 47)),
                                          signal_level=int(rng.integers(0, 256)) / 255.0,
                                          modeac=mlen == 2)
    return out


def _feed_all(deframer, rng, data):
    batches = []
    i = 0
    while i < len(data):
        n = int(rng.integers(1, 700))  # splits frames and escapes anywhere
        got = deframer.feed(data[i:i + n])
        if got is not None:
            batches.append(got)
        i += n
    cols = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    state = (deframer.receiver_id, deframer.synthetic_ms, deframer.frames_bad,
             list(deframer.commands))
    return cols, state


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "bridge"])
def test_columnar_deframer_equals_readsb_tpu(seed, use_native):
    """The same stream, split at the same random points: the port's columns
    and connection state equal readsb_tpu's native columnar deframer's."""
    data = _beast_stream(np.random.default_rng(seed))
    want, want_state = _feed_all(jax_beast.ColumnarDeframer(cap=64),
                                 np.random.default_rng(100 + seed), data)
    got, got_state = _feed_all(beast.ColumnarDeframer(cap=64, use_native=use_native),
                               np.random.default_rng(100 + seed), data)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got_state == want_state
    assert (want["mlen"] == 2).sum() > 20 and len(want_state[3]) > 20


def test_columnar_deframer_raises_without_its_native_scanner(monkeypatch):
    """The native scanner is built with g++ at first use; where it cannot
    be, the deframer raises and never takes the Python bridge unasked."""
    from readsb_tpu_torch import native

    assert beast.ColumnarDeframer()._native is not None
    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="native Beast deframer"):
        beast.ColumnarDeframer()
    assert beast.ColumnarDeframer(use_native=False)._py is not None


# --- accept_columns and decode_columns ------------------------------------------


def _rows(msgs):
    arr = np.zeros((len(msgs), 14), np.uint8)
    for i, m in enumerate(msgs):
        arr[i, :len(m)] = np.frombuffer(m, np.uint8)
    return arr


def _equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert g == w, k


@pytest.mark.parametrize("nfix,fix_df", [(1, True), (2, True), (0, False)])
def test_accept_columns_equals_readsb_tpu(nfix, fix_df):
    """readsb_tpu's netaccept stream (clean, corrupted and residual-addressed
    frames, some before their teaching DF17) through both scorers twice, so
    the second batch sees the addresses the first one taught."""
    scorers = (JaxScorer(nfix=nfix, fix_df=fix_df), Scorer(nfix=nfix, fix_df=fix_df))
    for rep in range(2):
        arr = _rows(test_netaccept._mkstream(np.random.default_rng(1234 + nfix + rep)))
        syn112 = crc.checksum_batch(arr, 112)
        syn56 = crc.checksum_batch(np.ascontiguousarray(arr[:, :7]), 56)
        want = jax_netaccept.accept_columns(scorers[0], arr, syn112, syn56)
        got = netaccept.accept_columns(scorers[1], arr, syn112, syn56)
        _equal_dicts(got, want)
        for sc, res in zip(scorers, (want, got)):
            for ad in res["learned"]:
                sc.icao.add(int(ad))
        assert (want["result"] == 0).sum() > 100


def test_decode_columns_equals_readsb_tpu():
    """readsb_tpu's decode fuzz (random bytes under a plausible DF mix) and
    real encodings: every column equal."""
    rng = np.random.default_rng(11)
    n = 4000
    msgs = rng.integers(0, 256, size=(n, 14), dtype=np.int64).astype(np.uint8)
    dfs = rng.choice([0, 4, 5, 11, 17, 18, 20, 21, 24], size=n)
    msgs[:, 0] = (dfs << 3 | (msgs[:, 0] & 7)).astype(np.uint8)
    real = _rows(test_netaccept._mkstream(np.random.default_rng(5), n=600))
    msgs = np.concatenate([msgs, real])
    addrs = rng.integers(1, 1 << 24, size=len(msgs), dtype=np.int64)
    ts = np.arange(len(msgs), dtype=np.int64) * 7 + 1_760_000_000_000
    corrected = rng.integers(0, 3, len(msgs))
    want = jax_batch.decode_columns(msgs, ts, addrs, corrected)
    got = batch.decode_columns(msgs, ts, addrs, corrected)
    _equal_dicts(got, want)
    assert want["cpr_valid"].sum() > 100 and want["covered"].sum() > 1000


def test_globe_index_np_equals_readsb_tpu():
    rng = np.random.default_rng(4)
    lat = rng.uniform(-90, 90, 20000)
    lon = rng.uniform(-180, 180, 20000)
    got = globe.globe_index_np(lat, lon)
    assert got.dtype == np.int32 and np.array_equal(got, jax_globe.globe_index_np(lat, lon))
    assert (got < 1000).any() and (got >= 1000).any()  # special tiles and the grid


# --- BulkTracker ----------------------------------------------------------------


def _assert_bulk_equal(got, want):
    for k in ("cpr_surface", "cpr_airborne", "cpr_global_ok", "cpr_global_bad",
              "cpr_global_skipped", "cpr_local_ok", "cpr_local_skipped",
              "cpr_global_speed_checks", "cpr_local_speed_checks", "messages_total",
              "n_slots"):
        assert getattr(got, k) == getattr(want, k), k
    gc, wc = vars(got.cols), vars(want.cols)
    assert sorted(gc) == sorted(wc)
    for k, w in wc.items():
        if isinstance(w, np.ndarray):
            assert gc[k].dtype == w.dtype and np.array_equal(gc[k], w, equal_nan=True), k
        else:
            assert gc[k] == w, k
    gr, wr = got.receivers.receivers, want.receivers.receivers
    assert sorted(gr) == sorted(wr)
    for rid, r in wr.items():
        assert vars(gr[rid]) == vars(r), hex(rid)


def _replay(batches, make):
    """Each batch's columns, copied, into a tracker from make()."""
    tr = make()
    for cols in batches:
        tr.update_batch(copy.deepcopy(cols))
    return tr


def _decode_batches(msgs, ts, addrs, bounds, rids=None, remote=False):
    out = []
    for a, b in zip(bounds, bounds[1:]):
        cols = jax_batch.decode_columns(msgs[a:b], ts[a:b], addrs[a:b], np.zeros(b - a, np.int64))
        if rids is not None:
            cols["receiver_id"] = rids[a:b]
        if remote:
            cols["remote"] = True
        out.append(cols)
    return out


@pytest.fixture(scope="module")
def capture_frames(tmp_path_factory):
    """test_bulk.py's capture (3 s, 4 aircraft, seed 9), demodulated by the
    port on the CPU (bit-equal to readsb_tpu's demodulator, which
    tests/test_torch_pipeline.py holds)."""
    from readsb_tpu_torch.pipeline import demodulate_file
    from readsb_tpu_torch.synth import build_standard_capture

    p = str(tmp_path_factory.mktemp("bulkcap") / "cap.uc8.dat")
    build_standard_capture(duration_s=3.0, n_aircraft=4, seed=9).write_uc8(p)
    frames, _ = demodulate_file(p, fmt="uc8", device="cpu")
    return frames


def test_bulk_tracker_equals_readsb_tpu_on_a_capture(capture_frames):
    frames = capture_frames
    assert len(frames) > 50
    msgs = _rows([f.msg for f in frames])
    ts = np.array([f.timestamp // 12000 for f in frames], np.int64)
    addrs = np.array([f.addr for f in frames], np.int64)
    batches = _decode_batches(msgs, ts, addrs, list(range(0, len(frames), 150)) + [len(frames)])
    want = _replay(batches, lambda: jax_bulk.BulkTracker(47.5, 8.5))
    got = _replay(batches, lambda: bulk.BulkTracker(47.5, 8.5))
    _assert_bulk_equal(got, want)
    assert want.cpr_global_ok > 10


def test_bulk_tracker_equals_readsb_tpu_on_the_multifeeder_stream():
    """test_bulk_aggregator.py's stream: extent boxes, the CPR network
    duplicate cache, a garbage feeder quarantined (position_received_cols)."""
    stream = test_bulk_aggregator._stream()
    n = len(stream)
    msgs = _rows([m for m, _, _ in stream])
    ts = np.array([t for _, t, _ in stream], np.int64)
    addrs = np.array([int.from_bytes(m[1:4], "big") for m, _, _ in stream], np.int64)
    rids = np.array([r for _, _, r in stream], np.uint64)
    bounds = sorted(set(range(0, n, 37)) | {n - 26, n - 14}) + [n]
    batches = _decode_batches(msgs, ts, addrs, bounds, rids, remote=True)
    want = _replay(batches, lambda: jax_bulk.BulkTracker(
        None, None, json_reliable=2, receivers=JaxReceiverStore()))
    got = _replay(batches, lambda: bulk.BulkTracker(
        None, None, json_reliable=2, receivers=ReceiverStore()))
    _assert_bulk_equal(got, want)
    assert got.receivers.check_bad(test_bulk_aggregator.FEED_BAD, stream[-1][1])


@pytest.mark.parametrize("seed", [3, 9])
def test_bulk_tracker_equals_readsb_tpu_on_the_adversarial_stream(seed):
    """test_bulk_adversarial.py's stream: outliers for the speed check,
    duplicates, stale pairs, bursts on one timestamp across batches."""
    stream = test_bulk_adversarial._stream(seed)
    n = len(stream)
    msgs = _rows([m for m, _, _ in stream])
    ts = np.array([t for _, _, t in stream], np.int64)
    addrs = np.array([a for _, a, _ in stream], np.int64)
    batches = _decode_batches(msgs, ts, addrs, list(range(0, n, 257)) + [n])
    want = _replay(batches, lambda: jax_bulk.BulkTracker(47.0, 8.0))
    got = _replay(batches, lambda: bulk.BulkTracker(47.0, 8.0))
    _assert_bulk_equal(got, want)
    assert want.cpr_global_speed_checks > 0
