"""Streaming demodulation pipeline: IQ bytes in -> accepted Mode-S frames out.

readsb_tpu.pipeline in PyTorch.  The host owns block bookkeeping (the
326-sample carried overlap, the scan-global index, EOF padding); one
device dispatch per superblock does the per-sample work, and a readback
of candidates goes to the host finalizer (native/finalizer.cpp or
decode/score.finalize_block, behind the same calls).

One engine (`_Engine`) runs the gated superblock for C >= 1 channels:
each superblock's IQ is written once into one reused host buffer (pinned
on a card) and goes to the device in one copy; the channels are laid out
as segments of one buffer (`multi_buffer`), and one dispatch
(`gated_dispatch`) scans them and drops, by the device score gate, the
candidates the host would reject.  `MultiDemodulator` is the engine over
C receivers; `Demodulator` is its one-channel case and adds what a
single receiver has.  The routes, chosen as readsb_tpu does:

  raw        fmt="uc8", gated, no Mode A/C: raw words go to the fused
             convert + dense scan kernel, then compaction, the win-row
             gather, the extraction kernel and the score gate; only the
             kept candidates are read back
  magnitude, gated   fmt="sc16" / "sc16q11" (or Demodulator.process_mag):
             samples are converted to uint16 magnitudes first
             (ops/convert.py), the dense scan runs on them
             (kernels.dense_scan), the rest as above; the block's mean
             level and power fall out of the same dispatch
  magnitude, ungated Demodulator with use_gate=False or modeac=True (any
             format; uc8 is converted by kernels.mag_uc8): all K
             candidates are read back and the host finalizer classifies
             them; with modeac=True the Mode A/C pass (ops/modeac.py)
             scans the same magnitude buffer

Frame-level parity with the reference (sdr_ifile.c:169-260 block cadence):

  stream  = [326 silent samples][samples...]
  scan    = offsets 0..valid_len-1 within each superblock
  ts      = scan_global_index * 5 + 768 + try_phase   (12 MHz clock)

Two alternative device routes, both off by default as in readsb_tpu:
FUSE_CLASSIFY (below) makes stage 4 classify each candidate phase for the
score gate (kernels.extract_classify_v3), and ops.demod.USE_FUSED makes
stages 1-4 one kernel per tile (ops/fused.py).  A fused dispatch that
overflows a tile's capacities is redone staged, and the demodulator then
stays staged (`_force_staged`): the fused capacities do not grow.

Both demodulators take `device=` (default "cuda") and raise when that
device is missing.  device="cpu" runs the kernels' plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import BLOCK_SAMPLES, PREAMBLE_THRESHOLD_DEFAULT, TRAILING_SAMPLES
from .decode import mode_ac as mode_ac_dec
from .decode.score import DemodStats, RawFrame, ScoreFinalizer
from .ops import convert as convert_ops
from .ops import demod as demod_ops
from .ops import kernels
from .ops import modeac as modeac_ops
from .ops.gate import DeviceIcaoMirror, GatedCandidates, score_gate, skipped_drops
from .spans import span

# uc8: one I byte and one Q byte; sc16 / sc16q11: little-endian int16 each
BYTES_PER_SAMPLE = {"uc8": 2, "sc16": 4, "sc16q11": 4}
# the interleaved I/Q words of a format -> uint16 magnitudes
_TO_MAG = {"uc8": kernels.mag_uc8, "sc16": convert_ops.mag_sc16,
           "sc16q11": convert_ops.mag_sc16q11}
# 0x8080 = I=Q=128, the quietest uc8 sample (magnitude 363): the initial
# overlap of the raw route.  The magnitude route starts from 326 zero
# magnitudes.  Both as in readsb_tpu.
SILENT_WORD = 0x8080
# zeros after each channel's segment and after the last: >= the 326-sample
# halo plus margin, and keeps 256-alignment
SEG_PAD = 512
# Gate classification inside the extraction kernel
# (kernels.extract_classify_v3): the score gate then reads the kernel's
# per-phase flags instead of searching the tables.  Off by default, as in
# readsb_tpu.
FUSE_CLASSIFY = False


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_fmt(fmt: str) -> None:
    if fmt not in BYTES_PER_SAMPLE:
        raise ValueError(f"unknown sample format {fmt!r}; one of {sorted(BYTES_PER_SAMPLE)}")


def _finalizers(use_native: bool | None, n: int, nfix: int, fix_df: bool) -> list:
    """n host finalizers: native.NativeFinalizer, or decode.score's behind
    the same calls (use_native=None: the native one when it builds)."""
    make = ScoreFinalizer
    if use_native is not False:
        from . import native as native_mod

        if native_mod.load() is not None:
            make = native_mod.NativeFinalizer
        elif use_native:
            raise RuntimeError("native finalizer requested but it failed to build")
    return [make(nfix=nfix, fix_df=fix_df) for _ in range(n)]


def _sigsum(a: np.ndarray) -> np.ndarray:
    s = np.asarray(a, dtype=np.int64)
    return ((s[:, 0] << 16) + s[:, 1]).astype(np.float64)


def _grown(cap: int, n: int) -> int:
    """cap doubled until n fits in it."""
    while cap < n:
        cap *= 2
    return cap


def _fit_or_grow(d, cand) -> int | None:
    """The rows to read back when the dispatch fit every capacity of
    demodulator d: n_keep of a gated dispatch, n_cand of an ungated one.
    Else double the capacities that overflowed and return None (the caller
    redoes the dispatch).  A fused dispatch that overflowed its per-tile or
    per-row capacity makes d staged for good and is redone too: those
    capacities are fixed.  One device sync.  Counts the candidates and kept
    rows of a dispatch that fit, and each dispatch to redo, on d."""
    need = {"k": cand.n_cand, "compact_l": cand.max_local}
    if isinstance(cand, GatedCandidates):
        need |= {"gate_k2": cand.n_keep, "gate_keep_l": cand.keep_watermark}
    counts = list(need.values())
    if cand.fused_overflow is not None:
        counts.append(cand.fused_overflow)
    with span("sync"):
        got = torch.stack(counts).tolist()
    if len(got) > len(need) and got[-1] > 0:
        d._force_staged = True
        d.redispatches += 1
        return None
    need = dict(zip(need, got))
    if any(n > getattr(d, cap) for cap, n in need.items()):
        d.redispatches += 1
        for cap, n in need.items():
            setattr(d, cap, _grown(getattr(d, cap), n))
        return None
    d.candidates += need["k"]
    kept = need.get("gate_k2", need["k"])
    d.kept += kept
    return kept


def _fetch(gc, names: tuple[str, ...]) -> list[np.ndarray]:
    with span("fetch"):
        return [getattr(gc, n).cpu().numpy() for n in names]


# the counters a superblock span notes the gains of
_NOTED = ("candidates", "kept", "redispatches", "pinned")


def _superblock(method):
    """Runs `method` as its demodulator's next superblock: in a span that
    notes what the counters gained inside it, and counted once it returns."""

    @functools.wraps(method)
    def run(d, *args):
        before = [(k, getattr(d, k)) for k in _NOTED]
        with span("superblock", sb=d.superblocks) as sp:
            out = method(d, *args)
            sp.note(**{k: getattr(d, k) - v for k, v in before})
        d.superblocks += 1
        return out

    return run


def multi_buffer(samples, overlaps, seg_stride: int, seg_valid: int) -> torch.Tensor:
    """Channels (C, S) of raw words or magnitudes laid out as concatenated
    segments [overlap | samples | zero gap] plus SEG_PAD zeros, so the dense
    scan runs once over one flat buffer; candidate offsets stay global
    (channel = offset // seg_stride)."""
    c = samples.shape[0]
    buf = torch.zeros(c * seg_stride + SEG_PAD, dtype=torch.uint16, device=samples.device)
    seg = buf[: c * seg_stride].view(c, seg_stride)
    seg[:, :TRAILING_SAMPLES] = overlaps
    seg[:, TRAILING_SAMPLES : TRAILING_SAMPLES + seg_valid] = samples
    return buf


def gated_dispatch(
    samples, overlaps, valid_len, threshold, known_tbl,
    *, raw_uc8, k, scan_len, l, k2, nfix, fix_df, reset_every, seg_stride, seg_valid,
    keep_l=64, force_staged=False,
):
    """One gated dispatch over C channels: raw UC8 words (raw_uc8) or
    magnitudes (C, S) + overlaps (C, 326) -> (GatedCandidates, the new
    overlaps, and on the magnitude route the per-channel block_sums of the
    valid samples, else None)."""
    buf = multi_buffer(samples, overlaps, seg_stride, seg_valid)
    bc, cs_hi, cs_lo = demod_ops._demod_core(
        buf, threshold, k=k, scan_len=scan_len, l=l,
        seg_stride=seg_stride, seg_valid=seg_valid, raw_uc8=raw_uc8,
        known_tbl=known_tbl if FUSE_CLASSIFY else None,
        nfix=nfix, fix_df=fix_df, force_staged=force_staged,
    )
    gc = score_gate(
        bc, known_tbl, cs_hi, cs_lo, valid_len,
        scan_len=scan_len, k2=k2, nfix=nfix, fix_df=fix_df,
        reset_every=reset_every, seg_stride=seg_stride, keep_l=keep_l,
    )
    sums = None if raw_uc8 else convert_ops.block_sums(samples[:, :valid_len])
    return gc, samples[:, -TRAILING_SAMPLES:].clone(), sums


class _Engine:
    """The gated superblock over C >= 1 lockstep channels (C SDRs sharing
    one sample clock).

    Each superblock's IQ is written once, into one host buffer that the
    engine owns and reuses (pinned on a card), and goes to the device in
    one copy, asynchronous on a card; the next write waits for that copy
    to end.  `pinned` counts the superblocks that went so.  One dispatch
    scans every channel; per channel, frames, timestamps and stats are
    those of a channel demodulated alone.  The device-side ICAO table is
    the union of all channels' filters, a safe over-approximation for the
    score gate that keeps drop counters exact per channel via
    drop_cum_chan differencing.
    """

    def __init__(self, n_chan, fmt, block_samples, blocks_per_batch, k_per_block,
                 threshold, nfix, fix_df, use_native, device):
        _check_fmt(fmt)
        self.device = _resolve_device(device)
        self.n_chan = n_chan
        self.fmt = fmt
        self.block_samples = block_samples
        self.seg_valid = block_samples * blocks_per_batch  # S per channel
        self.seg_stride = self.seg_valid + SEG_PAD
        self.scan_len = n_chan * self.seg_stride
        self.threshold = threshold
        self.nfix = nfix
        self.fix_df = fix_df
        self.k = k_per_block * blocks_per_batch * n_chan
        self.compact_l = 64  # escalation contract of _compact_two_level
        self.gate_k2 = max(1024, 64 * n_chan)
        self.gate_keep_l = 64
        self.mirror = DeviceIcaoMirror(device=self.device)
        self.fins = _finalizers(use_native, n_chan, nfix, fix_df)
        self.scan_global = 0  # per-channel sample clock (lockstep)
        self._pending = [b""] * n_chan
        self._gate_drops = [[0, 0, 0] for _ in range(n_chan)]  # preambles, unknown, bad
        # set for good by the first fused dispatch that overflows (USE_FUSED)
        self._force_staged = False
        # always on: superblocks, the scan's candidates on each dispatch that
        # fit, the rows kept and read back, dispatches redone on overflow
        self.superblocks = self.candidates = self.kept = self.redispatches = 0
        self._overlap_words = torch.full(
            (n_chan, TRAILING_SAMPLES), SILENT_WORD, dtype=torch.uint16, device=self.device
        )
        self._overlap_dev = torch.zeros(
            (n_chan, TRAILING_SAMPLES), dtype=torch.uint16, device=self.device
        )
        self.mean_level = np.zeros(n_chan)
        self.mean_power = np.zeros(n_chan)
        on_card = self.device.type == "cuda"
        self._staging = torch.empty(
            (n_chan, self.seg_valid * BYTES_PER_SAMPLE[fmt]), dtype=torch.uint8,
            pin_memory=on_card,
        )
        self._staging_np = self._staging.numpy()  # the rows feed() writes
        # raw words (I in the low byte) or interleaved int16 I/Q, as uploaded
        self._staging_words = self._staging.view(torch.uint16 if fmt == "uc8" else torch.int16)
        self._copied = torch.cuda.Event() if on_card else None  # the last copy out of it
        self.pinned = 0

    @property
    def raw_route(self) -> bool:
        """True when superblocks take the fused raw-UC8 route."""
        return self.fmt == "uc8"

    def _set_levels(self, level: np.ndarray, power: np.ndarray) -> None:
        self.mean_level, self.mean_power = level, power

    def _feed(self, raws) -> list[list[RawFrame]]:
        """One bytes chunk per channel in; per-channel frames of the whole
        superblocks now pending out."""
        super_bytes = self._staging_np.shape[1]
        with span("feed"):
            with span("stage", sb=self.superblocks):
                for c, r in enumerate(raws):
                    self._pending[c] = self._pending[c] + r if self._pending[c] else r
            out: list[list[RawFrame]] = [[] for _ in range(self.n_chan)]
            while min(len(p) for p in self._pending) >= super_bytes:
                with span("stage", sb=self.superblocks):
                    if self._copied is not None:
                        self._copied.synchronize()  # the buffer's last copy has left it
                    for row, p in zip(self._staging_np, self._pending):
                        row[:] = np.frombuffer(p, dtype=np.uint8, count=super_bytes)
                    self._pending = [p[super_bytes:] for p in self._pending]
                got = self._process(self._staging, self.seg_valid)
                for c in range(self.n_chan):
                    out[c].extend(got[c])
            # hold no caller's buffer (a bytearray, a memoryview) past the call
            self._pending = [p if type(p) is bytes else bytes(p) for p in self._pending]
            return out

    def _flush(self) -> list[list[RawFrame]]:
        """The final partial superblock (EOF): the whole samples pending,
        zero-padded in the staging buffer.  Channels must be lockstep (same
        pending length) for exact parity; shorter ones are padded too."""
        bps = BYTES_PER_SAMPLE[self.fmt]
        n = max(len(p) for p in self._pending) // bps
        if n == 0:
            self._pending = [b""] * self.n_chan
            return [[] for _ in range(self.n_chan)]
        with span("stage", sb=self.superblocks):
            if self._copied is not None:
                self._copied.synchronize()
            self._staging_np[:] = 0
            for row, p in zip(self._staging_np, self._pending):
                whole = len(p) // bps * bps
                row[:whole] = np.frombuffer(p, dtype=np.uint8, count=whole)
            self._pending = [b""] * self.n_chan
        return self._process(self._staging, n)

    def _upload_staged(self) -> torch.Tensor:
        """The staging buffer on the device as words (raw route) or
        magnitudes (C, S): one copy, asynchronous from pinned memory on a
        card, and an event behind it; on the CPU the buffer itself."""
        with span("upload"):
            with span("upload.h2d"):
                src = self._staging_words.to(self.device, non_blocking=True)
                if self._copied is not None:
                    self._copied.record(torch.cuda.current_stream(self.device))
            self.pinned += 1
            if self.raw_route:
                return src
            with span("upload.convert"):
                mag = _TO_MAG[self.fmt](src.reshape(-1))
            return mag.reshape(self.n_chan, self.seg_valid)

    def _samples(self, chunk) -> torch.Tensor:
        """The superblock (C, S) on the device: the staging buffer uploaded
        or, on the raw route, words the caller staged on the device."""
        if chunk is self._staging:
            return self._upload_staged()
        if not self.raw_route:
            raise ValueError("pre-staged words are taken on the raw-UC8 route only")
        shape = (self.n_chan, self.seg_valid)
        words = chunk.to(self.device)
        if words.dtype != torch.uint16 or tuple(words.shape) != shape:
            raise ValueError(f"expected uint16{list(shape)} words")
        return words

    @_superblock
    def _process(self, chunk, valid_len: int) -> list[list[RawFrame]]:
        """One superblock: the staging buffer or pre-staged words (_samples)."""
        return self._gated(self._samples(chunk), valid_len, self.raw_route)

    def _gated(self, samples: torch.Tensor, valid_len: int, raw_uc8: bool):
        """The gated superblock: dispatch (redone until it fits), fetch,
        per-channel finalize and drop accounting, ICAO aging and mirror."""
        overlaps = self._overlap_words if raw_uc8 else self._overlap_dev
        while True:
            with span("dispatch"):
                gc, new_overlaps, sums = gated_dispatch(
                    samples, overlaps, valid_len, self.threshold, self.mirror.tbl,
                    raw_uc8=raw_uc8, k=self.k, scan_len=self.scan_len, l=self.compact_l,
                    k2=self.gate_k2, nfix=self.nfix, fix_df=self.fix_df,
                    reset_every=self.block_samples,
                    seg_stride=self.seg_stride, seg_valid=self.seg_valid,
                    keep_l=self.gate_keep_l, force_staged=self._force_staged,
                )
            n_keep = _fit_or_grow(self, gc)
            if n_keep is not None:
                break
        if raw_uc8:
            self._overlap_words = new_overlaps
        else:
            self._overlap_dev = new_overlaps
            with span("fetch"):
                self._set_levels(*convert_ops.level_power(sums.cpu().numpy(), valid_len))

        (offs, cf, msgb, s112, s56, sl, ss, dcq, dcb, dcc) = _fetch(
            gc,
            ("offsets", "corr_fired", "msg", "syn112", "syn56", "sig_long",
             "sig_short", "drop_cum_q", "drop_cum_bnd", "drop_cum_chan"),
        )
        with span("fetch"):
            nb_per_chan = dcb.shape[1] // self.n_chan
            sl64 = _sigsum(sl)
            ss64 = _sigsum(ss)
            bounds = np.searchsorted(offs[:n_keep], np.arange(self.n_chan + 1) * self.seg_stride)
        results: list[list[RawFrame]] = []
        all_frames: list[RawFrame] = []
        for c in range(self.n_chan):
            with span("finalize", ch=c):  # with the slicing of the channel's rows
                a, b = int(bounds[c]), int(bounds[c + 1])
                loc = offs[a:b] - c * self.seg_stride
                kw = dict(
                    scan_len=self.seg_valid,
                    block_scan_start=self.scan_global,
                    reset_every=self.block_samples,
                )
                args = (loc, b - a, cf[a:b], msgb[a:b], s112[a:b], s56[a:b], sl64[a:b], ss64[a:b])
                frames, _ = self.fins[c].finalize_block(*args, **kw)

            # drops inside NMS skip windows are never counted by the serial
            # finalizer: subtract them from the device totals (exact stats
            # parity); the dcq/dcb slices hold GLOBAL cumulative counts,
            # which skipped_drops only ever differences
            with span("drops", ch=c):
                dcb_c = dcb[:, c * nb_per_chan : (c + 1) * nb_per_chan]
                sk_u, sk_b = skipped_drops(
                    frames, loc, dcq[:, :, a:b], dcb_c,
                    block_scan_start=self.scan_global, reset_every=self.block_samples,
                )
                gd = self._gate_drops[c]
                gd[0] += int(dcc[0, c + 1] - dcc[0, c]) - sk_u - sk_b
                gd[1] += int(dcc[1, c + 1] - dcc[1, c]) - sk_u
                gd[2] += int(dcc[2, c + 1] - dcc[2, c]) - sk_b
            results.append(frames)
            all_frames.extend(frames)

        self.scan_global += valid_len
        now_ms = self.scan_global * 5 // 12000
        with span("icao"):
            for fin in self.fins:
                fin.icao_expire(now_ms)
            # keep the device table == host filter state for the NEXT superblock
            self.mirror.add_from_frames(all_frames)
            self.mirror.expire(now_ms)
        return results

    def channel_stats(self, c: int) -> DemodStats:
        d = DemodStats(**self.fins[c].stats())
        # candidates classified and dropped on the device (ops/gate.py): the
        # drop counters are exactly what the host would have counted for them
        pre, unknown, bad = self._gate_drops[c]
        d.preambles += pre
        d.rejected_unknown_icao += unknown
        d.rejected_bad += bad
        return d

    def _load_state(self, state: dict, overlap_shape: tuple) -> None:
        """Continue the streams from state.demod_state_from_numpy(...), whose
        overlaps have overlap_shape."""
        if not isinstance(self.fins[0], ScoreFinalizer):
            raise ValueError("the ICAO filter hand-over needs use_native=False")
        if len(state["icao"]) != self.n_chan:
            raise ValueError("one ICAO filter state per channel expected")
        key = "overlap_words" if self.raw_route else "overlap_mag"
        if state.get(key) is None:
            # raw words and magnitudes are not interchangeable
            raise ValueError(f"this demodulator's route needs {key} in the state")
        ov = np.asarray(state[key], dtype=np.uint16)
        if ov.shape != overlap_shape:
            raise ValueError(f"{key} shape {ov.shape}, expected {overlap_shape}")
        overlap = torch.from_numpy(ov.reshape(self.n_chan, TRAILING_SAMPLES).copy()).to(self.device)
        if self.raw_route:
            self._overlap_words = overlap
        else:
            self._overlap_dev = overlap
            self._set_levels(*(np.broadcast_to(state[k], (self.n_chan,)).copy()
                               for k in ("mean_level", "mean_power")))
        self.scan_global = state["scan_global"]
        self.k = state["k"]
        self.compact_l = state["compact_l"]
        self.gate_k2 = state["gate_k2"]
        self.gate_keep_l = state["gate_keep_l"]
        self._force_staged = state["force_staged"]
        m = state["mirror"]
        self.mirror.load(m["cur"], m["prev"], m["next_swap_ms"], m["capacity"])
        for fin, icao in zip(self.fins, state["icao"]):
            filt = fin.scorer.icao
            filt.cur = set(icao["cur"])
            filt.prev = set(icao["prev"])
            filt.next_swap_ms = icao["next_swap_ms"]


class MultiDemodulator(_Engine):
    """Channel-batched streaming demodulator: the engine over C receivers,
    always gated (the raw route for uc8, the magnitude route otherwise).

    feed() takes one bytes chunk per channel (lockstep streams: C SDRs
    sharing one sample clock) and returns per-channel frames.
    """

    def __init__(
        self,
        n_chan: int,
        fmt: str = "uc8",
        block_samples: int = BLOCK_SAMPLES,
        blocks_per_batch: int = 1,
        k_per_block: int = 2048,
        threshold: int = PREAMBLE_THRESHOLD_DEFAULT,
        nfix: int = 1,
        fix_df: bool = True,
        use_native: bool | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__(n_chan, fmt, block_samples, blocks_per_batch, k_per_block,
                         threshold, nfix, fix_df, use_native, device)

    def feed(self, raws: list[bytes]) -> list[list[RawFrame]]:
        """Feed one bytes chunk per channel; returns per-channel frames."""
        if len(raws) != self.n_chan:
            raise ValueError(f"expected {self.n_chan} channel chunks, got {len(raws)}")
        return self._feed(raws)

    def flush(self) -> list[list[RawFrame]]:
        """Process the final partial superblock (EOF, zero-padded)."""
        return self._flush()

    @property
    def stats(self) -> DemodStats:
        """Aggregate demod stats across channels (per channel: channel_stats)."""
        d = DemodStats()
        acc: list[int] = []
        for c in range(self.n_chan):
            sc = self.channel_stats(c)
            d.preambles += sc.preambles
            d.rejected_bad += sc.rejected_bad
            d.rejected_unknown_icao += sc.rejected_unknown_icao
            for i, v in enumerate(sc.accepted):
                while len(acc) <= i:
                    acc.append(0)
                acc[i] += v
        d.accepted = acc or [0, 0, 0]
        return d

    def load_state(self, state: dict) -> None:
        """Continue C streams from state.demod_state_from_numpy(...)."""
        self._load_state(state, (self.n_chan, TRAILING_SAMPLES))


class Demodulator(_Engine):
    """Stateful streaming demodulator for one receiver channel: the
    engine's one-channel case (the gated routes), plus bytes in and frames
    out, process_mag, the ungated route (use_gate=False) and the Mode A/C
    route (modeac=True, which may be switched between superblocks)."""

    def __init__(
        self,
        fmt: str = "uc8",
        block_samples: int = BLOCK_SAMPLES,
        blocks_per_batch: int = 4,
        k_per_block: int = 2048,
        threshold: int = PREAMBLE_THRESHOLD_DEFAULT,
        nfix: int = 1,
        fix_df: bool = True,
        use_native: bool | None = None,
        modeac: bool = False,
        use_gate: bool | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__(1, fmt, block_samples, blocks_per_batch, k_per_block,
                         threshold, nfix, fix_df, use_native, device)
        self.super_samples = self.seg_valid
        self.mean_level = 0.0
        self.mean_power = 0.0
        self.modeac = modeac
        self.modeac_k = 512 * blocks_per_batch
        self.modeac_msgs: list = []  # decoded ModesMessage, drained by caller
        self.stats_modeac = 0
        # device-side score gate: only plausibly-acceptable candidates are
        # read back (ops/gate.py); frame output and stats are unchanged.
        # None means gated, readsb_tpu's default on an accelerator.
        self.use_gate = True if use_gate is None else bool(use_gate)

    @property
    def raw_route(self) -> bool:
        """True when superblocks take the fused raw-UC8 route."""
        return self.use_gate and not self.modeac and self.fmt == "uc8"

    @property
    def stats(self) -> DemodStats:
        return self.channel_stats(0)

    def _set_levels(self, level: np.ndarray, power: np.ndarray) -> None:
        self.mean_level, self.mean_power = float(level[0]), float(power[0])

    def feed(self, raw: bytes) -> list[RawFrame]:
        """Feed raw IQ bytes; returns frames completed by full superblocks."""
        return self._feed([raw])[0]

    def flush(self) -> list[RawFrame]:
        """Process the final partial superblock (EOF)."""
        return self._flush()[0]

    @_superblock
    def _process(self, chunk, valid_len: int) -> list[list[RawFrame]]:
        """One superblock: a gated route as the engine's, else the ungated
        route (with the Mode A/C pass)."""
        samples = self._samples(chunk)
        if self.use_gate and not self.modeac:
            return self._gated(samples, valid_len, self.raw_route)
        mag = samples[0]
        self.mean_level, self.mean_power = convert_ops.block_stats(mag[:valid_len])
        return [self._ungated(mag, valid_len)]

    @_superblock
    def process_mag(self, mag: np.ndarray) -> list[RawFrame]:
        """Feed a pre-converted magnitude superblock (super_samples long)."""
        if len(mag) != self.super_samples:
            raise ValueError(f"expected {self.super_samples} magnitudes, got {len(mag)}")
        mag_t = torch.from_numpy(np.array(mag, dtype=np.uint16)).to(self.device)
        if self.use_gate and not self.modeac:
            return self._gated(mag_t[None], self.super_samples, False)[0]
        if self.modeac:
            self.mean_level, self.mean_power = convert_ops.block_stats(mag_t)
        return self._ungated(mag_t, self.super_samples)

    def _demod_modeac(self, buf: torch.Tensor, valid_len: int) -> None:
        """Mode A/C pass over the same magnitude buffer (--modeac)."""
        stddev = np.sqrt(max(0.0, self.mean_power - self.mean_level**2))
        noise_level = int((self.mean_power + stddev) * 65535 + 0.5)
        while True:
            cand = modeac_ops.modeac_block(buf, noise_level, k=self.modeac_k,
                                           scan_len=self.super_samples)
            n = int(cand.n_cand)
            if n <= self.modeac_k:
                break
            self.modeac_k = _grown(self.modeac_k, n)
        offsets, ok, code, f2_clock = _fetch(cand, ("offsets", "ok", "modeac", "f2_clock"))
        offsets = np.where(offsets < valid_len, offsets, self.super_samples)
        hits = mode_ac_dec.finalize_modeac(
            offsets, ok, code, f2_clock, n,
            scan_len=self.super_samples, block_scan_start=self.scan_global,
        )
        for modea, ts, _off in hits:
            self.modeac_msgs.append(mode_ac_dec.decode_modeac_message(
                modea, timestamp=ts, sys_timestamp_ms=ts // 12000
            ))
        self.stats_modeac += len(hits)

    def _ungated(self, mag: torch.Tensor, valid_len: int) -> list[RawFrame]:
        """Ungated route: all K candidates are read back and the host
        finalizer classifies every one of them."""
        buf = torch.cat([self._overlap_dev[0], mag])
        if self.modeac:
            self._demod_modeac(buf, valid_len)
        while True:
            with span("dispatch"):
                cand = demod_ops.demod_block(
                    buf, self.threshold, k=self.k, scan_len=self.super_samples,
                    l=self.compact_l, force_staged=self._force_staged,
                )
            n = _fit_or_grow(self, cand)
            if n is not None:
                break
        offsets, cf, msg, s112, s56 = _fetch(
            cand, ("offsets", "corr_fired", "msg", "syn112", "syn56")
        )
        offsets = np.where(offsets < valid_len, offsets, self.super_samples)
        with span("finalize"):
            frames, _ = self.fins[0].finalize_block(
                offsets, n, cf, msg, s112, s56, cand.sigsum_long, cand.sigsum_short,
                scan_len=self.super_samples, block_scan_start=self.scan_global,
                reset_every=self.block_samples,
            )
        self._overlap_dev = buf[None, -TRAILING_SAMPLES:].clone()
        self.scan_global += valid_len
        with span("icao"):  # ICAO filter generation aging on the synthetic clock
            self.fins[0].icao_expire(self.scan_global * 5 // 12000)
        return frames

    def load_state(self, state: dict) -> None:
        """Continue a stream from state.demod_state_from_numpy(...)."""
        self._load_state(state, (TRAILING_SAMPLES,))
        if not self.raw_route:
            self.modeac_k = state["modeac_k"]


def demodulate_file(path: str, fmt: str = "uc8", **kw) -> tuple[list[RawFrame], Demodulator]:
    """Demodulate a whole IQ capture file (the reference's --ifile mode)."""
    demod = Demodulator(fmt=fmt, **kw)
    frames: list[RawFrame] = []
    chunk_bytes = demod.super_samples * BYTES_PER_SAMPLE[fmt]
    with open(path, "rb") as f:
        while True:
            raw = f.read(chunk_bytes)
            if not raw:
                break
            frames.extend(demod.feed(raw))
    frames.extend(demod.flush())
    return frames, demod
