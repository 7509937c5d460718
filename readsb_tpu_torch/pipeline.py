"""Streaming demodulation pipeline: IQ bytes in -> accepted Mode-S frames out.

readsb_tpu.pipeline in PyTorch.  The host owns block bookkeeping (the
326-sample carried overlap, the scan-global index, EOF padding); one
device dispatch per superblock does the per-sample work, and a readback
of candidates goes to the host finalizer (native/finalizer.cpp or
decode/score.finalize_block).  Three routes, chosen as readsb_tpu does:

  raw        fmt="uc8", gated, no Mode A/C: raw words go to the fused
             convert + dense scan kernel, then compaction, the win-row
             gather, the extraction kernel and the score gate; only the
             kept candidates are read back
  magnitude, gated   fmt="sc16" / "sc16q11" (or process_mag): samples are
             converted to uint16 magnitudes first (ops/convert.py), the
             dense scan runs on them (kernels.dense_scan), the rest as
             above; the block's mean level and power fall out of the
             same dispatch
  magnitude, ungated use_gate=False or modeac=True (any format; uc8 is
             converted by kernels.mag_uc8): all K candidates are read
             back and the host finalizer classifies them; with
             modeac=True the Mode A/C pass (ops/modeac.py) scans the
             same magnitude buffer

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
from .decode.score import DemodStats, RawFrame, Scorer, finalize_block
from .ops import convert as convert_ops
from .ops import demod as demod_ops
from .ops import kernels
from .ops import modeac as modeac_ops
from .ops.gate import DeviceIcaoMirror, score_gate, skipped_drops
from .spans import span

# uc8: one I byte and one Q byte; sc16 / sc16q11: little-endian int16 each
BYTES_PER_SAMPLE = {"uc8": 2, "sc16": 4, "sc16q11": 4}
# 0x8080 = I=Q=128, the quietest uc8 sample (magnitude 363): the initial
# overlap of the raw route.  The magnitude route starts from 326 zero
# magnitudes.  Both as in readsb_tpu.
SILENT_WORD = 0x8080
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


def _load_native(use_native: bool | None):
    """The native finalizer module, or None (use_native=None: when it builds)."""
    if use_native is False:
        return None
    from . import native as native_mod

    if native_mod.load() is None:
        if use_native:
            raise RuntimeError("native finalizer requested but it failed to build")
        return None
    return native_mod


def _upload(raw: np.ndarray, dtype: str, shape, device: torch.device) -> torch.Tensor:
    """uint8 bytes viewed as `dtype` in `shape`, copied to the device."""
    with span("upload.copy"):
        a = np.ascontiguousarray(raw).view(dtype).reshape(shape).copy()
    with span("upload.h2d"):
        out = torch.from_numpy(a).to(device)
    with span("upload.free"):
        del a  # the host copy's pages go back here, not in a parent's own time
    return out


def _words_from_bytes(raw: np.ndarray, shape, device: torch.device) -> torch.Tensor:
    """uint8 I/Q bytes -> uint16 words (I in the low byte) on the device."""
    with span("upload"):
        return _upload(raw, "<u2", shape, device)


def _to_mag(raw: np.ndarray, fmt: str, device: torch.device, sb: int = -1) -> torch.Tensor:
    """uint8 IQ bytes of any format -> uint16 magnitudes on the device; `sb`
    names the superblock of an upload made ahead of it."""
    with span("upload", sb=sb):
        src = _upload(raw, "<u2" if fmt == "uc8" else "<i2", (-1,), device)
        with span("upload.convert"):
            if fmt == "uc8":
                return kernels.mag_uc8(src)
            if fmt == "sc16":
                return convert_ops.mag_sc16(src)
            return convert_ops.mag_sc16q11(src)


def _sigsum(a: np.ndarray) -> np.ndarray:
    s = np.asarray(a, dtype=np.int64)
    return ((s[:, 0] << 16) + s[:, 1]).astype(np.float64)


def _fit_or_grow(d, gc) -> int | None:
    """n_keep when the dispatch fit every capacity of demodulator d; else
    double the capacities that overflowed and return None (the caller
    redoes the dispatch).  A fused dispatch that overflowed its per-tile or
    per-row capacity makes d staged for good and is redone too: those
    capacities are fixed.  One device sync.  Counts the candidates and kept
    rows of a dispatch that fit, and each dispatch to redo, on d."""
    counts = [gc.n_cand, gc.max_local, gc.n_keep, gc.keep_watermark]
    if gc.fused_overflow is not None:
        counts.append(gc.fused_overflow)
    with span("sync"):
        n, max_local, n_keep, kw, *overflow = torch.stack(counts).tolist()
    if overflow and overflow[0] > 0:
        d._force_staged = True
        d.redispatches += 1
        return None
    if n <= d.k and max_local <= d.compact_l and n_keep <= d.gate_k2 and kw <= d.gate_keep_l:
        d.candidates += n
        d.kept += n_keep
        return n_keep
    d.redispatches += 1
    while d.k < n:
        d.k *= 2
    while d.compact_l < max_local:
        d.compact_l *= 2
    while d.gate_k2 < n_keep:
        d.gate_k2 *= 2
    while d.gate_keep_l < kw:
        d.gate_keep_l *= 2
    return None


def _fetch(gc, names: tuple[str, ...]) -> list[np.ndarray]:
    with span("fetch"):
        return [getattr(gc, n).cpu().numpy() for n in names]


def _superblock(method):
    """Runs `method` as its demodulator's next superblock: in a span that
    notes what the counters gained inside it, and counted once it returns."""

    @functools.wraps(method)
    def run(d, *args):
        before = d.candidates, d.kept, d.redispatches
        with span("superblock", sb=d.superblocks) as sp:
            out = method(d, *args)
            sp.note(candidates=d.candidates - before[0], kept=d.kept - before[1],
                    redispatches=d.redispatches - before[2])
        d.superblocks += 1
        return out

    return run


def _demod_and_gate_raw(
    words, overlap_words, valid_len, threshold, known_tbl,
    *, k, scan_len, l, k2, nfix, fix_df, reset_every, keep_l=64,
    force_staged=False,
):
    """One dispatch: raw UC8 words (S,) + overlap words (326,) -> GatedCandidates."""
    buf = torch.empty(TRAILING_SAMPLES + words.shape[0], dtype=torch.uint16, device=words.device)
    buf[:TRAILING_SAMPLES] = overlap_words
    buf[TRAILING_SAMPLES:] = words
    bc, cs_hi, cs_lo = demod_ops._demod_core(
        buf, threshold, k=k, scan_len=scan_len, l=l, raw_uc8=True,
        known_tbl=known_tbl if FUSE_CLASSIFY else None,
        nfix=nfix, fix_df=fix_df, force_staged=force_staged,
    )
    return score_gate(
        bc, known_tbl, cs_hi, cs_lo, valid_len,
        scan_len=scan_len, k2=k2, nfix=nfix, fix_df=fix_df,
        reset_every=reset_every, keep_l=keep_l,
    )


def _demod_and_gate(
    mag, overlap, valid_len, threshold, known_tbl,
    *, k, scan_len, l, k2, nfix, fix_df, reset_every, keep_l=64,
    force_staged=False,
):
    """One dispatch of the gated magnitude route: magnitudes (S,) + overlap
    (326,) -> (GatedCandidates, new overlap, block_sums of the valid samples)."""
    buf = torch.cat([overlap, mag])
    bc, cs_hi, cs_lo = demod_ops._demod_core(
        buf, threshold, k=k, scan_len=scan_len, l=l,
        known_tbl=known_tbl if FUSE_CLASSIFY else None,
        nfix=nfix, fix_df=fix_df, force_staged=force_staged,
    )
    gc = score_gate(
        bc, known_tbl, cs_hi, cs_lo, valid_len,
        scan_len=scan_len, k2=k2, nfix=nfix, fix_df=fix_df,
        reset_every=reset_every, keep_l=keep_l,
    )
    return gc, buf[-TRAILING_SAMPLES:].clone(), convert_ops.block_sums(mag[:valid_len])


def multi_buffer(samples, overlaps, seg_stride: int, seg_valid: int) -> torch.Tensor:
    """Channels (C, S) of raw words or magnitudes laid out as concatenated
    segments [overlap | samples | zero gap] plus SEG_PAD zeros, so the dense
    scan runs once over one flat buffer; candidate offsets stay global
    (channel = offset // seg_stride)."""
    c = samples.shape[0]
    buf = torch.zeros(c * seg_stride + MultiDemodulator.SEG_PAD, dtype=torch.uint16,
                      device=samples.device)
    seg = buf[: c * seg_stride].view(c, seg_stride)
    seg[:, :TRAILING_SAMPLES] = overlaps
    seg[:, TRAILING_SAMPLES : TRAILING_SAMPLES + seg_valid] = samples
    return buf


def _demod_and_gate_multi_raw(
    words, overlap_words, valid_len, threshold, known_tbl,
    *, k, scan_len, l, k2, nfix, fix_df, reset_every, seg_stride, seg_valid,
    keep_l=64, force_staged=False,
):
    """One dispatch over C channels: words (C, S) + overlaps (C, 326)."""
    buf = multi_buffer(words, overlap_words, seg_stride, seg_valid)
    bc, cs_hi, cs_lo = demod_ops._demod_core(
        buf, threshold, k=k, scan_len=scan_len, l=l,
        seg_stride=seg_stride, seg_valid=seg_valid, raw_uc8=True,
        known_tbl=known_tbl if FUSE_CLASSIFY else None,
        nfix=nfix, fix_df=fix_df, force_staged=force_staged,
    )
    return score_gate(
        bc, known_tbl, cs_hi, cs_lo, valid_len,
        scan_len=scan_len, k2=k2, nfix=nfix, fix_df=fix_df,
        reset_every=reset_every, seg_stride=seg_stride, keep_l=keep_l,
    )


def _demod_and_gate_multi(
    mags, overlaps, valid_len, threshold, known_tbl,
    *, k, scan_len, l, k2, nfix, fix_df, reset_every, seg_stride, seg_valid,
    keep_l=64, force_staged=False,
):
    """One dispatch of the magnitude route over C channels: mags (C, S) +
    overlaps (C, 326) -> (GatedCandidates, new overlaps, per-channel
    block_sums of the valid samples)."""
    buf = multi_buffer(mags, overlaps, seg_stride, seg_valid)
    bc, cs_hi, cs_lo = demod_ops._demod_core(
        buf, threshold, k=k, scan_len=scan_len, l=l,
        seg_stride=seg_stride, seg_valid=seg_valid,
        known_tbl=known_tbl if FUSE_CLASSIFY else None,
        nfix=nfix, fix_df=fix_df, force_staged=force_staged,
    )
    gc = score_gate(
        bc, known_tbl, cs_hi, cs_lo, valid_len,
        scan_len=scan_len, k2=k2, nfix=nfix, fix_df=fix_df,
        reset_every=reset_every, seg_stride=seg_stride, keep_l=keep_l,
    )
    sums = convert_ops.block_sums(mags[:, :valid_len])
    return gc, mags[:, -TRAILING_SAMPLES:].clone(), sums


def _stats_of(fin, native: bool, gate_drops: list[int]) -> DemodStats:
    d = DemodStats()
    if native:
        st = fin.stats()
        d.preambles = st["preambles"]
        d.rejected_bad = st["rejected_bad"]
        d.rejected_unknown_icao = st["rejected_unknown_icao"]
        d.accepted = st["accepted"]
    else:
        s = fin.stats
        d.preambles = s.preambles
        d.rejected_bad = s.rejected_bad
        d.rejected_unknown_icao = s.rejected_unknown_icao
        d.accepted = list(s.accepted)
        d.overflow_blocks = s.overflow_blocks
    # candidates classified and dropped on the device (ops/gate.py): the
    # drop counters are exactly what the host would have counted for them
    d.preambles += gate_drops[0]
    d.rejected_unknown_icao += gate_drops[1]
    d.rejected_bad += gate_drops[2]
    return d


class Demodulator:
    """Stateful streaming demodulator for one receiver channel."""

    def __init__(
        self,
        fmt: str = "uc8",
        block_samples: int = BLOCK_SAMPLES,
        blocks_per_batch: int = 4,
        k_per_block: int = 2048,
        threshold: int = PREAMBLE_THRESHOLD_DEFAULT,
        nfix: int = 1,
        fix_df: bool = True,
        carry_skip: bool = False,
        use_native: bool | None = None,
        modeac: bool = False,
        use_gate: bool | None = None,
        device: torch.device | str = "cuda",
    ):
        _check_fmt(fmt)
        self.device = _resolve_device(device)
        self.fmt = fmt
        self.block_samples = block_samples
        self.blocks_per_batch = blocks_per_batch
        self.super_samples = block_samples * blocks_per_batch
        self.k = k_per_block * blocks_per_batch
        self.compact_l = 64  # escalation contract of _compact_two_level
        self.threshold = threshold
        self.carry_skip = carry_skip
        self.nfix = nfix
        self.fix_df = fix_df
        self.scorer = Scorer(nfix=nfix, fix_df=fix_df)
        native_mod = _load_native(use_native)
        self.native = native_mod.NativeFinalizer(nfix=nfix, fix_df=fix_df) if native_mod else None
        self.scan_global = 0
        self._skip = 0
        self._pending = b""
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
        self.gate_k2 = 1024
        self.gate_keep_l = 64
        self._gate_drops = [0, 0, 0]  # preambles, rejected_unknown, rejected_bad
        # set for good by the first fused dispatch that overflows (USE_FUSED)
        self._force_staged = False
        # always on: superblocks, the scan's candidates on each dispatch that
        # fit, the rows kept and read back, dispatches redone on overflow
        self.superblocks = self.candidates = self.kept = self.redispatches = 0
        self.icao_mirror = DeviceIcaoMirror(device=self.device)
        self._overlap_words = torch.full(
            (TRAILING_SAMPLES,), SILENT_WORD, dtype=torch.uint16, device=self.device
        )
        self._overlap_dev = torch.zeros(TRAILING_SAMPLES, dtype=torch.uint16, device=self.device)

    @property
    def raw_route(self) -> bool:
        """True when superblocks take the fused raw-UC8 route."""
        return self.use_gate and not self.modeac and self.fmt == "uc8"

    @property
    def stats(self) -> DemodStats:
        if self.native is not None:
            return _stats_of(self.native, True, self._gate_drops)
        return _stats_of(self.scorer, False, self._gate_drops)

    def feed(self, raw: bytes) -> list[RawFrame]:
        """Feed raw IQ bytes; returns frames completed by full superblocks.

        On the gated magnitude route, when several superblocks are
        available, the next chunk's upload and magnitude conversion are
        enqueued before the current chunk's host-side finalize, so the
        device works while the host scores.  The demod dispatch itself
        still follows the previous finalize, so the ICAO gate table is
        exact.
        """
        with span("feed"):
            super_bytes = self.super_samples * BYTES_PER_SAMPLE[self.fmt]
            with span("stage", sb=self.superblocks):
                data = self._pending + raw
                chunks = []
                off = 0
                while len(data) - off >= super_bytes:
                    chunks.append(np.frombuffer(data, dtype=np.uint8, count=super_bytes,
                                                offset=off))
                    off += super_bytes
                self._pending = data[off:]
            frames: list[RawFrame] = []
            if len(chunks) > 1 and self.use_gate and not self.modeac and not self.raw_route:
                # each upload is made ahead of its superblock, in feed's span
                sb = self.superblocks
                next_mag = _to_mag(chunks[0], self.fmt, self.device, sb)
                for i in range(len(chunks)):
                    mag = next_mag
                    if i + 1 < len(chunks):
                        next_mag = _to_mag(chunks[i + 1], self.fmt, self.device, sb + i + 1)
                    frames.extend(self._demod_mag_ahead(mag, self.super_samples))
                return frames
            for chunk in chunks:
                frames.extend(self._process(chunk, self.super_samples))
            return frames

    def flush(self) -> list[RawFrame]:
        """Process the final partial superblock (EOF)."""
        bps = BYTES_PER_SAMPLE[self.fmt]
        n = len(self._pending) // bps
        if n == 0:
            self._pending = b""
            return []
        chunk = np.zeros(self.super_samples * bps, dtype=np.uint8)
        chunk[: n * bps] = np.frombuffer(self._pending, dtype=np.uint8, count=n * bps)
        self._pending = b""
        return self._process(chunk, n)

    @_superblock
    def _process(self, chunk, valid_len: int) -> list[RawFrame]:
        """One superblock: uint8 bytes or, on the raw route, pre-staged
        uint16 words on the device."""
        if self.raw_route:
            return self._demod_raw_gated(chunk, valid_len)
        if isinstance(chunk, torch.Tensor):
            raise ValueError("pre-staged words are taken on the raw-UC8 route only")
        mag = _to_mag(chunk, self.fmt, self.device)
        if self.use_gate and not self.modeac:
            return self._demod_mag_gated(mag, valid_len)
        self.mean_level, self.mean_power = convert_ops.block_stats(mag[:valid_len])
        return self._demod_buf(torch.cat([self._overlap_dev, mag]), valid_len)

    @_superblock
    def process_mag(self, mag: np.ndarray) -> list[RawFrame]:
        """Feed a pre-converted magnitude superblock (super_samples long)."""
        if len(mag) != self.super_samples:
            raise ValueError(f"expected {self.super_samples} magnitudes, got {len(mag)}")
        mag_t = torch.from_numpy(np.array(mag, dtype=np.uint16)).to(self.device)
        if self.use_gate and not self.modeac:
            return self._demod_mag_gated(mag_t, self.super_samples)
        if self.modeac:
            self.mean_level, self.mean_power = convert_ops.block_stats(mag_t)
        return self._demod_buf(torch.cat([self._overlap_dev, mag_t]), self.super_samples)

    def _demod_raw_gated(self, chunk, valid_len: int) -> list[RawFrame]:
        """Raw route: UC8 words straight into the convert + dense scan
        kernel; the magnitude array never exists in device memory."""
        if isinstance(chunk, torch.Tensor):
            words = chunk.to(self.device)
        else:
            words = _words_from_bytes(chunk, (self.super_samples,), self.device)
        if words.dtype != torch.uint16 or tuple(words.shape) != (self.super_samples,):
            raise ValueError(f"expected uint16[{self.super_samples}] words")
        mirror = self.icao_mirror
        while True:
            with span("dispatch"):
                gc = _demod_and_gate_raw(
                    words, self._overlap_words, valid_len, self.threshold, mirror.tbl,
                    k=self.k, scan_len=self.super_samples, l=self.compact_l,
                    k2=self.gate_k2, nfix=self.nfix, fix_df=self.fix_df,
                    reset_every=self.block_samples, keep_l=self.gate_keep_l,
                    force_staged=self._force_staged,
                )
            n_keep = _fit_or_grow(self, gc)
            if n_keep is not None:
                break
        self._overlap_words = words[-TRAILING_SAMPLES:].clone()
        return _finalize_gated(self, gc, n_keep, valid_len)

    def _demod_mag_gated(self, mag: torch.Tensor, valid_len: int) -> list[RawFrame]:
        """Gated magnitude route: demod + score gate in one dispatch; a small
        readback, and the block's level and power from exact integer sums."""
        while True:
            with span("dispatch"):
                gc, new_overlap, sums = _demod_and_gate(
                    mag, self._overlap_dev, valid_len, self.threshold,
                    self.icao_mirror.tbl,
                    k=self.k, scan_len=self.super_samples, l=self.compact_l,
                    k2=self.gate_k2, nfix=self.nfix, fix_df=self.fix_df,
                    reset_every=self.block_samples, keep_l=self.gate_keep_l,
                    force_staged=self._force_staged,
                )
            n_keep = _fit_or_grow(self, gc)
            if n_keep is not None:
                break
        self._overlap_dev = new_overlap
        with span("fetch"):
            level, power = convert_ops.level_power(sums.cpu().numpy(), valid_len)
        self.mean_level, self.mean_power = float(level), float(power)
        return _finalize_gated(self, gc, n_keep, valid_len)

    _demod_mag_ahead = _superblock(_demod_mag_gated)  # the prefetching feed's superblocks

    def _demod_modeac(self, buf: torch.Tensor, valid_len: int) -> None:
        """Mode A/C pass over the same magnitude buffer (--modeac)."""
        stddev = np.sqrt(max(0.0, self.mean_power - self.mean_level**2))
        noise_level = int((self.mean_power + stddev) * 65535 + 0.5)
        k = self.modeac_k
        while True:
            cand = modeac_ops.modeac_block(buf, noise_level, k=k, scan_len=self.super_samples)
            n = int(cand.n_cand)
            if n <= k:
                break
            while k < n:
                k *= 2
            self.modeac_k = k
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

    def _demod_buf(self, buf: torch.Tensor, valid_len: int) -> list[RawFrame]:
        """Ungated route: all K candidates are read back and the host
        finalizer classifies every one of them."""
        if self.modeac:
            self._demod_modeac(buf, valid_len)
        k = self.k
        while True:
            with span("dispatch"):
                cand = demod_ops.demod_block(
                    buf, self.threshold, k=k, scan_len=self.super_samples,
                    l=self.compact_l, force_staged=self._force_staged,
                )
            with span("sync"):
                overflow = cand.fused_overflow is not None and int(cand.fused_overflow) > 0
                if not overflow:
                    n, max_local = torch.stack([cand.n_cand, cand.max_local]).tolist()
            if overflow:
                self._force_staged = True  # the fused capacities are fixed
                self.redispatches += 1
                continue
            if n <= k and max_local <= self.compact_l:
                self.candidates += n
                self.kept += n  # every candidate is read back
                break
            # capacity overflow: escalate and redo
            self.redispatches += 1
            while k < n:
                k *= 2
            self.k = k
            while self.compact_l < max_local:
                self.compact_l *= 2

        offsets, cf, msg, s112, s56 = _fetch(
            cand, ("offsets", "corr_fired", "msg", "syn112", "syn56")
        )
        offsets = np.where(offsets < valid_len, offsets, self.super_samples)
        args = (offsets, n, cf, msg, s112, s56, cand.sigsum_long, cand.sigsum_short)
        kw = dict(
            scan_len=self.super_samples,
            block_scan_start=self.scan_global,
            carry_skip=self._skip,
            reset_every=self.block_samples,
        )
        with span("finalize"):
            if self.native is not None:
                frames, leftover = self.native.finalize_block(*args, **kw)
            else:
                frames, leftover = finalize_block(self.scorer, *args, **kw)
        self._skip = leftover if self.carry_skip else 0

        # advance stream state
        self._overlap_dev = buf[-TRAILING_SAMPLES:].clone()
        self.scan_global += valid_len

        # ICAO filter generation aging on the synthetic clock
        now_ms = self.scan_global * 5 // 12000
        with span("icao"):
            if self.native is not None:
                self.native.icao_expire(now_ms)
            else:
                self.scorer.icao.expire(now_ms)
        return frames

    def load_state(self, state: dict) -> None:
        """Continue a stream from state.demod_state_from_numpy(...)."""
        if self.native is not None:
            raise ValueError("the ICAO filter hand-over needs use_native=False")
        overlap = _overlap_of(state, self.raw_route, (TRAILING_SAMPLES,), self.device)
        if self.raw_route:
            self._overlap_words = overlap
        else:
            self._overlap_dev = overlap
            self.mean_level = float(state["mean_level"])
            self.mean_power = float(state["mean_power"])
            self.modeac_k = state["modeac_k"]
        _load_common(self, self.icao_mirror, state)
        (icao,) = state["icao"]
        _load_filter(self.scorer.icao, icao)


def _overlap_of(state: dict, raw_route: bool, shape: tuple, device) -> torch.Tensor:
    """The carried overlap of the route the demodulator runs: raw words for
    the raw route, magnitudes for the magnitude route.  The two are not
    interchangeable, so a state of the other route is refused."""
    key = "overlap_words" if raw_route else "overlap_mag"
    if state.get(key) is None:
        raise ValueError(f"this demodulator's route needs {key} in the state")
    ov = np.asarray(state[key], dtype=np.uint16)
    if ov.shape != shape:
        raise ValueError(f"{key} shape {ov.shape}, expected {shape}")
    return torch.from_numpy(ov.copy()).to(device)


def _load_common(demod, mirror: DeviceIcaoMirror, state: dict) -> None:
    demod.scan_global = state["scan_global"]
    demod.k = state["k"]
    demod.compact_l = state["compact_l"]
    demod.gate_k2 = state["gate_k2"]
    demod.gate_keep_l = state["gate_keep_l"]
    demod._force_staged = state["force_staged"]
    m = state["mirror"]
    mirror.load(m["cur"], m["prev"], m["next_swap_ms"], m["capacity"])


def _load_filter(filt, icao: dict) -> None:
    filt.cur = set(icao["cur"])
    filt.prev = set(icao["prev"])
    filt.next_swap_ms = icao["next_swap_ms"]


def _finalize_gated(self: Demodulator, gc, n_keep: int, valid_len: int) -> list[RawFrame]:
    """Post-dispatch host half of the gated route."""
    (offs, cf, msg, s112, s56, sl, ss, pre_d, unk_d, bad_d, dcq, dcb) = _fetch(
        gc,
        ("offsets", "corr_fired", "msg", "syn112", "syn56", "sig_long", "sig_short",
         "pre_drop", "unknown_drop", "bad_drop", "drop_cum_q", "drop_cum_bnd"),
    )
    args = (offs, n_keep, cf, msg, s112, s56, _sigsum(sl), _sigsum(ss))
    kw = dict(
        scan_len=self.super_samples,
        block_scan_start=self.scan_global,
        carry_skip=self._skip,
        reset_every=self.block_samples,
    )
    with span("finalize"):
        if self.native is not None:
            frames, leftover = self.native.finalize_block(*args, **kw)
        else:
            frames, leftover = finalize_block(self.scorer, *args, **kw)
    self._skip = leftover if self.carry_skip else 0

    # drops inside NMS skip windows are never counted by the serial
    # finalizer; subtract them from the device totals (exact stats parity)
    with span("drops"):
        sk_u, sk_b = skipped_drops(
            frames, offs, dcq, dcb,
            block_scan_start=self.scan_global, reset_every=self.block_samples,
        )
    self._gate_drops[0] += int(pre_d) - sk_u - sk_b
    self._gate_drops[1] += int(unk_d) - sk_u
    self._gate_drops[2] += int(bad_d) - sk_b

    self.scan_global += valid_len
    now_ms = self.scan_global * 5 // 12000
    with span("icao"):
        if self.native is not None:
            self.native.icao_expire(now_ms)
        else:
            self.scorer.icao.expire(now_ms)
        # keep the device table == host filter state for the NEXT superblock
        self.icao_mirror.add_from_frames(frames)
        self.icao_mirror.expire(now_ms)
    return frames


class MultiDemodulator:
    """Channel-batched streaming demodulator.

    C independent receiver channels move through ONE device dispatch per
    superblock.  Per-channel frames, timestamps, and stats are identical
    with C independent Demodulators; the device-side ICAO table is the
    union of all channels' filters, a safe over-approximation for the
    score gate that keeps drop counters exact per channel via
    drop_cum_chan differencing.

    feed() takes one bytes chunk per channel (lockstep streams: C SDRs
    sharing one sample clock).
    """

    SEG_PAD = 512  # >= 326-sample halo + margin; keeps 256-alignment

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
        _check_fmt(fmt)
        self.device = _resolve_device(device)
        self.n_chan = n_chan
        self.fmt = fmt
        self.block_samples = block_samples
        self.seg_valid = block_samples * blocks_per_batch  # S per channel
        self.seg_stride = self.seg_valid + self.SEG_PAD
        self.scan_len = n_chan * self.seg_stride
        self.threshold = threshold
        self.nfix = nfix
        self.fix_df = fix_df
        self.k = k_per_block * blocks_per_batch * n_chan
        self.compact_l = 64
        self.gate_k2 = max(1024, 64 * n_chan)
        self.gate_keep_l = 64
        self.mirror = DeviceIcaoMirror(device=self.device)
        native_mod = _load_native(use_native)
        self.native = native_mod is not None
        self.fins = [
            native_mod.NativeFinalizer(nfix=nfix, fix_df=fix_df) if native_mod
            else Scorer(nfix=nfix, fix_df=fix_df)
            for _ in range(n_chan)
        ]
        self.scan_global = 0  # per-channel sample clock (lockstep)
        self._skips = [0] * n_chan
        self._pending = [b""] * n_chan
        self._gate_drops = [[0, 0, 0] for _ in range(n_chan)]
        self._force_staged = False  # as Demodulator's
        self.superblocks = self.candidates = self.kept = self.redispatches = 0  # as Demodulator's
        self._overlap_words = torch.full(
            (n_chan, TRAILING_SAMPLES), SILENT_WORD, dtype=torch.uint16, device=self.device
        )
        self._overlap_dev = torch.zeros(
            (n_chan, TRAILING_SAMPLES), dtype=torch.uint16, device=self.device
        )
        self.mean_level = np.zeros(n_chan)
        self.mean_power = np.zeros(n_chan)

    @property
    def raw_route(self) -> bool:
        """True when superblocks take the fused raw-UC8 route (always gated)."""
        return self.fmt == "uc8"

    def feed(self, raws: list[bytes]) -> list[list[RawFrame]]:
        """Feed one bytes chunk per channel; returns per-channel frames."""
        if len(raws) != self.n_chan:
            raise ValueError(f"expected {self.n_chan} channel chunks, got {len(raws)}")
        super_bytes = self.seg_valid * BYTES_PER_SAMPLE[self.fmt]
        with span("feed"):
            with span("stage", sb=self.superblocks):
                for c, r in enumerate(raws):
                    self._pending[c] = self._pending[c] + r if self._pending[c] else r
            out: list[list[RawFrame]] = [[] for _ in range(self.n_chan)]
            while min(len(p) for p in self._pending) >= super_bytes:
                with span("stage", sb=self.superblocks):
                    chunk = np.stack([np.frombuffer(p, dtype=np.uint8, count=super_bytes)
                                      for p in self._pending])
                    self._pending = [p[super_bytes:] for p in self._pending]
                got = self._process(chunk, self.seg_valid)
                with span("stage", sb=self.superblocks - 1):
                    del chunk  # the staged array's pages go back, counted as staging
                for c in range(self.n_chan):
                    out[c].extend(got[c])
            return out

    def flush(self) -> list[list[RawFrame]]:
        """Process the final partial superblock (EOF, zero-padded).

        Channels must be lockstep (same pending length) for exact parity;
        shorter channels are padded with zero bytes.
        """
        bps = BYTES_PER_SAMPLE[self.fmt]
        n = max(len(p) for p in self._pending) // bps
        if n == 0:
            self._pending = [b""] * self.n_chan
            return [[] for _ in range(self.n_chan)]
        super_bytes = self.seg_valid * bps
        chunk = np.zeros((self.n_chan, super_bytes), dtype=np.uint8)
        for c, p in enumerate(self._pending):
            chunk[c, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        self._pending = [b""] * self.n_chan
        return self._process(chunk, n)

    @_superblock
    def _process(self, chunk, valid_len: int) -> list[list[RawFrame]]:
        """One superblock: uint8[C, bytes] IQ bytes or, on the raw route,
        PRE-STAGED uint16[C, S] words on the device (no per-dispatch IQ
        upload)."""
        shape = (self.n_chan, self.seg_valid)
        if self.raw_route:
            if isinstance(chunk, torch.Tensor):
                samples = chunk.to(self.device)
            else:
                samples = _words_from_bytes(chunk, shape, self.device)
            if samples.dtype != torch.uint16 or tuple(samples.shape) != shape:
                raise ValueError(f"expected uint16{list(shape)} words")
            dispatch, overlaps = _demod_and_gate_multi_raw, self._overlap_words
        else:
            if isinstance(chunk, torch.Tensor):
                raise ValueError("pre-staged words are taken on the raw-UC8 route only")
            samples = _to_mag(chunk.reshape(-1), self.fmt, self.device).reshape(shape)
            dispatch, overlaps = _demod_and_gate_multi, self._overlap_dev
        while True:
            with span("dispatch"):
                out = dispatch(
                    samples, overlaps, valid_len, self.threshold, self.mirror.tbl,
                    k=self.k, scan_len=self.scan_len, l=self.compact_l,
                    k2=self.gate_k2, nfix=self.nfix, fix_df=self.fix_df,
                    reset_every=self.block_samples,
                    seg_stride=self.seg_stride, seg_valid=self.seg_valid,
                    keep_l=self.gate_keep_l, force_staged=self._force_staged,
                )
            gc = out if self.raw_route else out[0]
            n_keep = _fit_or_grow(self, gc)
            if n_keep is not None:
                break
        if self.raw_route:
            self._overlap_words = samples[:, -TRAILING_SAMPLES:].clone()
        else:
            _, self._overlap_dev, sums = out
            with span("fetch"):
                self.mean_level, self.mean_power = convert_ops.level_power(
                    sums.cpu().numpy(), valid_len
                )

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
            a, b = int(bounds[c]), int(bounds[c + 1])
            loc = offs[a:b] - c * self.seg_stride
            kw = dict(
                scan_len=self.seg_valid,
                block_scan_start=self.scan_global,
                carry_skip=self._skips[c],
                reset_every=self.block_samples,
            )
            args = (loc, b - a, cf[a:b], msgb[a:b], s112[a:b], s56[a:b], sl64[a:b], ss64[a:b])
            with span("finalize", ch=c):
                if self.native:
                    frames, _ = self.fins[c].finalize_block(*args, **kw)
                else:
                    frames, _ = finalize_block(self.fins[c], *args, **kw)
            self._skips[c] = 0  # carry_skip off (the Demodulator default)

            # exact per-channel drop statistics (see _finalize_gated); the
            # dcq/dcb slices hold GLOBAL cumulative counts, which
            # skipped_drops only ever differences
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
                if self.native:
                    fin.icao_expire(now_ms)
                else:
                    fin.icao.expire(now_ms)
            self.mirror.add_from_frames(all_frames)
            self.mirror.expire(now_ms)
        return results

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

    def channel_stats(self, c: int) -> DemodStats:
        return _stats_of(self.fins[c], self.native, self._gate_drops[c])

    def load_state(self, state: dict) -> None:
        """Continue C streams from state.demod_state_from_numpy(...)."""
        if self.native:
            raise ValueError("the ICAO filter hand-over needs use_native=False")
        if len(state["icao"]) != self.n_chan:
            raise ValueError("one ICAO filter state per channel expected")
        overlap = _overlap_of(
            state, self.raw_route, (self.n_chan, TRAILING_SAMPLES), self.device
        )
        if self.raw_route:
            self._overlap_words = overlap
        else:
            self._overlap_dev = overlap
            self.mean_level = np.broadcast_to(state["mean_level"], (self.n_chan,)).copy()
            self.mean_power = np.broadcast_to(state["mean_power"], (self.n_chan,)).copy()
        _load_common(self, self.mirror, state)
        for fin, icao in zip(self.fins, state["icao"]):
            _load_filter(fin.icao, icao)


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
