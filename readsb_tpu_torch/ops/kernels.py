"""Hand-written CUDA kernels of the demod hot path, with their plain versions.

Each wrapper launches its CUDA kernel (csrc/*.cu, built with nvcc for
sm_90a into BUILD_DIR at first use and loaded with ctypes) when given
CUDA tensors, and runs its plain PyTorch version only when given CPU
tensors.  A failed build or launch raises.  `<wrapper>.launches` counts
the kernel launches, so a run can show that the main path used them.

  dense_scan_uc8     raw UC8 words -> corrbits, slicer sign planes packed
                     32 samples/word, split hi/lo prefix sums of mag^2
  extract_syndromes  candidate win rows -> CRC-24 syndromes, message
                     bytes and correlation bits for 5 phases
  mag_uc8            raw UC8 words -> uint16 magnitudes, equal to the LUT
  dense_scan         uint16 magnitudes -> the outputs of dense_scan_uc8
  extract_classify_v3  extract_syndromes plus the score gate's per-phase
                     flag word
  extract_classify   the same function, the TPU's plan-order datapath

The output contracts are those of readsb_tpu.ops.pallas_kernels
dense_scan_uc8_pallas, extract_syndromes_pallas, mag_uc8_pallas,
dense_scan_pallas, extract_classify_v3_pallas and extract_classify_pallas.
The two dense scans share one kernel (csrc/dense_scan.cuh), kernels 2, 5
and 6 one block kernel (csrc/extract.cuh, with the compile-time tap
schedule of csrc/extract_taps.cuh), and 5 and 6 the classifier
(csrc/classify.cuh).  The seventh kernel, the fused per-tile demodulator,
has its wrapper in ops/fused.py and is built and loaded here.

Each library is loaded once per process and made ready once per CUDA
device: the first time a tensor on cuda:k reaches it, its rtpu_init and
table setters run with cuda:k current, which copies its tables there and
sets its launch attributes there.  Every launch runs with the tensor's
device current, on that device's current stream, so one process launches
on any card.  A CUDA wrapper given a tensor that is not on a CUDA device
raises ValueError.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from .. import BUILD_DIR
from . import crc as crc_ops
from .convert import mag_uc8_words, mag_uc8_words_i32, sq_table_np, uc8_lut_np

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = (
    "dense_scan_uc8", "extract_syndromes", "mag_uc8", "dense_scan",
    "extract_classify_v3", "extract_classify", "fused_demod",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
TILE = 65536  # dense-scan length granule (the Pallas kernel's tile)
DENSE_TILE = 8192  # samples per CUDA block of the dense scan (csrc/dense_scan.cuh)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_ready: set[tuple[str, int]] = set()  # (library, CUDA device index) made ready there


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(force: bool = False) -> dict[str, str]:
    """Compile every csrc/*.cu into BUILD_DIR, one nvcc per source, all
    started together.  A library is rebuilt when its source or any header
    of csrc/ is newer.  Returns {name: ptxas report}; raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    procs = {}
    for name in SOURCES:
        src = os.path.join(CSRC, name + ".cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        newest = max(os.path.getmtime(f) for f in (src, *headers))
        if not force and os.path.exists(so) and os.path.getmtime(so) >= newest:
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, so,
        )
    reports = {}
    failed = []
    try:
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate(timeout=600)
            reports[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(tmp, so)
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:  # a timeout above: stop every compiler started
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DENSE_ARGS = [_P, _LL, _I, _P, _P, _P, _P, _P, _P]
_CLASSIFY_ARGS = [_P, _P, _LL, _P, _I, _P, _I, _P, _I, _P]
# the C entry point of each library (named as its source) takes these
_ARGTYPES = {
    "dense_scan_uc8": _DENSE_ARGS,
    "dense_scan": _DENSE_ARGS,
    "mag_uc8": [_P, _LL, _P, _P],
    "extract_syndromes": [_P, _P, _LL, _P, _P],
    "extract_classify_v3": [*_CLASSIFY_ARGS, _P, _P],
    "extract_classify": [*_CLASSIFY_ARGS, _P, _P],
    "fused_demod": [_P, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
}
# libraries built on csrc/extract.cuh hold its tables
_EXTRACT_LIBS = ("extract_syndromes", "extract_classify_v3", "extract_classify", "fused_demod")


def _load(name: str) -> ctypes.CDLL:
    """Build (if stale) and load the library `name`, its entry points typed."""
    build()
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
    lib.rtpu_cuda_error_string.restype = ctypes.c_char_p
    lib.rtpu_cuda_error_string.argtypes = [ctypes.c_int]
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    lib.rtpu_init.restype = ctypes.c_int
    lib.rtpu_init.argtypes = [ctypes.POINTER(ctypes.c_int)]
    if name in _EXTRACT_LIBS:
        lib.rtpu_extract_set_tables.restype = ctypes.c_int
        lib.rtpu_extract_set_tables.argtypes = [_P]
    if name == "dense_scan_uc8":
        lib.rtpu_dense_set_table.restype = ctypes.c_int
        lib.rtpu_dense_set_table.argtypes = [_P]
    return lib


def _prepare(name: str, lib: ctypes.CDLL, index: int) -> None:
    """Make `lib` ready on cuda:index, which is current: its tables, launch
    attributes and SM count there."""
    device = ctypes.c_int(-1)
    _check(lib, lib.rtpu_init(ctypes.byref(device)), "rtpu_init")
    if device.value != index:
        raise RuntimeError(f"{name}: rtpu_init ran on cuda:{device.value}, not cuda:{index}")
    if name in _EXTRACT_LIBS:
        _check(lib, lib.rtpu_extract_set_tables(syndrome_bytes_np().ctypes.data),
               "rtpu_extract_set_tables")
    if name == "dense_scan_uc8":
        _check(lib, lib.rtpu_dense_set_table(sq_table_np().ctypes.data), "rtpu_dense_set_table")


def _lib(name: str, index: int) -> ctypes.CDLL:
    """The library `name`, loaded at first use and ready on cuda:index."""
    with _lock:
        if name not in _libs:
            _libs[name] = _load(name)
        lib = _libs[name]
        if (name, index) not in _ready:
            with torch.cuda.device(index):
                _prepare(name, lib, index)
            _ready.add((name, index))
        return lib


def check_device(device: torch.device, what: str) -> None:
    """Raise ValueError unless `device` is a CUDA device: the kernels launch
    on CUDA devices only (a CPU tensor takes the plain version before this)."""
    if device.type != "cuda":
        raise ValueError(f"{what}: the tensor is on {device}, not on a CUDA device")


def _launch(name: str, t: torch.Tensor, *args) -> None:
    """Launch the library `name`'s entry point on t's device: args, then the
    stream, with that device current.  Raises on a CUDA error."""
    check_device(t.device, name)
    index = t.device.index
    lib = _lib(name, index)
    with torch.cuda.device(index):
        rc = getattr(lib, name)(*args, _stream(t))
    _check(lib, rc, name)


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.rtpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (the kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"


# ---------------------------------------------------------------------------
# Shared integer helpers
# ---------------------------------------------------------------------------


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def pack_plane_words(planes: torch.Tensor) -> torch.Tensor:
    """bool[P, L] -> int32[P, L // 32] little-endian bit packing (bit j of
    word w = plane value at sample 32*w + j; bit 31 makes the word negative)."""
    nplane, length = planes.shape
    nwords = length // 32
    b = planes[:, : nwords * 32].reshape(nplane, nwords, 32).to(torch.int64)
    sh = torch.arange(32, dtype=torch.int64, device=planes.device)
    return wrap_i32((b << sh).sum(-1))


# ---------------------------------------------------------------------------
# Kernels 1 and 4: the dense scan, of raw UC8 words and of magnitudes
# ---------------------------------------------------------------------------


def dense_from_mag(m: torch.Tensor, threshold: int, tail: int):
    """Dense scan of int32 magnitudes m[n] (n % 32 == 0); samples read past
    the end have magnitude `tail`.  Returns (corrbits int8[n], pwords
    int32[5, n // 32], cs_hi int32[n], cs_lo int32[n]):

      corrbits  bit0..2 = correlation A/B/C fired, bit3 = candidate
                (pre-check AND any correlation; demod_2400.c:311-378)
      pwords    five slicer sign planes, 32 samples per word
      cs_hi/lo  inclusive prefix sums of (mag^2 >> 16) / (mag^2 & 0xffff),
                wraparound int32
    """
    n = m.shape[0]
    if n % 32:
        raise ValueError(f"dense scan length {n} is not a multiple of 32")
    mext = torch.cat([m, torch.full((19,), tail, dtype=torch.int32, device=m.device)])

    def at(i):
        return mext[i : i + n]

    p1, p2, p3, p4, p5 = at(1), at(2), at(3), at(4), at(5)
    p7, p8, p9, p10, p11 = at(7), at(8), at(9), at(10), at(11)
    p12, p14, p15, p16, p17, p18 = at(12), at(14), at(15), at(16), at(17), at(18)
    pre = (p1 > p7) & (p12 > p14) & (p12 > p15)
    ref_level = ((p5 + p8 + p16 + p17 + p18) * int(threshold)) >> 5
    d23 = p2 - p3
    s14 = p1 + p4
    d1011 = p10 - p11
    common = s14 - d23 + p9 + p12
    corr_a = (common - d1011) >= ref_level  # phases 4, 5
    corr_b = (common + d1011) >= ref_level  # phases 6, 7
    corr_c = (s14 + 2 * d23 + d1011 + p12) >= ref_level  # phase 8
    cand = pre & (corr_a | corr_b | corr_c)
    corrbits = (
        corr_a.to(torch.int8)
        | (corr_b.to(torch.int8) << 1)
        | (corr_c.to(torch.int8) << 2)
        | (cand.to(torch.int8) << 3)
    )

    s0, s1, s2, s3 = at(0), p1, p2, p3
    planes = torch.stack(
        [
            (18 * s0 - 15 * s1 - 3 * s2) > 0,
            (14 * s0 - 5 * s1 - 9 * s2) > 0,
            (16 * s0 + 5 * s1 - 20 * s2) > 0,
            (7 * s0 + 11 * s1 - 18 * s2) > 0,
            (4 * s0 + 15 * s1 - 20 * s2 + s3) > 0,
        ]
    )
    pwords = pack_plane_words(planes)

    sq = m.to(torch.int64) * m.to(torch.int64)
    cs_hi = wrap_i32(torch.cumsum(sq >> 16, 0))
    cs_lo = wrap_i32(torch.cumsum(sq & 0xFFFF, 0))
    return corrbits, pwords, cs_hi, cs_lo


def dense_scan_uc8_plain(words: torch.Tensor, threshold: int):
    """Plain PyTorch version of dense_scan_uc8 (same contract)."""
    # a zero word past the end converts to full scale, as in the Pallas kernel
    return dense_from_mag(mag_uc8_words_i32(words), threshold, tail=int(uc8_lut_np()[0]))


def dense_scratch_words(n: int) -> int:
    """int32 words of the dense scan's scratch at length n: a 32-word head
    (the tile ticket) and per tile a status flag and two pairs of sums."""
    return 32 + 6 * (n // DENSE_TILE)


def _launch_dense(name: str, samples: torch.Tensor, threshold: int):
    """Allocate the outputs and launch the dense-scan library `name`."""
    samples = samples.contiguous()
    if samples.data_ptr() % 16:  # the kernel reads 16-byte chunks
        samples = samples.clone()
    n = samples.shape[0]
    dev = samples.device
    corr = torch.empty(n, dtype=torch.int8, device=dev)
    pwords = torch.empty((5, n // 32), dtype=torch.int32, device=dev)
    cs_hi = torch.empty(n, dtype=torch.int32, device=dev)
    cs_lo = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(dense_scratch_words(n), dtype=torch.int32, device=dev)
    _launch(
        name, samples, samples.data_ptr(), n, int(threshold),
        corr.data_ptr(), pwords.data_ptr(), cs_hi.data_ptr(), cs_lo.data_ptr(),
        scratch.data_ptr(),
    )
    return corr, pwords, cs_hi, cs_lo


def _check_dense_input(samples: torch.Tensor, what: str) -> None:
    if samples.dtype != torch.uint16 or samples.dim() != 1:
        raise ValueError(
            f"{what} must be 1-D uint16, got {samples.dtype} {tuple(samples.shape)}"
        )
    n = samples.shape[0]
    if n == 0 or n % TILE:
        raise ValueError(f"{what} length {n} is not a positive multiple of {TILE}")


def dense_scan_uc8(words: torch.Tensor, threshold: int):
    """Fused UC8 convert + dense scan.

    words: uint16[n], one interleaved uc8 I/Q pair per element (I in the
    low byte), n % 65536 == 0.  Samples past the end read as zero words,
    which convert to full-scale magnitudes: callers pad with >= 512 words
    beyond every candidate window and mask candidates to scan_len.
    Returns (corrbits int8[n], pwords int32[5, n // 32], cs_hi int32[n],
    cs_lo int32[n]) as in dense_from_mag.
    """
    _check_dense_input(words, "words")
    if _on_cpu(words):
        return dense_scan_uc8_plain(words, threshold)
    out = _launch_dense("dense_scan_uc8", words, threshold)
    dense_scan_uc8.launches += 1
    return out


dense_scan_uc8.launches = 0


def dense_scan_plain(mag: torch.Tensor, threshold: int):
    """Plain PyTorch version of dense_scan (same contract)."""
    return dense_from_mag(mag.to(torch.int32), threshold, tail=0)


def dense_scan(mag: torch.Tensor, threshold: int):
    """Dense scan of magnitudes.

    mag: uint16[n] magnitudes, n % 65536 == 0 (callers pad with zero
    magnitudes).  Samples past the end read as magnitude 0.  Returns
    (corrbits, pwords, cs_hi, cs_lo) as in dense_from_mag.
    """
    _check_dense_input(mag, "mag")
    if _on_cpu(mag):
        return dense_scan_plain(mag, threshold)
    out = _launch_dense("dense_scan", mag, threshold)
    dense_scan.launches += 1
    return out


dense_scan.launches = 0


# ---------------------------------------------------------------------------
# Kernel 3: UC8 words -> magnitudes
# ---------------------------------------------------------------------------


def mag_uc8(words: torch.Tensor) -> torch.Tensor:
    """UC8 words uint16[N] (one I/Q pair per element, I in the low byte) ->
    uint16[N] magnitudes, equal to the 64k LUT on every pair.  Any N.
    The plain version is the LUT gather, convert.mag_uc8_words."""
    if words.dtype != torch.uint16 or words.dim() != 1:
        raise ValueError(f"words must be 1-D uint16, got {words.dtype} {tuple(words.shape)}")
    if _on_cpu(words):
        return mag_uc8_words(words)
    words = words.contiguous()
    n = words.shape[0]
    out = torch.empty(n, dtype=torch.uint16, device=words.device)
    if n == 0:
        return out
    _launch("mag_uc8", words, words.data_ptr(), n, out.data_ptr())
    mag_uc8.launches += 1
    return out


mag_uc8.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: per-candidate extraction + syndromes
# ---------------------------------------------------------------------------

WIN_PLANE_WORDS = 19  # words per slicer plane in a win row (ops/demod.py)
WIN_CORR_BASE = 95  # first correlation-bitplane lane of a win row


@functools.lru_cache(maxsize=None)
def extract_tables_np() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tap int32[560], syn112 uint32[112], syn56 uint32[56]).

    tap[p * 112 + b] = (kid << 9) | aoff for slicer bit b of phase p
    (ops/demod.lattice_tables), written out as csrc/extract_taps.cuh;
    syn* are the per-bit CRC-24 syndromes, the rows of
    crc.syndrome_matrix(112) and (56) packed MSB first, from which
    syndrome_bytes_np builds the kernels' byte table.
    """
    from .demod import lattice_tables

    aoff, kid = lattice_tables()
    tap = ((kid.astype(np.int32) << 9) | aoff.astype(np.int32)).reshape(-1)
    s112 = crc_ops.single_bit_syndromes(112).astype(np.uint32)
    s56 = crc_ops.single_bit_syndromes(56).astype(np.uint32)
    return np.ascontiguousarray(tap), np.ascontiguousarray(s112), np.ascontiguousarray(s56)


@functools.lru_cache(maxsize=None)
def syndrome_bytes_np() -> np.ndarray:
    """uint32[14, 256]: t[pos, byte] = the CRC-24 syndrome of a 112-bit
    message that holds `byte` at byte `pos` and zeros elsewhere, the XOR of
    the per-bit syndromes of its set bits.  A message's syndrome is the XOR
    of its bytes' entries; byte pos of a 56-bit message lies as far from
    its end as byte pos + 7 of a 112-bit one, so it takes row pos + 7."""
    s112 = crc_ops.single_bit_syndromes(112).astype(np.uint32).reshape(14, 8)
    bits = (np.arange(256)[:, None] >> (7 - np.arange(8))[None, :]) & 1  # (256, 8), MSB first
    table = np.zeros((14, 256), dtype=np.uint32)
    for i in range(8):
        table ^= np.where(bits[None, :, i] == 1, s112[:, i, None], np.uint32(0))
    return np.ascontiguousarray(table)


def aligned_window(rows: torch.Tensor, offsets: torch.Tensor):
    """Win rows int32[K,128] + offsets int32[K] -> (sw int64[K,55], corr
    int64[K,3]): per candidate the five planes' 11 aligned window words
    (bit i of word plane * 11 + j = plane bit at offset + 32 j + i) and the
    three correlation bits at the candidate sample."""
    dev = rows.device
    k = rows.shape[0]
    r64 = rows.to(torch.int64) & 0xFFFFFFFF
    s = offsets.to(torch.int64) & 255
    wrot = s >> 5
    sb = (s & 31)[:, None, None]

    base = torch.arange(5, device=dev)[:, None] * WIN_PLANE_WORDS + torch.arange(12, device=dev)
    idx = (base[None] + wrot[:, None, None]).reshape(k, 60)
    sw_pre = torch.gather(r64, 1, idx).reshape(k, 5, 12)
    sw = funnel_align(sw_pre, sb).reshape(k, 55)

    cidx = WIN_CORR_BASE + torch.arange(3, device=dev)[None, :] * 8 + wrot[:, None]
    corr = (torch.gather(r64, 1, cidx) >> sb[:, :, 0]) & 1
    return sw, corr


def funnel_align(sw_pre: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """int64[..., 12] unsigned 32-bit words -> int64[..., 11]: each word
    shifted right by sb (0..31) with the next word's low bits shifted in."""
    lo = sw_pre[..., :11] >> sb
    hi = (sw_pre[..., 1:] & ((1 << sb) - 1)) << (32 - sb)  # 0 when sb == 0
    return lo | hi


def lanes_from_counts(counts: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """Bit-sum counts int64[K,5,62] (demod._combined_matrix columns per
    phase) + corr int64[K,3] -> int64[K,83]: lanes 0:5 syn112, 5:10 syn56,
    10:80 message bytes, 80:83 correlation bits."""
    k = counts.shape[0]
    w24 = 1 << torch.arange(23, -1, -1, device=counts.device)
    syn112 = ((counts[:, :, 0:24] & 1) * w24).sum(-1)
    syn56 = ((counts[:, :, 24:48] & 1) * w24).sum(-1)
    msg = counts[:, :, 48:62].reshape(k, 70)
    return torch.cat([syn112, syn56, msg, corr], dim=1)


def lanes_from_aligned(sw: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """Aligned window words int64[K,55] + corr int64[K,3] -> int64[K,83].

    Bits are picked in (phase, bit) order with integer ops; syndromes and
    message bytes come from one float32 product with
    demod._combined_matrix, exact because every entry and every sum is an
    integer below 2^8 (so TF32 would be exact too).
    """
    from .demod import _combined_matrix, lattice_tables

    dev = sw.device
    k = sw.shape[0]
    aoff, kid = lattice_tables()
    word = torch.from_numpy((kid * 11 + (aoff >> 5)).reshape(-1).astype(np.int64)).to(dev)
    shift = torch.from_numpy((aoff & 31).reshape(-1).astype(np.int64)).to(dev)
    bits = (sw[:, word] >> shift) & 1  # (K, 560)
    comb = torch.from_numpy(_combined_matrix()).to(dev)
    counts = (bits.to(torch.float32).reshape(k * 5, 112) @ comb).to(torch.int64)
    return lanes_from_counts(counts.reshape(k, 5, 62), corr)


def pad_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """int64[K, L <= 128] -> int32[K,128], zero-filled."""
    k, used = lanes.shape
    pad = torch.zeros((k, 128 - used), dtype=torch.int64, device=lanes.device)
    return torch.cat([lanes, pad], dim=1).to(torch.int32)


def extract_syndromes_plain(rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of extract_syndromes (same contract)."""
    return pad_lanes(lanes_from_aligned(*aligned_window(rows, offsets)))


def _check_rows(rows: torch.Tensor, offsets: torch.Tensor) -> int:
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != 128:
        raise ValueError(f"rows must be int32[K, 128], got {rows.dtype} {tuple(rows.shape)}")
    k = rows.shape[0]
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (k,):
        raise ValueError(f"offsets must be int32[{k}], got {offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device != rows.device:
        raise ValueError("rows and offsets must be on one device")
    return k


def extract_syndromes(rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(K,128) int32 win rows + (K,) int32 offsets -> (K,128) int32.

    Per candidate the win row is aligned by offset & 255 and 5 phases x
    112 slicer bits are unpacked.  Lanes 0:5 syn112 per phase, 5:10 syn56
    (CRC-24 over the first 56 bits), 10:80 message bytes (phase-major, 14
    per phase), 80:83 correlation-lane bits, the rest 0.  Any K.
    """
    k = _check_rows(rows, offsets)
    if _on_cpu(rows):
        return extract_syndromes_plain(rows, offsets)
    rows = rows.contiguous()
    offsets = offsets.contiguous()
    out = torch.empty((k, 128), dtype=torch.int32, device=rows.device)
    if k == 0:
        return out
    _launch("extract_syndromes", rows, rows.data_ptr(), offsets.data_ptr(), k, out.data_ptr())
    extract_syndromes.launches += 1
    return out


extract_syndromes.launches = 0


# ---------------------------------------------------------------------------
# Kernels 5 and 6: extraction fused with the gate's per-phase classification
# ---------------------------------------------------------------------------

PLAN_WORDS = 576  # the 560 emission lanes padded to 18 rounds of 32


@functools.lru_cache(maxsize=None)
def extract_plan_words_np() -> np.ndarray:
    """int32[576]: demod._extract_plan's 560 emission lanes in plan order,
    one word each: aligned window word (plane * 11 + j, 6 bits) | bit
    shift << 6 | message bit << 11 | phase << 18.  The 16 padding words
    carry phase 7.  The plan picks the taps of csrc/extract_taps.cuh in
    another order, which is why extract_classify's kernel is cand_rows."""
    from .demod import extract_plan_lanes

    word, shift, col = extract_plan_lanes()
    out = np.full(PLAN_WORDS, 7 << 18, np.int32)
    out[: len(word)] = word | (shift << 6) | ((col % 112) << 11) | ((col // 112) << 18)
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(nfix: int, fix_df: bool, device: torch.device):
    """(t112, t56, dfd) of gate.gate_tables_np as int32 tensors on
    `device`, made once per (nfix, fix_df) pair and device."""
    from .gate import gate_tables_np

    return tuple(torch.from_numpy(a.copy()).to(device) for a in gate_tables_np(nfix, fix_df))


def extract_classify_v3_plain(rows, offsets, known_tbl, *, nfix: int = 1, fix_df: bool = True):
    """Plain PyTorch version of extract_classify_v3: extract_syndromes_plain
    plus gate.classify_plain in lanes 83:88."""
    from .gate import classify_plain

    lanes = lanes_from_aligned(*aligned_window(rows, offsets))
    flags = classify_plain(lanes[:, 0:5], lanes[:, 5:10], lanes[:, 10:80], known_tbl, nfix, fix_df)
    return pad_lanes(torch.cat([lanes, flags.to(torch.int64)], dim=1))


def extract_classify_plain(rows, offsets, known_tbl, *, nfix: int = 1, fix_df: bool = True):
    """Plain PyTorch version of extract_classify: the same function as
    extract_classify_v3_plain by readsb_tpu's plan-order datapath
    (demod._extract_plan): the 560 bits are emitted grouped by (plane,
    word), and the column permutation is folded into the product's matrix."""
    from .demod import _extract_plan, extract_plan_lanes
    from .gate import classify_plain

    dev = rows.device
    sw, corr = aligned_window(rows, offsets)
    word, shift, _ = extract_plan_lanes()
    bits = (sw[:, torch.from_numpy(word.astype(np.int64)).to(dev)]
            >> torch.from_numpy(shift.astype(np.int64)).to(dev)) & 1  # (K, 560) in plan order
    m = torch.from_numpy(_extract_plan()[1]).to(dev)  # (560, 310), exact in float32
    counts = (bits.to(torch.float32) @ m).to(torch.int64).reshape(rows.shape[0], 5, 62)
    lanes = lanes_from_counts(counts, corr)
    flags = classify_plain(lanes[:, 0:5], lanes[:, 5:10], lanes[:, 10:80], known_tbl, nfix, fix_df)
    return pad_lanes(torch.cat([lanes, flags.to(torch.int64)], dim=1))


def _check_known(known_tbl: torch.Tensor, rows: torch.Tensor) -> None:
    if known_tbl.dtype != torch.int32 or known_tbl.dim() != 1:
        raise ValueError(
            f"known_tbl must be 1-D int32, got {known_tbl.dtype} {tuple(known_tbl.shape)}"
        )
    t = known_tbl.shape[0]
    if t == 0 or t % 128:
        raise ValueError(f"known_tbl length {t} is not a positive multiple of 128")
    if known_tbl.device != rows.device:
        raise ValueError("rows and known_tbl must be on one device")


def _launch_classify(wrapper, rows, offsets, known_tbl, nfix: int, fix_df: bool):
    """Allocate the output, launch the library named as `wrapper` and count
    the launch on it."""
    name = wrapper.__name__
    k = rows.shape[0]
    rows = rows.contiguous()
    offsets = offsets.contiguous()
    known_tbl = known_tbl.contiguous()
    out = torch.empty((k, 128), dtype=torch.int32, device=rows.device)
    if k == 0:
        return out
    t112, t56, dfd = _device_tables(int(nfix), bool(fix_df), rows.device)
    _launch(
        name, rows, rows.data_ptr(), offsets.data_ptr(), k,
        known_tbl.data_ptr(), known_tbl.shape[0],
        t112.data_ptr(), t112.shape[0], t56.data_ptr(), t56.shape[0], dfd.data_ptr(),
        out.data_ptr(),
    )
    wrapper.launches += 1
    return out


def extract_classify_v3(rows, offsets, known_tbl, *, nfix: int = 1, fix_df: bool = True):
    """extract_syndromes plus the score gate's per-phase classification.

    rows int32[K,128], offsets int32[K] as extract_syndromes; known_tbl
    int32[T], T % 128 == 0: the known-ICAO addresses SORTED ascending and
    padded at the end with gate.TBL_SENTINEL (what DeviceIcaoMirror.tbl
    hands out; the kernel searches it, it does not scan it).  nfix and
    fix_df select the static tables of gate.gate_tables_np.

    Returns int32[K,128]: lanes 0:83 as extract_syndromes, 83:88 one flag
    word per phase (1 in_t112, 2 in_t56, 4 in_tbl, 8 fix_ok, 16 zero7; see
    gate.classify_plain), the rest 0.  Any K, sentinel rows included: a row
    past the candidates is classified like any other.
    """
    _check_rows(rows, offsets)
    _check_known(known_tbl, rows)
    if _on_cpu(rows):
        return extract_classify_v3_plain(rows, offsets, known_tbl, nfix=nfix, fix_df=fix_df)
    return _launch_classify(extract_classify_v3, rows, offsets, known_tbl, nfix, fix_df)


extract_classify_v3.launches = 0


def extract_classify(rows, offsets, known_tbl, *, nfix: int = 1, fix_df: bool = True):
    """The function of extract_classify_v3, bit for bit; readsb_tpu
    computes it by the plan-order datapath (demod._extract_plan), which
    picks the same 560 taps in another order, so on the card it is the same
    lane-per-candidate block kernel (csrc/extract_classify.cu).  The
    pipeline calls extract_classify_v3; this one is held by the tests and
    timed beside it."""
    _check_rows(rows, offsets)
    _check_known(known_tbl, rows)
    if _on_cpu(rows):
        return extract_classify_plain(rows, offsets, known_tbl, nfix=nfix, fix_df=fix_df)
    return _launch_classify(extract_classify, rows, offsets, known_tbl, nfix, fix_df)


extract_classify.launches = 0
