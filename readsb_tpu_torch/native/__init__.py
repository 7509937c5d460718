"""Native (C++) host finalizer, loaded via ctypes.

finalizer.cpp is compiled on demand with g++ into BUILD_DIR.  load()
returns None when no compiler is available; callers that pass
use_native=True turn that into an error.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .. import BUILD_DIR

_SRC = os.path.join(os.path.dirname(__file__), "finalizer.cpp")
_SO = os.path.join(BUILD_DIR, "libfinalizer.so")
_lock = threading.Lock()
_lib = None


class OutFrame(ctypes.Structure):
    _fields_ = [
        ("msg", ctypes.c_uint8 * 14),
        ("msgbits", ctypes.c_int32),
        ("timestamp", ctypes.c_int64),
        ("score", ctypes.c_int32),
        ("phase", ctypes.c_int32),
        ("correctedbits", ctypes.c_int32),
        ("addr", ctypes.c_uint32),
        ("signal_power", ctypes.c_float),
        ("iid", ctypes.c_uint32),
        ("scan_offset", ctypes.c_int64),
    ]


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, _SO)
    return True


def load():
    """Load (building if needed) the native library, or None."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.rtpu_ctx_new.restype = ctypes.c_void_p
        lib.rtpu_ctx_new.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rtpu_ctx_free.argtypes = [ctypes.c_void_p]
        lib.rtpu_icao_add.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.rtpu_icao_test.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.rtpu_icao_test.restype = ctypes.c_int
        lib.rtpu_icao_expire.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.rtpu_get_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.rtpu_finalize_block.restype = ctypes.c_int
        lib.rtpu_finalize_block.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(OutFrame), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


class NativeFinalizer:
    """Drop-in accelerated replacement for decode.score.Scorer+finalize_block."""

    def __init__(self, nfix: int = 1, fix_df: bool = True):
        lib = load()
        if lib is None:
            raise RuntimeError("native finalizer unavailable (g++ build failed)")
        self._lib = lib
        self._ctx = lib.rtpu_ctx_new(nfix, int(fix_df))
        self._out_cap = 4096
        self._out = (OutFrame * self._out_cap)()

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx is not None:
            self._lib.rtpu_ctx_free(ctx)
            self._ctx = None

    def icao_expire(self, now_ms: int) -> None:
        self._lib.rtpu_icao_expire(self._ctx, now_ms)

    def icao_add(self, addr: int) -> None:
        self._lib.rtpu_icao_add(self._ctx, addr)

    def icao_test(self, addr: int) -> bool:
        return bool(self._lib.rtpu_icao_test(self._ctx, addr))

    def stats(self):
        buf = (ctypes.c_int64 * 6)()
        self._lib.rtpu_get_stats(self._ctx, buf)
        return {
            "preambles": buf[0],
            "rejected_bad": buf[1],
            "rejected_unknown_icao": buf[2],
            "accepted": [buf[3], buf[4], buf[5]],
        }

    def finalize_block(
        self,
        offsets: np.ndarray,
        n_cand: int,
        corr_fired: np.ndarray,
        msg: np.ndarray,
        syn112: np.ndarray,
        syn56: np.ndarray,
        sigsum_long: np.ndarray,
        sigsum_short: np.ndarray,
        *,
        scan_len: int,
        block_scan_start: int = 0,
        carry_skip: int = 0,
        reset_every: int | None = None,
    ):
        offsets = np.ascontiguousarray(offsets, dtype=np.int32)
        corr_fired = np.ascontiguousarray(corr_fired, dtype=np.uint8)
        msg = np.ascontiguousarray(msg, dtype=np.uint8)
        syn112 = np.ascontiguousarray(syn112, dtype=np.int32)
        syn56 = np.ascontiguousarray(syn56, dtype=np.int32)
        sigsum_long = np.ascontiguousarray(sigsum_long, dtype=np.float32)
        sigsum_short = np.ascontiguousarray(sigsum_short, dtype=np.float32)
        k = len(offsets)
        if msg.shape != (k, 5, 14) or corr_fired.shape != (k, 3):
            raise ValueError(f"bad candidate shapes {msg.shape} {corr_fired.shape}")
        leftover = ctypes.c_int64(0)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        n = self._lib.rtpu_finalize_block(
            self._ctx,
            ptr(offsets, ctypes.c_int32), k, n_cand,
            ptr(corr_fired, ctypes.c_uint8),
            ptr(msg, ctypes.c_uint8),
            ptr(syn112, ctypes.c_int32), ptr(syn56, ctypes.c_int32),
            ptr(sigsum_long, ctypes.c_float), ptr(sigsum_short, ctypes.c_float),
            scan_len, block_scan_start, reset_every or 0, carry_skip,
            self._out, self._out_cap, ctypes.byref(leftover),
        )
        from ..decode.score import RawFrame

        frames = []
        for i in range(n):
            f = self._out[i]
            frames.append(
                RawFrame(
                    msg=bytes(f.msg[: f.msgbits // 8]),
                    msgbits=f.msgbits,
                    timestamp=f.timestamp,
                    score=f.score,
                    phase=f.phase,
                    correctedbits=f.correctedbits,
                    addr=f.addr,
                    signal_power=f.signal_power,
                    iid=f.iid,
                    scan_offset=f.scan_offset,
                )
            )
        return frames, int(leftover.value)
