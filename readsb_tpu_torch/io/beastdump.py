"""Beast stream recorder: --dump-beast-dir (modesDumpBeastData, net_io.c:1716-1793).

A copy of readsb_tpu's `io/beastdump.py`, with readsb_tpu's names, that
writes through the port's zstd codec (`io/zstd.py`) in place of the
`zstandard` package.  Its rule on the format is readsb_tpu's: `.zst` chunks
where the codec loads, `.gz` otherwise.

Records every incoming beast frame with a 0xE8 synthetic-millisecond
prefix (and a 0xE3 receiver-id prefix when present) into rotating
zstd-compressed chunk files.  Replaying a chunk through the beast reader
with synthetic timestamps accepted reproduces the multi-feeder message
stream with virtualized time — the reference's de-facto aggregator test
vehicle (SURVEY §4).
"""

from __future__ import annotations

import gzip
import os
import time

from . import beast as beast_io
from . import zstd


def _escape(payload: bytes) -> bytes:
    return payload.replace(b"\x1a", b"\x1a\x1a")


def encode_synthetic_ts(ms: int) -> bytes:
    """0x1A 0xE8 + 6-byte big-endian milliseconds (net_io.c:4772-4818)."""
    return b"\x1a\xe8" + _escape(ms.to_bytes(6, "big"))


def encode_receiver_id(rid: int) -> bytes:
    """0x1A 0xE3 + 8-byte receiver id (net_io.c:4819-4857)."""
    return b"\x1a\xe3" + _escape(rid.to_bytes(8, "big"))


class BeastDumper:
    def __init__(self, directory: str, chunk_seconds: float = 30.0):
        self.dir = directory
        self.chunk_seconds = chunk_seconds
        os.makedirs(directory, exist_ok=True)
        self._fh = None
        self._writer = None
        self._chunk_start = 0.0

    def _rotate(self) -> None:
        self.close()
        ts = time.strftime("%Y%m%d-%H%M%S")
        have_zstd = zstd.available()
        ext = "zst" if have_zstd else "gz"
        path = os.path.join(self.dir, f"beast-{ts}.{ext}")
        self._fh = open(path, "wb")
        if have_zstd:
            self._writer = zstd.StreamWriter(self._fh, level=3)
        else:
            self._writer = gzip.GzipFile(fileobj=self._fh, mode="wb")
        self._chunk_start = time.time()

    def record(self, bf, now_ms: int) -> None:
        if self._writer is None or time.time() - self._chunk_start >= self.chunk_seconds:
            self._rotate()
        out = encode_synthetic_ts(bf.synthetic_ms or now_ms)
        if bf.receiver_id:
            out += encode_receiver_id(bf.receiver_id)
        modeac = len(bf.msg) == 2
        out += beast_io.encode_frame(
            bf.msg, bf.timestamp, bf.signal_level, modeac=modeac
        )
        self._writer.write(out)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:
                pass
            self._fh = None
