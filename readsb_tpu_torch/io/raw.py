"""AVR 'raw' ASCII wire format.

Lines like `*8d4840d6...;` (no timestamp), `@<12-hex-ts><hex>;` (with
12 MHz timestamp) and `<<12-hex-ts><2-hex-sig><hex>;` (with signal), as
parsed by the reference's decodeHexMessage (net_io.c:4104-4318) and
written by modesSendRawOutput (net_io.c:1837-1898).

A copy of readsb_tpu's codec, but encode_line writes a timestamp wider
than 48 bits as its low 48 bits, as the Beast writer does; readsb_tpu
writes every hex digit and so a line of the wrong width.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional


@dataclasses.dataclass
class RawLine:
    msg: bytes
    timestamp: int = 0
    signal_byte: int = 0


def encode_line(msg: bytes, timestamp: Optional[int] = None) -> bytes:
    if timestamp is None:
        return b"*" + msg.hex().encode() + b";\n"
    # the clock's low 48 bits, as in the Beast writer
    return b"@" + format(timestamp & ((1 << 48) - 1), "012x").encode() + msg.hex().encode() + b";\n"


class RawDeframer:
    def __init__(self):
        self._buf = b""
        self.lines_bad = 0

    def feed(self, data: bytes) -> Iterator[RawLine]:
        self._buf += data
        *lines, self._buf = self._buf.split(b"\n")
        for line in lines:
            line = line.strip().rstrip(b";")
            if not line:
                continue
            try:
                if line.startswith(b"*"):
                    h = line[1:]
                    yield RawLine(msg=bytes.fromhex(h.decode()))
                elif line.startswith(b"@"):
                    h = line[1:]
                    yield RawLine(
                        msg=bytes.fromhex(h[12:].decode()),
                        timestamp=int(h[:12], 16),
                    )
                elif line.startswith(b"<"):
                    h = line[1:]
                    yield RawLine(
                        msg=bytes.fromhex(h[14:].decode()),
                        timestamp=int(h[:12], 16),
                        signal_byte=int(h[12:14], 16),
                    )
                else:
                    self.lines_bad += 1
            except ValueError:
                self.lines_bad += 1
