"""Planefinder DLE-stuffed binary input protocol.

Reference: readPlanefinder (net_io.c:4670-4736) for framing and
decodePfMessage (net_io.c:3995-4103) for the packet-0xC1 payload:
DLE, ID=0xC1, pad, type byte (low nibble 0=Mode A/C, 1=short, 2=long;
bit4 = CRC present), signal byte, 4-byte epoch seconds, 4-byte
nanoseconds, raw frame bytes, DLE ETX trailer.  DLE bytes inside the
payload are escaped by doubling.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

DLE = 0x10
ETX = 0x03


@dataclasses.dataclass
class PfMessage:
    msg: bytes
    signal_byte: int
    timestamp_ns: int
    is_modeac: bool


class PfDeframer:
    def __init__(self):
        self._buf = b""
        self.frames_bad = 0

    def feed(self, data: bytes) -> Iterator[PfMessage]:
        self._buf += data
        buf = self._buf
        som = 0
        while True:
            start = buf.find(bytes([DLE]), som)
            if start < 0:
                self._buf = b""
                return
            # skip DLEs that are escapes / trailers, not frame starts
            if start + 1 < len(buf) and buf[start + 1] in (DLE, ETX):
                som = start + 1
                continue
            # find DLE ETX end, skipping over doubled DLEs
            p = start + 2
            end = -1
            while p < len(buf):
                if buf[p] == DLE:
                    if p + 1 >= len(buf):
                        break
                    if buf[p + 1] == ETX:
                        end = p + 1
                        break
                    p += 1  # escaped DLE: skip the pair
                p += 1
            if end < 0:
                self._buf = buf[start:]
                return
            frame = buf[start:end + 1]
            som = end + 1
            if frame[1] == 0xC1:
                msg = self._decode(frame)
                if msg is not None:
                    yield msg
                else:
                    self.frames_bad += 1

    @staticmethod
    def _decode(frame: bytes) -> PfMessage | None:
        # unstuff payload between <DLE, 0xC1> and <DLE, ETX>
        payload = bytearray()
        i = 2
        limit = len(frame) - 2
        while i < limit:
            if frame[i] == DLE and i + 1 < limit and frame[i + 1] == DLE:
                payload.append(DLE)
                i += 2
            else:
                payload.append(frame[i])
                i += 1
        if len(payload) < 11:
            return None
        typ = payload[1]
        kind = typ & 0x0F
        if kind == 0:
            msg_len = 2
        elif kind == 1:
            msg_len = 7
        elif kind == 2:
            msg_len = 14
        else:
            return None
        if len(payload) < 11 + msg_len:
            return None
        seconds = int.from_bytes(payload[3:7], "big")
        nanos = int.from_bytes(payload[7:11], "big")
        return PfMessage(
            msg=bytes(payload[11:11 + msg_len]),
            signal_byte=payload[2],
            timestamp_ns=seconds * 1_000_000_000 + nanos,
            is_modeac=kind == 0,
        )
