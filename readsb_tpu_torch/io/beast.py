"""Beast binary wire protocol: framing, escaping, encode/decode.

Frame format (reference net_io.c:4737-5019 reader, 1655-1715 writer):
  0x1A <type> <6-byte 12MHz timestamp> <1-byte signal> <payload>
  type '1' = Mode-A/C (2 bytes), '2' = short Mode-S (7), '3' = long (14),
  '5' = radarcape position/status (21), 0xE3 = receiverId prefix (8 bytes),
  0xE8 = synthetic-timestamp prefix, 0xE4 UUID, 'P' ping, 'W' commands.
  0x1A bytes inside the body are escaped by doubling.

A copy of readsb_tpu's codec with its columnar deframer (ColumnarDeframer
over the native rtpu_beast_deframe).  The columnar deframer raises when
the native scanner cannot be built, and bridges the Python BeastDeframer
only when its caller asks for that (use_native=False).  One fault
of readsb_tpu is not copied: encode_frame writes a timestamp wider than
48 bits as its low 48 bits, as readsb's writer does, where readsb_tpu
raises OverflowError (a planefinder clock in 12 MHz ticks is 55 bits).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

ESC = 0x1A
MASK_48 = (1 << 48) - 1


@dataclasses.dataclass
class BeastFrame:
    msg: bytes  # 2 / 7 / 14 bytes
    timestamp: int  # 12 MHz
    signal_byte: int  # raw 0..255
    msg_type: int  # ord('1'), ord('2'), ord('3')
    receiver_id: int = 0  # from a preceding 0xE3 prefix
    synthetic_ms: int = 0  # from a preceding 0xE8 prefix

    @property
    def signal_level(self) -> float:
        s = self.signal_byte / 255.0
        return s * s


def _escape(payload: bytes) -> bytes:
    return payload.replace(b"\x1a", b"\x1a\x1a")


def encode_frame(
    msg: bytes, timestamp: int, signal_level: float = 0.0, modeac: bool = False
) -> bytes:
    """Encode one message as a Beast frame (modesSendBeastOutput)."""
    if modeac:
        t = ord("1")
    elif len(msg) == 7:
        t = ord("2")
    elif len(msg) == 14:
        t = ord("3")
    else:
        raise ValueError(f"bad message length {len(msg)}")
    sig = int(round(math.sqrt(max(0.0, min(1.0, signal_level))) * 255))
    # the wire holds the clock's low 48 bits (a planefinder clock is wider)
    body = (timestamp & MASK_48).to_bytes(6, "big") + bytes([sig]) + msg
    return bytes([ESC, t]) + _escape(body)


def encode_receiver_id(receiver_id: int) -> bytes:
    """0xE3-prefixed 8-byte receiverId (net_io.c:4819-4857)."""
    return bytes([ESC, 0xE3]) + _escape(receiver_id.to_bytes(8, "big"))


def encode_synthetic_ts(now_ms: int) -> bytes:
    """0xE8-prefixed 6-byte ms timestamp for replay (net_io.c:4772-4818)."""
    return bytes([ESC, 0xE8]) + _escape(now_ms.to_bytes(6, "big"))


MALFORMED_BYTES = [0]  # process-wide malformed-beast accounting (stats.c:830)


class BeastDeframer:
    """Incremental Beast stream parser.

    feed() yields BeastFrame records; receiverId / synthetic-timestamp
    prefixes apply to subsequent frames from the same connection.
    """

    MSG_LEN = {ord("1"): 2, ord("2"): 7, ord("3"): 14, ord("5"): 21}
    PREFIX_LEN = {0xE3: 8, 0xE8: 6, 0xE4: 16}

    def __init__(self):
        self._buf = bytearray()
        self.receiver_id = 0
        self.synthetic_ms = 0
        self.frames_bad = 0
        self.commands: list[bytes] = []  # 'P'/'W' payloads seen

    def feed(self, data: bytes) -> Iterator[BeastFrame]:
        self._buf += data
        buf = self._buf
        pos = 0
        n = len(buf)
        out = []
        while True:
            # find frame start
            i = buf.find(b"\x1a", pos)
            if i < 0 or i + 1 >= n:
                pos = n if i < 0 else i
                break
            t = buf[i + 1]
            if t == ESC:
                # doubled escape outside a frame: skip
                pos = i + 2
                continue
            body_len = None
            if t in self.MSG_LEN:
                body_len = 7 + self.MSG_LEN[t]
            elif t in self.PREFIX_LEN:
                body_len = self.PREFIX_LEN[t]
            elif t == ord("P"):
                body_len = 3  # 24-bit ping value (net_io.c:4885-4895)
            elif t == ord("W"):
                body_len = 1  # one command byte, e.g. 'O' (net_io.c:4896-4901)
            else:
                pos = i + 1
                self.frames_bad += 1
                MALFORMED_BYTES[0] += 1
                pos = i + 2
                continue

            # unescape body
            body = bytearray()
            j = i + 2
            ok = True
            while len(body) < body_len:
                if j >= n:
                    ok = False
                    break
                b = buf[j]
                if b == ESC:
                    if j + 1 >= n:
                        ok = False
                        break
                    if buf[j + 1] == ESC:
                        body.append(ESC)
                        j += 2
                        continue
                    else:
                        # new frame begins inside: truncated frame
                        break
                body.append(b)
                j += 1
            if not ok:
                pos = i
                break  # wait for more data
            if len(body) < body_len:
                # truncated by a new 0x1A: resync
                self.frames_bad += 1
                MALFORMED_BYTES[0] += 1
                pos = j
                continue

            if t in self.MSG_LEN:
                ts = int.from_bytes(body[0:6], "big")
                sig = body[6]
                msg = bytes(body[7 : 7 + self.MSG_LEN[t]])
                out.append(
                    BeastFrame(
                        msg=msg, timestamp=ts, signal_byte=sig, msg_type=t,
                        receiver_id=self.receiver_id, synthetic_ms=self.synthetic_ms,
                    )
                )
            elif t == 0xE3:
                self.receiver_id = int.from_bytes(body, "big")
            elif t == 0xE8:
                self.synthetic_ms = int.from_bytes(body, "big")
            elif t == 0xE4:
                pass  # UUID; connection identity handled by the server layer
            else:
                self.commands.append(bytes([t]) + bytes(body))
            pos = j

        del buf[:pos]
        return iter(out)


class ColumnarDeframer:
    """Columnar Beast deframer: feed() returns frame COLUMNS, not objects.

    The native C++ scanner (rtpu_beast_deframe — the analog of the
    reference's C readBeast, net_io.c:4737), built with g++ at first use;
    RuntimeError if it cannot be built.  use_native=False bridges the
    Python BeastDeframer instead.  Streams the same per-connection
    receiverId / synthetic-timestamp prefix state and command tokens.
    """

    def __init__(self, cap: int = 8192, use_native: bool = True):
        import numpy as np

        self._np = np
        self.cap = cap
        self._pending = b""
        self.receiver_id = 0
        self.synthetic_ms = 0
        self.frames_bad = 0
        self.commands: list[bytes] = []
        self._native = None
        if use_native:
            from .. import native as native_mod

            self._native = native_mod.load()
            if self._native is None:
                raise RuntimeError("native Beast deframer unavailable (g++ build failed)")
        self._py = None if self._native is not None else BeastDeframer()

    def feed(self, data: bytes) -> dict | None:
        """Returns {'msgs': (N,14) u8, 'ts': i64, 'sig': u8, 'mlen': i32,
        'rid': u64, 'synth': i64} or None when no frames completed."""
        np = self._np
        if self._native is None:
            return self._feed_py(data)
        import ctypes

        buf = self._pending + data
        batches = []
        while True:
            n = len(buf)
            if n == 0:
                break
            arr = np.frombuffer(buf, np.uint8)
            msgs = np.empty((self.cap, 14), np.uint8)
            ts = np.empty(self.cap, np.int64)
            sig = np.empty(self.cap, np.uint8)
            mlen = np.empty(self.cap, np.int32)
            rid = np.empty(self.cap, np.uint64)
            synth = np.empty(self.cap, np.int64)
            cmds = np.zeros((64, 4), np.uint8)
            io_rid = ctypes.c_uint64(self.receiver_id)
            io_synth = ctypes.c_int64(self.synthetic_ms)
            consumed = ctypes.c_long(0)
            bad = ctypes.c_long(0)
            n_cmds = ctypes.c_long(0)

            def p(a, t):
                return a.ctypes.data_as(ctypes.POINTER(t))

            got = self._native.rtpu_beast_deframe(
                p(arr, ctypes.c_uint8), n,
                p(msgs, ctypes.c_uint8), p(ts, ctypes.c_int64),
                p(sig, ctypes.c_uint8), p(mlen, ctypes.c_int32),
                p(rid, ctypes.c_uint64), p(synth, ctypes.c_int64),
                self.cap,
                ctypes.byref(io_rid), ctypes.byref(io_synth),
                ctypes.byref(consumed), ctypes.byref(bad),
                p(cmds, ctypes.c_uint8), 64, ctypes.byref(n_cmds),
            )
            self.receiver_id = io_rid.value
            self.synthetic_ms = io_synth.value
            self.frames_bad += bad.value
            MALFORMED_BYTES[0] += bad.value
            for k in range(n_cmds.value):
                t = int(cmds[k, 0])
                ln = 3 if t == ord("P") else 1
                self.commands.append(bytes([t]) + bytes(cmds[k, 1 : 1 + ln]))
            if got:
                batches.append(
                    dict(msgs=msgs[:got].copy(), ts=ts[:got].copy(),
                         sig=sig[:got].copy(), mlen=mlen[:got].copy(),
                         rid=rid[:got].copy(), synth=synth[:got].copy())
                )
            buf = buf[consumed.value:]
            if got < self.cap:
                break
        self._pending = bytes(buf)
        if not batches:
            return None
        if len(batches) == 1:
            return batches[0]
        return {
            k: np.concatenate([b[k] for b in batches]) for k in batches[0]
        }

    def _feed_py(self, data: bytes) -> dict | None:
        np = self._np
        frames = [f for f in self._py.feed(data)]
        self.receiver_id = self._py.receiver_id
        self.synthetic_ms = self._py.synthetic_ms
        self.frames_bad = self._py.frames_bad
        self.commands = self._py.commands
        if not frames:
            return None
        n = len(frames)
        msgs = np.zeros((n, 14), np.uint8)
        mlen = np.zeros(n, np.int32)
        for i, f in enumerate(frames):
            b = f.msg[:14]
            msgs[i, : len(b)] = np.frombuffer(b, np.uint8)
            mlen[i] = len(f.msg)
        return dict(
            msgs=msgs,
            ts=np.fromiter((f.timestamp for f in frames), np.int64, n),
            sig=np.fromiter((f.signal_byte for f in frames), np.uint8, n),
            mlen=mlen,
            rid=np.fromiter((f.receiver_id for f in frames), np.uint64, n),
            synth=np.fromiter((f.synthetic_ms for f in frames), np.int64, n),
        )
