"""ACAS RA event logging: daily acas.csv / acas.json files.

Ports the reference's RA extraction and daily log writers
(json_out.c:175-630 sprintACASInfoShort/sprintACASJson/logACASInfoShort,
globe_index.c:3415 checkNewDayAcas, validity check comm_b.c:263-300).
RAs arrive as DF16 MV with VDS 3,0, Comm-B BDS 3,0 (DF20/21), or ES
type 28 subtype 2 (DF17/18); deduplication keeps one line per distinct
(addr, 7 bytes) within 300 ms (5 s once Clear-of-Conflict).

A copy of readsb_tpu's `io/acas.py`.
"""

from __future__ import annotations

import json
import os
import time


def _bit(b: bytes, n: int) -> int:
    """1-based MSB-first bit (getbit)."""
    return (b[(n - 1) // 8] >> (7 - ((n - 1) % 8))) & 1


def _bits(b: bytes, first: int, last: int) -> int:
    out = 0
    for n in range(first, last + 1):
        out = (out << 1) | _bit(b, n)
    return out


def ra_valid(bytes7: bytes, df: int) -> bool:
    """checkAcasRaValid (comm_b.c:263-300), non-debug path."""
    ara = _bit(bytes7, 9)
    rat = _bit(bytes7, 27)
    mte = _bit(bytes7, 28)
    if not (ara or rat or mte):
        return False
    if _bits(bytes7, 9, 28) == 0:
        return False
    if _bit(bytes7, 23) and _bit(bytes7, 24):
        return False
    if _bit(bytes7, 25) and _bit(bytes7, 26):
        return False
    if df == 16:
        return _bits(bytes7, 29, 56) == 0
    if _bit(bytes7, 25) or _bit(bytes7, 26):
        return False
    tti = _bits(bytes7, 29, 30)
    if tti == 3:
        return False
    return True


def advisory_text(bytes7: bytes) -> str:
    """Human-readable advisory (sprintACASJson, json_out.c:355-426)."""
    ara = _bit(bytes7, 9)
    rat = _bit(bytes7, 27)
    mte = _bit(bytes7, 28)
    out = []
    if rat:
        return "Clear of Conflict"
    if ara:
        corr = _bit(bytes7, 10)
        down = _bit(bytes7, 11)
        increase = _bit(bytes7, 12)
        reversal = _bit(bytes7, 13)
        crossing = _bit(bytes7, 14)
        positive = _bit(bytes7, 15)
        s = ""
        if corr and positive:
            if reversal:
                pass  # reversal phrasing below
            elif increase:
                s += "Increase "
            s += "Descend" if down else "Climb"
            if reversal:
                s += "; Descend" if down else "; Climb"
                s += " NOW"
            if crossing:
                s += "; Crossing"
                s += " Descend" if down else " Climb"
        if corr and not positive:
            s += "Level Off"
        if not corr and positive:
            s += "Maintain vertical Speed"
            if crossing:
                s += "; Crossing Maintain"
        if not corr and not positive:
            s += "Monitor vertical Speed"
        return s
    if mte:
        if _bit(bytes7, 10):
            out.append(" Correct upwards;")
        if _bit(bytes7, 11):
            out.append(" Climb required;")
        if _bit(bytes7, 12):
            out.append(" Correct downwards;")
        if _bit(bytes7, 13):
            out.append(" Descent required;")
        if _bit(bytes7, 14):
            out.append(" Crossing;")
        if _bit(bytes7, 15):
            out.append(" Increase / Maintain vertical rate")
        else:
            out.append(" Reduce / Limit vertical rate")
    return "".join(out)


_RACS_LONG = ["Do not pass below", "Do not pass above",
              "Do not turn left", "Do not turn right"]
_RACS_SHORT = ["not below", "not above", "not left ", "not right"]


def json_record(addr: int, bytes7: bytes, a, mm, now_ms: int) -> dict:
    rec = {
        "utc": time.strftime("%F %T", time.gmtime(now_ms // 1000))
        + ".%d" % ((now_ms % 1000) // 100),
        "unix_timestamp": round(now_ms / 1000.0, 2),
    }
    if mm is not None:
        rec["df_type"] = mm.msgtype
        rec["full_bytes"] = mm.msg.hex().upper()
    rec["bytes"] = bytes7.hex().upper()
    rec["ARA"] = "".join(str(_bit(bytes7, i)) for i in range(9, 16))
    rec["RAT"] = str(_bit(bytes7, 27))
    rec["MTE"] = str(_bit(bytes7, 28))
    rec["RAC"] = "".join(str(_bit(bytes7, i)) for i in range(23, 27))
    rec["advisory_complement"] = "; ".join(
        _RACS_LONG[i - 23] for i in range(23, 27) if _bit(bytes7, i)
    )
    rec["advisory"] = advisory_text(bytes7)
    tti = _bits(bytes7, 29, 30)
    rec["TTI"] = "".join(str(_bit(bytes7, i)) for i in (29, 30))
    if tti == 1:
        rec["threat_id_hex"] = "%06x" % _bits(bytes7, 31, 54)
    if a is not None:
        rec["hex"] = "%06x" % (addr & 0xFFFFFF)
        if a.seen_pos:
            rec["lat"] = round(a.lat, 6)
            rec["lon"] = round(a.lon, 6)
        if a.baro_alt is not None:
            rec["alt_baro"] = a.baro_alt
    return rec


def csv_line(addr: int, bytes7: bytes, a, mm, now_ms: int) -> str:
    """sprintACASInfoShort (json_out.c:443-540) comma format."""
    t = time.gmtime(now_ms // 1000)
    p = time.strftime("%F", t) + ","
    p += time.strftime("%T", t) + ".%d, " % ((now_ms % 1000) // 100)
    p += "%06x,DF:," % (addr & 0xFFFFFF)
    p += "%2u" % mm.msgtype if mm is not None else "  "
    p += ",bytes:," + bytes7.hex().upper() + ","
    if a is not None and a.seen_pos:
        p += "%11.6f,%11.6f," % (a.lat, a.lon)
    else:
        p += "           ,           ,"
    if a is not None and a.baro_alt is not None:
        p += "%5d,ft," % a.baro_alt
    else:
        p += "     ,ft,"
    rate = None
    if a is not None:
        rate = a.geom_rate if a.geom_rate is not None else a.baro_rate
    p += ("%5d" % rate if rate is not None else "     ") + ",fpm,"
    p += "ARA:," + "".join(str(_bit(bytes7, i)) for i in range(9, 16))
    p += ",RAT:,%u" % _bit(bytes7, 27)
    p += ",MTE:,%u" % _bit(bytes7, 28)
    p += ",RAC:," + "".join(str(_bit(bytes7, i)) for i in range(23, 27))
    p += ", "
    if _bits(bytes7, 23, 26):
        p += "".join(_RACS_SHORT[i - 23] for i in range(23, 27) if _bit(bytes7, i))
    else:
        p += advisory_text(bytes7)
    return p


class AcasLogger:
    """Day-rolled acas.csv / acas.json writers with the reference's
    dedup ring (logACASInfoShort, json_out.c:193-245)."""

    def __init__(self, history_dir: str):
        self.history_dir = history_dir
        self._day = None
        self._csv = None
        self._json = None
        self._dedup: list[tuple[int, bytes, int]] = []  # (addr, bytes, ts)
        self.events = 0

    def _roll(self, now_ms: int) -> None:
        day = time.strftime("%Y-%m-%d", time.gmtime(now_ms // 1000))
        if day == self._day:
            return
        self._day = day
        for f in (self._csv, self._json):
            if f:
                f.close()
        d = os.path.join(self.history_dir, day, "acas")
        os.makedirs(d, exist_ok=True)
        self._csv = open(os.path.join(d, "acas.csv"), "a")
        self._json = open(os.path.join(d, "acas.json"), "a")

    def log(self, addr: int, bytes7: bytes, a, mm, now_ms: int) -> bool:
        rat = _bit(bytes7, 27)
        ival = 5000 if rat else 300
        self._dedup = [
            (ad, by, ts) for ad, by, ts in self._dedup if now_ms - ts < 5000
        ]
        for ad, by, ts in self._dedup:
            if ad == addr and by == bytes7 and now_ms - ts < ival:
                return False
        self._dedup.append((addr, bytes7, now_ms))
        self._roll(now_ms)
        self._csv.write(csv_line(addr, bytes7, a, mm, now_ms) + "\n")
        self._csv.flush()
        self._json.write(json.dumps(json_record(addr, bytes7, a, mm, now_ms)) + "\n")
        self._json.flush()
        self.events += 1
        return True

    def close(self) -> None:
        for f in (self._csv, self._json):
            if f:
                f.close()
