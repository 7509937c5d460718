"""Mode A/C code handling: Gillham altitude conversion + message decode.

Behavioral contract mirrors the reference (wiedehopf/readsb mode_ac.c):
- modeAToModeC / modeCToModeA Gillham gray-code conversion tables
  (mode_ac.c:63-160)
- decodeModeAMessage: synthesizes a 16-bit pseudo-frame with msgtype
  DFTYPE_MODEAC = 77, a non-ICAO address derived from the Mode A code,
  squawk, SPI flag, and a Mode-C altitude when plausible (mode_ac.c:165+)
- index <-> modeA packing helpers (track.h:722-734)

plus the host-side serial finalizer for the device kernel in
ops.modeac (the "skip one frame after accept" rule, demod_2400.c:756).
"""

from __future__ import annotations

import functools

import numpy as np

from .fields import (
    AddrType,
    AirGround,
    INVALID_ALTITUDE,
    MODES_NON_ICAO_ADDRESS,
    ModesMessage,
    Source,
    squawk_hex_to_dec,
)

DFTYPE_MODEAC = 77


def modea_to_index(modea: int) -> int:
    """Pack hex-style Mode A code into a 0-4095 index (track.h:722-727)."""
    return (modea & 0x0007) | ((modea & 0x0070) >> 1) | ((modea & 0x0700) >> 2) | ((modea & 0x7000) >> 3)


def index_to_modea(index: int) -> int:
    return (index & 0o0007) | ((index & 0o0070) << 1) | ((index & 0o0700) << 2) | ((index & 0o7000) << 3)


def _modea_to_modec(modea: int) -> int:
    """Gillham gray-code to 100s-of-feet (mode_ac.c:101-160)."""
    five_hundreds = 0
    one_hundreds = 0

    if (modea & 0xFFFF8889) != 0 or (modea & 0x000000F0) == 0:
        return INVALID_ALTITUDE

    if modea & 0x0010:
        one_hundreds ^= 0x007  # C1
    if modea & 0x0020:
        one_hundreds ^= 0x003  # C2
    if modea & 0x0040:
        one_hundreds ^= 0x001  # C4
    if (one_hundreds & 5) == 5:
        one_hundreds ^= 2
    if one_hundreds > 5:
        return INVALID_ALTITUDE

    if modea & 0x0002:
        five_hundreds ^= 0x0FF  # D2
    if modea & 0x0004:
        five_hundreds ^= 0x07F  # D4
    if modea & 0x1000:
        five_hundreds ^= 0x03F  # A1
    if modea & 0x2000:
        five_hundreds ^= 0x01F  # A2
    if modea & 0x4000:
        five_hundreds ^= 0x00F  # A4
    if modea & 0x0100:
        five_hundreds ^= 0x007  # B1
    if modea & 0x0200:
        five_hundreds ^= 0x003  # B2
    if modea & 0x0400:
        five_hundreds ^= 0x001  # B4

    if five_hundreds & 1:
        one_hundreds = 6 - one_hundreds

    return five_hundreds * 5 + one_hundreds - 13


@functools.lru_cache(maxsize=None)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(modeA index -> modeC, modeC+13 -> modeA) LUTs (mode_ac.c:65-77)."""
    a_to_c = np.full(4096, INVALID_ALTITUDE, dtype=np.int32)
    c_to_a = np.zeros(4096, dtype=np.uint32)
    for i in range(4096):
        modea = index_to_modea(i)
        modec = _modea_to_modec(modea)
        a_to_c[i] = modec
        modec += 13
        if 0 <= modec < 4096 and modec != INVALID_ALTITUDE + 13:
            c_to_a[modec] = modea
    return a_to_c, c_to_a


def modea_to_modec(modea: int) -> int:
    """Mode A (hex-coded) -> Mode C altitude in 100s of feet, or
    INVALID_ALTITUDE."""
    i = modea_to_index(modea)
    return int(_tables()[0][i])


def modec_to_modea(modec: int) -> int:
    """Mode C (100s of feet) -> Mode A code, or 0."""
    modec += 13
    if modec < 0 or modec >= 4096:
        return 0
    return int(_tables()[1][modec])


def decode_modeac_message(modeac: int, timestamp: int = 0, sys_timestamp_ms: int = 0,
                          signal_level: float = 0.0) -> ModesMessage:
    """decodeModeAMessage (mode_ac.c:165-203): build the pseudo-frame."""
    mm = ModesMessage(
        msg=bytes([(modeac >> 8) & 0xFF, modeac & 0xFF]),
        msgbits=16,
        msgtype=DFTYPE_MODEAC,
        timestamp=timestamp,
        sys_timestamp_ms=sys_timestamp_ms,
        signal_level=signal_level,
    )
    mm.source = Source.MODE_AC
    mm.addrtype = AddrType.MODE_AC
    mm.addr = (modeac & 0x0000FF7F) | MODES_NON_ICAO_ADDRESS
    mm.squawk_hex = modeac & 0x7777
    mm.spi = bool(modeac & 0x0080)
    mm.spi_valid = True
    mm.airground = AirGround.UNCERTAIN
    if not mm.spi:
        modec = modea_to_modec(modeac)
        if modec != INVALID_ALTITUDE:
            mm.baro_alt = modec * 100
    return mm


def finalize_modeac(
    offsets: np.ndarray,
    ok: np.ndarray,
    modeac: np.ndarray,
    f2_clock: np.ndarray,
    n_cand: int,
    *,
    scan_len: int,
    block_scan_start: int = 0,
) -> list[tuple[int, int, int]]:
    """Serial accept pass over device candidates (demod_2400.c:756):
    an accepted frame skips the scan 20*87/25 samples forward; rejected
    candidates do not skip.

    Returns [(modeac, timestamp_12mhz, scan_offset_global), ...].
    """
    from ..ops.modeac import FRAME_SAMPLES

    out: list[tuple[int, int, int]] = []
    next_allowed = -1
    n = min(n_cand, len(offsets))
    for i in range(n):
        off = int(offsets[i])
        if off >= scan_len:
            break
        if off <= next_allowed:
            continue
        if not ok[i]:
            continue
        ts = block_scan_start * 5 + int(f2_clock[i]) // 5  # 60 MHz -> 12 MHz
        out.append((int(modeac[i]), ts, block_scan_start + off))
        next_allowed = off + FRAME_SAMPLES
    return out
