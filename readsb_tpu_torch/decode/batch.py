"""Vectorized batch decode of the hot DFs: numpy columns, no per-message
Python objects.

The aggregator ingest path drains thousands of frames per tick; building
a ModesMessage dataclass per frame caps the rate at ~30k msgs/s.  This
module decodes a whole drained batch of raw 14-byte frames into columnar
numpy arrays in a handful of vector ops (the data-plane analog of the
reference's decodeTask batches, net_io.c:5365-5474).

Covered (the high-rate message types; SURVEY §2.1 DF map):
  DF17/18  airborne position (metype 9-18, 20-22): CPR, AC12 altitude,
           NIC-B  (mode_s.c:1016-1102)
  DF17/18  surface position (metype 5-8): CPR, movement  (mode_s.c:979)
  DF17/18  velocity (metype 19 sub 1-4): GS/track or IAS/TAS, rates
           (mode_s.c:871-978)
  DF17/18  ident (metype 1-4): callsign  (mode_s.c:806-846)
  DF11     all-call: address only
  DF4/20   altitude reply: AC13  (mode_s.c:110-178)
  DF5/21   identity reply: ID13 squawk  (mode_s.c:83-108)

Everything else keeps the scalar decode_frame path (low rate).

A copy of readsb_tpu's module, unchanged.
"""

from __future__ import annotations

import numpy as np

from .fields import CprType, Source


def _bits(msg: np.ndarray, first: int, last: int) -> np.ndarray:
    """getbits() over a (N, 14) uint8 matrix: message bits first..last
    (1-based, MSB-first) -> int64 column.  Byte-wise assembly (a whole
    byte per op instead of a bit per op)."""
    f0 = first - 1
    l0 = last  # exclusive
    nbits = l0 - f0
    out = np.zeros(len(msg), np.int64)
    got = 0
    b = f0
    while b < l0:
        byte = b // 8
        hi = b % 8  # bits already consumed in this byte
        take = min(8 - hi, l0 - b)
        chunk = (msg[:, byte].astype(np.int64, copy=False) >> (8 - hi - take)) & ((1 << take) - 1)
        out = (out << take) | chunk
        b += take
        got += take
    assert got == nbits
    return out


def _me_bits(msg: np.ndarray, first: int, last: int) -> np.ndarray:
    """getbits over the ME field (message bit 32 + n)."""
    return _bits(msg, 32 + first, 32 + last)


def _ac12_to_alt(ac12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """AC12 altitude (mode_s.c:147-178): (alt_ft int64, valid bool)."""
    q = (ac12 & 0x10) != 0
    # Q=1: 25 ft steps
    n = ((ac12 & 0x0FE0) >> 1) | (ac12 & 0x000F)
    alt_q = n * 25 - 1000
    # Q=0 (Gillham) is rare; flag invalid here, scalar path handles it
    valid = q & (ac12 != 0)
    return alt_q, valid


def _ac13_to_alt(ac13: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """AC13 altitude (mode_s.c:110-145), M-bit metric + Q-bit 25ft."""
    m = (ac13 & 0x0040) != 0
    q = (ac13 & 0x0010) != 0
    n = ((ac13 & 0x1F80) >> 2) | ((ac13 & 0x0020) >> 1) | (ac13 & 0x000F)
    alt_q = n * 25 - 1000
    valid = (~m) & q & (ac13 != 0)
    return alt_q, valid


def decode_columns(
    msgs: np.ndarray,
    timestamps: np.ndarray,
    addrs: np.ndarray | None = None,
    corrected: np.ndarray | None = None,
) -> dict:
    """Decode (N, 14) uint8 frames -> columnar fields.

    addrs: the CRC-stage addresses (RawFrame.addr) — required for DF4/5/
    20/21 whose address is the CRC residual, not a message field.  When
    omitted, the AA bits are used (valid for DF11/17/18 only).

    Returns a dict of numpy arrays, all length N.  Validity columns are
    boolean masks; invalid entries hold zeros.
    """
    n = len(msgs)
    msgs_u8 = msgs
    msgs = msgs.astype(np.int64)  # one widening; every _bits call reuses it
    df = msgs[:, 0] >> 3
    out = {
        "df": df,
        "ts": timestamps,
        "addr": (
            np.asarray(addrs, np.int64) & 0xFFFFFF
            if addrs is not None
            else _bits(msgs, 9, 32).astype(np.int64)
        ),
        "source": np.full(n, int(Source.ADSB), np.int64),
        "cpr_valid": np.zeros(n, bool),
        "cpr_odd": np.zeros(n, bool),
        "cpr_lat": np.zeros(n, np.int64),
        "cpr_lon": np.zeros(n, np.int64),
        "cpr_surface": np.zeros(n, bool),
        "metype": np.zeros(n, np.int64),
        "nic_b": np.zeros(n, np.int64),
        "alt_valid": np.zeros(n, bool),
        "alt": np.zeros(n, np.int64),
        "gs_valid": np.zeros(n, bool),
        "gs": np.zeros(n),
        "track_valid": np.zeros(n, bool),
        "track": np.zeros(n),
        "squawk_valid": np.zeros(n, bool),
        "squawk": np.zeros(n, np.int64),
        "baro_rate_valid": np.zeros(n, bool),
        "baro_rate": np.zeros(n, np.int64),
        "geom_rate_valid": np.zeros(n, bool),
        "geom_rate": np.zeros(n, np.int64),
        "alt_q": np.zeros(n, bool),  # AC12/AC13 q bit (updateAltitude guard)
        # crc == 0 (updateAltitude implicit-trust rule): clean DF17/18 only;
        # other DFs carry a nonzero residual/IID by construction.  With no
        # corrected-bits column the frames are assumed clean (None default
        # = pre-validated feeds).
        "crc_zero": ((df == 17) | (df == 18))
        & (np.ones(n, bool) if corrected is None else np.asarray(corrected) == 0),
        "callsign_valid": np.zeros(n, bool),
        "callsign": np.zeros((n, 8), np.uint8),
    }

    # DF18 CF 3 (TIS-B coarse), 4 and 7 carry no standard ES payload —
    # the scalar decoder returns before field extraction (fields.py DF18
    # dispatch, mode_s.c:846-869); match it so columnar decode never
    # invents positions from coarse TIS-B frames
    cf18 = (msgs[:, 0] & 7).astype(np.int64)
    es = (df == 17) | ((df == 18) & (cf18 != 3) & (cf18 != 4) & (cf18 != 7))
    metype = np.where(es, _me_bits(msgs, 1, 5), 0)
    out["metype"] = metype

    # sources by DF (decode_frame's mapping; DF18 CF variants take the
    # scalar path upstream)
    for d in (0, 4, 5, 16, 20, 21):
        out["source"][df == d] = int(Source.MODE_S)
    out["source"][df == 11] = int(Source.MODE_S_CHECKED)

    # airground: CA field for DF11/17, FS for DF4/5/20/21 (fields.py:709-744)
    from .fields import AirGround

    ag = np.full(n, int(AirGround.UNCERTAIN), np.int64)
    ca = _bits(msgs, 6, 8)
    ca_map = np.full(8, int(AirGround.UNCERTAIN), np.int64)
    ca_map[4] = int(AirGround.GROUND)
    ca_map[5] = int(AirGround.AIRBORNE)
    is_ca = (df == 11) | (df == 17)
    ag = np.where(is_ca, ca_map[ca & 7], ag)
    fs = ca  # same bits 6-8
    is_fs = (df == 4) | (df == 5) | (df == 20) | (df == 21)
    fs_ground = (fs == 1) | (fs == 3)
    ag = np.where(is_fs & fs_ground, int(AirGround.GROUND), ag)
    out["airground"] = ag

    # --- airborne position -------------------------------------------------
    air = es & (((metype >= 9) & (metype <= 18)) | ((metype >= 20) & (metype <= 22)))
    cpr_lat = _me_bits(msgs, 23, 39)
    cpr_lon = _me_bits(msgs, 40, 56)
    ac12 = _me_bits(msgs, 9, 20)
    corrupt15 = (ac12 == 0) & (cpr_lon == 0) & ((cpr_lat & 0x0FFF) == 0) & (metype == 15)
    pos_ok = air & ~corrupt15
    out["cpr_valid"] |= pos_ok
    out["cpr_odd"] = np.where(pos_ok, _me_bits(msgs, 22, 22) != 0, out["cpr_odd"])
    out["cpr_lat"] = np.where(pos_ok, cpr_lat, out["cpr_lat"])
    out["cpr_lon"] = np.where(pos_ok, cpr_lon, out["cpr_lon"])
    out["nic_b"] = np.where(air, _me_bits(msgs, 8, 8), out["nic_b"])
    alt_q, alt_ok = _ac12_to_alt(ac12)
    baro = air & (metype <= 18)  # metype 20-22: geometric (arena v2: baro only)
    # on-ground reports carry no usable AC12 altitude (fields.py
    # _decode_es_airborne: `ac12 and airground != GROUND`)
    not_ground = ag != int(AirGround.GROUND)
    out["alt_valid"] |= baro & alt_ok & not_ground
    out["alt"] = np.where(baro & alt_ok & not_ground, alt_q, out["alt"])
    out["alt_q"] |= baro & alt_ok & not_ground & ((ac12 & 0x10) != 0)

    # --- surface position --------------------------------------------------
    surf = es & (metype >= 5) & (metype <= 8)
    out["airground"] = np.where(surf, int(AirGround.GROUND), out["airground"])
    out["cpr_valid"] |= surf
    out["cpr_surface"] |= surf
    out["cpr_odd"] = np.where(surf, _me_bits(msgs, 22, 22) != 0, out["cpr_odd"])
    out["cpr_lat"] = np.where(surf, cpr_lat, out["cpr_lat"])
    out["cpr_lon"] = np.where(surf, cpr_lon, out["cpr_lon"])

    # --- velocity ----------------------------------------------------------
    vel = es & (metype == 19)
    mesub = np.where(vel, _me_bits(msgs, 6, 8), 0)
    gvel = vel & ((mesub == 1) | (mesub == 2))
    ew_raw = _me_bits(msgs, 15, 24)
    ns_raw = _me_bits(msgs, 26, 35)
    both = gvel & (ew_raw != 0) & (ns_raw != 0)
    scale = np.where(mesub == 2, 4, 1)
    ew = (ew_raw - 1) * np.where(_me_bits(msgs, 14, 14) != 0, -1, 1) * scale
    ns = (ns_raw - 1) * np.where(_me_bits(msgs, 25, 25) != 0, -1, 1) * scale
    gs = np.sqrt((ns * ns + ew * ew).astype(np.float64) + 0.5).astype(np.float32).astype(np.float64)
    out["gs_valid"] |= both
    out["gs"] = np.where(both, gs, out["gs"])
    trk = np.degrees(np.arctan2(ew.astype(np.float64), ns.astype(np.float64)))
    trk = np.where(trk < 0, trk + 360.0, trk)
    tr_ok = both & (gs > 0)
    out["track_valid"] |= tr_ok
    out["track"] = np.where(tr_ok, trk, out["track"])

    # vertical rates (fields.py: VR bits 38-46, sign 37, baro/geom select 36)
    sub_ok = vel & (mesub >= 1) & (mesub <= 4)
    vr = _me_bits(msgs, 38, 46)
    rate = (vr - 1) * np.where(_me_bits(msgs, 37, 37) != 0, -64, 64)
    vr_ok = sub_ok & (vr != 0)
    is_baro = _me_bits(msgs, 36, 36) != 0
    out["baro_rate_valid"] |= vr_ok & is_baro
    out["baro_rate"] = np.where(vr_ok & is_baro, rate, out["baro_rate"])
    out["geom_rate_valid"] |= vr_ok & ~is_baro
    out["geom_rate"] = np.where(vr_ok & ~is_baro, rate, out["geom_rate"])

    # --- ident -------------------------------------------------------------
    ident = es & (metype >= 1) & (metype <= 4)
    if ident.any():
        from .ais import AIS_CHARSET

        lut = np.frombuffer(AIS_CHARSET.encode("latin1"), dtype=np.uint8)
        for c in range(8):
            six = _me_bits(msgs, 9 + 6 * c, 14 + 6 * c)
            out["callsign"][:, c] = np.where(ident, lut[six & 63], 0)
        out["callsign_valid"] |= ident
    out["ident"] = ident

    # --- DF4/20 altitude, DF5/21 squawk -------------------------------------
    alt_reply = (df == 4) | (df == 20)
    ac13 = _bits(msgs, 20, 32)
    alt13, ok13 = _ac13_to_alt(ac13)
    out["alt_valid"] |= alt_reply & ok13
    out["alt"] = np.where(alt_reply & ok13, alt13, out["alt"])
    out["alt_q"] |= alt_reply & ok13 & ((ac13 & 0x0010) != 0)

    id_reply = (df == 5) | (df == 21)
    # Gillham interleave -> 4 octal digits (decode_id13, mode_s.c:83)
    b = _bits(msgs, 20, 32)
    hexd = (
        ((b & 0x1000) >> 12) * 0x0010 | ((b & 0x0800) >> 11) * 0x1000
        | ((b & 0x0400) >> 10) * 0x0020 | ((b & 0x0200) >> 9) * 0x2000
        | ((b & 0x0100) >> 8) * 0x0040 | ((b & 0x0080) >> 7) * 0x4000
        | ((b & 0x0020) >> 5) * 0x0100 | ((b & 0x0010) >> 4) * 0x0001
        | ((b & 0x0008) >> 3) * 0x0200 | ((b & 0x0004) >> 2) * 0x0002
        | ((b & 0x0002) >> 1) * 0x0400 | (b & 0x0001) * 0x0004
    )
    # id13 == 0 means "no code" and stays invalid (fields.py: `if id13:`)
    out["squawk_valid"] |= id_reply & (b != 0)
    out["squawk"] = np.where(id_reply & (b != 0), hexd, out["squawk"])

    # hot-path coverage marker: rows NOT covered must take the scalar path
    covered = (
        pos_ok | surf | both | tr_ok | ident | alt_reply | id_reply | (df == 11)
    )
    out["covered"] = covered
    return out
