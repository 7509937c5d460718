"""Device-side aircraft arena: a dense SoA state store updated in bulk.

The reference tracks aircraft in a 2^20-bucket open hash swept by
threadpools (readsb.h:310-313, track.c:2948-3043, aircraft.c:29-100).  The
arena splits the work:

  host    owns the ICAO -> slot assignment (a Python dict -- control plane,
          O(1) per message) and batches per-message field updates into SoA
          tensors;
  device  owns the state (structure-of-arrays over N slots) and applies a
          whole batch per update, plus the staleness sweep (track.c:2948)
          as a masked bulk clear.

Execution model: the host ranks each message within its slot (message
ordinal r); the device runs one round per ordinal -- round r applies at
most ONE message per slot as vectorized masked scatters, so the serial
per-aircraft fold of trackUpdateFromMessage is reproduced EXACTLY (the
round decomposition the columnar host tracker uses, track/bulk.py, moved
onto the device).  The field-specific accept rules run on the device:

  - plain accept_data lattice fields (track.c:128-221)
  - baro-altitude outlier rejection (updateAltitude, track.c:1709-1813):
    reliability score + implied-fpm window from the known vertical rate
  - squawk double-confirmation (track.c:2071-2092): JAERO immediate
    accept, else the tentative must have held unchanged for >750 ms
  - callsign + counters + seen
  - the CPR pair store and the GLOBAL decode (ops/cpr_device.py: exact
    int32 lattice + NL thresholds inside the update rounds) -- airborne
    always, surface when a fixed receiver location is configured (the
    track.c:759-777 reference chain then always picks it); the host
    applies the surface 450 km reference-distance gate (track.c:784-792)
    and converts the integer decisions to f64 degrees with the
    reference's exact expressions.

readsb_tpu's track/arena.py in torch, on an explicit device (`Arena(...,
device=)`, default the card).  `lax.scan` over rounds is a Python loop
over rounds on the same carry; `.at[].set(mode="drop")` is a scatter into
a buffer with one spare row that is sliced off.  Three faults of
readsb_tpu are not copied:

  - every time field (seen, fts, cs_ts, alt_ts, sq_ts, sq_tent_ts, c_ts,
    the batch's ts and the sweep's now / ttl) is int64, so epoch
    milliseconds (~1.76e12) neither raise (readsb_tpu's sweep casts
    now_ms to int32) nor wrap (its update_cols / update_batch store int32
    timestamps); _NEVER stays -(1 << 30), so that below 2^31 ms the state
    equals readsb_tpu's value for value;
  - `cpr_decodes` is drained: `pop_cpr_decodes()` returns and clears it,
    and the app's tick pops it after the overlay (app/bulk_drain.py
    materialize_arena), where readsb_tpu's list grows without bound;
  - with int64 time the overlay of materialize_arena compares in one time
    base and fires, where readsb_tpu's never does on epoch time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..decode.fields import CprType
from ..ops import cpr_device
from .bulk import _NIC_V0, _RC_V0
from .tracker import CPR_MAX_INTERVAL, TRACK_EXPIRE, TRACK_STALE, Source, greatcircle

ARENA_SLOTS = 1 << 17
_NEVER = -(1 << 30)

# plain-accept scalar fields mirrored on device (tracker.py update()).
FIELDS = (
    "gs",
    "track_rate",
    "roll",
    "baro_rate",
    "geom_rate",
    "ias",
    "tas",
    "mach",
    "geom_alt",
    "geom_delta",
    "nav_qnh",
    "nav_altitude_mcp",
    "nav_altitude_fms",
    "nav_heading",
)
NFIELDS = len(FIELDS)
FIELD_IDX = {name: i for i, name in enumerate(FIELDS)}
# integer-typed aircraft fields (materializers cast back from the f32 SoA)
INT_FIELDS = frozenset(
    {"geom_alt", "geom_delta", "nav_altitude_mcp", "nav_altitude_fms",
     "baro_rate", "geom_rate", "ias", "tas"}
)
# message attribute carrying each field (tracker.py reads gs_selected)
ATTR_OF = {name: name for name in FIELDS}
ATTR_OF["gs"] = "gs_selected"
ATTR_OF["nav_altitude_mcp"] = "nav_mcp_altitude"
ATTR_OF["nav_altitude_fms"] = "nav_fms_altitude"
_J_BR = FIELD_IDX["baro_rate"]
_J_GR = FIELD_IDX["geom_rate"]

_I32, _I64, _F32, _BOOL = torch.int32, torch.int64, torch.float32, torch.bool


class ArenaState(NamedTuple):
    icao: torch.Tensor  # int32[N], -1 = free slot
    seen: torch.Tensor  # int64[N] ms of last message
    messages: torch.Tensor  # int32[N]
    fval: torch.Tensor  # f32[N, F]
    fts: torch.Tensor  # int64[N, F] ms of last accept (_NEVER = unset)
    fsrc: torch.Tensor  # int32[N, F] Source enum, -1 = invalid
    callsign: torch.Tensor  # int32[N, 2] 8 chars packed big-endian
    cs_ts: torch.Tensor  # int64[N]
    cs_src: torch.Tensor  # int32[N]
    # baro altitude + outlier score (updateAltitude)
    alt: torch.Tensor  # int32[N] feet
    alt_ts: torch.Tensor  # int64[N]
    alt_src: torch.Tensor  # int32[N]
    alt_rel: torch.Tensor  # int32[N] reliability 0..20
    # baro_alt ever assigned: score exhaustion invalidates alt_src while the
    # stale value is retained (track.c:1793-1800), so alt_src can't encode it
    alt_set: torch.Tensor  # bool[N]
    # squawk + double-confirmation tentative; -1 = unset
    squawk: torch.Tensor  # int32[N]
    sq_ts: torch.Tensor  # int64[N]
    sq_src: torch.Tensor  # int32[N]
    sq_tent: torch.Tensor  # int32[N]
    sq_tent_ts: torch.Tensor  # int64[N] ms of last tentative change
    # CPR pair state (track.c:1249-1385 head): index 0=even, 1=odd;
    # raw values always overwrite, the clock moves via accept_data
    c_lat: torch.Tensor  # int32[N, 2]
    c_lon: torch.Tensor  # int32[N, 2]
    c_surf: torch.Tensor  # bool[N, 2]
    c_ts: torch.Tensor  # int64[N, 2]
    c_src: torch.Tensor  # int32[N, 2]
    c_nic: torch.Tensor  # int32[N, 2] integrity category at pair accept
    c_rc: torch.Tensor  # f32[N, 2] containment radius (meters)


# (field, dtype, trailing shape, fill) -- the empty value is also what the
# sweep writes into a freed slot
_LAYOUT = (
    ("icao", _I32, (), -1),
    ("seen", _I64, (), 0),
    ("messages", _I32, (), 0),
    ("fval", _F32, (NFIELDS,), 0),
    ("fts", _I64, (NFIELDS,), _NEVER),
    ("fsrc", _I32, (NFIELDS,), -1),
    ("callsign", _I32, (2,), 0),
    ("cs_ts", _I64, (), _NEVER),
    ("cs_src", _I32, (), -1),
    ("alt", _I32, (), 0),
    ("alt_ts", _I64, (), _NEVER),
    ("alt_src", _I32, (), -1),
    ("alt_rel", _I32, (), 0),
    ("alt_set", _BOOL, (), False),
    ("squawk", _I32, (), -1),
    ("sq_ts", _I64, (), _NEVER),
    ("sq_src", _I32, (), -1),
    ("sq_tent", _I32, (), -1),
    ("sq_tent_ts", _I64, (), _NEVER),
    ("c_lat", _I32, (2,), 0),
    ("c_lon", _I32, (2,), 0),
    ("c_surf", _BOOL, (2,), False),
    ("c_ts", _I64, (2,), _NEVER),
    ("c_src", _I32, (2,), -1),
    ("c_nic", _I32, (2,), 0),
    ("c_rc", _F32, (2,), 0),
)
_FILL = {name: fill for name, _, _, fill in _LAYOUT}
# the fields that hold milliseconds (int64 here, int32 in readsb_tpu)
TIME_FIELDS = ("seen", "fts", "cs_ts", "alt_ts", "sq_ts", "sq_tent_ts", "c_ts")


def empty_arena(n: int = ARENA_SLOTS, device="cuda") -> ArenaState:
    device = torch.device(device)
    return ArenaState(**{
        name: torch.full((n,) + shape, fill, dtype=dt, device=device)
        for name, dt, shape, fill in _LAYOUT
    })


class UpdateBatch(NamedTuple):
    """SoA message batch (M rows); host fills from decoded messages."""

    slot: torch.Tensor  # int32[M] arena slot (host-assigned); -1 = padding
    rank: torch.Tensor  # int32[M] message ordinal within its slot
    icao: torch.Tensor  # int32[M]
    ts: torch.Tensor  # int64[M] ms
    src: torch.Tensor  # int32[M] Source enum
    fmask: torch.Tensor  # bool[M, F] which fields this message carries
    fval: torch.Tensor  # f32[M, F]
    cs_valid: torch.Tensor  # bool[M]
    cs: torch.Tensor  # int32[M, 2]
    alt_valid: torch.Tensor  # bool[M]
    alt: torch.Tensor  # int32[M] feet
    alt_q: torch.Tensor  # bool[M] AC q bit
    crc0: torch.Tensor  # bool[M] mm.crc == 0
    sq_valid: torch.Tensor  # bool[M]
    sq: torch.Tensor  # int32[M] squawk hex
    cpr_valid: torch.Tensor  # bool[M]
    cpr_odd: torch.Tensor  # bool[M]
    cpr_surf: torch.Tensor  # bool[M]
    cpr_lat: torch.Tensor  # int32[M] raw 17-bit CPR
    cpr_lon: torch.Tensor  # int32[M]
    cpr_nic: torch.Tensor  # int32[M] NIC at pair accept (v0 tables)
    cpr_rc: torch.Tensor  # f32[M] Rc (meters)


_BATCH_DTYPES = {
    "slot": np.int32, "rank": np.int32, "icao": np.int32, "ts": np.int64,
    "src": np.int32, "fmask": np.bool_, "fval": np.float32,
    "cs_valid": np.bool_, "cs": np.int32, "alt_valid": np.bool_,
    "alt": np.int32, "alt_q": np.bool_, "crc0": np.bool_,
    "sq_valid": np.bool_, "sq": np.int32, "cpr_valid": np.bool_,
    "cpr_odd": np.bool_, "cpr_surf": np.bool_, "cpr_lat": np.int32,
    "cpr_lon": np.int32, "cpr_nic": np.int32, "cpr_rc": np.float32,
}
_NP_TO_TORCH = {np.dtype(np.int32): _I32, np.dtype(np.int64): _I64,
                np.dtype(np.float32): _F32, np.dtype(np.bool_): _BOOL}


def upload_batch(cols: dict, device) -> UpdateBatch:
    """Numpy batch columns -> UpdateBatch on `device` in one host-to-device
    copy: the columns are laid end to end in one byte buffer (each a
    multiple of 8 bytes, since M is a multiple of 256) and viewed back."""
    arrs = [np.ascontiguousarray(cols[k], _BATCH_DTYPES[k]) for k in UpdateBatch._fields]
    blob = np.concatenate([a.reshape(-1).view(np.uint8) for a in arrs])
    dev = torch.from_numpy(blob).to(device)
    out, off = [], 0
    for a in arrs:
        nb = a.nbytes
        out.append(dev[off:off + nb].view(_NP_TO_TORCH[a.dtype]).reshape(a.shape))
        off += nb
    return UpdateBatch(*out)


def _check_batch(state: ArenaState, b: UpdateBatch) -> None:
    dev = state.icao.device
    for name, t in zip(UpdateBatch._fields, b):
        if t.device != dev:
            raise ValueError(
                f"arena_update: batch field {name} is on {t.device}, the arena "
                f"state on {dev}; a batch must be on the arena's device"
            )


def _scatter(n, slot, mask, vals, fill):
    """One-row-per-slot scatter of this round's values; unset -> fill.
    Rows outside `mask` go to the spare row n, which is sliced off."""
    out = torch.full((n + 1,) + tuple(vals.shape[1:]), fill, dtype=vals.dtype, device=vals.device)
    out[torch.where(mask, slot, n).long()] = vals
    return out[:n]


def _scatter_set(base, slot_all, vals):
    n = base.shape[0]
    out = torch.cat([base, base[:1]])
    out[slot_all] = vals
    return out[:n]


def _pick(a, idx):
    """a[i, idx[i]] for a 2-column state field."""
    return a.gather(1, idx[:, None])[:, 0]


def arena_update(state: ArenaState, b: UpdateBatch, rounds: int,
                 surf_q=(0, 0, 0, 0, 0)) -> tuple[ArenaState, torch.Tensor]:
    """Apply one message batch: one round per per-slot message ordinal.

    surf_q: (enabled, zneg, zpos, t0, t1) ints from
    ops.cpr_device.surface_quadrant_consts -- the fixed-receiver surface
    reference (track.c:759-777 always picks the user location when one
    is set, so a single-receiver arena decodes surface pairs on device
    with exact host-chain semantics; enabled=0 leaves surface rows to
    the host path).  Returns the new state and the per-round decode
    records, int32 (rounds, N, 12)."""
    _check_batch(state, b)
    n = state.icao.shape[0]
    dev = state.icao.device
    live = b.slot >= 0
    slot_all = torch.where(live, b.slot, n).long()

    # --- bookkeeping (order-independent): a slot's duplicate rows write
    # equal values, so the order of CUDA's index_put_ does not matter ----
    icao = _scatter_set(state.icao, slot_all, torch.where(live, b.icao, 0))
    seen = torch.cat([state.seen, state.seen.new_zeros(1)])
    seen.scatter_reduce_(0, slot_all, torch.where(live, b.ts, 0), "amax")
    seen = seen[:n]
    messages = torch.cat([state.messages, state.messages.new_zeros(1)])
    messages.index_add_(0, slot_all, live.to(_I32))
    messages = messages[:n]

    s = state._asdict()
    fval, fts, fsrc = s["fval"], s["fts"], s["fsrc"]
    callsign, cs_ts, cs_src = s["callsign"], s["cs_ts"], s["cs_src"]
    alt, alt_ts, alt_src, alt_rel, alt_set = (
        s["alt"], s["alt_ts"], s["alt_src"], s["alt_rel"], s["alt_set"])
    squawk, sq_ts, sq_src, sq_tent, sq_tent_ts = (
        s["squawk"], s["sq_ts"], s["sq_src"], s["sq_tent"], s["sq_tent_ts"])
    c_lat, c_lon, c_surf, c_ts, c_src, c_nic, c_rc = (
        s["c_lat"], s["c_lon"], s["c_surf"], s["c_ts"], s["c_src"], s["c_nic"], s["c_rc"])
    surf_en, zneg, zpos, t0q, t1q = (int(v) for v in surf_q)
    adsb, prio = int(Source.ADSB), int(Source.PRIO)
    jaero, sbs, mlat = int(Source.JAERO), int(Source.SBS), int(Source.MLAT)
    ys = torch.empty((rounds, n, 12), dtype=_I32, device=dev)

    for r in range(rounds):
        mrow = live & (b.rank == r)
        slot = torch.where(mrow, b.slot, n)

        def sc(vals, fill, mask=mrow):
            return _scatter(n, slot, mask, vals, fill)

        # per-slot planes of this round's message (fill = inert)
        u_src = sc(b.src, -1)
        u_ts = sc(b.ts, _NEVER)
        p_src = torch.where(u_src == prio, adsb, u_src)

        def gate(cur_ts, cur_src):
            """accept_data (track.c:128-221) for this round's message."""
            ok = (u_src >= 1) & (u_ts >= cur_ts)
            return ok & ~((u_src < cur_src) & (u_ts < cur_ts + TRACK_STALE))

        # --- altitude outlier logic FIRST (tracker update order: the alt
        # decision reads rate state from strictly earlier messages) --------
        a_have = sc(b.alt_valid, False, mrow & b.alt_valid)
        a_val = sc(b.alt, 0)
        a_q = sc(b.alt_q, False)
        a_crc0 = sc(b.crc0, False)
        old = torch.where(alt_set, alt, 0)
        delta = a_val - old  # int32, as readsb_tpu
        big = delta.abs() >= 300
        age_alt = torch.clamp(u_ts - alt_ts, min=0)
        # pre-gate (track.c:2059-2068): lower-priority sources only run the
        # outlier logic once the held altitude goes stale
        a_have &= (
            (u_src >= alt_src)
            | ((age_alt > 10_000) & (alt_src != jaero) & (alt_src != sbs))
            | (age_alt > 30_000)
        )
        # C trunc division: all quantities here are nonneg denominators
        den = torch.clamp(age_alt // 100 + 10, min=1)
        fpm = torch.where(delta < 0, -((-delta * 600) // den), (delta * 600) // den)
        fpm = torch.where(big, fpm, 0)
        gr_ok = (fsrc[:, _J_GR] >= 0) & (u_ts < fts[:, _J_GR] + TRACK_EXPIRE)
        br_ok = (fsrc[:, _J_BR] >= 0) & (u_ts < fts[:, _J_BR] + TRACK_EXPIRE)
        age_gr = torch.clamp(u_ts - fts[:, _J_GR], min=0)
        age_br = torch.clamp(u_ts - fts[:, _J_BR], min=0)
        use_gr = gr_ok & (age_gr < age_br)
        use_br = ~use_gr & br_ok
        slack_gr = 1500 + torch.clamp(age_gr // 2, max=11000)
        slack_br = 1500 + torch.clamp(age_br // 2, max=11000)
        gr_v = fval[:, _J_GR].to(_I32)
        br_v = fval[:, _J_BR].to(_I32)
        min_fpm = torch.where(use_gr, gr_v - slack_gr,
                              torch.where(use_br, br_v - slack_br, -12500))
        max_fpm = torch.where(use_gr, gr_v + slack_gr,
                              torch.where(use_br, br_v + slack_br, 12500))
        alt_fresh = (alt_src >= 0) & (u_ts < alt_ts + TRACK_EXPIRE) & (age_alt < 30_000)
        decayed = torch.where(
            alt_fresh, torch.minimum(20 - 20 * age_alt // 30_000, alt_rel.to(_I64)), 0
        )
        rel_now = torch.where(a_have & big, decayed, alt_rel.to(_I64))
        good_crc = torch.where(a_crc0 & ((u_src >= jaero) | (u_src == sbs)), 20, 0)
        good_crc = torch.where(u_src == mlat, 9, good_crc)
        qbad = (old > 50175) & a_q & (rel_now > 5)
        # the q-bit branch zeroes good_crc and takes the discard path
        # (track.c:1756-1760)
        good_crc = torch.where(qbad, 0, good_crc)
        accept_a = ~qbad & (
            (good_crc >= rel_now) | (u_src > alt_src) | (rel_now <= 0)
            | (delta.abs() < 300) | ((fpm > min_fpm) & (fpm < max_fpm))
        )
        latt_a = a_have & accept_a & gate(alt_ts, alt_src)
        discard_a = a_have & ~accept_a
        dec = rel_now - (good_crc + 1)
        # discard epilogue (track.c:1793-1800): clamp at 0 and invalidate the
        # source on exhaustion (the arena carries no JAERO position state,
        # so the pos_reliable JAERO exception never applies here)
        exhausted = discard_a & (dec <= 0)
        alt_rel = torch.where(
            discard_a, torch.clamp(dec, min=0),
            torch.where(latt_a, torch.clamp(rel_now + good_crc + 1, 0, 20), rel_now),
        ).to(_I32)
        alt = torch.where(latt_a, a_val, alt)
        alt_ts = torch.where(latt_a, u_ts, alt_ts)
        alt_src = torch.where(exhausted, -1, torch.where(latt_a, p_src, alt_src))
        alt_set = alt_set | latt_a

        # --- plain lattice fields ------------------------------------------
        u_fm = sc(b.fmask, False)
        u_fv = sc(b.fval, 0.0)
        ok_f = (
            u_fm
            & (u_src[:, None] >= 1)
            & (u_ts[:, None] >= fts)
            & ~((u_src[:, None] < fsrc) & (u_ts[:, None] < fts + TRACK_STALE))
        )
        fval = torch.where(ok_f, u_fv, fval)
        fts = torch.where(ok_f, u_ts[:, None], fts)
        fsrc = torch.where(ok_f, p_src[:, None], fsrc)

        # --- callsign ------------------------------------------------------
        u_cm = sc(b.cs_valid, False)
        u_cs = sc(b.cs, 0)
        ok_c = u_cm & gate(cs_ts, cs_src)
        callsign = torch.where(ok_c[:, None], u_cs, callsign)
        cs_ts = torch.where(ok_c, u_ts, cs_ts)
        cs_src = torch.where(ok_c, p_src, cs_src)

        # --- squawk double-confirmation (track.c:2071-2092) ----------------
        # JAERO accepts immediately; otherwise the tentative value must have
        # held unchanged for >750 ms.  The tentative is NOT cleared on
        # confirm.  (The reference's `now - a->seen < 15 s` guard on the
        # tentative change is always true -- seen was set this message.)
        q_have = sc(b.sq_valid, False, mrow & b.sq_valid)
        q_val = sc(b.sq, -2)
        will_q = gate(sq_ts, sq_src)
        change_tent = q_have & (sq_tent != q_val) & will_q
        confirm = (u_src == jaero) | ((sq_tent == q_val) & (u_ts - sq_tent_ts > 750))
        m1 = q_have & confirm & will_q
        squawk = torch.where(m1, q_val, squawk)
        sq_ts = torch.where(m1, u_ts, sq_ts)
        sq_src = torch.where(m1, p_src, sq_src)
        sq_tent = torch.where(change_tent, q_val, sq_tent)
        sq_tent_ts = torch.where(change_tent, u_ts, sq_tent_ts)

        # --- CPR pair + device global airborne decode ----------------------
        # pair raw values always overwrite; the clock moves via accept_data
        # (tracker._update_position head, track.c:1249-1385)
        p_have = sc(b.cpr_valid, False, mrow & b.cpr_valid)
        p_odd = sc(b.cpr_odd, False)
        p_surf = sc(b.cpr_surf, False)
        p_lat = sc(b.cpr_lat, 0)
        p_lon = sc(b.cpr_lon, 0)
        p_nic = sc(b.cpr_nic, 0)
        p_rc = sc(b.cpr_rc, 0.0)
        par = p_odd.to(_I32)  # 0=even, 1=odd
        pidx = par.long()
        sel = torch.stack([~p_odd, p_odd], 1) & p_have[:, None]
        c_lat = torch.where(sel, p_lat[:, None], c_lat)
        c_lon = torch.where(sel, p_lon[:, None], c_lon)
        c_surf = torch.where(sel, p_surf[:, None], c_surf)
        c_nic = torch.where(sel, p_nic[:, None], c_nic)
        c_rc = torch.where(sel, p_rc[:, None], c_rc)
        acc_p = p_have & gate(_pick(c_ts, pidx), _pick(c_src, pidx))
        c_ts = torch.where(sel & acc_p[:, None], u_ts[:, None], c_ts)
        c_src = torch.where(sel & acc_p[:, None], p_src[:, None], c_src)

        # global eligibility (tracker._update_position): other parity
        # fresh, close in time, same type; airborne decodes always on
        # device, surface only with a fixed receiver reference (surf_q)
        opar = 1 - pidx
        o_ts = _pick(c_ts, opar)
        glob = (
            p_have
            & (_pick(c_src, opar) >= 0)
            & (u_ts < o_ts + TRACK_EXPIRE)
            & ((_pick(c_ts, pidx) - o_ts).abs() <= CPR_MAX_INTERVAL)
            & (_pick(c_surf, opar) == p_surf)
        )
        pairs = (c_lat[:, 0], c_lon[:, 0], c_lat[:, 1], c_lon[:, 1], par)
        da = cpr_device.decode_airborne_core(*pairs)
        ds = cpr_device.decode_surface_core(*pairs, zneg, zpos, t0q, t1q)
        dec_ok = glob & torch.where(p_surf, ds["ok"] & (surf_en != 0), da["ok"])
        rec = ys[r]
        rec[:, 0] = dec_ok.to(_I32)
        for col, key in enumerate(("j", "nl", "ni", "m"), start=1):
            rec[:, col] = torch.where(p_surf, ds[key], da[key])
        rec[:, 5] = c_lat[:, 0]
        rec[:, 6] = c_lon[:, 0]
        rec[:, 7] = c_lat[:, 1]
        rec[:, 8] = c_lon[:, 1]
        # decoded NIC/Rc for a global fix: worse of the pair halves
        # (doGlobalCPR, track.c:753-756); Rc goes in by its bits
        rec[:, 9] = torch.minimum(c_nic[:, 0], c_nic[:, 1])
        rec[:, 10] = torch.maximum(c_rc[:, 0], c_rc[:, 1]).view(_I32)
        rec[:, 11] = p_surf.to(_I32)

    return ArenaState(
        icao=icao, seen=seen, messages=messages,
        fval=fval, fts=fts, fsrc=fsrc,
        callsign=callsign, cs_ts=cs_ts, cs_src=cs_src,
        alt=alt, alt_ts=alt_ts, alt_src=alt_src, alt_rel=alt_rel,
        alt_set=alt_set,
        squawk=squawk, sq_ts=sq_ts, sq_src=sq_src, sq_tent=sq_tent,
        sq_tent_ts=sq_tent_ts,
        c_lat=c_lat, c_lon=c_lon, c_surf=c_surf, c_ts=c_ts, c_src=c_src,
        c_nic=c_nic, c_rc=c_rc,
    ), ys


def arena_sweep(state: ArenaState, now_ms: int, ttl_ms: int) -> tuple[ArenaState, torch.Tensor]:
    """Staleness sweep (trackRemoveStale, track.c:2948): clear dead slots.

    now_ms / ttl_ms are int64 milliseconds.  Returns (state, freed mask)
    -- the host reclaims freed slot ids.
    """
    dead = (state.icao >= 0) & (now_ms >= state.seen + ttl_ms)

    def clr(name, a):
        return torch.where(dead.reshape((-1,) + (1,) * (a.dim() - 1)), _FILL[name], a)

    return ArenaState(**{name: clr(name, a) for name, a in state._asdict().items()}), dead


def _pad(a, mpad, fill, dtype):
    out = np.full(mpad, fill, dtype)
    out[: len(a)] = a
    return out


def _rank_rounds(slots: np.ndarray):
    """Per-row ordinal within its slot, and the round count (a power of
    two, as readsb_tpu compiles per count)."""
    m = len(slots)
    order = np.argsort(slots, kind="stable")
    ss = slots[order]
    first = np.searchsorted(ss, ss)
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m) - first
    rounds = int(rank.max()) + 1
    return rank, max(1, 1 << (rounds - 1).bit_length())


class Arena:
    """Host shell: slot assignment + batch building around the device state."""

    def __init__(
        self,
        n: int = ARENA_SLOTS,
        receiver_lat: float | None = None,
        receiver_lon: float | None = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' for the CPU")
        self.n = n
        self.state = empty_arena(n, self.device)
        self.slot_of: dict[int, int] = {}
        self.free: list[int] = list(range(n - 1, -1, -1))
        # device-decoded global positions, appended per batch:
        # (addr, ts_ms, fflag, lat, lon, nic, rc); pop_cpr_decodes drains it
        self.cpr_decodes: list[tuple] = []
        # fixed surface reference: with a configured receiver location the
        # reference chain (track.c:759-777) always picks it, so surface
        # pairs decode on device too (ops/cpr_device.decode_surface_core)
        self.receiver_lat = receiver_lat
        self.receiver_lon = receiver_lon
        if receiver_lat is not None:
            q = cpr_device.surface_quadrant_consts(receiver_lat)
            self._surf_q = (1, q["zneg"], q["zpos"], q["t0"], q["t1"])
        else:
            self._surf_q = (0, 0, 0, 0, 0)

    def _slot(self, addr: int) -> int:
        s = self.slot_of.get(addr)
        if s is None:
            s = self.free.pop()
            self.slot_of[addr] = s
        return s

    def _update(self, cols: dict, rounds: int) -> torch.Tensor:
        self.state, ys = arena_update(
            self.state, upload_batch(cols, self.device), rounds, self._surf_q
        )
        return ys

    def update_batch(self, msgs) -> None:
        """msgs: iterable of ModesMessage-likes (time-ordered)."""
        msgs = list(msgs)
        if not msgs:
            return
        addrs = np.array([mm.addr & 0xFFFFFF for mm in msgs], np.int64)
        slots = np.array([self._slot(int(a)) for a in addrs], np.int64)
        rank, rounds = _rank_rounds(slots)
        m = len(msgs)
        mpad = max(256, 1 << (m - 1).bit_length())
        c = {
            "slot": _pad(slots, mpad, -1, np.int32),
            "rank": _pad(rank, mpad, 0, np.int32),
            "icao": _pad(addrs, mpad, 0, np.int32),
            "ts": _pad([mm.sys_timestamp_ms for mm in msgs], mpad, 0, np.int64),
            "src": _pad([int(mm.source) for mm in msgs], mpad, 0, np.int32),
            "fmask": np.zeros((mpad, NFIELDS), bool),
            "fval": np.zeros((mpad, NFIELDS), np.float32),
            "cs_valid": np.zeros(mpad, bool), "cs": np.zeros((mpad, 2), np.int32),
            "alt_valid": np.zeros(mpad, bool), "alt": np.zeros(mpad, np.int32),
            "alt_q": np.zeros(mpad, bool), "crc0": np.zeros(mpad, bool),
            "sq_valid": np.zeros(mpad, bool), "sq": np.full(mpad, -2, np.int32),
            "cpr_valid": np.zeros(mpad, bool), "cpr_odd": np.zeros(mpad, bool),
            "cpr_surf": np.zeros(mpad, bool), "cpr_lat": np.zeros(mpad, np.int32),
            "cpr_lon": np.zeros(mpad, np.int32), "cpr_nic": np.zeros(mpad, np.int32),
            "cpr_rc": np.zeros(mpad, np.float32),
        }
        for i, mm in enumerate(msgs):
            for name, j in FIELD_IDX.items():
                v = getattr(mm, ATTR_OF[name], None)
                if v is not None:
                    c["fmask"][i, j] = True
                    c["fval"][i, j] = np.float32(v)
            call = getattr(mm, "callsign", None)
            if call:
                raw = call.encode()[:8].ljust(8)
                c["cs_valid"][i] = True
                c["cs"][i, 0] = int.from_bytes(raw[:4], "big", signed=False) - (1 << 31)
                c["cs"][i, 1] = int.from_bytes(raw[4:], "big", signed=False) - (1 << 31)
            av = getattr(mm, "baro_alt", None)
            if av is not None:
                c["alt_valid"][i] = True
                c["alt"][i] = int(av)
                c["alt_q"][i] = bool(getattr(mm, "alt_q_bit", 0))
                c["crc0"][i] = getattr(mm, "crc", 1) == 0
            qv = getattr(mm, "squawk_hex", None)
            if qv is not None:
                c["sq_valid"][i] = True
                c["sq"][i] = int(qv)
            if getattr(mm, "cpr_valid", False):
                c["cpr_valid"][i] = True
                c["cpr_odd"][i] = bool(mm.cpr_odd)
                c["cpr_surf"][i] = mm.cpr_type == CprType.SURFACE
                c["cpr_lat"][i] = int(mm.cpr_lat)
                c["cpr_lon"][i] = int(mm.cpr_lon)
                mt = int(getattr(mm, "metype", 0) or 0)
                nb = 1 if getattr(mm, "nic_b", 0) else 0
                c["cpr_nic"][i] = int(_NIC_V0[mt, nb])
                c["cpr_rc"][i] = float(_RC_V0[mt, nb])
        ys = self._update(c, rounds)
        idx = np.nonzero(c["cpr_valid"][:m])[0]
        if len(idx):
            self._collect_cpr(rank[idx], slots[idx], addrs[idx], c["ts"][idx],
                              c["cpr_odd"][idx], ys)

    def update_cols(self, cols: dict) -> None:
        """Columnar batch feed (decode/batch.py columns) -- the live-app
        --device-arena path: the drained network batch updates the device
        SoA directly, no per-message objects."""
        addrs = np.asarray(cols["addr"], np.int64) & 0xFFFFFF
        m = len(addrs)
        if m == 0:
            return
        slots = np.fromiter((self._slot(int(a)) for a in addrs), np.int64, m)
        rank, rounds = _rank_rounds(slots)
        mpad = max(256, 1 << (m - 1).bit_length())

        fmask = np.zeros((mpad, NFIELDS), bool)
        fval = np.zeros((mpad, NFIELDS), np.float32)
        for name, col, vcol in (
            ("gs", "gs", "gs_valid"),
            ("baro_rate", "baro_rate", "baro_rate_valid"),
            ("geom_rate", "geom_rate", "geom_rate_valid"),
        ):
            j = FIELD_IDX[name]
            fmask[:m, j] = cols[vcol]
            fval[:m, j] = np.where(cols[vcol], cols[col], 0).astype(np.float32)

        csb = np.asarray(cols["callsign"], np.uint32)  # (m, 8) chars
        cs = np.zeros((mpad, 2), np.int32)
        cs[:m, 0] = (
            (csb[:, 0] << 24) | (csb[:, 1] << 16) | (csb[:, 2] << 8) | csb[:, 3]
        ).astype(np.int64) - (1 << 31)
        cs[:m, 1] = (
            (csb[:, 4] << 24) | (csb[:, 5] << 16) | (csb[:, 6] << 8) | csb[:, 7]
        ).astype(np.int64) - (1 << 31)
        metype, nic_b = cols["metype"], cols["nic_b"]
        ts = np.asarray(cols["ts"], np.int64)
        c = {
            "slot": _pad(slots, mpad, -1, np.int32),
            "rank": _pad(rank, mpad, 0, np.int32),
            "icao": _pad(addrs, mpad, 0, np.int32),
            "ts": _pad(ts, mpad, 0, np.int64),
            "src": _pad(cols["source"], mpad, 0, np.int32),
            "fmask": fmask, "fval": fval,
            "cs_valid": _pad(cols["callsign_valid"], mpad, False, bool),
            "cs": cs,
            "alt_valid": _pad(cols["alt_valid"], mpad, False, bool),
            "alt": _pad(cols["alt"], mpad, 0, np.int32),
            "alt_q": _pad(cols["alt_q"], mpad, False, bool),
            "crc0": _pad(cols["crc_zero"], mpad, False, bool),
            "sq_valid": _pad(cols["squawk_valid"], mpad, False, bool),
            "sq": _pad(np.where(cols["squawk_valid"], cols["squawk"], -2), mpad, -2, np.int32),
            "cpr_valid": _pad(cols["cpr_valid"], mpad, False, bool),
            "cpr_odd": _pad(cols["cpr_odd"], mpad, False, bool),
            "cpr_surf": _pad(cols["cpr_surface"], mpad, False, bool),
            "cpr_lat": _pad(cols["cpr_lat"], mpad, 0, np.int32),
            "cpr_lon": _pad(cols["cpr_lon"], mpad, 0, np.int32),
            "cpr_nic": _pad(_NIC_V0[metype, nic_b], mpad, 0, np.int32),
            "cpr_rc": _pad(_RC_V0[metype, nic_b], mpad, 0.0, np.float32),
        }
        ys = self._update(c, rounds)
        idx = np.nonzero(np.asarray(cols["cpr_valid"], bool))[0]
        if len(idx):
            self._collect_cpr(rank[idx], slots[idx], addrs[idx], ts[idx],
                              np.asarray(cols["cpr_odd"], bool)[idx], ys)

    def _collect_cpr(self, rr, ss, addrs, tss, ffs, ys: torch.Tensor) -> None:
        """Convert the rounds' device decode records into f64 positions for
        the per-message CPR rows (arrays rr=rank, ss=slot, addrs, tss=ms,
        ffs=odd flag), using the reference's exact float maps
        (ops.cpr_device airborne_latlon_f64 / surface_latlon_f64; surface
        rows additionally pass the 450 km reference-distance gate,
        track.c:784-792).  Only the rows ys[rr, ss] are gathered on the
        device and read back.  Appends (addr, ts_ms, fflag, lat, lon, nic,
        rc) to self.cpr_decodes."""
        if len(rr) == 0:
            return
        sel = torch.from_numpy(np.stack([rr, ss]).astype(np.int64)).to(ys.device)
        rec = ys[sel[0], sel[1]].cpu().numpy()  # (m, 12): ok, j, nl, ni, m, pairs, nic, rc, surf
        ok = rec[:, 0] != 0
        if not ok.any():
            return
        dev = {"j": rec[:, 1], "nl": rec[:, 2], "ni": rec[:, 3], "m": rec[:, 4]}
        lat, lon = cpr_device.airborne_latlon_f64(
            dev, rec[:, 5], rec[:, 6], rec[:, 7], rec[:, 8], ffs
        )
        surf = rec[:, 11] != 0
        if surf.any():
            slat, slon = cpr_device.surface_latlon_f64(
                dev, self.receiver_lat, self.receiver_lon,
                rec[:, 5], rec[:, 6], rec[:, 7], rec[:, 8], ffs,
            )
            lat = np.where(surf, slat, lat)
            lon = np.where(surf, slon, lon)
        rc = rec[:, 10].astype(np.int32).view(np.float32)
        for i in np.nonzero(ok)[0]:
            if surf[i] and greatcircle(
                self.receiver_lat, self.receiver_lon,
                float(lat[i]), float(lon[i]),
            ) > 450e3:
                continue
            self.cpr_decodes.append(
                (int(addrs[i]), int(tss[i]), bool(ffs[i]),
                 float(lat[i]), float(lon[i]),
                 int(rec[i, 9]), float(rc[i]))
            )

    def pop_cpr_decodes(self) -> list[tuple]:
        """The device-decoded positions since the last pop; clears the list."""
        out, self.cpr_decodes = self.cpr_decodes, []
        return out

    def sweep(self, now_ms: int, ttl_ms: int = 5 * TRACK_EXPIRE) -> int:
        self.state, dead = arena_sweep(self.state, int(now_ms), int(ttl_ms))
        freed = torch.nonzero(dead).flatten().cpu().tolist()
        if freed:
            inv = {v: k for k, v in self.slot_of.items()}
            for s in freed:
                addr = inv.get(s)
                if addr is not None:
                    del self.slot_of[addr]
                    self.free.append(s)
        return len(freed)

    # -- host-side readback (snapshot) --------------------------------------

    def read_slots(self) -> tuple[list[int], dict]:
        """(addrs, {field: numpy rows}) of every assigned slot, in slot_of
        order: the rows are gathered on the device and only they are read
        back."""
        addrs = list(self.slot_of)
        idx = torch.tensor([self.slot_of[a] for a in addrs], dtype=torch.int64)
        idx = idx.to(self.device)
        return addrs, {k: v[idx].cpu().numpy() for k, v in self.state._asdict().items()}

    def snapshot(self, now_ms: int):
        """Fetch live rows as a dict addr -> {field: (value, src) fresh only}."""
        addrs, st = self.read_slots()
        out = {}
        for k, addr in enumerate(addrs):
            if st["icao"][k] < 0:
                continue
            row = {"seen": int(st["seen"][k]), "messages": int(st["messages"][k])}
            for name, j in FIELD_IDX.items():
                if st["fsrc"][k, j] >= 0 and now_ms < st["fts"][k, j] + TRACK_EXPIRE:
                    row[name] = (float(st["fval"][k, j]), int(st["fsrc"][k, j]))
            if st["cs_src"][k] >= 0 and now_ms < st["cs_ts"][k] + TRACK_EXPIRE:
                b0 = int(st["callsign"][k, 0]) + (1 << 31)
                b1 = int(st["callsign"][k, 1]) + (1 << 31)
                row["callsign"] = (
                    b0.to_bytes(4, "big") + b1.to_bytes(4, "big")
                ).decode().rstrip("\x00").rstrip()
            if st["alt_src"][k] >= 0 and now_ms < st["alt_ts"][k] + TRACK_EXPIRE:
                row["baro_alt"] = (int(st["alt"][k]), int(st["alt_src"][k]))
                row["alt_reliable"] = int(st["alt_rel"][k])
            if st["sq_src"][k] >= 0:
                row["squawk"] = (
                    int(st["squawk"][k]) if st["squawk"][k] >= 0 else None,
                    int(st["sq_src"][k]),
                )
            if st["sq_tent"][k] >= 0:
                row["squawk_tentative"] = int(st["sq_tent"][k])
            out[addr] = row
        return out
