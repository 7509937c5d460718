"""Stream-state hand-over into the port's demodulators.

A demodulator's stream state is the part of it that is not recomputed:
the carried overlap (raw words on the raw-UC8 route, uint16 magnitudes on
the magnitude route, with that route's block level and power and its Mode
A/C capacity), the scan-global sample clock, the escalated capacities, whether a fused
overflow has made the stream staged for good, the
device ICAO mirror's generations and clock, and the host ICAO filter of
each channel's Python Scorer.  The static tables
(slicer lattice, syndrome matrices, error tables, DF delta syndromes) are
recomputed by the port.  The state arrives as plain numpy and Python
values, so any producer (readsb_tpu's Demodulator / MultiDemodulator
included) can hand a running stream over without the two packages sharing
a type.
"""

from __future__ import annotations

import numpy as np

from .constants import TRAILING_SAMPLES

_CAPACITIES = ("k", "compact_l", "gate_k2", "gate_keep_l")


def _addr_set(values, what: str) -> set[int]:
    out = {int(a) for a in values}
    if any(a < 0 or a > 0xFFFFFF for a in out):
        raise ValueError(f"{what}: addresses must be 24-bit")
    return out


def _clock(v) -> int | None:
    return None if v is None else int(v)


def demod_state_from_numpy(d: dict) -> dict:
    """Validate a plain stream state and return it in the form that
    Demodulator.load_state / MultiDemodulator.load_state take.

    d keys:
      overlap_words  uint16[326] (one channel) or uint16[C, 326]: the last
                     326 raw UC8 words fed (raw route), or
      overlap_mag    the same shapes: the last 326 magnitudes (magnitude
                     route; readsb_tpu's `overlap` / `_overlap_dev`).
                     Exactly one of the two.  With overlap_mag, optionally:
      mean_level, mean_power   float, or float[C]: the last block's (default 0)
      modeac_k       int capacity of the Mode A/C pass (power of two times
                     512; default 512)
      scan_global    int, samples consumed per channel
      k, compact_l, gate_k2, gate_keep_l   int capacities (powers of two)
      force_staged   bool, optional (default False): readsb_tpu's
                     `_force_staged`, set when a fused dispatch overflowed
      mirror         {"cur", "prev": address iterables,
                      "next_swap_ms": int | None, "capacity": int}
      icao           one {"cur", "prev", "next_swap_ms"} per channel: the
                     Python Scorer's two-generation ICAO filter
    """
    keys = [key for key in ("overlap_words", "overlap_mag") if d.get(key) is not None]
    if len(keys) != 1:
        raise ValueError("exactly one of overlap_words and overlap_mag is expected")
    (key,) = keys
    ow = np.asarray(d[key])
    if ow.dtype != np.uint16 or ow.shape[-1] != TRAILING_SAMPLES or ow.ndim not in (1, 2):
        raise ValueError(f"{key} must be uint16[..., {TRAILING_SAMPLES}]")
    n_chan = 1 if ow.ndim == 1 else ow.shape[0]
    out = {key: ow.copy(), "scan_global": int(d["scan_global"])}
    if out["scan_global"] < 0:
        raise ValueError("scan_global must be >= 0")
    if key == "overlap_mag":
        for name in ("mean_level", "mean_power"):
            v = np.asarray(d.get(name, 0.0), dtype=np.float64)
            if v.shape not in ((), (n_chan,)) or not np.isfinite(v).all() or (v < 0).any():
                raise ValueError(f"{name} must be one finite value >= 0 per channel")
            out[name] = v.copy()
        mk = int(d.get("modeac_k", 512))
        if mk < 512 or mk & (mk - 1):
            raise ValueError(f"modeac_k={mk} is not a power of two >= 512")
        out["modeac_k"] = mk
    for name in _CAPACITIES:
        v = int(d[name])
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name}={v} is not a power of two")
        out[name] = v
    out["force_staged"] = bool(d.get("force_staged", False))
    m = d["mirror"]
    out["mirror"] = {
        "cur": _addr_set(m["cur"], "mirror.cur"),
        "prev": _addr_set(m["prev"], "mirror.prev"),
        "next_swap_ms": _clock(m["next_swap_ms"]),
        "capacity": int(m["capacity"]),
    }
    icao = list(d["icao"])
    if len(icao) != n_chan:
        raise ValueError(f"{len(icao)} ICAO filter states for {n_chan} channels")
    out["icao"] = [
        {
            "cur": _addr_set(f["cur"], "icao.cur"),
            "prev": _addr_set(f["prev"], "icao.prev"),
            "next_swap_ms": _clock(f["next_swap_ms"]),
        }
        for f in icao
    ]
    return out
