"""Stream-state hand-over into the port's demodulators.

A demodulator's stream state is the part of it that is not recomputed:
the carried overlap of raw words, the scan-global sample clock, the
escalated capacities, the device ICAO mirror's generations and clock, and
the host ICAO filter of each channel's Python Scorer.  The static tables
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
                     326 raw UC8 words fed
      scan_global    int, samples consumed per channel
      k, compact_l, gate_k2, gate_keep_l   int capacities (powers of two)
      mirror         {"cur", "prev": address iterables,
                      "next_swap_ms": int | None, "capacity": int}
      icao           one {"cur", "prev", "next_swap_ms"} per channel: the
                     Python Scorer's two-generation ICAO filter
    """
    ow = np.asarray(d["overlap_words"])
    if ow.dtype != np.uint16 or ow.shape[-1] != TRAILING_SAMPLES or ow.ndim not in (1, 2):
        raise ValueError(f"overlap_words must be uint16[..., {TRAILING_SAMPLES}]")
    n_chan = 1 if ow.ndim == 1 else ow.shape[0]
    out = {"overlap_words": ow.copy(), "scan_global": int(d["scan_global"])}
    if out["scan_global"] < 0:
        raise ValueError("scan_global must be >= 0")
    for name in _CAPACITIES:
        v = int(d[name])
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name}={v} is not a power of two")
        out[name] = v
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
