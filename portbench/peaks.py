"""Published peaks of the cards a run may land on (NVIDIA data sheets,
SXM parts at the full power limit)."""

from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str) -> float | None:
    """The peak `key` of the card named `device_name`, or None."""
    for part, table in PEAKS.items():
        if part in device_name:
            return table.get(key)
    return None
