"""The port's measurement tools: counterparts of the JAX repo's
`tools/bench_arena.py`, `tools/bench_net.py`, `tools/bench_serving.py` and
`tools/state_scale_1m.py`, run as

    python3 -m readsb_tpu_torch.tools.<name> [sizes...]

Each prints its readings, then one JSON line last: the metric's name, its
value and unit, and the device the numbers were taken on (the card's name
and power limit as nvidia-smi reports them).  The host-only tools name the
card unless READSB_TPU_PLATFORM=cpu, as the app does; the two device
benches time on the card only.  Nothing is written beside the
repository: a tool's files go to a temporary directory it removes.
"""

from __future__ import annotations

import subprocess

import torch

from ..pipeline import _resolve_device


def require_card() -> torch.device:
    """The card a timing runs on; raises without one: a device timing is
    never taken on the CPU."""
    return _resolve_device("cuda")


def card_line(dev: torch.device) -> str:
    """nvidia-smi's "name, power.limit" line of this card.  The card is
    named by its UUID: nvidia-smi lists every card of the machine in PCI
    order, whatever CUDA_VISIBLE_DEVICES hides, so a line's position is not
    torch's index."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = torch.cuda.get_device_properties(index).uuid
    out = subprocess.run(
        ["nvidia-smi", "-i", f"GPU-{uuid}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_fields(dev: torch.device) -> dict:
    """{"device", "power_limit_w"} of the device a reading was taken on:
    torch's name of the card and its power limit in W, or "cpu" and None."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = card_line(dev).rsplit(",", 1)[1].split()[0]
    return {"device": torch.cuda.get_device_name(index), "power_limit_w": float(limit)}
