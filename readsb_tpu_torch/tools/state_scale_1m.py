"""Checkpoint at the reference's design scale: save and load of N aircraft.

The port of the JAX repo's `tools/state_scale_1m.py`:

    python3 -m readsb_tpu_torch.tools.state_scale_1m [N]

The reference's design point is 1M+ aircraft (2^20 hash buckets,
readsb.h:310-313) checkpointed as 256 zstd blobs loaded by parallel
threads (globe_index.c:3565-3761).  This times the port's v2 blob format
(`io/state.py`, zstd through `io/zstd.py`) at N aircraft (default
1,000,000; every twentieth with an 8-point trace): save, load, and the
original's round-trip spot check.  Host work only; the device named beside
the numbers is the machine's card (which it raises without), or the CPU
under READSB_TPU_PLATFORM=cpu.  The state directory is temporary and
removed.  The last line is one JSON object {"metric": "state_save", ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..decode.fields import Source
from ..io import state as state_io
from ..app.main import platform_device
from ..pipeline import _resolve_device
from ..track.traces import State, Trace
from ..track.tracker import Aircraft, Tracker, Validity
from . import device_fields


def build_fleet(tracker: Tracker, n: int, traces_every: int = 20) -> None:
    """n aircraft, default_rng(5), as the original builds them."""
    rng = np.random.default_rng(5)
    lat = rng.uniform(-60, 70, n)
    lon = rng.uniform(-180, 180, n)
    alt = rng.integers(0, 45000, n)
    for i in range(n):
        addr = 0x100000 + i
        a = Aircraft(addr=addr)
        a.seen = 1_000_000 + i
        a.messages = int(alt[i]) % 997
        a.lat, a.lon = float(lat[i]), float(lon[i])
        a.seen_pos = a.seen
        a.baro_alt = int(alt[i])
        a.baro_alt_valid = Validity(updated=a.seen, source=Source.ADSB,
                                    last_source=Source.ADSB)
        a.callsign = f"TST{i % 1000:03d}"
        if i % traces_every == 0:
            tr = Trace()
            tr.points = [
                State(timestamp=a.seen - 1000 * k, lat=a.lat, lon=a.lon, baro_alt=a.baro_alt)
                for k in range(8)
            ]
            a.trace = tr
        tracker.aircraft[addr] = a


def run(n: int = 1_000_000) -> dict:
    """Measure and print; returns the JSON line's object.  Raises when the
    loaded store does not hold the saved fleet."""
    dev = _resolve_device(platform_device())
    tr = Tracker()
    t0 = time.perf_counter()
    build_fleet(tr, n)
    print(f"fleet build: {time.perf_counter() - t0:.1f}s ({n} aircraft)", flush=True)

    with tempfile.TemporaryDirectory(prefix="state1m_") as tmp:
        d = os.path.join(tmp, "state")
        t0 = time.perf_counter()
        saved = state_io.save_state(tr, d, now_ms=2_000_000)
        dt_save = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        print(f"save: {dt_save:.2f}s  ({saved} aircraft, {size / 1e6:.0f} MB, "
              f"{saved / dt_save / 1e3:.0f}k aircraft/s)", flush=True)

        del tr
        tr2 = Tracker()
        t0 = time.perf_counter()
        loaded = state_io.load_state(tr2, d)
        dt_load = time.perf_counter() - t0
    print(f"load: {dt_load:.2f}s  ({loaded} aircraft, {loaded / dt_load / 1e3:.0f}k "
          f"aircraft/s)", flush=True)
    if loaded != n:
        raise RuntimeError(f"loaded {loaded} aircraft of {n}")

    # spot round trip: the last aircraft, and a traced one
    last = tr2.aircraft[0x100000 + n - 1]
    first = tr2.aircraft[0x100000]
    if not last.callsign.startswith("TST") or first.trace is None or len(first.trace.points) != 8:
        raise RuntimeError("the round trip lost the callsign or the trace")
    print("roundtrip spot-check ok", flush=True)
    line = {
        "metric": "state_save", "value": dt_save, "unit": "s", **device_fields(dev),
        "n": n, "load_s": dt_load, "bytes": size, "saved": saved, "loaded": loaded,
        "save_aircraft_per_s": saved / dt_save, "load_aircraft_per_s": loaded / dt_load,
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    return run(ap.parse_args(argv).n)


if __name__ == "__main__":
    main()
