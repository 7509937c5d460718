"""Serving-tick benchmark at aggregator scale.

The port of the JAX repo's `tools/bench_serving.py`:

    python3 -m readsb_tpu_torch.tools.bench_serving [n_aircraft]

The reference's upkeep / json / globeBin threads regenerate the serving
surfaces on a ~1 s cadence (readsb.c:228; json writers readsb.c:532-717,
api.c:859).  This times one full serving tick for a fleet of n_aircraft
(default 50,000) with live positions, every fifth with a trace, through the
port's host modules:

  aircraft.json   generate + gzip write (json_out.c:1321 analog)
  binCraft        full-fleet zstd record file (json_out.c:1017)
  globe binCraft  per-tile files (json_out.c:1106; 1/8 of the tiles per
                  tick in the reference: all are timed and /8 reported)
  traces          the trace writer's sweep over every dirty trace (/8)
  API snapshot    the /re-api double-buffer rebuild (apiUpdate, api.c:859)

Host work only; the device named beside the numbers is the machine's card
(which it raises without), or the CPU under READSB_TPU_PLATFORM=cpu.  The
files go to a temporary directory that is removed.  The last lines are
the original's SERVING_TICK line and one JSON object {"metric":
"serving_tick", "value": tick ms, ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..decode.fields import Source
from ..io import history as history_io
from ..io.api import ApiSnapshot
from ..io.bincraft import write_bincraft_zst
from ..io.json_out import generate_aircraft_json, write_json_atomic
from ..app.main import platform_device
from ..pipeline import _resolve_device
from ..track import globe as globe_mod
from ..track.traces import Trace
from ..track.tracker import Aircraft, Tracker, Validity
from . import device_fields

NOW = 10_000_000
BUDGET_MS = 1000


def build_fleet(tr: Tracker, n: int) -> None:
    """n aircraft with positions, default_rng(7), as the original builds
    them; every fifth carries a trace of 30 recent points."""
    rng = np.random.default_rng(7)
    lat = rng.uniform(-60, 70, n)
    lon = rng.uniform(-180, 180, n)
    alt = rng.integers(1000, 43000, n)
    gs = rng.uniform(80, 520, n)
    trk = rng.uniform(0, 360, n)
    for i in range(n):
        a = Aircraft(addr=0x400000 + i)
        a.seen = NOW - int(rng.integers(0, 5000))
        a.messages = 50 + i % 997
        a.lat, a.lon = float(lat[i]), float(lon[i])
        a.seen_pos = a.seen
        a.pos_nic, a.pos_rc = 8, 186.0
        a.pos_reliable_odd = a.pos_reliable_even = 4.0
        a.baro_alt = int(alt[i])
        a.gs = float(gs[i])
        a.track = float(trk[i])
        a.callsign = f"BNC{i % 10000:04d}"
        a.squawk = 0x1000 + (i % 0o7777)
        for v in ("baro_alt_valid", "gs_valid", "track_valid",
                  "position_valid", "callsign_valid", "squawk_valid"):
            setattr(a, v, Validity(updated=a.seen, source=Source.ADSB,
                                   last_source=Source.ADSB))
        a.globe_index = globe_mod.globe_index(a.lat, a.lon)
        if i % 5 == 0:
            t = Trace()
            for k in range(30):
                t.add(a, a.seen - (30 - k) * 4000, json_trace_interval=1000)
            t.dirty = True
            a.trace = t
        tr.aircraft[a.addr] = a


def run(n: int = 50_000) -> dict:
    """Measure and print; returns the JSON line's object."""
    dev = _resolve_device(platform_device())
    tr = Tracker(keep_traces=True)
    t0 = time.perf_counter()
    build_fleet(tr, n)
    print(f"fleet: {n} aircraft (+{n // 5} traces) in {time.perf_counter() - t0:.1f}s",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="serving_") as out:
        t0 = time.perf_counter()
        doc = generate_aircraft_json(tr, NOW)
        write_json_atomic(doc, os.path.join(out, "aircraft.json"), gzip_level=1)
        t_json = time.perf_counter() - t0

        t0 = time.perf_counter()
        write_bincraft_zst(tr, os.path.join(out, "aircraft.binCraft.zst"), NOW)
        t_bin = time.perf_counter() - t0

        t0 = time.perf_counter()
        ntiles = history_io.write_globe_bincraft(tr, out, NOW)
        t_globe = time.perf_counter() - t0

        t0 = time.perf_counter()
        ntr, _cursor = history_io.write_traces(tr, out, NOW, time_budget_s=None)
        t_traces = time.perf_counter() - t0

    t0 = time.perf_counter()
    snap = ApiSnapshot(tr, NOW)
    t_api = time.perf_counter() - t0
    if snap.n_pos <= 0:
        raise RuntimeError("the API snapshot holds no aircraft with a position")

    # the reference writes 1/8 of the globe tiles and a budgeted slice of
    # the traces per tick; those are scaled for the per-tick figure
    tick = t_json + t_bin + t_globe / 8 + t_traces / 8 + t_api
    print(f"aircraft.json:  {t_json * 1e3:7.0f} ms ({len(doc['aircraft'])} rows)")
    print(f"binCraft full:  {t_bin * 1e3:7.0f} ms")
    print(f"globe binCraft: {t_globe * 1e3:7.0f} ms ALL {ntiles} tiles "
          f"(/8 per tick: {t_globe / 8 * 1e3:.0f} ms)")
    print(f"traces:         {t_traces * 1e3:7.0f} ms ALL {ntr} dirty "
          f"(/8 per tick: {t_traces / 8 * 1e3:.0f} ms)")
    print(f"api snapshot:   {t_api * 1e3:7.0f} ms")
    print(f"SERVING_TICK {{'n': {n}, 'tick_ms': {tick * 1e3:.0f}, 'budget_ms': {BUDGET_MS}}}")
    line = {
        "metric": "serving_tick", "value": tick * 1e3, "unit": "ms", **device_fields(dev),
        "n": n, "budget_ms": BUDGET_MS, "aircraft_json_ms": t_json * 1e3,
        "bincraft_ms": t_bin * 1e3, "globe_all_ms": t_globe * 1e3, "tiles": ntiles,
        "traces_all_ms": t_traces * 1e3, "traces": ntr, "api_ms": t_api * 1e3,
        "api_rows": snap.n_pos,
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_aircraft", nargs="?", type=int, default=50_000)
    return run(ap.parse_args(argv).n_aircraft)


if __name__ == "__main__":
    main()
