"""Checkpoint / resume: persist the aircraft store across restarts.

A copy of readsb_tpu's `io/state.py`, with readsb_tpu's names and file
formats: `save_blob`, `save_state` and `load_state`, which reads the v1
gzip'd JSON blobs and the v2 zstd pickles and writes v2, history traces
included.  Two things differ:

- zstd is the port's own codec (`io/zstd.py`, libzstd through ctypes) in
  place of the `zstandard` package;
- readsb_tpu's v2 blobs pickle its own classes (`Aircraft`'s `Validity`
  and `CprPair`, the enums of `decode.fields`, a trace's `Trace` and
  `State`).  `load_state` maps those class paths to the port's modules, so
  a state directory that readsb_tpu wrote loads without importing it; the
  port's `pos_reliable_valid` is absent there and materializes as a fresh
  `Validity` (`Aircraft.__getattr__`).  A restored trace's chunks still
  pickle readsb_tpu's `State`: `track/traces.load_chunk` maps it when
  they are read.

The reference writes 256 round-robin zstd "blobs" of raw aircraft structs
(globe_index.c:2656-3081, readsb.c:2545-2568).  Here the store is a
dict of dataclasses, so the checkpoint is N blobs sharded by address
(same round-robin continuous-write pattern).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import json
import os
import pickle
from typing import Optional

from ..decode.fields import AddrType, AirGround, HeadingType, Source
from ..track.tracker import Aircraft, CprPair, Tracker, Validity
from . import zstd

STATE_BLOBS = 64
STATE_MAGIC = "readsb-tpu-state-v1"


def _validity_to_list(v: Validity) -> list:
    return [v.updated, int(v.source), int(v.last_source)]


def _validity_from_list(x: list) -> Validity:
    return Validity(updated=x[0], source=Source(x[1]), last_source=Source(x[2]))


_SKIP = {"signal_ring", "trace"}  # trace serialized separately (see below)


def _trace_to_dict(tr) -> Optional[dict]:
    """Persist a Trace incl. compressed chunks (globe_index.c:2656-2938
    keeps trace chunks in the state blobs; restart must not lose them)."""
    import base64

    if tr is None or (not tr.points and not tr.chunks):
        return None
    return {
        "points": [dataclasses.asdict(s) for s in tr.points],
        "chunks": [base64.b64encode(c).decode() for c in tr.chunks],
        "chunk_meta": [list(m) for m in tr.chunk_meta],
        "len_total": tr.len_total,
        "next_marker": tr.next_marker,
    }


def _trace_from_dict(d: Optional[dict]):
    import base64

    from ..track.traces import State, Trace

    if not d:
        return None
    tr = Trace()
    tr.points = [State(**p) for p in d["points"]]
    tr.chunks = [base64.b64decode(c) for c in d["chunks"]]
    tr.chunk_meta = [tuple(m) for m in d["chunk_meta"]]
    tr.len_total = d["len_total"]
    tr.next_marker = d.get("next_marker", 0)
    return tr


def _aircraft_to_dict(a: Aircraft) -> dict:
    """A v1 record: readsb_tpu writes these, and its own and the port's
    load_state read them."""
    out = {}
    tr = _trace_to_dict(getattr(a, "trace", None))
    if tr is not None:
        out["__trace"] = tr
    for f in dataclasses.fields(a):
        val = getattr(a, f.name)
        if f.name in _SKIP:
            continue
        if isinstance(val, Validity):
            out[f.name] = _validity_to_list(val)
        elif isinstance(val, CprPair):
            out[f.name] = [
                val.lat, val.lon, int(val.type), _validity_to_list(val.valid),
                val.nic, val.rc,
            ]
        elif isinstance(val, (Source, AddrType, AirGround, HeadingType)):
            out[f.name] = int(val)
        elif isinstance(val, bytes):
            out[f.name] = {"__hex": val.hex()}
        else:
            out[f.name] = val
    return out


def _aircraft_from_dict(d: dict) -> Aircraft:
    a = Aircraft(addr=d["addr"])
    for f in dataclasses.fields(Aircraft):
        if f.name not in d or f.name in _SKIP:
            continue
        val = d[f.name]
        cur = getattr(a, f.name)
        if isinstance(cur, Validity):
            setattr(a, f.name, _validity_from_list(val))
        elif isinstance(cur, CprPair):
            pair = CprPair(
                lat=val[0], lon=val[1], type=val[2],
                valid=_validity_from_list(val[3]),
            )
            if len(val) >= 6:  # nic/rc added round 3
                pair.nic, pair.rc = val[4], val[5]
            setattr(a, f.name, pair)
        elif isinstance(cur, AirGround):
            setattr(a, f.name, AirGround(val))
        elif isinstance(cur, AddrType):
            setattr(a, f.name, AddrType(val))
        elif isinstance(cur, HeadingType):
            setattr(a, f.name, HeadingType(val))
        elif isinstance(val, dict) and "__hex" in val:
            setattr(a, f.name, bytes.fromhex(val["__hex"]))
        else:
            setattr(a, f.name, val)
    tr = _trace_from_dict(d.get("__trace"))
    if tr is not None:
        a.trace = tr
    return a


STATE_MAGIC_V2 = b"readsb-tpu-state-v2"

_SENTINEL = object()
_DEF = None  # default Aircraft field template, built lazily
_NEVER = -(1 << 60)


def _pack_aircraft(a: Aircraft) -> dict:
    """Sparse state dict: only fields that differ from a fresh Aircraft.

    Untouched Validity clocks (the ~45 per-field timers, most of them
    never set on a typical aircraft) are detected by two attribute loads
    instead of a dataclass __eq__, which dominates a naive diff at
    aggregator fleet sizes."""
    global _DEF
    if _DEF is None:
        _DEF = dict(Aircraft(addr=0).__dict__)
    d = {}
    for k, v in a.__dict__.items():
        t = type(v)
        if t is Validity:
            if v.updated != _NEVER or v.source:
                d[k] = v
        elif t is CprPair:
            if v.valid.updated != _NEVER or v.lat or v.lon:
                d[k] = v
        elif _DEF.get(k, _SENTINEL) != v:
            d[k] = v
    return d


_IMMUT = None


def _unpack_aircraft(d: dict) -> Aircraft:
    """Reconstruct without running the dataclass __init__: immutable
    defaults are shared, and the ~45 untouched Validity/CprPair/list
    defaults per aircraft are NOT built at all — Aircraft.__getattr__
    materializes them lazily on first access.  This makes the load cost
    proportional to the fields actually set (the sparse analog of the
    reference's flat-struct memcpy load, globe_index.c:2939-3081)."""
    global _IMMUT, _DEF
    if _IMMUT is None:
        if _DEF is None:
            _DEF = dict(Aircraft(addr=0).__dict__)
        _IMMUT = {
            k: v for k, v in _DEF.items()
            if isinstance(v, (int, float, str, bytes, bool, type(None)))
            or isinstance(v, (Source, AddrType, AirGround, HeadingType))
        }
    a = object.__new__(Aircraft)
    ad = dict(_IMMUT)
    ad.update(d)
    a.__dict__ = ad
    return a


# readsb_tpu's modules whose classes its v2 blobs pickle -> the port's copies
_RECORD_MODULES = {
    "readsb_tpu.track.tracker": "readsb_tpu_torch.track.tracker",
    "readsb_tpu.decode.fields": "readsb_tpu_torch.decode.fields",
    "readsb_tpu.track.traces": "readsb_tpu_torch.track.traces",
}


class _Unpickler(pickle.Unpickler):
    """Reads the port's v2 blobs and readsb_tpu's: readsb_tpu's record
    classes resolve to the port's copies, never to readsb_tpu itself."""

    def find_class(self, module: str, name: str):
        module = _RECORD_MODULES.get(module, module)
        if module.split(".")[0] == "readsb_tpu":
            raise pickle.UnpicklingError(f"{module}.{name} is no state record class")
        return super().find_class(module, name)


def save_blob(tracker: Tracker, directory: str, blob: int) -> int:
    """Write one round-robin blob (aircraft with addr % STATE_BLOBS == blob).

    v2 format: zstd-compressed pickle of the Aircraft dataclasses behind a
    magic prefix — the binary analog of the reference's zstd struct blobs
    (save_blob, globe_index.c:2656-2938); load_state still reads v1 blobs
    for upgrade compatibility.
    """
    os.makedirs(directory, exist_ok=True)
    records = [
        _pack_aircraft(a)
        for addr, a in tracker.aircraft.items()
        if addr % STATE_BLOBS == blob
    ]
    payload = pickle.dumps({"blob": blob, "aircraft": records}, protocol=4)
    path = os.path.join(directory, f"blob_{blob:02d}.bin.zst")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(STATE_MAGIC_V2)
        f.write(zstd.compress(payload, 1))
    os.rename(tmp, path)
    # a leftover v1 blob would resurrect stale aircraft on load
    v1 = os.path.join(directory, f"blob_{blob:02d}.json.gz")
    if os.path.exists(v1):
        os.unlink(v1)
    return len(records)


def save_state(tracker: Tracker, directory: str, now_ms: int) -> int:
    """Full checkpoint (writeInternalState analog)."""
    n = 0
    for blob in range(STATE_BLOBS):
        n += save_blob(tracker, directory, blob)
    # polar range table rides along (writeRangeDirs, globe_index.c:3460)
    tracker.outline.save(os.path.join(directory, "rangeDirs.gz"))
    return n


def load_state(tracker: Tracker, directory: str) -> int:
    """Parallel-loadable startup restore (readInternalState analog).

    GC is paused for the bulk reconstruction: allocating 10^5..10^6
    objects with a large live heap otherwise triggers quadratic
    collector scans."""
    import gc

    gc_was = gc.isenabled()
    gc.disable()
    try:
        return _load_state_inner(tracker, directory)
    finally:
        if gc_was:
            gc.enable()


def _load_state_inner(tracker: Tracker, directory: str) -> int:
    n = 0

    # v2 blobs load in parallel (the reference spreads load_blob over
    # io_threads, globe_index.c:3565-3761): file IO + zstd decompression
    # release the GIL, so reads/decompresses overlap while the pure-Python
    # record unpacking serializes; insertion order across blobs does not
    # matter (addresses are disjoint by construction).
    def _load_v2(blob: int):
        path = os.path.join(directory, f"blob_{blob:02d}.bin.zst")
        if not os.path.exists(path):
            return None
        try:
            raw = open(path, "rb").read()
            if not raw.startswith(STATE_MAGIC_V2):
                return []
            doc = _Unpickler(io.BytesIO(zstd.decompress(raw[len(STATE_MAGIC_V2):]))).load()
        except (OSError, pickle.UnpicklingError, zstd.ZstdError):
            return []
        return [_unpack_aircraft(d) for d in doc.get("aircraft", [])]

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(_load_v2, range(STATE_BLOBS)))
    for blob, recs in enumerate(results):
        if recs is not None:
            for a in recs:
                tracker.aircraft[a.addr] = a
                n += 1
            continue
        path = os.path.join(directory, f"blob_{blob:02d}.json.gz")
        if not os.path.exists(path):
            continue
        try:
            with gzip.open(path, "rt") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if doc.get("magic") != STATE_MAGIC:
            continue
        for rec in doc.get("aircraft", []):
            a = _aircraft_from_dict(rec)
            tracker.aircraft[a.addr] = a
            n += 1
    rd = os.path.join(directory, "rangeDirs.gz")
    if os.path.exists(rd):
        tracker.outline.load(rd)
    return n
