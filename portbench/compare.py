"""The comparison that decides `correct`: the program's frames and stats
against the reference's, channel by channel and superblock by superblock.

A superblock's frames are packed as (message bytes joined, int64[n, 8]
fields, float64[n] signal power), the fields being msgbits, timestamp,
score, phase, correctedbits, addr, iid and scan_offset.  Packing keeps a
run's recorded output out of the garbage collector's sight.

Numbers compared, each with its limit (set in PERF.md from the readings
of sound runs and of the control):

  frames_differing      frames of any channel whose bytes or
                        fields differ, or that one side lacks      limit 0
  stats_differing       per-channel demodulator counters that differ
                        (preambles, rejected bad / unknown, accepted
                        with 0, 1, 2 corrected bits)               limit 0
  signal_rel_gap        the widest relative gap of a frame's signal
                        power; the program keeps it in float32,
                        readsb in double                           LIMITS
"""

from __future__ import annotations

import itertools
import operator

import numpy as np

LIMITS = {"frames_differing": 0, "stats_differing": 0, "signal_rel_gap": 1e-5}
FIELDS = ("msgbits", "timestamp", "score", "phase", "correctedbits", "addr", "iid", "scan_offset")


_FIELDS = operator.attrgetter(*FIELDS)
_POWER = operator.attrgetter("signal_power")
_MSG = operator.attrgetter("msg")


def pack_program(frames) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Pack the program's frame objects."""
    n = len(frames)
    ints = np.fromiter(itertools.chain.from_iterable(map(_FIELDS, frames)), np.int64, 8 * n)
    power = np.fromiter(map(_POWER, frames), np.float64, n)
    return b"".join(map(_MSG, frames)), ints.reshape(n, 8), power


def pack_reference(frames: list[tuple]) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Pack the reference's frame tuples (reference.Channel.superblock)."""
    n = len(frames)
    ints = np.array([f[1:9] for f in frames], dtype=np.int64).reshape(n, 8)
    power = np.array([f[9] for f in frames], dtype=np.float64)
    return b"".join(f[0] for f in frames), ints, power


def _messages(packed) -> list[bytes]:
    msgs, ints, _ = packed
    out, at = [], 0
    for nbits in ints[:, 0].tolist():
        out.append(msgs[at : at + nbits // 8])
        at += nbits // 8
    return out


def compare_superblock(prog, ref) -> tuple[int, float]:
    """(frames differing, widest relative signal gap among the frames that
    agree otherwise) of one channel's superblock."""
    pm, rm = _messages(prog), _messages(ref)
    n = min(len(pm), len(rm))
    same = np.all(prog[1][:n] == ref[1][:n], axis=1) & np.array(
        [pm[i] == rm[i] for i in range(n)], dtype=bool
    )
    differing = abs(len(pm) - len(rm)) + int((~same).sum())
    gap = 0.0
    if same.any():
        p, r = prog[2][:n][same], ref[2][:n][same]
        gap = float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-300)))
    return differing, gap


def compare(prog_frames: dict, prog_stats: dict, ref_frames: dict, ref_stats: dict) -> dict:
    """Numbers of the comparison over the channels of ref_frames.  *_frames map a
    channel to its packed superblocks in feed order, *_stats to its six
    counters.  Returns {"checks": {name: {"value", "limit"}}, "failing":
    the positions of the superblocks in which a channel differs}."""
    frames_diff, gap, failing = 0, 0.0, set()
    for c, ref in ref_frames.items():
        prog = prog_frames.get(c, [])
        for i in range(max(len(prog), len(ref))):
            if i >= len(prog) or i >= len(ref):
                d, g = len((prog if i < len(prog) else ref)[i][2]), 0.0
            else:
                d, g = compare_superblock(prog[i], ref[i])
            frames_diff += d
            gap = max(gap, g)
            if d:
                failing.add(i)
    stats_diff = sum(
        int(a != b) for c in ref_stats
        for a, b in zip(prog_stats.get(c, [None] * 6), ref_stats[c])
    )
    checks = {
        "frames_differing": {"value": frames_diff, "limit": LIMITS["frames_differing"]},
        "stats_differing": {"value": stats_diff, "limit": LIMITS["stats_differing"]},
        "signal_rel_gap": {"value": gap, "limit": LIMITS["signal_rel_gap"]},
    }
    return {"checks": checks, "failing": sorted(failing)}


def passed(checks: dict) -> bool:
    """Every number within its limit."""
    return all(v["value"] <= v["limit"] for v in checks.values())
