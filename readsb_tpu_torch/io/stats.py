"""Stats outputs: stats.json and the collect() counter snapshot.

Mirrors the reference's windowed stats.json contract (README-json.md:263+):
"latest", "last1min", "last5min", "last15min", "total" blocks built from
a ring of 1-minute periods (statsUpdate, stats.c:470 — the reference's
90x10s ring collapsed to the per-minute roll its JSON surface actually
exposes).  The Prometheus file (--write-prom) reads the history and Beast
layers and comes with ROADMAP item 8c.
"""

from __future__ import annotations

import dataclasses


# cumulative sources sampled by the collector: (field, getter)
_CPR_FIELDS = (
    "cpr_surface", "cpr_airborne", "cpr_global_ok", "cpr_global_bad",
    "cpr_global_skipped", "cpr_global_speed_checks", "cpr_local_ok",
    "cpr_local_skipped", "cpr_local_aircraft_relative",
    "cpr_local_receiver_relative", "cpr_local_range_checks",
    "cpr_local_speed_checks", "cpr_filtered",
    "tracks_all", "tracks_single_message",
)


@dataclasses.dataclass
class StatsPeriod:
    """One collection period's counters (struct stats, stats.h:57-149)."""

    start: float = 0.0
    end: float = 0.0
    # local (SDR/demod)
    samples_processed: int = 0
    blocks_processed: int = 0
    modeac: int = 0
    modes: int = 0  # preambles
    bad: int = 0
    unknown_icao: int = 0
    accepted: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    signal_sum: float = 0.0  # sum of per-message power (linear)
    signal_n: int = 0
    peak_signal: float = 0.0
    strong_signals: int = 0
    # remote (network ingest)
    remote_modeac: int = 0
    remote_modes: int = 0
    remote_bad: int = 0
    remote_unknown_icao: int = 0
    remote_accepted: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    # cpu milliseconds
    cpu_demod: float = 0.0
    cpu_reader: float = 0.0
    cpu_background: float = 0.0
    cpu_net: float = 0.0
    cpu_api: float = 0.0
    # cpr + tracks
    counters: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _CPR_FIELDS}
    )
    messages: int = 0

    def add(self, other: "StatsPeriod") -> None:
        self.end = max(self.end, other.end)
        self.start = min(self.start, other.start) if self.start else other.start
        for f in (
            "samples_processed", "blocks_processed", "modeac", "modes", "bad",
            "unknown_icao", "signal_sum", "signal_n", "strong_signals",
            "remote_modeac", "remote_modes", "remote_bad",
            "remote_unknown_icao", "cpu_demod", "cpu_reader",
            "cpu_background", "cpu_net", "cpu_api", "messages",
        ):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.peak_signal = max(self.peak_signal, other.peak_signal)
        for i, v in enumerate(other.accepted):
            while len(self.accepted) <= i:
                self.accepted.append(0)
            self.accepted[i] += v
        for i, v in enumerate(other.remote_accepted):
            while len(self.remote_accepted) <= i:
                self.remote_accepted.append(0)
            self.remote_accepted[i] += v
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v

    def to_json(self, local: bool, remote: bool) -> dict:
        import math

        def dbfs(p):
            return round(10 * math.log10(max(p, 1e-10)), 1)

        out = {"start": round(self.start, 1), "end": round(self.end, 1)}
        if local:
            sig = self.signal_sum / self.signal_n if self.signal_n else 0.0
            out["local"] = {
                "samples_processed": self.samples_processed,
                "blocks_processed": self.blocks_processed,
                "modeac": self.modeac,
                "modes": self.modes,
                "bad": self.bad,
                "unknown_icao": self.unknown_icao,
                "accepted": list(self.accepted),
                "signal": dbfs(sig),
                "peak_signal": dbfs(self.peak_signal),
                "strong_signals": self.strong_signals,
            }
        if remote:
            out["remote"] = {
                "modeac": self.remote_modeac,
                "modes": self.remote_modes,
                "bad": self.remote_bad,
                "unknown_icao": self.remote_unknown_icao,
                "accepted": list(self.remote_accepted),
            }
        c = self.counters
        out["cpu"] = {
            "demod": round(self.cpu_demod, 1),
            "reader": round(self.cpu_reader, 1),
            "background": round(self.cpu_background, 1),
            "net": round(self.cpu_net, 1),
            "api": round(self.cpu_api, 1),
        }
        out["cpr"] = {
            "surface": c["cpr_surface"],
            "airborne": c["cpr_airborne"],
            "global_ok": c["cpr_global_ok"],
            "global_bad": c["cpr_global_bad"],
            "global_range": 0,
            "global_speed": c["cpr_global_speed_checks"],
            "global_skipped": c["cpr_global_skipped"],
            "local_ok": c["cpr_local_ok"],
            "local_aircraft_relative": c["cpr_local_aircraft_relative"],
            "local_receiver_relative": c["cpr_local_receiver_relative"],
            "local_skipped": c["cpr_local_skipped"],
            "local_range": c["cpr_local_range_checks"],
            "local_speed": c["cpr_local_speed_checks"],
            "filtered": c["cpr_filtered"],
        }
        out["tracks"] = {
            "all": c["tracks_all"],
            "single_message": c["tracks_single_message"],
        }
        out["messages"] = self.messages
        return out


class StatsCollector:
    """Delta-samples the app's cumulative counters into 1-minute periods
    and serves the reference's latest/1/5/15-min/total window contract."""

    def __init__(self):
        self.current = StatsPeriod()
        self.minutes: list[StatsPeriod] = []  # most recent last, max 15
        self.total = StatsPeriod()
        self._last: dict | None = None
        self._last_roll: float | None = None
        # live CPU accumulators (ms), charged by the app's sections
        self.cpu = {"demod": 0.0, "reader": 0.0, "background": 0.0,
                    "net": 0.0, "api": 0.0}
        # live signal accounting, fed per accepted local frame
        self._sig = [0.0, 0, 0.0, 0]  # sum, n, peak, strong
        self.remote_ping_rtt = [0] * self.PING_BUCKETS
        # SDR buffers shed because the demod fell behind realtime
        # (reference samples_dropped, sdr_rtlsdr.c:300-320)
        self.samples_dropped_buffers = 0

    # RTT histogram buckets (PING_BUCKETS, readsb.h:332-334)
    PING_BUCKETS = 20
    PING_BUCKETBASE = 24.0
    PING_BUCKETMULT = 1.2

    def note_rtt(self, rtt_ms: float) -> None:
        """Bucket a feeder ping RTT (pongReceived, net_io.c:1384-1396)."""
        bucketmax, bucketsize = 0.0, self.PING_BUCKETBASE
        bucket = self.PING_BUCKETS - 1
        for i in range(self.PING_BUCKETS):
            bucketmax = round((bucketmax + bucketsize) / 10) * 10
            bucketsize *= self.PING_BUCKETMULT
            if rtt_ms <= bucketmax:
                bucket = i
                break
        self.remote_ping_rtt[bucket] += 1

    def note_sdr_drops(self, n_buffers: int) -> None:
        self.samples_dropped_buffers += n_buffers

    def note_signal(self, power: float) -> None:
        s = self._sig
        s[0] += power
        s[1] += 1
        s[2] = max(s[2], power)
        if power > 0.50119:  # -3 dBFS (demod_2400.c:446)
            s[3] += 1

    def _snapshot(self, app) -> dict:
        t = app.tracker
        snap = {k: getattr(t, k) for k in _CPR_FIELDS}
        snap["messages"] = app.messages
        snap["remote_modes"] = getattr(app, "remote_modes", 0)
        snap["remote_bad"] = getattr(app, "remote_bad", 0)
        snap["remote_modeac"] = getattr(app, "remote_modeac", 0)
        if app._demod is not None:
            st = app._demod.stats
            snap["samples_processed"] = app._demod.scan_global
            snap["modes"] = st.preambles
            snap["bad"] = st.rejected_bad
            snap["unknown_icao"] = st.rejected_unknown_icao
            snap["accepted"] = list(st.accepted)
            snap["modeac"] = getattr(app._demod, "stats_modeac", 0)
        for k, v in self.cpu.items():
            snap["cpu_" + k] = v
        return snap

    def sample(self, app, now_s: float) -> None:
        """Fold counter deltas since the last sample into `current`."""
        snap = self._snapshot(app)
        prev = self._last or {
            k: ([0] * len(v) if isinstance(v, list) else 0)
            for k, v in snap.items()
        }
        self._last = snap
        cur = self.current
        if not cur.start:
            cur.start = now_s
            self._last_roll = self._last_roll or now_s
        cur.end = now_s

        def d(key):
            return snap.get(key, 0) - (prev.get(key) or 0)

        cur.samples_processed += d("samples_processed")
        cur.blocks_processed += d("samples_processed") // 131072
        cur.modes += d("modes")
        cur.bad += d("bad")
        cur.unknown_icao += d("unknown_icao")
        cur.modeac += d("modeac")
        acc_now = snap.get("accepted") or []
        acc_prev = prev.get("accepted") or [0] * len(acc_now)
        for i, v in enumerate(acc_now):
            while len(cur.accepted) <= i:
                cur.accepted.append(0)
            cur.accepted[i] += v - (acc_prev[i] if i < len(acc_prev) else 0)
        cur.remote_modes += d("remote_modes")
        cur.remote_bad += d("remote_bad")
        cur.remote_modeac += d("remote_modeac")
        for k in _CPR_FIELDS:
            cur.counters[k] += d(k)
        cur.messages += d("messages")
        cur.cpu_demod += d("cpu_demod")
        cur.cpu_reader += d("cpu_reader")
        cur.cpu_background += d("cpu_background")
        cur.cpu_net += d("cpu_net")
        cur.cpu_api += d("cpu_api")
        sig = self._sig
        cur.signal_sum += sig[0]
        cur.signal_n += sig[1]
        cur.peak_signal = max(cur.peak_signal, sig[2])
        cur.strong_signals += sig[3]
        self._sig = [0.0, 0, 0.0, 0]

        # roll once a minute (statsUpdate, stats.c:470)
        if self._last_roll is None:
            self._last_roll = now_s
        if now_s - self._last_roll >= 60.0:
            self._last_roll = now_s
            self.total.add(cur)
            self.minutes.append(cur)
            del self.minutes[:-15]
            self.current = StatsPeriod(start=now_s, end=now_s)

    def stats_json(self, app, now_s: float) -> dict:
        local = app._demod is not None
        remote = bool(getattr(app.args, "net", False) or getattr(app.args, "net_only", False))

        def window(n):
            p = StatsPeriod()
            for q in self.minutes[-n:]:
                p.add(q)
            if not self.minutes:
                p.start = p.end = now_s
            return p

        tot = StatsPeriod()
        tot.add(self.total)
        tot.add(self.current)
        doc = {
            "latest": self.current.to_json(local, remote),
            "last1min": window(1).to_json(local, remote),
            "last5min": window(5).to_json(local, remote),
            "last15min": window(15).to_json(local, remote),
            "total": tot.to_json(local, remote),
        }
        if getattr(app.args, "stats_range", False):
            # --stats-range: per-bearing max range in meters over the
            # outline's 24h ring (reference polar_range, stats.c:733-790)
            outline = getattr(app.tracker, "outline", None)
            if outline is not None:
                doc["polar_range"] = [
                    int(v) for v in outline.distance.max(axis=0).tolist()
                ]
        return doc


def collect(app, now_ms: int) -> dict:
    t = app.tracker
    with_pos = sum(1 for a in t.aircraft.values() if a.seen_pos > 0)
    d = {
        "now": now_ms / 1000.0,
        "messages": app.messages,
        "aircraft_total": len(t.aircraft),
        "aircraft_with_pos": with_pos,
        "cpr_global_ok": t.cpr_global_ok,
        "cpr_global_bad": t.cpr_global_bad,
        "cpr_global_skipped": t.cpr_global_skipped,
        "cpr_local_ok": t.cpr_local_ok,
        "cpr_surface": t.cpr_surface,
        "cpr_airborne": t.cpr_airborne,
    }
    if app._demod is not None:
        st = app._demod.stats
        d.update(
            {
                "samples_processed": app._demod.scan_global,
                "demod_preambles": st.preambles,
                "demod_rejected_bad": st.rejected_bad,
                "demod_rejected_unknown_icao": st.rejected_unknown_icao,
                "demod_accepted": list(st.accepted),
            }
        )
    return d
