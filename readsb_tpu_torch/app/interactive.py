"""Interactive aircraft table (interactive.c:121 interactiveShowData).

A curses table refreshed every 250 ms over the live tracker — the
viewadsb display.  Rendering is isolated here so the asyncio app just
schedules refresh() calls; plain-terminal fallback (no curses / no tty)
prints a periodic table to stdout instead.
"""

from __future__ import annotations

import sys
import time

REFRESH_S = 0.25

_HDR = (
    " Hex    Mode  Sqwk  Flight   Alt    Spd  Hdg    Lat      Long   RSSI  Msgs  Ti"
)


def _rows(tracker, now_ms: int, limit: int, ttl_ms: int = 60_000,
          metric: bool = False) -> list[str]:
    out = []
    aircraft = sorted(
        (a for a in tracker.aircraft.values() if now_ms - a.seen <= ttl_ms),
        key=lambda a: a.seen, reverse=True,
    )[:limit]
    for a in aircraft:
        mode = "S"
        squawk = f"{a.squawk:04x}" if a.squawk is not None else ""
        flight = (a.callsign or "").strip()
        altv = getattr(a, "baro_alt", None)
        if metric and altv is not None:
            altv = int(altv * 0.3048)  # feet -> meters (--metric, help.h)
        alt = f"{altv:6d}" if altv is not None else "      "
        spdv = getattr(a, "gs", None)
        if metric and spdv is not None:
            spdv = spdv * 1.852  # knots -> km/h
        spd = f"{spdv:4.0f}" if spdv is not None else "    "
        hdg = f"{a.track:3.0f}" if getattr(a, "track", None) is not None else "   "
        lat = f"{a.lat:8.3f}" if a.lat is not None else "        "
        lon = f"{a.lon:8.3f}" if a.lon is not None else "        "
        rssi = f"{a.rssi_dbfs():5.1f}" if hasattr(a, "rssi_dbfs") else "     "
        ti = max(0, (now_ms - a.seen) // 1000)
        out.append(
            f" {a.addr:06X} {mode:>4} {squawk:>5}  {flight:<8} {alt} {spd} {hdg:>4}"
            f" {lat} {lon} {rssi} {a.messages:5d} {ti:3d}"
        )
    return out


class InteractiveDisplay:
    def __init__(self, tracker, ttl_s: float = 60.0, metric: bool = False):
        self.tracker = tracker
        self.ttl_ms = int(ttl_s * 1000)  # --interactive-ttl (help.h)
        self.metric = metric  # --metric: meters / km/h display
        self._scr = None
        try:
            if sys.stdout.isatty():
                import curses

                self._scr = curses.initscr()
                curses.noecho()
                curses.cbreak()
                self._scr.nodelay(True)
        except Exception:
            self._scr = None
        self._last_plain = 0.0

    def refresh(self, now_ms: int) -> None:
        if self._scr is not None:
            import curses

            h, w = self._scr.getmaxyx()
            self._scr.erase()
            self._scr.addnstr(0, 0, _HDR, w - 1, curses.A_REVERSE)
            for i, line in enumerate(
                _rows(self.tracker, now_ms, h - 2, self.ttl_ms, self.metric)
            ):
                self._scr.addnstr(i + 1, 0, line, w - 1)
            self._scr.refresh()
        else:
            # no tty: periodic plain table (1 s cadence)
            if time.time() - self._last_plain < 1.0:
                return
            self._last_plain = time.time()
            print(_HDR, file=sys.stderr)
            for line in _rows(self.tracker, now_ms, 30, self.ttl_ms, self.metric):
                print(line, file=sys.stderr)

    def close(self) -> None:
        if self._scr is not None:
            import curses

            try:
                curses.nocbreak()
                curses.echo()
                curses.endwin()
            except Exception:
                pass
            self._scr = None
