"""Known-ICAO address filter.

The reference keeps two open-addressed hash tables swapped every 60 s for
TTL aging (icao_filter.c:96-154).  Here the host-side filter is two Python
sets with the same two-generation aging; the device side mirrors it as a
sorted address table (ops/gate.py DeviceIcaoMirror).
"""

from __future__ import annotations

FILTER_TTL_MS = 60_000


class IcaoFilter:
    def __init__(self):
        self.cur: set[int] = set()
        self.prev: set[int] = set()
        self.next_swap_ms: int | None = None

    def add(self, addr: int) -> None:
        self.cur.add(addr & 0xFFFFFF)

    def test(self, addr: int) -> bool:
        addr &= 0xFFFFFF
        return addr in self.cur or addr in self.prev

    def expire(self, now_ms: int) -> None:
        """Swap generations every FILTER_TTL_MS (icao_filter.c:96-110)."""
        if self.next_swap_ms is None:
            self.next_swap_ms = now_ms + FILTER_TTL_MS
            return
        if now_ms >= self.next_swap_ms:
            self.prev = self.cur
            self.cur = set()
            self.next_swap_ms = now_ms + FILTER_TTL_MS
