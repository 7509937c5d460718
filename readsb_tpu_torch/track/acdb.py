"""tar1090 aircraft database ingest (registration / type / dbFlags).

Reference: aircraft.c:465-784 — `--db-file` points at tar1090's
`aircraft.csv.gz`, a gzip of `addr;registration;typeCode;dbFlags;
typeLong;year;ownOp` lines keyed by hex ICAO.  readsb re-checks the
file mtime every 30 s, rebuilds an index off-thread, and re-joins every
tracked aircraft (updateTypeReg).  Military ICAO ranges are OR'd into
dbFlags bit 0 regardless of DB contents (isMilRange, aircraft.c:785-890).

Here the DB is a plain dict (host control plane); the join happens at
aircraft creation and after each reload sweep.

A copy of readsb_tpu's `track/acdb.py`.
"""

from __future__ import annotations

import dataclasses
import gzip
import logging
import os
from typing import Optional

log = logging.getLogger("readsb_tpu_torch.acdb")

# (lo, hi) inclusive military ICAO allocations (aircraft.c:785-890)
MIL_RANGES: tuple[tuple[int, int], ...] = (
    (0xADF7C8, 0xAFFFFF),  # united states
    (0x010070, 0x01008F),  # egypt
    (0x0A4000, 0x0A4FFF),  # algeria
    (0x33FF00, 0x33FFFF),  # italy
    (0x350000, 0x37FFFF),  # spain
    (0x3AA000, 0x3AFFFF),  # france 1
    (0x3B7000, 0x3BFFFF),  # france 2
    (0x3EA000, 0x3EBFFF),  # germany 1
    (0x3F4000, 0x3FBFFF),  # germany 2+3
    (0x400000, 0x40003F),  # united kingdom 1
    (0x43C000, 0x43CFFF),  # united kingdom 2
    (0x444000, 0x446FFF),  # austria
    (0x44F000, 0x44FFFF),  # belgium
    (0x457000, 0x457FFF),  # bulgaria
    (0x45F400, 0x45F4FF),  # denmark
    (0x468000, 0x4683FF),  # greece
    (0x473C00, 0x473C0F),  # hungary
    (0x478100, 0x4781FF),  # norway
    (0x480000, 0x480FFF),  # netherlands
    (0x48D800, 0x48D87F),  # poland
    (0x497C00, 0x497CFF),  # portugal
    (0x498420, 0x49842F),  # czech republic
    (0x4B7000, 0x4B7FFF),  # switzerland
    (0x4B8200, 0x4B82FF),  # turkey
    (0x70C070, 0x70C07F),  # oman
    (0x710258, 0x71028F),  # saudi arabia 1-3
    (0x710380, 0x71039F),  # saudi arabia 4
    (0x738A00, 0x738AFF),  # israel
    (0x7CF800, 0x7CFAFF),  # australia
    (0x800200, 0x8002FF),  # india
    (0xC20000, 0xC3FFFF),  # canada
    (0xE40000, 0xE41FFF),  # brazil
)


def is_mil_range(addr: int) -> bool:
    for lo, hi in MIL_RANGES:
        if lo <= addr <= hi:
            return True
    return False


@dataclasses.dataclass
class DbEntry:
    registration: str = ""
    type_code: str = ""
    db_flags: int = 0
    type_long: str = ""
    year: str = ""
    own_op: str = ""


def _parse_flags(field: str) -> int:
    """LSB-first '1'/'0' character bitstring (updateDetails, aircraft.c:731)."""
    flags = 0
    for j, ch in enumerate(field[:32]):
        if ch == "1":
            flags |= 1 << j
    return flags


class AircraftDb:
    """Mtime-watched aircraft.csv.gz lookup table."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: dict[int, DbEntry] = {}
        self._mtime: float = -1.0

    def maybe_reload(self) -> bool:
        """Reload if the file changed; True when a new table was applied."""
        if not self.path:
            return False
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return False
        if mtime == self._mtime:
            return False
        try:
            opener = gzip.open if self.path.endswith(".gz") else open
            with opener(self.path, "rt", errors="replace") as f:
                entries: dict[int, DbEntry] = {}
                for line in f:
                    parts = line.rstrip("\n").split(";")
                    if len(parts) < 3:
                        continue
                    try:
                        addr = int(parts[0], 16)
                    except ValueError:
                        continue
                    if addr == 0:
                        continue
                    entries[addr] = DbEntry(
                        registration=parts[1].strip() if len(parts) > 1 else "",
                        type_code=parts[2].strip() if len(parts) > 2 else "",
                        db_flags=_parse_flags(parts[3]) if len(parts) > 3 else 0,
                        type_long=parts[4].strip() if len(parts) > 4 else "",
                        year=parts[5].strip() if len(parts) > 5 else "",
                        own_op=parts[6].strip() if len(parts) > 6 else "",
                    )
        except OSError as e:
            log.warning("db-file read failed: %s", e)
            return False
        if not entries:
            log.warning("db-file has no entries, keeping old table")
            return False
        self.entries = entries
        self._mtime = mtime
        log.info("aircraft db loaded: %d entries", len(entries))
        return True

    def lookup(self, addr: int) -> Optional[DbEntry]:
        return self.entries.get(addr & 0xFFFFFF)

    def apply(self, a) -> None:
        """Join DB details onto a tracked aircraft (updateTypeReg)."""
        d = self.lookup(a.addr)
        if d is not None:
            a.registration = d.registration
            a.type_code = d.type_code
            a.db_flags = d.db_flags
            a.type_long = d.type_long
            a.own_op = d.own_op
            a.year = d.year
        else:
            a.registration = ""
            a.type_code = ""
            a.db_flags = 0
            a.type_long = ""
            a.own_op = ""
            a.year = ""
        if is_mil_range(a.addr):
            a.db_flags |= 1
