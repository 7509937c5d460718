"""Aircraft tracking: decoded messages -> live aircraft state store.

Host control-plane analog of the reference's track.c, re-designed rather
than transcribed: a dict-backed store of per-aircraft records whose field
updates follow the reference's acceptance rules:

- 3-state data validity {fresh, stale, expired} with source priority:
  updates from a lower-priority source are rejected while the field is
  fresh (TRACK_STALE=15s), accepted when stale, fields expire at
  TRACK_EXPIRE=60s (track.h:105-119, track.c:128-221)
- squawk double-confirmation before accepting a changed squawk
  (track.c:2071-2092)
- CPR position pipeline: global odd/even pair decode when both halves are
  <10s apart, else local/relative decode against the last position;
  surface decode requires a reference position (track.c:1249-1385,746,843)
- speed check: faithful port of the reference's plausibility model —
  great-circle distance vs speed estimate with track-bonus geometry,
  per-source allowances, unreliability counters and overrides
  (track.c:423-736; see _speed_check)
- odd/even position reliability counters with configurable threshold
  (track.c:3686-3758, track.h:636-658)
- staleness sweep removing aircraft idle > 5 min (trackRemoveStale,
  track.c:2948; the reference keeps them longer for globe history — that
  retention lives in the trace/history layer here)

A copy of readsb_tpu's dict tracker, kept bit-equal to it, without its
history traces (keep_traces, json_trace_interval): those come with ROADMAP
item 8c and the device arena with item 10.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import Optional

from ..decode import cpr as cpr_mod
from ..decode.fields import (
    AddrType,
    AirGround,
    CprType,
    HeadingType,
    ModesMessage,
    SilType,
    Source,
)

MS = 1
SECONDS = 1000
MINUTES = 60 * SECONDS

TRACK_MODEAC_MIN_MESSAGES = 4
TRACK_STALE = 15 * SECONDS
TRACK_EXPIRE = 60 * SECONDS
TRACK_EXPIRE_LONG = 180 * SECONDS
TRACK_EXPIRE_JAERO = 33 * MINUTES
POS_RELIABLE_TIMEOUT = 60 * MINUTES
CPR_MAX_INTERVAL = 10 * SECONDS  # max odd/even gap for global decode (track.c:85)


def greatcircle(lat0: float, lon0: float, lat1: float, lon1: float) -> float:
    """Great-circle distance in meters (haversine; util.h:164)."""
    lat0, lon0, lat1, lon1 = map(math.radians, (lat0, lon0, lat1, lon1))
    dlat = lat1 - lat0
    dlon = lon1 - lon0
    a = math.sin(dlat / 2) ** 2 + math.cos(lat0) * math.cos(lat1) * math.sin(dlon / 2) ** 2
    return 6371e3 * 2 * math.asin(min(1.0, math.sqrt(a)))


def bearing(lat0, lon0, lat1, lon1) -> float:
    lat0, lon0, lat1, lon1 = map(math.radians, (lat0, lon0, lat1, lon1))
    y = math.sin(lon1 - lon0) * math.cos(lat1)
    x = math.cos(lat0) * math.sin(lat1) - math.sin(lat0) * math.cos(lat1) * math.cos(lon1 - lon0)
    return (math.degrees(math.atan2(y, x)) + 360.0) % 360.0


@dataclasses.dataclass
class Validity:
    """Per-field update clock (track.h data_validity)."""

    updated: int = -(1 << 60)
    source: Source = Source.INVALID
    last_source: Source = Source.INVALID

    def age(self, now: int) -> int:
        return max(0, now - self.updated)

    def valid(self, now: int, expire: int = TRACK_EXPIRE) -> bool:
        return self.source != Source.INVALID and now < self.updated + expire

    def expire(self, now: int, expire: int = TRACK_EXPIRE) -> None:
        if self.source != Source.INVALID and now >= self.updated + expire:
            self.source = Source.INVALID


@dataclasses.dataclass
class CprPair:
    lat: int = 0
    lon: int = 0
    nuc: int = 0
    nic: int = 0  # integrity category at pair accept (track.c:1833,1844)
    rc: float = 0.0  # containment radius, meters; 0 = RC_UNKNOWN (track.h:63)
    type: CprType = CprType.NONE
    valid: Validity = dataclasses.field(default_factory=Validity)


def compute_nic(metype: int, version: int, nic_a: int, nic_b: int, nic_c: int) -> int:
    """NIC from position metype + version + NIC supplements (track.c:1387-1472)."""
    if metype in (5, 9, 20):
        return 11
    if metype in (6, 10, 21):
        return 10
    if metype == 7:
        if version == 2:
            return 9 if (nic_a and not nic_c) else 8
        if version == 1:
            return 9 if nic_a else 8
        return 8
    if metype == 8:
        if version == 2:
            if nic_a and nic_c:
                return 7
            if nic_a != nic_c:
                return 6
        return 0
    if metype == 11:
        if version == 2:
            return 9 if (nic_a and nic_b) else 8
        if version == 1:
            return 9 if nic_a else 8
        return 8
    if 12 <= metype <= 15:
        return {12: 7, 13: 6, 14: 5, 15: 4}[metype]
    if metype == 16:
        return 3 if (nic_a and nic_b) else 2
    if metype == 17:
        return 1
    return 0


def compute_rc(metype: int, version: int, nic_a: int, nic_b: int, nic_c: int) -> float:
    """Containment radius in meters from the same inputs (track.c:1475-1588)."""
    if metype in (5, 9, 20):
        return 8  # 7.5 m
    if metype in (6, 10, 21):
        return 25
    if metype == 7:
        ok = (nic_a and not nic_c) if version == 2 else (nic_a if version == 1 else 0)
        return 75 if ok else 186
    if metype == 8:
        if version == 2:
            if nic_a and nic_c:
                return 371
            if nic_a and not nic_c:
                return 556
            if nic_c:
                return 926
        return 0  # RC_UNKNOWN
    if metype == 11:
        ok = (nic_a and nic_b) if version == 2 else (nic_a if version == 1 else 0)
        return 75 if ok else 186
    if metype == 12:
        return 371
    if metype == 13:
        if version == 2:
            if not nic_a and nic_b:
                return 556
            if not nic_a and not nic_b:
                return 926
            if nic_a and nic_b:
                return 1112
            return 0
        if version == 1:
            return 1112 if nic_a else 926
        return 926
    if metype == 14:
        return 1852
    if metype == 15:
        return 3704
    if metype == 16:
        if version == 2:
            return 7408 if (nic_a and nic_b) else 14816
        if version == 1:
            return 7408 if nic_a else 14816
        return 18520
    if metype == 17:
        return 37040
    return 0


# ADS-B v0: NACp / SIL inferred from the position metype
# (ED-102A tables N-7/N-8; track.c:1593-1663)
_V0_NACP = {0: 0, 5: 11, 6: 10, 7: 8, 8: 0, 9: 11, 10: 10, 11: 8, 12: 7,
            13: 6, 14: 5, 15: 4, 16: 1, 17: 1, 18: 0, 20: 11, 21: 10, 22: 0}
_V0_SIL = {0: 0, 18: 0, 22: 0,
           **{m: 2 for m in (5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 20, 21)}}


@dataclasses.dataclass
class Aircraft:
    addr: int
    seen: int = 0  # ms of last message
    seen_pos: int = 0
    messages: int = 0
    registration: str = ""
    type_code: str = ""
    db_flags: int = 0
    type_long: str = ""
    own_op: str = ""
    year: str = ""

    # position state
    lat: float = 0.0
    lon: float = 0.0
    pos_nic: int = 0
    pos_rc: float = 0.0
    # global-fix bookkeeping for local-CPR gating (track.h:464,515)
    seen_pos_global: int = 0
    local_cpr_allow_ac_rel: bool = False
    surface_cpr_allow_ac_rel: bool = False
    lat_reliable: float = 0.0
    lon_reliable: float = 0.0
    pos_surface: bool = False
    position_valid: Validity = dataclasses.field(default_factory=Validity)
    pos_reliable_odd: float = 0.0
    pos_reliable_even: float = 0.0
    cpr_odd: CprPair = dataclasses.field(default_factory=CprPair)
    cpr_even: CprPair = dataclasses.field(default_factory=CprPair)
    gs_last_pos: float = 0.0
    # duplicate / discard caches + unreliability counters (track.h:96-97,580-581)
    prev_lat: float = 0.0
    prev_lon: float = 0.0
    prev_pos_time: int = 0
    cpr_cache: list = dataclasses.field(default_factory=list)  # [ts, clat, clon, rid] x4
    cpr_cache_index: int = 0
    disc_cache: list = dataclasses.field(default_factory=list)
    disc_cache_index: int = 0
    speed_unreliable: int = 0
    track_unreliable: int = 0
    last_override_ts: int = 0

    # core kinematics
    baro_alt: Optional[int] = None
    alt_reliable: int = 0  # altitude plausibility score (track.c:1709-1813)
    baro_alt_valid: Validity = dataclasses.field(default_factory=Validity)
    geom_alt: Optional[int] = None
    geom_alt_valid: Validity = dataclasses.field(default_factory=Validity)
    geom_delta: Optional[int] = None
    geom_delta_valid: Validity = dataclasses.field(default_factory=Validity)
    baro_rate: Optional[int] = None
    baro_rate_valid: Validity = dataclasses.field(default_factory=Validity)
    geom_rate: Optional[int] = None
    geom_rate_valid: Validity = dataclasses.field(default_factory=Validity)
    gs: Optional[float] = None
    gs_valid: Validity = dataclasses.field(default_factory=Validity)
    ias: Optional[int] = None
    ias_valid: Validity = dataclasses.field(default_factory=Validity)
    tas: Optional[int] = None
    tas_valid: Validity = dataclasses.field(default_factory=Validity)
    mach: Optional[float] = None
    mach_valid: Validity = dataclasses.field(default_factory=Validity)
    track: Optional[float] = None
    track_valid: Validity = dataclasses.field(default_factory=Validity)
    track_rate: Optional[float] = None
    track_rate_valid: Validity = dataclasses.field(default_factory=Validity)
    roll: Optional[float] = None
    roll_valid: Validity = dataclasses.field(default_factory=Validity)
    mag_heading: Optional[float] = None
    mag_heading_valid: Validity = dataclasses.field(default_factory=Validity)
    true_heading: Optional[float] = None
    true_heading_valid: Validity = dataclasses.field(default_factory=Validity)
    airground: AirGround = AirGround.UNCERTAIN
    airground_valid: Validity = dataclasses.field(default_factory=Validity)

    # identity
    callsign: str = ""
    callsign_valid: Validity = dataclasses.field(default_factory=Validity)
    next_reduce_forward_pos: int = 0  # beast_reduce rate limiter (track.h)
    squawk: Optional[int] = None  # hex-coded octal
    squawk_valid: Validity = dataclasses.field(default_factory=Validity)
    squawk_tentative: Optional[int] = None
    squawk_tentative_changed: int = -(1 << 60)  # ms ts of last tentative change
    emergency: Optional[int] = None
    emergency_valid: Validity = dataclasses.field(default_factory=Validity)
    category: Optional[int] = None
    category_valid: Validity = dataclasses.field(default_factory=Validity)
    alert: bool = False
    alert_valid: Validity = dataclasses.field(default_factory=Validity)
    spi: bool = False
    spi_valid: Validity = dataclasses.field(default_factory=Validity)

    # nav / intent
    nav_qnh: Optional[float] = None
    nav_qnh_valid: Validity = dataclasses.field(default_factory=Validity)
    nav_altitude_mcp: Optional[int] = None
    nav_altitude_mcp_valid: Validity = dataclasses.field(default_factory=Validity)
    nav_altitude_fms: Optional[int] = None
    nav_altitude_fms_valid: Validity = dataclasses.field(default_factory=Validity)
    nav_heading: Optional[float] = None
    nav_heading_valid: Validity = dataclasses.field(default_factory=Validity)
    nav_modes: Optional[int] = None
    nav_modes_valid: Validity = dataclasses.field(default_factory=Validity)
    nav_altitude_src: int = 0

    # accuracy / version (per-source version slots, track.c:2004-2017)
    adsb_version: int = -1
    tisb_version: int = -1
    adsr_version: int = -1
    adsb_hrd: HeadingType = HeadingType.MAGNETIC
    adsb_tah: HeadingType = HeadingType.GROUND_TRACK
    nic_a: int = 0
    nic_a_valid: Validity = dataclasses.field(default_factory=Validity)
    nic_b: int = 0
    nic_c: int = 0
    nic_c_valid: Validity = dataclasses.field(default_factory=Validity)
    nic_baro: int = 0
    nic_baro_valid: Validity = dataclasses.field(default_factory=Validity)
    nac_p: int = 0
    nac_p_valid: Validity = dataclasses.field(default_factory=Validity)
    nac_v: int = 0
    nac_v_valid: Validity = dataclasses.field(default_factory=Validity)
    sil: int = 0
    sil_type: int = 0
    sil_valid: Validity = dataclasses.field(default_factory=Validity)
    gva: int = 0
    gva_valid: Validity = dataclasses.field(default_factory=Validity)
    acas_ra: bytes = b""
    acas_ra_valid: Validity = dataclasses.field(default_factory=Validity)
    sda: int = 0
    sda_valid: Validity = dataclasses.field(default_factory=Validity)

    # meteo
    wind_speed: Optional[float] = None
    wind_dir: Optional[float] = None
    wind_valid: Validity = dataclasses.field(default_factory=Validity)
    wind_alt: Optional[int] = None
    oat: Optional[float] = None
    oat_valid: Validity = dataclasses.field(default_factory=Validity)

    # signal bookkeeping
    signal_ring: list = dataclasses.field(default_factory=list)  # last 8 power values
    addrtype: AddrType = AddrType.UNKNOWN
    last_message_crc_addr_ok: bool = True

    # Mode A/C correlation flags (track.c:2754,2766)
    modea_hit: bool = False
    modec_hit: bool = False

    # history
    trace: Optional[object] = None  # history trace (ROADMAP item 8c)
    receiver_id: int = 0  # feeder of the last accepted position (lastPosReceiverId)
    globe_index: int = -1  # current 3-degree globe tile

    def rssi(self) -> float:
        """Mean of last-8 signal powers in dBFS (json_out convention)."""
        ring = [s for s in self.signal_ring[-8:] if s > 0]
        if not ring:
            return -49.5
        avg = sum(ring) / len(ring)
        return 10 * math.log10(avg) if avg > 0 else -49.5

    # Lazy default materialization: checkpoint load (io/state.py) rebuilds
    # instances via __new__ with ONLY the explicitly-set fields in __dict__;
    # the ~45 untouched Validity/CprPair/list defaults per aircraft are
    # created here on first access instead of up front (the reference's
    # load_blob memcpys flat structs, globe_index.c:2939-3081 — this is the
    # sparse-object analog of that cost profile).
    _lazy_factory: typing.ClassVar[dict] = {}

    def __getattr__(self, name: str):
        fact = Aircraft._lazy_factory
        if not fact:
            for f in dataclasses.fields(Aircraft):
                if f.default_factory is not dataclasses.MISSING:
                    fact[f.name] = f.default_factory
        f = fact.get(name)
        if f is None:
            raise AttributeError(name)
        v = f()
        self.__dict__[name] = v
        return v


class Tracker:
    """The aircraft state store (analog of Modes.aircraft + track.c)."""

    def __init__(
        self,
        json_reliable: int = 1,
        receiver_lat: Optional[float] = None,
        receiver_lon: Optional[float] = None,
        max_range_km: float = 450 * 1.852,  # 450 nmi (readsb.c:149)
    ):
        self.reduce_interval_ms = 125  # --net-beast-reduce-interval
        # beast_reduce output shaping knobs (readsb.c:137-138,1741-1751)
        self.reduce_filter_dist_m = -1.0  # --net-beast-reduce-filter-dist
        self.reduce_filter_alt_ft = -1.0  # --net-beast-reduce-filter-alt
        self.reduce_optimize_mlat = False  # --net-beast-reduce-optimize-for-mlat
        # reliability counter cap (Modes.position_persistence, track.c:3713)
        self.position_persistence = 4.0
        # JAERO aircraft stay on the map longer (track.c:2857-2870)
        self.track_expire_jaero_ms = 33 * 60_000
        from .receiver import ReceiverStore

        self.aircraft: dict[int, Aircraft] = {}
        self.receivers = ReceiverStore()
        self.db = None  # optional acdb.AircraftDb, joined at create/reload
        self.json_reliable = json_reliable
        self.receiver_lat = receiver_lat
        self.receiver_lon = receiver_lon
        self.max_range_m = max_range_km * 1000
        # stats counters (mirrors the cpr_* stats block, stats.h)
        self.cpr_global_ok = 0
        self.cpr_global_bad = 0
        self.cpr_global_skipped = 0
        self.cpr_local_ok = 0
        self.cpr_local_skipped = 0
        self.cpr_surface = 0
        self.cpr_airborne = 0
        # fine-grained CPR accounting (stats.h cpr_* block)
        self.cpr_global_speed_checks = 0
        self.cpr_local_speed_checks = 0
        self.cpr_local_range_checks = 0
        self.cpr_global_range_checks = 0
        self.cpr_local_aircraft_relative = 0
        self.cpr_local_receiver_relative = 0
        self.cpr_filtered = 0
        self.tracks_all = 0
        self.tracks_single_message = 0
        self.messages_total = 0
        # position counters (stats.h pos_all/pos_duplicate/pos_by_type)
        self.pos_all = 0
        self.pos_duplicate = 0
        self.pos_garbage = 0
        self.pos_by_type: dict = {}
        # Mode A/C squawk-indexed count/match tables (track.c:56-59)
        import numpy as _np

        from .outline import RangeOutline

        self.outline = RangeOutline()
        self.distance_max = 0.0  # stats distance_max/min (track.c:298-300)
        self.distance_min = float("inf")
        self.modeac_count = _np.zeros(4096, dtype=_np.uint32)
        self.modeac_lastcount = _np.zeros(4096, dtype=_np.uint32)
        self.modeac_match = _np.zeros(4096, dtype=_np.uint32)
        self.modeac_age = _np.zeros(4096, dtype=_np.uint32)

    # ------------------------------------------------------------------

    def get_or_create(self, addr: int, now: int) -> Aircraft:
        a = self.aircraft.get(addr)
        if a is None:
            a = Aircraft(addr=addr)
            self.tracks_all += 1
            if self.db is not None:
                self.db.apply(a)
            self.aircraft[addr] = a
        return a

    def db_reload(self) -> bool:
        """Re-check --db-file and re-join all aircraft on change
        (dbUpdate/dbFinishUpdate, aircraft.c:465-700)."""
        if self.db is None or not self.db.maybe_reload():
            return False
        for a in self.aircraft.values():
            self.db.apply(a)
        return True

    def _accept(self, a: Aircraft, v: Validity, source: Source, now: int) -> bool:
        """accept_data: source-priority + freshness gate (track.c:128-221)."""
        if source == Source.INVALID:
            return False
        if now < v.updated:
            return False
        if source < v.source and now < v.updated + TRACK_STALE:
            return False
        v.source = Source.ADSB if source == Source.PRIO else source
        v.last_source = v.source
        v.updated = now
        return True

    def _will_accept(
        self, a: Aircraft, v: Validity, source: Source, now: int
    ) -> bool:
        """will_accept_data: the same gate without mutating (track.c:121-126)."""
        if source == Source.INVALID:
            return False
        if now < v.updated:
            return False
        if source < v.source and now < v.updated + TRACK_STALE:
            return False
        return True

    def _update_altitude(self, a: Aircraft, mm: ModesMessage, src: Source, now: int) -> None:
        """Baro-altitude outlier rejection (updateAltitude, track.c:1709-1813).

        A per-aircraft reliability score (0..20) gates large altitude jumps
        against an implied-fpm window derived from the known vertical rate;
        implausible jumps decay the score instead of updating the field.
        (The reference's netReceiverId and mlat-server score tweaks at
        track.c:1777-1787 depend on aggregator receiver counts and are not
        reproduced.)
        """
        RELIABLE_MAX = 20  # ALTITUDE_BARO_RELIABLE_MAX, track.h:65
        alt = mm.baro_alt
        old = a.baro_alt if a.baro_alt is not None else 0
        if a.modec_hit:
            # C trunc-toward-zero division (track.c:1712-1717)
            if int((old + 49) / 100) != int((alt + 49) / 100):
                a.modec_hit = False

        delta = alt - old
        fpm = 0
        max_fpm, min_fpm = 12500, -12500
        if abs(delta) >= 300:
            age_alt = a.baro_alt_valid.age(now)
            fpm = int(delta * 600 / (abs(int(age_alt / 100)) + 10))
            gr_ok = a.geom_rate_valid.valid(now)
            if gr_ok and a.geom_rate_valid.age(now) < a.baro_rate_valid.age(now):
                slack = 1500 + min(11000, int(a.geom_rate_valid.age(now) / 2))
                min_fpm = a.geom_rate - slack
                max_fpm = a.geom_rate + slack
            elif a.baro_rate_valid.valid(now):
                slack = 1500 + min(11000, int(a.baro_rate_valid.age(now) / 2))
                min_fpm = a.baro_rate - slack
                max_fpm = a.baro_rate + slack
            if a.baro_alt_valid.valid(now) and a.baro_alt_valid.age(now) < 30 * SECONDS:
                a.alt_reliable = min(
                    RELIABLE_MAX
                    - RELIABLE_MAX * a.baro_alt_valid.age(now) // (30 * SECONDS),
                    a.alt_reliable,
                )
            else:
                a.alt_reliable = 0

        good_crc = 0
        if mm.crc == 0 and (src >= Source.JAERO or src == Source.SBS):
            good_crc = RELIABLE_MAX
        if src == Source.MLAT:
            good_crc = RELIABLE_MAX // 2 - 1
        if old > 50175 and mm.alt_q_bit and a.alt_reliable > RELIABLE_MAX // 4:
            # q-bit encoding tops out: high-altitude q=1 reads are bogus;
            # reference zeroes good_crc and takes the discard path
            # (track.c:1756-1760)
            good_crc = 0
            accept = False
        else:
            accept = (
                good_crc >= a.alt_reliable
                or src > a.baro_alt_valid.source
                or a.alt_reliable <= 0
                or abs(delta) < 300
                or (min_fpm < fpm < max_fpm)
            )
        if not accept:
            # discard epilogue (track.c:1793-1800): clamp the score at 0 and
            # invalidate the stale altitude once the score exhausts
            a.alt_reliable -= good_crc + 1
            if a.alt_reliable <= 0:
                a.alt_reliable = 0
                if a.position_valid.source != Source.JAERO:
                    a.baro_alt_valid.source = Source.INVALID
            return
        if self._accept(a, a.baro_alt_valid, src, now):
            a.alt_reliable = min(RELIABLE_MAX, a.alt_reliable + good_crc + 1)
            if a.alt_reliable < 0:
                a.alt_reliable = 0
            a.baro_alt = alt

    # ------------------------------------------------------------------

    def update(self, mm: ModesMessage) -> Optional[Aircraft]:
        """trackUpdateFromMessage (track.c:1858-2730), core field flow."""
        now = mm.sys_timestamp_ms
        if mm.msgtype == 77:  # DFTYPE_MODEAC: just count it (track.c:1869-1874)
            from ..decode.mode_ac import modea_to_index

            self.messages_total += 1
            if mm.squawk_hex is not None:
                self.modeac_count[modea_to_index(mm.squawk_hex)] += 1
            return None
        addr = mm.addr & 0xFFFFFF
        a = self.get_or_create(addr, now)
        a.seen = now
        a.messages += 1
        self.messages_total += 1
        if mm.signal_level > 0:
            a.signal_ring.append(mm.signal_level)
            if len(a.signal_ring) > 8:
                a.signal_ring = a.signal_ring[-8:]
        if mm.addrtype < a.addrtype or not a.messages:
            a.addrtype = mm.addrtype
        if a.addrtype > AddrType.ADSB_ICAO_NT:
            # non-ADS-B address type resets the ADS-B version (track.c:1996)
            a.adsb_version = -1
        src = mm.source

        # --- ADS-B version bookkeeping (track.c:2001-2056) ----------------
        # per-source version slot; assume v0 once any message arrives, let
        # opstatus set the real version, then backfill v0 NACp/SIL from the
        # position metype (ED-102A tables N-7/N-8)
        _vslot = {
            Source.ADSB: "adsb_version",
            Source.TISB: "tisb_version",
            Source.ADSR: "adsr_version",
        }.get(src)
        mv = getattr(a, _vslot) if _vslot else -1
        if mv < 0:
            mv = 0
        if mm.opstatus_valid and mm.adsb_version is not None:
            mv = mm.adsb_version
        if _vslot:
            setattr(a, _vslot, mv)
        if mv == 0 and mm.msgtype in (17, 18) and mm.metype in _V0_NACP:
            if mm.nac_p is None:
                mm.nac_p = _V0_NACP[mm.metype]
            if mm.sil_type == SilType.INVALID and mm.metype in _V0_SIL:
                mm.sil = _V0_SIL[mm.metype]
                mm.sil_type = SilType.UNKNOWN

        # --- altitude ----------------------------------------------------
        if mm.baro_alt is not None:
            # pre-gate (track.c:2059-2068): lower-priority sources only get
            # to run the outlier logic once the held altitude goes stale
            av = a.baro_alt_valid
            age = av.age(now)
            if (
                src >= av.source
                or (
                    age > 10 * SECONDS
                    and av.source not in (Source.JAERO, Source.SBS)
                )
                or age > 30 * SECONDS
            ):
                self._update_altitude(a, mm, src, now)
        if mm.geom_alt is not None and self._accept(a, a.geom_alt_valid, src, now):
            a.geom_alt = mm.geom_alt
        if mm.geom_delta is not None and self._accept(a, a.geom_delta_valid, src, now):
            a.geom_delta = mm.geom_delta
        if mm.baro_rate is not None and self._accept(a, a.baro_rate_valid, src, now):
            a.baro_rate = mm.baro_rate
        if mm.geom_rate is not None and self._accept(a, a.geom_rate_valid, src, now):
            a.geom_rate = mm.geom_rate

        # --- squawk double-confirmation (track.c:2071-2092) ---------------
        if mm.squawk_hex is not None:
            sq = mm.squawk_hex
            change_tentative = False
            if (
                a.squawk_tentative != sq
                and now - a.seen < 15 * SECONDS
                and self._will_accept(a, a.squawk_valid, src, now)
            ):
                # a tentative change always forwards (track.c:2074-2079)
                a.next_reduce_forward_pos = now + self.reduce_interval_ms
                mm.reduce_forward = True
                change_tentative = True
            # confirmation: JAERO immediately, else the tentative value must
            # have held for >750 ms (track.c:2081-2087); the tentative is NOT
            # cleared on confirm
            if (
                src == Source.JAERO
                or (
                    a.squawk_tentative == sq
                    and now - a.squawk_tentative_changed > 750
                )
            ) and self._accept(a, a.squawk_valid, src, now):
                if sq != a.squawk:
                    a.modea_hit = False
                a.squawk = sq
            if change_tentative:
                a.squawk_tentative = sq
                a.squawk_tentative_changed = now

        # --- speeds / headings -------------------------------------------
        if mm.gs_selected is not None and self._accept(a, a.gs_valid, src, now):
            a.gs = mm.gs_selected
        if mm.ias is not None and self._accept(a, a.ias_valid, src, now):
            a.ias = mm.ias
        if mm.tas is not None and self._accept(a, a.tas_valid, src, now):
            a.tas = mm.tas
        if mm.mach is not None and self._accept(a, a.mach_valid, src, now):
            a.mach = mm.mach
            self._calc_temp(a, now)
        if mm.roll is not None and self._accept(a, a.roll_valid, src, now):
            a.roll = mm.roll
        if mm.track_rate is not None and self._accept(a, a.track_rate_valid, src, now):
            a.track_rate = mm.track_rate
        if mm.heading is not None:
            ht = mm.heading_type
            # resolve MAGNETIC_OR_TRUE / TRACK_OR_HEADING via opstatus HRD/TAH
            # (track.c:2140-2168)
            if ht == HeadingType.MAGNETIC_OR_TRUE:
                ht = self._hrd(a)
            elif ht == HeadingType.TRACK_OR_HEADING:
                ht = HeadingType.GROUND_TRACK if a.adsb_tah == HeadingType.GROUND_TRACK else self._hrd(a)
            if ht == HeadingType.GROUND_TRACK:
                if self._accept(a, a.track_valid, src, now):
                    a.track = mm.heading
            elif ht == HeadingType.MAGNETIC:
                dec = self._declination(a, now)
                if self._accept(a, a.mag_heading_valid, src, now):
                    a.mag_heading = mm.heading
                    true_h = (mm.heading + (dec or 0.0)) % 360.0
                    crab_ok = (
                        not a.track_valid.valid(now)
                        or abs((true_h - (a.track or 0) + 180) % 360 - 180) < 45
                    )
                    if dec is not None and crab_ok and self._accept(
                        a, a.true_heading_valid, Source.INDIRECT, now
                    ):
                        a.true_heading = true_h
                        self._calc_wind(a, now)
            elif ht == HeadingType.TRUE:
                if self._accept(a, a.true_heading_valid, src, now):
                    a.true_heading = mm.heading

        # --- identity -----------------------------------------------------
        if mm.callsign is not None and mm.callsign_valid and self._accept(a, a.callsign_valid, src, now):
            a.callsign = mm.callsign
        if mm.category is not None and self._accept(a, a.category_valid, src, now):
            a.category = mm.category
        if mm.emergency is not None and self._accept(a, a.emergency_valid, src, now):
            a.emergency = mm.emergency
        if mm.alert is not None and mm.alert_valid and self._accept(a, a.alert_valid, src, now):
            a.alert = bool(mm.alert)
        if mm.spi is not None and mm.spi_valid and self._accept(a, a.spi_valid, src, now):
            a.spi = bool(mm.spi)
        if mm.airground != AirGround.INVALID and mm.airground != AirGround.UNCERTAIN:
            if self._accept(a, a.airground_valid, src, now):
                a.airground = mm.airground
        elif mm.airground == AirGround.UNCERTAIN and a.airground_valid.source == Source.INVALID:
            a.airground = AirGround.UNCERTAIN

        # --- nav / intent -------------------------------------------------
        if mm.nav_qnh is not None and self._accept(a, a.nav_qnh_valid, src, now):
            a.nav_qnh = mm.nav_qnh
        if mm.nav_mcp_altitude is not None and self._accept(a, a.nav_altitude_mcp_valid, src, now):
            a.nav_altitude_mcp = mm.nav_mcp_altitude
        if mm.nav_fms_altitude is not None and self._accept(a, a.nav_altitude_fms_valid, src, now):
            a.nav_altitude_fms = mm.nav_fms_altitude
        if mm.nav_heading is not None and self._accept(a, a.nav_heading_valid, src, now):
            a.nav_heading = mm.nav_heading
        if mm.nav_modes is not None and self._accept(a, a.nav_modes_valid, src, now):
            a.nav_modes = mm.nav_modes
        if mm.nav_altitude_source:
            a.nav_altitude_src = mm.nav_altitude_source

        # --- accuracy / opstatus -----------------------------------------
        # (version itself is handled in the bookkeeping block above)
        if mm.opstatus_valid:
            a.adsb_hrd = mm.opstatus_hrd
            a.adsb_tah = mm.opstatus_tah
        if mm.nic_a is not None and self._accept(a, a.nic_a_valid, src, now):
            a.nic_a = mm.nic_a
        if mm.nic_b is not None:
            a.nic_b = mm.nic_b
        if mm.nic_c is not None and self._accept(a, a.nic_c_valid, src, now):
            a.nic_c = mm.nic_c
        if mm.nic_baro is not None and self._accept(a, a.nic_baro_valid, src, now):
            a.nic_baro = mm.nic_baro
        if mm.nac_p is not None and self._accept(a, a.nac_p_valid, src, now):
            a.nac_p = mm.nac_p
        if mm.nac_v is not None and self._accept(a, a.nac_v_valid, src, now):
            a.nac_v = mm.nac_v
        if mm.sil is not None and self._accept(a, a.sil_valid, src, now):
            a.sil = mm.sil
            a.sil_type = int(mm.sil_type)
        if mm.gva is not None and self._accept(a, a.gva_valid, src, now):
            a.gva = mm.gva
        if mm.acas_ra_valid:
            ra = (mm.MV if mm.msgtype == 16 else
                  mm.MB if mm.msgtype in (20, 21) else mm.ME)
            if ra:
                from ..io.acas import ra_valid as _ra_valid

                if _ra_valid(bytes(ra), mm.msgtype) and self._accept(
                    a, a.acas_ra_valid, src, now
                ):
                    a.acas_ra = bytes(ra)
        if mm.sda is not None and self._accept(a, a.sda_valid, src, now):
            a.sda = mm.sda

        # --- meteo --------------------------------------------------------
        if mm.wind_speed is not None and self._accept(a, a.wind_valid, src, now):
            a.wind_speed = mm.wind_speed
            a.wind_dir = mm.wind_dir
            a.wind_alt = a.baro_alt if a.baro_alt_valid.valid(now) else None
        if mm.oat is not None and self._accept(a, a.oat_valid, src, now):
            a.oat = mm.oat

        # --- position -----------------------------------------------------
        if mm.cpr_valid:
            self._update_position(a, mm, now)
        elif mm.sbs_pos_valid:
            # pre-decoded position (SBS/ASTERIX/MLAT inputs)
            if self._speed_check(a, mm, mm.decoded_lat, mm.decoded_lon, now):
                self._set_position(a, mm, mm.decoded_lat, mm.decoded_lon, now, False)

        # --- beast_reduce output shaping (track.c:2335-2339,2647-2666) ----
        if self.reduce_optimize_mlat and (
            mm.cpr_valid or a.position_valid.source < Source.ADSR
        ):
            mm.reduce_forward = True  # keep everything an mlat-client needs
        if mm.reduce_forward:
            if (
                self.reduce_filter_dist_m > 0
                and self.receiver_lat is not None
                and a.lat is not None
                and now < a.seen_pos + 60_000
                and greatcircle(self.receiver_lat, self.receiver_lon, a.lat, a.lon)
                > self.reduce_filter_dist_m
            ):
                mm.reduce_forward = False
            if (
                self.reduce_filter_alt_ft > 0
                and a.baro_alt is not None
                and a.baro_alt_valid.valid(now)
                and a.airground != AirGround.GROUND
                and a.baro_alt > self.reduce_filter_alt_ft
            ):
                mm.reduce_forward = False

        return a

    def _hrd(self, a: Aircraft) -> HeadingType:
        return a.adsb_hrd if a.adsb_hrd in (HeadingType.MAGNETIC, HeadingType.TRUE) else HeadingType.MAGNETIC

    # -- wind / temperature derivation (track.c:3086-3164) -----------------

    def _declination(self, a: Aircraft, now: int):
        """Cached per-aircraft magnetic declination (track.c:3166-3217)."""
        if not a.seen_pos or not a.position_valid.valid(now, POS_RELIABLE_TIMEOUT):
            return None
        cache = getattr(a, "_dec_cache", None)
        if cache is not None and now < cache[0] + 5 * SECONDS:
            return cache[1]
        from . import geomag

        year = 1970.0 + now / 1000.0 / (365.25 * 86400)
        alt_km = (a.baro_alt or 0) * 0.0003048
        try:
            dec = geomag.declination(a.lat, a.lon, alt_km, year)
        except (ValueError, ZeroDivisionError):
            return None
        a._dec_cache = (now, dec)
        return dec

    def _calc_wind(self, a: Aircraft, now: int) -> None:
        """Wind vector from TAS/GS/heading triangle (track.c:3086-3146)."""
        TRACK_WT_TIMEOUT = 2500
        if not a.position_valid.valid(now, POS_RELIABLE_TIMEOUT) or a.airground == AirGround.GROUND:
            return
        if (
            a.tas_valid.age(now) > TRACK_WT_TIMEOUT
            or a.gs_valid.age(now) > TRACK_WT_TIMEOUT
            or a.track_valid.age(now) > TRACK_WT_TIMEOUT // 2
            or a.true_heading_valid.age(now) > TRACK_WT_TIMEOUT // 2
            or not all(
                v.source != Source.INVALID
                for v in (a.tas_valid, a.gs_valid, a.track_valid, a.true_heading_valid)
            )
        ):
            return
        trk = math.radians(a.track)
        hdg = math.radians(a.true_heading)
        tas = float(a.tas)
        gs = float(a.gs)
        crab = (hdg - trk + math.pi) % (2 * math.pi) - math.pi
        hw = tas - math.cos(crab) * gs
        cw = math.sin(crab) * gs
        ws = math.sqrt(hw * hw + cw * cw)
        wd = math.degrees((hdg + math.atan2(cw, hw)) % (2 * math.pi))
        if ws > 250:
            return
        a.wind_speed = ws
        a.wind_dir = wd
        a.wind_alt = a.baro_alt
        a.wind_valid.updated = now
        a.wind_valid.source = Source.INDIRECT
        a.wind_valid.last_source = Source.INDIRECT

    def _calc_temp(self, a: Aircraft, now: int) -> None:
        """OAT from TAS/Mach (track.c:3148-3164)."""
        TRACK_WT_TIMEOUT = 2500
        if a.airground == AirGround.GROUND:
            return
        if a.tas_valid.age(now) > TRACK_WT_TIMEOUT or a.mach_valid.age(now) > TRACK_WT_TIMEOUT:
            return
        if a.mach is None or a.tas is None or a.mach < 0.395:
            return
        fraction = a.tas / 661.47 / a.mach
        oat = (fraction * fraction * 288.15) - 273.15
        a.oat = oat
        a.oat_valid.updated = now
        a.oat_valid.source = Source.INDIRECT
        a.oat_valid.last_source = Source.INDIRECT

    # -- CPR position pipeline (track.c:1249-1385, 746-967) ---------------

    def _update_position(self, a: Aircraft, mm: ModesMessage, now: int) -> None:
        # network duplicate: same raw CPR from another feeder (track.c:2305)
        if mm.cpr_valid and mm.remote:
            self._cpr_duplicate_check(a, mm, now)
        pair = a.cpr_odd if mm.cpr_odd else a.cpr_even
        pair.lat = mm.cpr_lat
        pair.lon = mm.cpr_lon
        pair.type = mm.cpr_type
        # NIC/Rc at pair accept (compute_nic_rc_from_message, track.c:1666)
        nic_a = 1 if (a.nic_a_valid.valid(now) and a.nic_a) else 0
        nic_b = 1 if mm.nic_b else 0
        nic_c = 1 if (a.nic_c_valid.valid(now) and a.nic_c) else 0
        pair.nic = compute_nic(mm.metype, a.adsb_version, nic_a, nic_b, nic_c)
        pair.rc = compute_rc(mm.metype, a.adsb_version, nic_a, nic_b, nic_c)
        self._accept(a, pair.valid, mm.source, now)

        if mm.cpr_type == CprType.SURFACE:
            self.cpr_surface += 1
        else:
            self.cpr_airborne += 1

        if getattr(self, "cpr_focus", None) == a.addr:
            import sys as _sys

            print(
                f"cpr_focus {a.addr:06x}: {'odd' if mm.cpr_odd else 'even'} "
                f"({mm.cpr_lat}) ({mm.cpr_lon}) type={mm.cpr_type.name} "
                f"rel_o={a.pos_reliable_odd:.1f} rel_e={a.pos_reliable_even:.1f}",
                file=_sys.stderr,
            )
        other = a.cpr_even if mm.cpr_odd else a.cpr_odd
        result = None
        used_global = False
        max_elapsed = CPR_MAX_INTERVAL
        if (
            other.valid.valid(now)
            and abs(pair.valid.updated - other.valid.updated) <= max_elapsed
            and other.type == mm.cpr_type
        ):
            result = self._do_global_cpr(a, mm)
            used_global = result is not None
            if result is None:
                self.cpr_global_bad += 1
        else:
            self.cpr_global_skipped += 1

        if result is None:
            self._last_local_rel = 0
            result = self._do_local_cpr(a, mm, now)
            if result is not None:
                self.cpr_local_ok += 1
                if self._last_local_rel == 1:
                    self.cpr_local_aircraft_relative += 1
                elif self._last_local_rel == 2:
                    self.cpr_local_receiver_relative += 1
            else:
                self.cpr_local_skipped += 1
        elif used_global:
            self.cpr_global_ok += 1

        if result is None:
            return
        if used_global:
            # worse of the two pair halves: smaller NIC, larger Rc
            # (doGlobalCPR, track.c:753-756)
            mm.decoded_nic = min(a.cpr_even.nic, a.cpr_odd.nic)
            mm.decoded_rc = max(a.cpr_even.rc, a.cpr_odd.rc)
        # (the local path sets decoded_nic/rc inside _do_local_cpr)
        lat, lon = result

        if not self._speed_check(a, mm, lat, lon, now):
            if used_global:
                self.cpr_global_speed_checks += 1
            else:
                self.cpr_local_speed_checks += 1
            # implausible: decrement reliability unless rate-limited or
            # ignorable (track.c:2631-2639 gating around position_bad)
            if not (
                mm.source < a.position_valid.source
                or mm.in_disc_cache
                or mm.garbage
                or mm.pos_ignore
            ):
                self._position_bad(a, mm, now)
            return
        if mm.pos_ignore or mm.duplicate:
            return  # counted, but the position itself is not used

        self._set_position(a, mm, lat, lon, now, used_global)

    def _do_global_cpr(self, a: Aircraft, mm: ModesMessage):
        if mm.cpr_type == CprType.SURFACE:
            reflat, reflon = self._surface_reference(a, mm)
            if reflat is None:
                return None
            out = cpr_mod.decode_surface(
                reflat, reflon,
                a.cpr_even.lat, a.cpr_even.lon, a.cpr_odd.lat, a.cpr_odd.lon,
                mm.cpr_odd,
            )
            # surface decodes far from the reference are suspect
            # (track.c:784-792, 450 km gate)
            if out is not None and greatcircle(reflat, reflon, out[0], out[1]) > 450e3:
                return None
            return out
        return cpr_mod.decode_airborne(
            a.cpr_even.lat, a.cpr_even.lon, a.cpr_odd.lat, a.cpr_odd.lon, mm.cpr_odd
        )

    def _do_local_cpr(self, a: Aircraft, mm: ModesMessage, now: int):
        """Relative decode against our last position or the receiver
        location (track.c:843-967)."""
        surface = mm.cpr_type == CprType.SURFACE
        pair = a.cpr_odd if mm.cpr_odd else a.cpr_even
        mm.decoded_nic = pair.nic
        mm.decoded_rc = pair.rc
        if now < a.seen_pos_global + 10 * MINUTES and a.local_cpr_allow_ac_rel:
            # aircraft-relative: allowed for 10 min after a global fix
            # (track.c:862-881); fixed 100 NM limit — a wrong relative
            # decode one cell off would need Mach 2.3 over the ground
            range_limit = 1852 * 100
            ref = (a.lat, a.lon)
            self._last_local_rel = 1
            # inherits the previous position's integrity when worse
            # (track.c:864-869 — note the reference takes the SMALLER rc
            # here; replicated as-is)
            if a.pos_nic < mm.decoded_nic:
                mm.decoded_nic = a.pos_nic
            if a.pos_rc < mm.decoded_rc:
                mm.decoded_rc = a.pos_rc
        elif self.receiver_lat is not None and not surface:
            # receiver-relative: cell size >= 360 NM, so the usable radius
            # shrinks once max_range passes half a cell and vanishes at a
            # full cell (track.c:882-905); surface local CPR is never
            # receiver-relative in the reference
            if self.max_range_m == 0 or self.max_range_m >= 1852 * 360:
                return None
            if self.max_range_m <= 1852 * 180:
                range_limit = self.max_range_m
            else:
                range_limit = 1852 * 360 - self.max_range_m
            ref = (self.receiver_lat, self.receiver_lon)
            self._last_local_rel = 2
        else:
            return None
        out = cpr_mod.decode_relative(ref[0], ref[1], mm.cpr_lat, mm.cpr_lon, mm.cpr_odd, surface)
        if out is None:
            return None
        if greatcircle(ref[0], ref[1], out[0], out[1]) > range_limit:
            return None
        # absolute receiver max-range check (track.c:930-950)
        if self.receiver_lat is not None and self.max_range_m > 0:
            if (
                greatcircle(self.receiver_lat, self.receiver_lon, out[0], out[1])
                > self.max_range_m
            ):
                return None
        return out

    def _surface_reference(self, a: Aircraft, mm: ModesMessage):
        """Surface global CPR reference chain (track.c:759-777):
        user location, then the feeder's extent-box center, then the
        aircraft's own reliable position."""
        if self.receiver_lat is not None:
            return self.receiver_lat, self.receiver_lon
        if mm.receiver_id:
            ref = self.receivers.get_reference(mm.receiver_id)
            if ref is not None:
                return ref
        if a.seen_pos and a.surface_cpr_allow_ac_rel:
            # last reliable position (track.c:770-773)
            return a.lat_reliable, a.lon_reliable
        return None, None

    # -- duplicate / discard caches (track.c:312-421) -----------------------

    def _duplicate_check(self, a: Aircraft, mm: ModesMessage, lat: float, lon: float, now: int) -> bool:
        """duplicate_check (track.c:350-377)."""
        if getattr(mm, "duplicate_checked", False) or mm.duplicate:
            return mm.duplicate
        mm.duplicate_checked = True
        if now > a.seen_pos + 2 * SECONDS:
            return False
        if a.lat == lat and a.lon == lon:
            mm.duplicate = True
            return True
        if now > a.prev_pos_time + 2 * SECONDS:
            return False
        if a.prev_lat == lat and a.prev_lon == lon:
            mm.duplicate = True
            return True
        return False

    def _cpr_duplicate_check(self, a: Aircraft, mm: ModesMessage, now: int) -> bool:
        """cpr_duplicate_check (track.c:312-349): same raw CPR from a
        *different* receiver within 2 s is a network duplicate."""
        for ts, clat, clon, rid in a.cpr_cache:
            if (
                now - ts < 2 * SECONDS
                and clat == mm.cpr_lat
                and clon == mm.cpr_lon
                and rid != mm.receiver_id
            ):
                mm.duplicate = True
                return True
        entry = [now, mm.cpr_lat, mm.cpr_lon, mm.receiver_id]
        if len(a.cpr_cache) < 4:
            a.cpr_cache.append(entry)
        else:
            a.cpr_cache_index = (a.cpr_cache_index + 1) % 4
            a.cpr_cache[a.cpr_cache_index] = entry
        return False

    def _in_disc_cache(self, a: Aircraft, mm: ModesMessage, now: int) -> bool:
        """inDiscCache (track.c:390-421): rate-limit reliability hits."""
        for ts, clat, clon, rid in a.disc_cache:
            if (now - ts < 4 * SECONDS and clat == mm.cpr_lat and clon == mm.cpr_lon) or (
                now - ts < 300 and rid == mm.receiver_id
            ):
                return True
        return False

    def _position_bad(self, a: Aircraft, mm: ModesMessage, now: int) -> None:
        """position_bad (track.c:3726-3763)."""
        if mm.cpr_valid:
            entry = [now, mm.cpr_lat, mm.cpr_lon, mm.receiver_id]
            if len(a.disc_cache) < 4:
                a.disc_cache.append(entry)
            else:
                a.disc_cache_index = (a.disc_cache_index + 1) % 4
                a.disc_cache[a.disc_cache_index] = entry
        a.pos_reliable_odd -= 0.26
        a.pos_reliable_even -= 0.26
        if a.pos_reliable_odd < 0.1 or a.pos_reliable_even < 0.1:
            a.pos_reliable_odd = 0.0
            a.pos_reliable_even = 0.0
            # invalidate CPRs to start fresh; re-accept the one just seen
            a.cpr_even.valid.source = Source.INVALID
            a.cpr_odd.valid.source = Source.INVALID
            if mm.cpr_valid:
                pair = a.cpr_odd if mm.cpr_odd else a.cpr_even
                pair.lat = mm.cpr_lat
                pair.lon = mm.cpr_lon
                pair.type = mm.cpr_type
                self._accept(a, pair.valid, mm.source, now)

    def _speed_check(self, a: Aircraft, mm: ModesMessage, lat: float, lon: float, now: int) -> bool:
        """speed_check (track.c:423-736), faithful port minus debug output.

        Sets mm.pos_ignore / mm.duplicate side effects exactly like the
        reference; returns the in-range verdict (with overrides applied).
        """
        source = mm.source
        elapsed = a.position_valid.age(now)
        receiver_range_exceeded = False

        if self._duplicate_check(a, mm, lat, lon, now):
            # duplicates count toward receiver heuristics but nothing else
            mm.pos_ignore = True
            if self.receiver_lat is None and mm.receiver_id:
                self.receivers.position_received(a, mm, lat, lon, now)
            return True

        if mm.cpr_valid and self._in_disc_cache(a, mm, now):
            mm.in_disc_cache = True

        surface = (
            a.airground_valid.valid(now)
            and a.airground == AirGround.GROUND
            and a.pos_surface
            and (not mm.cpr_valid or mm.cpr_type == CprType.SURFACE)
        )

        override = False
        bogus = not (-90 <= lat <= 90) or not (-180 <= lon <= 180) or (
            abs(lat) < 0.01 and abs(lon) < 0.01
        )
        if self.json_reliable == -1 or source == Source.PRIO:
            override = True
        elif bogus or (mm.cpr_valid and mm.cpr_lat == 0 and mm.cpr_lon == 0) or (
            mm.cpr_valid
            and (mm.cpr_lat == 0 or mm.cpr_lon == 0)
            and (a.position_valid.source < Source.TISB or not self.pos_reliable(a))
        ):
            mm.pos_ignore = True
        elif a.pos_reliable_odd < 0.01 or a.pos_reliable_even < 0.01:
            override = True
        elif now - a.position_valid.updated > POS_RELIABLE_TIMEOUT:
            override = True
        elif (
            source > a.position_valid.source
            and source > a.position_valid.last_source
        ):
            override = True
        elif source > a.position_valid.source and a.position_valid.source == Source.INDIRECT:
            override = True
        elif source <= Source.MLAT and elapsed > 45 * SECONDS:
            override = True

        if getattr(mm, "in_disc_cache", False):
            override = False

        # speed estimate (knots)
        speed = -1.0
        if a.gs_valid.valid(now):
            speed = max(a.gs_last_pos, a.gs or 0.0)
            speed += 3 * a.gs_valid.age(now) / 1000.0 + 3 * a.position_valid.age(now) / 1000.0
        elif a.tas_valid.valid(now):
            speed = (a.tas or 0) * 4 / 3
        elif a.ias_valid.valid(now):
            speed = (a.ias or 0) * 2
        transmitted_speed = speed

        old_lat, old_lon = a.lat, a.lon
        distance = greatcircle(old_lat or 0.0, old_lon or 0.0, lat, lon)
        if not a.seen_pos:
            distance = 0.0

        track_max_age = 5 * SECONDS
        track = -1.0
        track_age = -1
        if a.track_valid.age(now) < track_max_age and a.track is not None:
            track = a.track
            track_age = a.track_valid.age(now)
        elif a.true_heading_valid.age(now) < track_max_age and a.true_heading is not None:
            track = a.true_heading
            track_age = a.true_heading_valid.age(now)

        track_diff = -1.0
        if distance > 2.5:
            calc_track = bearing(old_lat or 0.0, old_lon or 0.0, lat, lon)
            if (
                source != Source.MLAT
                and track > -1
                and a.position_valid.age(now) < 7 * SECONDS
            ):
                d = abs((track - calc_track + 180.0) % 360.0 - 180.0)
                track_diff = d

        mm_track_unreliable = 0
        if track_diff > 70.0 and speed > 10:
            mm_track_unreliable = 1
        elif track_diff > -1:
            mm_track_unreliable = -1

        if not self.pos_reliable(a):
            track_diff = -1.0

        if speed < 0 or a.speed_unreliable > 8:
            speed = 120.0 if surface else 900.0

        rng = -1.0
        if speed > 10 and track_diff > -1 and a.track_unreliable < 8:
            track_bonus = speed * (90.0 - track_diff) / 90.0
            track_bonus *= (0.9 if surface else 1.0) * (1.0 - track_age / track_max_age)
            if (a.gs or 0.0) < 10:
                track_bonus = max(0.0, track_bonus)
                speed += 2
            speed += track_bonus
            if track_diff > 160:
                mm.pos_ignore = True  # pos_old: don't decrement reliability
            if speed > 40 and track_diff < 10:
                rng += 2e3
        else:
            speed = speed * 1.3

        rng += 10 if surface else 30
        if elapsed < 2 and a.receiver_id == mm.receiver_id and source > Source.MLAT:
            rng += 500  # same TCP packet, same feeder
        speed = min(speed, 2000.0)
        if source == Source.MLAT:
            speed = speed * 1.4 + 50
            rng += 250

        mm_speed_unreliable = 0
        kt2ms = 1852.0 / 3600.0
        if transmitted_speed < 0:
            mm_speed_unreliable = -1
        elif distance > 2.5 and (track_diff < 70 or track_diff == -1):
            if distance <= rng + (elapsed + 50.0) / 1000.0 * transmitted_speed * kt2ms:
                mm_speed_unreliable = -1
            elif distance > rng + (elapsed + 400.0) / 1000.0 * transmitted_speed * kt2ms:
                mm_speed_unreliable = 1

        rng += (elapsed + 200.0) / 1000.0 * speed * kt2ms
        inrange = distance <= rng

        # no going backwards against good track info across feeders
        if (
            not surface
            and (a.gs or 0.0) > 10
            and track_diff > 135
            and elapsed < 2 * SECONDS
            and a.track_valid.age(now) < 2 * SECONDS
            and a.receiver_id != mm.receiver_id
        ):
            inrange = False

        if self.receiver_lat is None and mm.receiver_id and (inrange or override):
            from .receiver import RANGE_BAD

            st = self.receivers.position_received(a, mm, lat, lon, now)
            if st == RANGE_BAD:
                receiver_range_exceeded = True
                self.receivers.bad(mm.receiver_id, a.addr, now)

        if not mm.pos_ignore:
            # unreliability counters fold in via trackUpdateFromMessage's
            # tail (track.c:2631-2639)
            a.speed_unreliable = max(0, min(16, a.speed_unreliable + mm_speed_unreliable))
            a.track_unreliable = max(0, min(16, a.track_unreliable + mm_track_unreliable))

        if override:
            if not inrange:
                a.last_override_ts = now
            inrange = True
        if receiver_range_exceeded:
            inrange = False
            mm.pos_ignore = True
        return inrange

    def _set_position(self, a: Aircraft, mm: ModesMessage, lat: float, lon: float, now: int, from_global: bool) -> None:
        # same position again from an inferior source within 10 min and
        # < 20 m traveled: delayed data, treat as duplicate (track.c:974-980)
        if (
            a.seen_pos
            and now < a.seen_pos + 10 * MINUTES
            and mm.source < a.position_valid.last_source
            and greatcircle(a.lat, a.lon, lat, lon) < 20
        ):
            mm.duplicate = True
            mm.pos_ignore = True
            self.pos_duplicate += 1
            return
        if not self._accept(a, a.position_valid, mm.source, now):
            return
        self.pos_all += 1
        k = int(mm.addrtype)
        self.pos_by_type[k] = self.pos_by_type.get(k, 0) + 1
        a.prev_lat, a.prev_lon, a.prev_pos_time = a.lat or 0.0, a.lon or 0.0, a.seen_pos
        a.lat = lat
        a.lon = lon
        a.seen_pos = now
        a.pos_surface = mm.cpr_type == CprType.SURFACE
        a.gs_last_pos = a.gs or 0.0
        a.receiver_id = mm.receiver_id  # lastPosReceiverId (track.c:1166)
        a.pos_nic = mm.decoded_nic
        a.pos_rc = mm.decoded_rc
        mm.cpr_decoded = True
        mm.decoded_lat = lat
        mm.decoded_lon = lon
        # reduce_forward: accepted positions forward rate-limited per
        # aircraft (track.c:2244 + currentReduceInterval)
        if now >= a.next_reduce_forward_pos:
            a.next_reduce_forward_pos = now + self.reduce_interval_ms
            mm.reduce_forward = True
        # reliability bump (incrementReliable, track.c:3686)
        inc = 1.0
        if from_global:
            a.seen_pos_global = now
            a.local_cpr_allow_ac_rel = True
        cap = self.position_persistence  # Modes.position_persistence cap
        if mm.cpr_odd:
            a.pos_reliable_odd = min(a.pos_reliable_odd + inc, cap)
            if from_global:
                a.pos_reliable_even = min(a.pos_reliable_even + 0.5, cap)
        else:
            a.pos_reliable_even = min(a.pos_reliable_even + inc, cap)
            if from_global:
                a.pos_reliable_odd = min(a.pos_reliable_odd + 0.5, cap)
        if self.pos_reliable(a):
            # reliable-position snapshot (setPosition, track.c:1172-1182)
            a.lat_reliable = lat
            a.lon_reliable = lon
            a.surface_cpr_allow_ac_rel = True

        # polar range histogram vs our own location (track.c:252-300)
        if self.receiver_lat is not None:
            dist = greatcircle(self.receiver_lat, self.receiver_lon, lat, lon)
            self.outline.update(
                now, dist,
                bearing(self.receiver_lat, self.receiver_lon, lat, lon),
                lat, lon,
                a.baro_alt if a.baro_alt is not None else (a.geom_alt or 0),
                reliable=a.pos_reliable_odd >= 2 and a.pos_reliable_even >= 2,
                json_reliable=self.json_reliable,
            )
            self.distance_max = max(self.distance_max, dist)
            self.distance_min = min(self.distance_min, dist)

        # globe tile (traceAdd, globe_index.c:2286)
        from . import globe as globe_mod

        a.globe_index = globe_mod.globe_index(lat, lon)

    # ------------------------------------------------------------------

    def pos_reliable(self, a: Aircraft) -> bool:
        """posReliable (track.h:636-658)."""
        if self.json_reliable <= 0:
            return a.position_valid.source != Source.INVALID
        if a.position_valid.source in (Source.JAERO, Source.MLAT, Source.INDIRECT, Source.SBS):
            return True
        need = float(self.json_reliable)
        return a.pos_reliable_odd >= need and a.pos_reliable_even >= need

    def match_ac(self, now: int) -> None:
        """trackMatchAC (track.c:2731-2810): correlate Mode A/C reply
        counts with tracked Mode-S aircraft by squawk and Mode-C altitude,
        then age out idle codes."""
        from ..decode.mode_ac import modea_to_index, modec_to_modea

        count, last, match, age = (
            self.modeac_count, self.modeac_lastcount, self.modeac_match, self.modeac_age,
        )
        match[:] = 0

        def mark(i: int, addr: int) -> None:
            match[i] = 0xFFFFFFFF if match[i] else addr

        for a in self.aircraft.values():
            if now - a.seen > 5000:
                continue
            if a.squawk is not None and a.squawk_valid.valid(now):
                i = modea_to_index(a.squawk)
                if count[i] - last[i] >= TRACK_MODEAC_MIN_MESSAGES:
                    a.modea_hit = True
                    mark(i, a.addr)
            if a.baro_alt is not None and a.baro_alt_valid.valid(now):
                modec = (a.baro_alt + 49) // 100
                for mc in (modec, modec + 1, modec - 1):  # +/- 100 ft
                    modea = modec_to_modea(mc)
                    if not modea:
                        continue
                    i = modea_to_index(modea)
                    if count[i] - last[i] >= TRACK_MODEAC_MIN_MESSAGES:
                        a.modec_hit = True
                        mark(i, a.addr)

        active = count != 0
        live = (count - last) >= TRACK_MODEAC_MIN_MESSAGES
        # idle codes age out after 15 sweeps; matched codes start at age 10
        import numpy as np

        idle = active & ~live
        age[idle] += 1
        expired = idle & (age > 15)
        count[expired] = 0
        last[expired] = 0
        age[expired] = 0
        age[active & live] = np.where(match[active & live] != 0, 10, 0)
        last[active & ~expired] = count[active & ~expired]

    def remove_stale(self, now: int) -> int:
        """trackRemoveStale sweep (track.c:2948): expire fields, drop idle."""
        dead = []
        for addr, a in self.aircraft.items():
            expire = TRACK_EXPIRE_LONG
            if a.addrtype == AddrType.JAERO:
                # satellite-relayed reports update rarely (track.c:2857-2870)
                expire = max(expire, self.track_expire_jaero_ms)
            if now > a.seen + expire + 2 * MINUTES:
                dead.append(addr)
                continue
            for v in (
                a.baro_alt_valid, a.geom_alt_valid, a.geom_delta_valid,
                a.baro_rate_valid, a.geom_rate_valid, a.gs_valid, a.ias_valid,
                a.tas_valid, a.mach_valid, a.track_valid, a.track_rate_valid,
                a.roll_valid, a.mag_heading_valid, a.true_heading_valid,
                a.airground_valid, a.callsign_valid, a.squawk_valid,
                a.emergency_valid, a.category_valid, a.alert_valid, a.spi_valid,
                a.nav_qnh_valid, a.nav_altitude_mcp_valid, a.nav_altitude_fms_valid,
                a.nav_heading_valid, a.nav_modes_valid, a.nic_baro_valid,
                a.nic_a_valid, a.nic_c_valid,
                a.nac_p_valid, a.nac_v_valid, a.sil_valid, a.gva_valid,
                a.sda_valid, a.wind_valid, a.oat_valid,
            ):
                v.expire(now)
            a.position_valid.expire(now, TRACK_EXPIRE_LONG)
            a.cpr_odd.valid.expire(now)
            a.cpr_even.valid.expire(now)
        for addr in dead:
            if self.aircraft[addr].messages < 2:
                self.tracks_single_message += 1
            del self.aircraft[addr]
        return len(dead)

    # convenience --------------------------------------------------------

    def active(self, now: int) -> list[Aircraft]:
        return [a for a in self.aircraft.values() if now < a.seen + TRACK_EXPIRE]
