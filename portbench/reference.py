"""Plain reference demodulator: readsb's demodulate2400 over one channel.

Written from the reference readsb's documented behaviour (wiedehopf/readsb
convert.c, demod_2400.c, mode_s.c, crc.c, icao_filter.c) in plain PyTorch
and Python, with nothing of readsb_tpu_torch.  It is handed the same IQ
bytes as the program and works out everything again: magnitudes, the
326-sample overlap carried between superblocks, candidates, slicer bits,
CRC syndromes, the serial scoring with its skip rule, the known-ICAO
filter with its 60 s generations, and the signal power.

    stream  = [326 samples of silence][superblock 0][superblock 1]...
    scan    = offsets 0..S-1 of each superblock's [overlap | samples]
    ts      = (global offset) * 5 + 768 + try_phase      (12 MHz clock)

The per-sample front end (magnitudes to syndromes) depends on the bytes
of one superblock and the overlap only, so `Channel` keeps it per
distinct (previous, current) pair of pool entries; the serial part runs
for every superblock, as the filter's state changes.

`mag_round` is the control's hook: "float16" rounds every magnitude
through half precision before anything reads it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import crc24

TRAILING = 326  # (8 + 112 + 16) us at 2.4 MS/s
SIG_LONG = 112 * 12 // 5  # 268 samples
SIG_SHORT = 56 * 12 // 5  # 134 samples
FILTER_TTL_MS = 60_000
SHORT_DF = frozenset((0, 4, 5, 11))
LONG_DF = frozenset((16, 17, 18, 20, 21))
DF17_ONE_BIT = frozenset((1, 25, 21, 19, 16))  # DF17 with one DF bit flipped
NOT_SCORED = -42

# slicer kernels by sub-sample phase (demod_2400.c:74-93)
KERNELS = {
    0: (18, -15, -3, 0),
    1: (14, -5, -9, 0),
    2: (16, 5, -20, 0),
    3: (7, 11, -18, 0),
    4: (4, 15, -20, 1),
}
# per phase: the eight bits of a byte as (sample offset, kernel) and the
# pointer advance to the next byte (demod_2400.c:133-213)
BYTE_SCHEDULE = {
    0: ([(0, 0), (2, 2), (4, 4), (7, 1), (9, 3), (12, 0), (14, 2), (16, 4)], 19),
    1: ([(0, 1), (2, 3), (5, 0), (7, 2), (9, 4), (12, 1), (14, 3), (17, 0)], 19),
    2: ([(0, 2), (2, 4), (5, 1), (7, 3), (10, 0), (12, 2), (14, 4), (17, 1)], 19),
    3: ([(0, 3), (3, 0), (5, 2), (7, 4), (10, 1), (12, 3), (15, 0), (17, 2)], 19),
    4: ([(0, 4), (3, 1), (5, 3), (8, 0), (10, 2), (12, 4), (15, 1), (17, 3)], 20),
}


@functools.lru_cache(maxsize=None)
def slicer() -> tuple[np.ndarray, np.ndarray]:
    """(offset, coefficient) int64[5, 112, 4]: bit b of try_phase p + 4 is
    sum(coef * mag[candidate + offset]) > 0."""
    off = np.zeros((5, 112, 4), dtype=np.int64)
    coef = np.zeros((5, 112, 4), dtype=np.int64)
    for p in range(5):
        try_phase = p + 4
        ptr = 19 + try_phase // 5
        phase = try_phase % 5
        bit = 0
        for _ in range(14):
            sched, advance = BYTE_SCHEDULE[phase]
            for boff, kid in sched:
                off[p, bit] = ptr + boff + np.arange(4)
                coef[p, bit] = KERNELS[kid]
                bit += 1
            ptr += advance
            phase = (phase + 1) % 5
    return off, coef


@functools.lru_cache(maxsize=None)
def uc8_table() -> np.ndarray:
    """int64[65536] magnitude of I * 256 + Q in readsb's float32 order
    (convert.c:45-58): f32 of the double quotient, f32 square and sum,
    sqrtf, f32 scale + 0.5, truncation."""
    f = ((np.arange(256, dtype=np.float64) - 127.5) / 127.5).astype(np.float32)
    sq = f * f
    magsq = np.minimum(sq[:, None] + sq[None, :], np.float32(1.0))
    mag = np.sqrt(magsq)
    return (mag * np.float32(65535.0) + np.float32(0.5)).astype(np.int64).reshape(-1)


def magnitudes(raw: bytes, fmt: str, device) -> torch.Tensor:
    """int64 magnitudes of interleaved IQ bytes."""
    if fmt == "uc8":
        b = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device).to(torch.int64)
        lut = torch.from_numpy(uc8_table()).to(device)
        return lut[b[0::2] * 256 + b[1::2]]
    if fmt != "sc16":
        raise ValueError(f"unknown sample format {fmt!r}")
    v = np.frombuffer(raw, dtype="<i2")
    iq = torch.from_numpy(v.astype(np.float32)).to(device) * (1.0 / 32768.0)
    fi, fq = iq[0::2], iq[1::2]
    magsq = torch.clamp(fi * fi + fq * fq, max=1.0)
    # the double root rounded once is the correctly rounded float32 root
    mag = torch.sqrt(magsq.to(torch.float64)).to(torch.float32)
    return (mag * 65535.0 + 0.5).to(torch.int64)


def silence(fmt: str) -> bytes:
    """The IQ bytes of one quiet sample: the stream's first overlap."""
    return bytes([128, 128]) if fmt == "uc8" else bytes(4)


@functools.lru_cache(maxsize=None)
def _parity_matrices() -> tuple[np.ndarray, np.ndarray]:
    return crc24.syndrome_matrix(112), crc24.syndrome_matrix(56)


def _preamble(mag: torch.Tensor, scan: int, threshold: int):
    """(zero-padded magnitudes, candidate mask, three correlation flags) at
    offsets 0..scan-1: the pre-check on the preamble's shape, then the
    three correlations against the noise level (demod_2400.c:311-378)."""
    m = torch.zeros(scan + 512, dtype=torch.int64, device=mag.device)
    m[: mag.shape[0]] = mag

    def p(i):
        return m[i : i + scan]

    pre = (p(1) > p(7)) & (p(12) > p(14)) & (p(12) > p(15))
    ref = ((p(5) + p(8) + p(16) + p(17) + p(18)) * int(threshold)) >> 5
    d23, s14, d1011 = p(2) - p(3), p(1) + p(4), p(10) - p(11)
    common = s14 - d23 + p(9) + p(12)
    fired = torch.stack(
        [common - d1011 >= ref, common + d1011 >= ref, s14 + 2 * d23 + d1011 + p(12) >= ref], 1
    )
    return m, pre & fired.any(1), fired


def candidate_count(mag: torch.Tensor, scan: int, threshold: int) -> int:
    """The number of preamble candidates of one buffer (offsets 0..scan-1)."""
    return int(_preamble(mag, scan, threshold)[1].sum())


def front_end(mag: torch.Tensor, scan: int, threshold: int) -> dict[str, np.ndarray]:
    """Candidates of one buffer [overlap | samples] (int64 magnitudes) at
    offsets 0..scan-1, with every phase's bits worked out: offsets, the
    three correlation flags, message bytes, CRC syndromes over 112 and 56
    bits, and the sums of mag^2 over the long and short message bodies."""
    dev = mag.device
    m, cand, fired = _preamble(mag, scan, threshold)
    offs = torch.nonzero(cand).flatten()
    off, coef = (torch.from_numpy(a).to(dev) for a in slicer())
    win = m[offs[:, None, None, None] + off[None]]  # (n, 5, 112, 4)
    bits = ((win * coef[None]).sum(-1) > 0).to(torch.float32)  # (n, 5, 112)
    m112, m56 = (torch.from_numpy(a).to(dev) for a in _parity_matrices())
    par112 = (bits @ m112).to(torch.int64) % 2
    par56 = (bits[..., :56] @ m56).to(torch.int64) % 2
    w24 = 1 << torch.arange(23, -1, -1, device=dev)
    w8 = 1 << torch.arange(7, -1, -1, device=dev)
    msg = (bits.to(torch.int64).reshape(len(offs), 5, 14, 8) * w8).sum(-1)
    prefix = torch.zeros(m.shape[0] + 1, dtype=torch.int64, device=dev)
    prefix[1:] = torch.cumsum(m * m, 0)
    a = offs + 19
    return {
        "offsets": offs.cpu().numpy(),
        "fired": fired[offs].cpu().numpy(),
        "msg": msg.to(torch.uint8).cpu().numpy(),
        "syn112": (par112 * w24).sum(-1).cpu().numpy(),
        "syn56": (par56 * w24).sum(-1).cpu().numpy(),
        "sig_long": (prefix[a + SIG_LONG] - prefix[a]).cpu().numpy(),
        "sig_short": (prefix[a + SIG_SHORT] - prefix[a]).cpu().numpy(),
    }


class IcaoFilter:
    """Known addresses in two generations swapped every 60 s of the
    stream's clock (icao_filter.c:96-154)."""

    def __init__(self):
        self.cur: set[int] = set()
        self.prev: set[int] = set()
        self.next_swap_ms: int | None = None

    def test(self, addr: int) -> bool:
        addr &= 0xFFFFFF
        return addr in self.cur or addr in self.prev

    def expire(self, now_ms: int) -> None:
        if self.next_swap_ms is None:
            self.next_swap_ms = now_ms + FILTER_TTL_MS
        elif now_ms >= self.next_swap_ms:
            self.prev, self.cur = self.cur, set()
            self.next_swap_ms = now_ms + FILTER_TTL_MS


def _aa(msg) -> int:
    return (msg[1] << 16) | (msg[2] << 8) | msg[3]


def _flip_aa(addr: int, bit: int) -> int:
    """An error bit inside the AA field (bits 8..31) applied to addr."""
    return addr ^ (1 << (31 - bit)) if 8 <= bit <= 31 else addr


def _flip(msg: list[int], bit: int) -> list[int]:
    out = list(msg)
    out[bit >> 3] ^= 1 << (7 - (bit & 7))
    return out


class Scorer:
    """scoreModesMessage and the accept stage of decodeModesMessage
    (mode_s.c:276-419, 443-596) with one-bit correction (--fix) and the
    DF17 type repair (fix_df), over one channel's filter."""

    def __init__(self, nfix: int, fix_df: bool):
        if nfix not in (0, 1):
            raise ValueError("the reference corrects at most one bit")
        self.nfix = nfix
        self.fix_df = fix_df and nfix > 0
        self.filter = IcaoFilter()
        self.learned: set[int] = set()  # addresses accept() added, for Channel's memo
        self.err_long = crc24.single_error_table(112) if nfix else {}
        self.err_short = crc24.single_error_table(56) if nfix else {}
        syn = crc24.bit_syndromes(112)
        self.df_delta = [0] * 32
        for df in range(32):
            d = df ^ 17
            for j in range(5):  # message bit j is DF bit 4 - j
                if (d >> (4 - j)) & 1:
                    self.df_delta[df] ^= int(syn[j])
        self.long_df = set(LONG_DF) | (set(DF17_ONE_BIT) if self.fix_df else set())

    def score(self, msg: list[int], validbits: int, syn112: int, syn56: int) -> int:
        test = self.filter.test
        df = msg[0] >> 3
        if validbits >= 112 and self.fix_df and df in DF17_ONE_BIT:
            if syn112 ^ self.df_delta[df] == 0:
                return 900 if test(_aa(msg)) else 700
        msgbits = 112 if df >= 16 else 56
        if validbits < msgbits or not any(msg[:7]):
            return -2
        crc = syn112 if msgbits == 112 else syn56
        if df in (0, 4, 5, 16, 20, 21):
            return 1000 if test(crc) else -1
        if df == 11:
            addr = _aa(msg)
            if crc & 0xFFFF80:
                bit = self.err_short.get(crc)
                if bit is None:
                    return -2
                return 800 if test(_flip_aa(addr, bit)) else -1
            if crc & 0x7F == 0:
                return 1600 if test(addr) else 750
            return 1000 if test(addr) else -1
        if df in (17, 18):
            nerr, addr = 0, _aa(msg)
            if crc:
                bit = self.err_long.get(crc)
                if bit is None:
                    return -2
                nerr, addr = 1, _flip_aa(addr, bit)
            return (1800 if test(addr) else 1400) // (nerr + 1)
        return -2

    def accept(self, msg: list[int], syn112: int, syn56: int):
        """(0, frame fields) or (-1 unknown address / -2 bad, None); learns
        the address of an uncorrected DF17 or DF11 with IID 0 (mode_s.c:778)."""
        test = self.filter.test
        if not any(msg[:7]):
            return -2, None
        df = msg[0] >> 3
        corrected = 0
        if self.fix_df and df in DF17_ONE_BIT and syn112 ^ self.df_delta[df] == 0:
            msg = [(17 << 3) | (msg[0] & 7)] + list(msg[1:])
            syn112, df, corrected = 0, 17, 1
        msgbits = 112 if df >= 16 else 56
        crc = syn112 if msgbits == 112 else syn56
        iid = 0
        if df in (0, 4, 5, 16, 20, 21) or 24 <= df <= 31:
            if not test(crc):
                return -1, None
            addr = crc
        elif df == 11:
            iid = crc & 0x7F
            if crc & 0xFFFF80:
                bit = self.err_short.get(crc)
                if bit is None:
                    return -2, None
                corrected, iid = 1, 0
                msg = _flip(msg, bit)
                if not test(_aa(msg)):
                    return -1, None
            addr = _aa(msg)
        elif df in (17, 18):
            if crc:
                bit = self.err_long.get(crc)
                if bit is None:
                    return -2, None
                before = _aa(msg)
                corrected = 1
                msg = _flip(msg, bit)
                if _aa(msg) != before and not test(_aa(msg)):
                    return -1, None
            addr = _aa(msg)
        else:
            return -2, None
        if corrected == 0 and (df == 17 or (df == 11 and iid == 0)):
            self.filter.cur.add(addr & 0xFFFFFF)
            self.learned.add(addr & 0xFFFFFF)
        return 0, (bytes(msg[: msgbits // 8]), msgbits, addr, corrected, iid)


class Channel:
    """One receiver's stream through the reference."""

    def __init__(self, cfg: dict, device, mag_round: str | None = None):
        self.fmt = cfg["fmt"]
        self.block = int(cfg["block_samples"])
        self.scan = self.block * int(cfg["blocks_per_batch"])
        self.threshold = int(cfg["threshold"])
        self.scorer = Scorer(int(cfg["nfix"]), bool(cfg["fix_df"]))
        self.device = torch.device(device)
        self.mag_round = mag_round
        self.scan_global = 0
        self.stats = [0, 0, 0, 0, 0, 0]  # preambles, bad, unknown, accepted 0/1/2
        self._front: dict = {}
        self._memo: dict = {}

    def _mag(self, raw: bytes) -> torch.Tensor:
        m = magnitudes(raw, self.fmt, self.device)
        if self.mag_round == "float16":
            m = m.clamp(max=65504).to(torch.float16).to(torch.int64)
        elif self.mag_round is not None:
            raise ValueError(f"unknown rounding {self.mag_round!r}")
        return m

    def front(self, key, overlap: bytes, samples: bytes) -> dict:
        if key not in self._front:
            mag = self._mag(overlap + samples)
            self._front[key] = front_end(mag, self.scan, self.threshold)
        return self._front[key]

    def serial_plain(self, cand: dict) -> list[tuple]:
        """The serial pass over one superblock's candidates, candidate by
        candidate as demodulate2400 does it: frames as (msg, msgbits,
        offset in the superblock, score, phase, correctedbits, addr, iid,
        signal_power).  `serial` gives the same, faster."""
        sc = self.scorer
        offsets = cand["offsets"].tolist()
        fired = cand["fired"].tolist()
        msgs = cand["msg"].tolist()
        s112 = cand["syn112"].tolist()
        s56 = cand["syn56"].tolist()
        frames: list[tuple] = []
        skip_until = 0
        for i, o in enumerate(offsets):
            if o < skip_until:
                continue
            a, b, c = fired[i]
            phases = ([0, 1] if a else []) + ([2, 3] if b else []) + ([4] if c else [])
            best, bestscore = None, NOT_SCORED
            for ph in phases:
                m = msgs[i][ph]
                df = m[0] >> 3
                if df in sc.long_df:
                    validbits = 112
                elif df in SHORT_DF:
                    validbits = 56
                else:
                    bestscore = max(bestscore, -2)
                    continue
                s = sc.score(m, validbits, s112[i][ph], s56[i][ph])
                if s > bestscore:
                    bestscore, best = s, ph
            end = self._decide(cand, i, o, best, bestscore, msgs[i], s112[i], s56[i], frames)
            if end is not None:
                skip_until = end
        return frames

    def _decide(self, cand, i, o, best, bestscore, msgs, s112, s56, frames):
        """Count candidate i scored `bestscore` at phase `best`, accept it
        when it passes; the end of its skip window when accepted.  msgs,
        s112 and s56 are the candidate's five phases."""
        st = self.stats
        if bestscore == NOT_SCORED:
            return None
        st[0] += 1
        if bestscore < 0:
            st[2 if bestscore == -1 else 1] += 1
            return None
        m = msgs[best]
        msgbits = 112 if (m[0] >> 3) >= 16 else 56
        result, info = self.scorer.accept(m, s112[best], s56[best])
        if result < 0:
            st[2 if result == -1 else 1] += 1
            return None
        body, nbits, addr, corrected, iid = info
        st[3 + min(corrected, 2)] += 1
        siglen = msgbits * 12 // 5
        sigsum = cand["sig_long"][i] if msgbits == 112 else cand["sig_short"][i]
        power = float(sigsum) / (65535.0 * 65535.0) / siglen
        frames.append((body, nbits, o, bestscore, best + 4, corrected, addr, iid, power))
        return min(o + msgbits * 2 + 1, (o // self.block + 1) * self.block)

    def serial(self, cand: dict) -> list[tuple]:
        """serial_plain's result with the scores worked out for all
        candidates at once against the filter as the superblock starts.
        A candidate whose score could change inside the superblock (one of
        its tested addresses is unknown at the start and could be learned
        from a frame of this superblock), or that could be accepted, goes
        through the serial pass; the rest only count as rejected, unless an
        accepted frame's skip window covers them."""
        sc = self.scorer
        if "plan" not in cand:  # the same for every superblock of this buffer
            cand["plan"] = plan_scores(cand, sc)
        tab = cand["plan"]
        n = len(cand["offsets"])
        if n == 0:
            return []
        known0 = sc.filter.cur | sc.filter.prev
        taddr = tab["taddr"]
        is_known = np.isin(taddr, np.fromiter(known0, np.int64, len(known0)))
        score = np.where((taddr < 0) | is_known, tab["s_known"], tab["s_unknown"])
        score = np.where(tab["fired"], score, NOT_SCORED)
        bestscore = score.max(1)
        best = np.where(tab["gated"], score, NOT_SCORED - 1).argmax(1)
        learnable = np.fromiter(tab["learnable"], np.int64, len(tab["learnable"]))
        dependent = (tab["fired"] & (taddr >= 0) & ~is_known & np.isin(taddr, learnable)).any(1)
        serial = dependent | (bestscore >= 0)

        offsets = cand["offsets"]
        rows = np.nonzero(serial)[0]
        msgs = cand["msg"][rows].tolist()
        s112 = cand["syn112"][rows].tolist()
        s56 = cand["syn56"][rows].tolist()
        frames: list[tuple] = []
        starts, ends = [], []
        skip_until = 0
        for j, i in enumerate(rows.tolist()):
            o = int(offsets[i])
            if o < skip_until:
                continue
            b, bs = int(best[i]), int(bestscore[i])
            if dependent[i]:
                b, bs = None, NOT_SCORED
                for ph in np.nonzero(tab["fired"][i])[0].tolist():
                    m = msgs[j][ph]
                    if not tab["gated"][i, ph]:
                        bs = max(bs, -2)
                        continue
                    s = sc.score(m, 112 if (m[0] >> 3) in sc.long_df else 56,
                                 s112[j][ph], s56[j][ph])
                    if s > bs:
                        bs, b = s, ph
            end = self._decide(cand, i, o, b, bs, msgs[j], s112[j], s56[j], frames)
            if end is not None:
                skip_until = end
                starts.append(o)
                ends.append(end)

        rest = np.nonzero(~serial)[0]
        o = offsets[rest]
        w = np.searchsorted(np.array(starts, np.int64), o) - 1
        covered = (w >= 0) & (o < np.array(ends + [0], np.int64)[np.maximum(w, 0)])
        counted = bestscore[rest][~covered]
        self.stats[0] += len(counted)
        self.stats[1] += int((counted != -1).sum())
        self.stats[2] += int((counted == -1).sum())
        return frames

    def superblock(self, key, overlap: bytes, samples: bytes, plain: bool = False) -> list[tuple]:
        """One superblock [overlap | samples] through the reference: frames
        as (msg, msgbits, timestamp, score, phase, correctedbits, addr, iid,
        scan_offset, signal_power).  `key` names the buffer: equal keys mean
        equal bytes.  The serial pass is a function of the buffer and the
        known addresses alone, so its result (frames, counters, addresses
        learned) is kept per (key, known addresses) and replayed.  plain:
        serial_plain on every superblock, with nothing kept."""
        sc = self.scorer
        memo_key = (key, frozenset(sc.filter.cur | sc.filter.prev))
        hit = None if plain else self._memo.get(memo_key)
        if hit is None:
            before = list(self.stats)
            sc.learned = set()
            cand = self.front(key, overlap, samples)
            rel = self.serial_plain(cand) if plain else self.serial(cand)
            hit = (rel, [x - y for x, y in zip(self.stats, before)], frozenset(sc.learned))
            if not plain:
                self._memo[memo_key] = hit
        else:
            self.stats = [x + y for x, y in zip(self.stats, hit[1])]
            sc.filter.cur |= hit[2]
        base = self.scan_global
        frames = [(b, nb, (base + o) * 5 + 768 + ph, score, ph, corr, addr, iid, base + o, pw)
                  for b, nb, o, score, ph, corr, addr, iid, pw in hit[0]]
        self.scan_global += self.scan
        sc.filter.expire(self.scan_global * 5 // 12000)
        return frames


def _lookup(table: dict[int, int], keys: np.ndarray) -> np.ndarray:
    """table[key] for every key, -1 where it is absent."""
    if not table:
        return np.full(keys.shape, -1, np.int64)
    k = np.array(sorted(table), np.int64)
    v = np.array([table[x] for x in k.tolist()], np.int64)
    i = np.clip(np.searchsorted(k, keys), 0, len(k) - 1)
    return np.where(k[i] == keys, v[i], -1)


def _flip_aa_np(addr: np.ndarray, bit: np.ndarray) -> np.ndarray:
    inside = (bit >= 8) & (bit <= 31)
    return np.where(inside, addr ^ (1 << np.clip(31 - bit, 0, 23)), addr)


def plan_scores(cand: dict, sc: Scorer) -> dict:
    """Scorer.score for every candidate and phase at once, as (address it
    tests or -1, score when that address is known, score when not), with
    the phases fired, the phases the DF gate lets through, and the
    addresses any frame of these candidates could teach the filter."""
    msg = cand["msg"].astype(np.int64)  # (n, 5, 14)
    n = len(msg)
    df = msg[..., 0] >> 3
    aa = (msg[..., 1] << 16) | (msg[..., 2] << 8) | msg[..., 3]
    s112, s56 = cand["syn112"], cand["syn56"]
    f = cand["fired"]
    fired = np.stack([f[:, 0], f[:, 0], f[:, 1], f[:, 1], f[:, 2]], 1) if n else np.zeros((0, 5), bool)
    long_ = np.isin(df, list(sc.long_df))
    gated = long_ | np.isin(df, list(SHORT_DF))
    taddr = np.full(df.shape, -1, np.int64)
    s_known = np.full(df.shape, -2, np.int64)
    s_unknown = np.full(df.shape, -2, np.int64)
    todo = gated.copy()

    def put(mask, addr, known, unknown):
        nonlocal todo
        mask = mask & todo
        taddr[mask] = np.broadcast_to(addr, df.shape)[mask]
        s_known[mask] = np.broadcast_to(known, df.shape)[mask]
        s_unknown[mask] = np.broadcast_to(unknown, df.shape)[mask]
        todo = todo & ~mask

    delta = np.array(sc.df_delta, np.int64)[df]
    if sc.fix_df:
        put(long_ & np.isin(df, list(DF17_ONE_BIT)) & ((s112 ^ delta) == 0), aa, 900, 700)
    zero7 = ~msg[..., :7].any(-1)
    put(zero7, -1, -2, -2)
    crc = np.where(df >= 16, s112, s56)
    put(np.isin(df, [0, 4, 5, 16, 20, 21]), crc, 1000, -1)
    bit_s = _lookup(sc.err_short, crc)
    df11 = df == 11
    put(df11 & ((crc & 0xFFFF80) != 0) & (bit_s < 0), -1, -2, -2)
    put(df11 & ((crc & 0xFFFF80) != 0), _flip_aa_np(aa, bit_s), 800, -1)
    put(df11 & ((crc & 0x7F) == 0), aa, 1600, 750)
    put(df11, aa, 1000, -1)
    bit_l = _lookup(sc.err_long, crc)
    df1718 = np.isin(df, [17, 18])
    put(df1718 & (crc == 0), aa, 1800, 1400)
    put(df1718 & (bit_l < 0), -1, -2, -2)
    put(df1718, _flip_aa_np(aa, bit_l), 900, 700)
    put(todo, -1, -2, -2)
    # notgated phases count -2 but never become the best phase
    s_known = np.where(gated, s_known, -2)
    s_unknown = np.where(gated, s_unknown, -2)
    learn = fired & (((df == 17) & (s112 == 0)) | ((df == 11) & (s56 == 0)))
    return {
        "taddr": np.where(taddr >= 0, taddr & 0xFFFFFF, -1),
        "s_known": s_known, "s_unknown": s_unknown,
        "fired": fired, "gated": gated,
        "learnable": set(aa[learn].tolist()),
    }


def run_channel(cfg: dict, pool_c: list[bytes], schedule: list[int], device,
                mag_round: str | None = None, plain: bool = False):
    """The reference over one channel fed pool_c[schedule[0]],
    pool_c[schedule[1]], ...: frames per superblock and the six counters."""
    ch = Channel(cfg, device, mag_round)
    tail = TRAILING * (2 if cfg["fmt"] == "uc8" else 4)
    out = []
    prev = None
    for idx in schedule:
        overlap = silence(cfg["fmt"]) * TRAILING if prev is None else pool_c[prev][-tail:]
        out.append(ch.superblock((prev, idx), overlap, pool_c[idx], plain))
        prev = idx
    return out, ch.stats
