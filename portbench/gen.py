"""Traffic generator: a fleet heard by many receivers, rendered as IQ bytes.

The recipe is that of readsb_tpu_torch/synth.py (frames, CRC, CPR and the
noise model), rewritten to run vectorised: the schedule and the message
bits are drawn with numpy from the seed, the envelopes, carrier and noise
are rendered on the device with a torch.Generator seeded from the same
seed, then quantised to UC8 or SC16 and copied back as one `bytes` object
per channel and superblock.  All the parameters are in a traffic file
(portbench/traffic/<name>.json); this module holds no parameter of a mix.

A frame is the synth recipe's: preamble pulses at 0, 1.0, 3.5 and 4.5 us,
then one 0.5 us pulse per bit (first half for 1, second half for 0),
drawn on a 24 MHz grid, shifted by a random tenth of a sample and
box-averaged to 2.4 MS/s; overlapping frames take the larger envelope;
a carrier at 0.031 of the sample rate carries it, plus Gaussian noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import crc24

FS = 2_400_000.0
OVERSAMPLE = 10
HALF_SLOT_FINE = 12  # 0.5 us on the 24 MHz grid
LONG_HALF_SLOTS = 2 * (8 + 112)  # preamble + 112 bits, in 0.5 us slots
ENV_FINE = LONG_HALF_SLOTS * HALF_SLOT_FINE + 4 * OVERSAMPLE
ENV_SAMPLES = ENV_FINE // OVERSAMPLE  # 292: every frame's envelope length
KINDS = ("df11", "df4", "pos_even", "pos_odd", "vel", "ident")
AIS = "?ABCDEFGHIJKLMNOPQRSTUVWXYZ????? ???????????????0123456789??????"


# ---------------------------------------------------------------------------
# Fleet and schedule
# ---------------------------------------------------------------------------


def fleet(index: np.ndarray) -> dict[str, np.ndarray]:
    """Per aircraft of the fleet: address, start position, altitude, speed,
    track and climb, from its fleet index alone (so receivers that hear
    one index hear one aircraft)."""
    a = np.asarray(index, dtype=np.int64)
    return {
        "addr": 0x400000 + 0x101 * (a + 1),
        "lat0": 46.0 + 0.13 * (a % 64),
        "lon0": 6.0 + 0.21 * (a % 64),
        "alt": 3000.0 + 1000.0 * (a % 30),
        "gs": 180.0 + 7.0 * (a % 40),
        "trk": (a * 37.0) % 360.0,
        "vr": ((a % 7) - 3) * 256.0,
    }


def schedule(traffic: dict, n_chan: int, duration_s: float, seed: int) -> dict[str, np.ndarray]:
    """Every message of every receiver over `duration_s`: channel, fleet
    index, time, kind, amplitude and sub-sample phase."""
    rng = np.random.default_rng(seed)
    n_ac = int(traffic["aircraft_per_receiver"])
    stride = int(traffic["fleet_stride"])
    g_lo, g_hi = traffic["gap_s"]
    nmax = int(duration_s / g_lo) + 2
    t0 = rng.uniform(*traffic["first_s"], size=(n_chan, n_ac, 1))
    gaps = rng.uniform(g_lo, g_hi, size=(n_chan, n_ac, nmax - 1))
    t = np.concatenate([t0, t0 + np.cumsum(gaps, axis=-1)], axis=-1)
    keep = t < duration_s - 0.01
    chan, local, k = np.nonzero(keep)
    times = t[keep]
    cycle = traffic["cycle"]
    slot = k % len(cycle)
    kind = np.array([KINDS.index(x) for x in cycle], dtype=np.int64)[slot]
    amp_cfg = traffic["amplitude"]
    amp = amp_cfg["base"] + amp_cfg["step"] * ((local + k) % amp_cfg["levels"])
    echo = traffic.get("echo")
    if echo:
        e = np.isin(slot, echo["slots"]) & (local % echo["every"] == 0)
        e &= times + echo["delay_s"] < duration_s - 0.001
        chan = np.concatenate([chan, chan[e]])
        local = np.concatenate([local, local[e]])
        times = np.concatenate([times, times[e] + echo["delay_s"]])
        kind = np.concatenate([kind, np.full(int(e.sum()), KINDS.index("df4"))])
        amp = np.concatenate([amp, amp[e]])
    phase = rng.uniform(0.0, 1.0, size=len(times))
    return {
        "chan": chan, "aircraft": chan * stride + local, "t": times,
        "kind": kind, "amp": amp.astype(np.float32), "phase": phase,
    }


# ---------------------------------------------------------------------------
# Message bits
# ---------------------------------------------------------------------------


def _set(bits: np.ndarray, first1: int, last1: int, value) -> None:
    """Set message bits first1..last1 (1-based, MSB first) of every row."""
    n = last1 - first1 + 1
    v = np.asarray(value, dtype=np.int64)
    bits[:, first1 - 1 : last1] = (v[:, None] >> np.arange(n - 1, -1, -1)) & 1


def _nl(lat: np.ndarray) -> np.ndarray:
    """CPR NL(lat): longitude zones at a latitude (ICAO Annex 10)."""
    a = np.abs(lat)
    nz = 15.0
    c = 1 - math.cos(math.pi / (2 * nz))
    with np.errstate(invalid="ignore", divide="ignore"):
        nl = np.floor(2 * math.pi / np.arccos(1 - c / np.cos(np.pi / 180.0 * a) ** 2))
    nl = np.where(a < 10.47047130, 59, nl)
    return np.where(a > 87.0, np.where(a > 90.0, 1, 2), nl).astype(np.int64)


def cpr_airborne(lat: np.ndarray, lon: np.ndarray, odd: np.ndarray):
    """17-bit airborne CPR encoding -> (lat17, lon17)."""
    dlat = 360.0 / (60 - odd)
    yz = np.floor(2**17 * (np.mod(lat, dlat) / dlat) + 0.5)
    rlat = dlat * (yz / 2**17 + np.floor(lat / dlat))
    nl = _nl(rlat) - odd
    dlon = np.where(nl > 0, 360.0 / np.maximum(nl, 1), 360.0)
    xz = np.floor(2**17 * (np.mod(lon, dlon) / dlon) + 0.5)
    return yz.astype(np.int64) & 0x1FFFF, xz.astype(np.int64) & 0x1FFFF


def _alt_code(alt: np.ndarray) -> np.ndarray:
    return np.clip(np.round((alt + 1000) / 25), 0, 0x7FF).astype(np.int64)


def encode(sched: dict[str, np.ndarray]) -> np.ndarray:
    """uint8[M, 112] message bits of every scheduled message (a short
    message fills the first 56); parity set so every syndrome is 0."""
    kind = sched["kind"]
    m = len(kind)
    ac = fleet(sched["aircraft"])
    t = sched["t"]
    addr = ac["addr"]
    bits = np.zeros((m, 112), dtype=np.uint8)
    long_ = kind >= KINDS.index("pos_even")
    short = ~long_

    df = np.where(kind == KINDS.index("df11"), 11, np.where(kind == KINDS.index("df4"), 4, 17))
    _set(bits, 1, 5, df)
    _set(bits, 6, 8, np.where(df == 4, 0, 5))  # FS airborne / CA airborne
    n = _alt_code(ac["alt"])
    ac13 = ((n & 0x7F0) << 2) | 0x040 | (n & 0x00F)
    rows = np.nonzero(df == 4)[0]
    sub = bits[rows]
    _set(sub, 20, 32, ac13[rows])
    bits[rows] = sub
    rows = np.nonzero(df != 4)[0]
    sub = bits[rows]
    _set(sub, 9, 32, addr[rows])
    bits[rows] = sub

    # airborne position (metype 11), odd / even CPR at the aircraft's place at t
    pos = np.nonzero((kind == KINDS.index("pos_even")) | (kind == KINDS.index("pos_odd")))[0]
    if len(pos):
        odd = (kind[pos] == KINDS.index("pos_odd")).astype(np.int64)
        mps = ac["gs"][pos] * 0.514444
        trk = np.radians(ac["trk"][pos])
        lat0 = ac["lat0"][pos]
        lat = lat0 + mps * np.cos(trk) * t[pos] / 111320.0
        lon = ac["lon0"][pos] + mps * np.sin(trk) * t[pos] / (111320.0 * np.cos(np.radians(lat0)))
        ylat, xlon = cpr_airborne(lat, lon, odd)
        ac12 = ((n[pos] & 0x7F0) << 1) | 0x010 | (n[pos] & 0x00F)
        sub = bits[pos]
        _set(sub, 33, 37, np.full(len(pos), 11))
        _set(sub, 41, 52, ac12)
        _set(sub, 54, 54, odd)
        _set(sub, 55, 71, ylat)
        _set(sub, 72, 88, xlon)
        bits[pos] = sub

    vel = np.nonzero(kind == KINDS.index("vel"))[0]
    if len(vel):
        gs, trk = ac["gs"][vel], np.radians(ac["trk"][vel])
        ew, ns, vr = gs * np.sin(trk), gs * np.cos(trk), ac["vr"][vel]
        sub = bits[vel]
        _set(sub, 33, 37, np.full(len(vel), 19))
        _set(sub, 38, 40, np.ones(len(vel)))
        _set(sub, 46, 46, ew < 0)
        _set(sub, 47, 56, np.minimum(1023, np.round(np.abs(ew)).astype(np.int64) + 1))
        _set(sub, 57, 57, ns < 0)
        _set(sub, 58, 67, np.minimum(1023, np.round(np.abs(ns)).astype(np.int64) + 1))
        _set(sub, 68, 68, np.ones(len(vel)))
        _set(sub, 69, 69, vr < 0)
        _set(sub, 70, 78, np.minimum(511, np.round(np.abs(vr) / 64).astype(np.int64) + 1))
        bits[vel] = sub

    ident = np.nonzero(kind == KINDS.index("ident"))[0]
    if len(ident):
        a16 = addr[ident] & 0xFFFF
        digits = [(a16 >> s) & 0xF for s in (12, 8, 4, 0)]
        codes = [np.full(len(ident), AIS.index("T")), np.full(len(ident), AIS.index("R"))]
        codes += [np.where(d < 10, AIS.index("0") + d, AIS.index("A") + d - 10) for d in digits]
        codes += [np.full(len(ident), AIS.index(" "))] * 2
        sub = bits[ident]
        _set(sub, 33, 37, np.full(len(ident), 4))  # category set A
        _set(sub, 38, 40, np.full(len(ident), 3))
        for i, code in enumerate(codes):
            _set(sub, 41 + 6 * i, 46 + 6 * i, code)
        bits[ident] = sub

    # parity: the remainder of the data bits; DF4 overlays the address
    par_l = crc24.pack24(bits[:, :88].astype(np.float32) @ crc24.syndrome_matrix(112)[:88] % 2)
    par_s = crc24.pack24(bits[:, :32].astype(np.float32) @ crc24.syndrome_matrix(56)[:32] % 2)
    par_s = np.where(df == 4, par_s ^ addr, par_s)
    for rows, first, par in ((np.nonzero(long_)[0], 89, par_l), (np.nonzero(short)[0], 33, par_s)):
        sub = bits[rows]
        _set(sub, first, first + 23, par[rows])
        bits[rows] = sub
    return bits


def half_slots(bits: np.ndarray, long_: np.ndarray) -> np.ndarray:
    """uint8[M, 240]: which 0.5 us slots of each frame carry a pulse."""
    m = len(bits)
    hs = np.zeros((m, LONG_HALF_SLOTS), dtype=np.uint8)
    hs[:, [0, 2, 7, 9]] = 1  # preamble
    nb = np.where(long_, 112, 56)
    i = np.arange(112)
    on = i[None, :] < nb[:, None]
    col = 16 + 2 * i[None, :] + (1 - bits.astype(np.int64))
    r, c = np.nonzero(on)
    hs[r, col[r, c]] = 1
    return hs


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _envelopes(hs: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """float32[M, ENV_SAMPLES]: box averages of each frame's fine pulse
    train, delayed by `shift` fine steps."""
    fine = torch.arange(ENV_FINE, device=hs.device)[None, :] - shift[:, None]
    inside = (fine >= 0) & (fine < LONG_HALF_SLOTS * HALF_SLOT_FINE)
    slot = (fine // HALF_SLOT_FINE).clamp(0, LONG_HALF_SLOTS - 1)
    on = torch.gather(hs, 1, slot).to(torch.float32) * inside
    return on.reshape(len(hs), ENV_SAMPLES, OVERSAMPLE).mean(-1)


def render(traffic: dict, cfg: dict, seed: int, device) -> tuple[list[list[bytes]], np.ndarray]:
    """The cell's pool: pool[c][i] = bytes of channel c's superblock i, and
    the number of messages each channel's pool holds."""
    device = torch.device(device)
    n_chan = int(cfg["channels"])
    sb = int(cfg["block_samples"]) * int(cfg["blocks_per_batch"])
    n_sb = int(traffic["pool_superblocks"])
    n = sb * n_sb
    sched = schedule(traffic, n_chan, n / FS, seed)
    bits = encode(sched)
    long_ = sched["kind"] >= KINDS.index("pos_even")
    hs_all = half_slots(bits, long_)
    start_all = np.round(sched["t"] * FS).astype(np.int64)
    shift_all = np.round(sched["phase"] * OVERSAMPLE).astype(np.int64)
    counts = np.bincount(sched["chan"], minlength=n_chan)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    tt = torch.arange(n, dtype=torch.float64, device=device)
    arg = 2 * math.pi * torch.remainder(0.031 * tt, 1.0) + 0.7
    cos, sin = torch.cos(arg).to(torch.float32), torch.sin(arg).to(torch.float32)
    del tt, arg
    fmt = cfg["fmt"]
    group = int(cfg.get("render_group", 8))
    pool: list[list[bytes]] = []
    for c0 in range(0, n_chan, group):
        g = min(group, n_chan - c0)
        env = torch.zeros(g * n, dtype=torch.float32, device=device)
        sel = np.nonzero((sched["chan"] >= c0) & (sched["chan"] < c0 + g))[0]
        for s0 in range(0, len(sel), 16384):
            rows = sel[s0 : s0 + 16384]
            hs = torch.from_numpy(hs_all[rows].astype(np.int64)).to(device)
            shift = torch.from_numpy(shift_all[rows]).to(device)
            amp = torch.from_numpy(sched["amp"][rows]).to(device)
            wave = _envelopes(hs, shift) * amp[:, None]
            pos = torch.from_numpy(start_all[rows]).to(device)[:, None] + torch.arange(
                ENV_SAMPLES, device=device
            )
            base = torch.from_numpy((sched["chan"][rows] - c0) * n).to(device)[:, None]
            ok = pos < n
            env.scatter_reduce_(
                0, (base + pos.clamp(max=n - 1)).reshape(-1),
                (wave * ok).reshape(-1), reduce="amax",
            )
        env = env.view(g, n)
        noise = torch.randn((g, n, 2), generator=gen, device=device) * float(traffic["noise_rms"])
        i = env * cos + noise[..., 0]
        q = env * sin + noise[..., 1]
        del noise, env
        if fmt == "uc8":
            iq = torch.stack([i, q], -1).mul_(127.5).add_(127.5).round_().clamp_(0, 255)
            raw = iq.to(torch.uint8).reshape(g, -1).cpu().numpy()
        elif fmt == "sc16":
            iq = torch.stack([i, q], -1).mul_(32767.0).round_().clamp_(-32768, 32767)
            raw = iq.to(torch.int16).reshape(g, -1).cpu().numpy().view(np.uint8)
        else:
            raise ValueError(f"unknown sample format {fmt!r}")
        del i, q, iq
        per = raw.shape[1] // n_sb
        for c in range(g):
            pool.append([raw[c, j * per : (j + 1) * per].tobytes() for j in range(n_sb)])
    return pool, counts
