"""Synthetic Mode-S capture generator.

Builds 1090ES downlink waveforms (preamble + PPM bits) at 2.4 MS/s with
arbitrary sub-sample phase, embeds encoded DF11/DF17/DF4 frames from a
fleet of simulated aircraft (CPR-encoded positions, velocity, ident), adds
Gaussian noise, and renders UC8 or SC16 IQ plus a ground-truth list; Mode
A/C replies can be added to the same timeline.  Given the same arguments
it renders the same bytes as tools/synth.py, so a capture can be decoded
by both packages and the results compared.
"""

from __future__ import annotations

import json
import math

import numpy as np

from .ops import crc as crc_ops

SAMPLE_RATE = 2_400_000.0
BIT_US = 1.0  # Mode-S bit duration


# ---------------------------------------------------------------------------
# Frame encoding
# ---------------------------------------------------------------------------


def append_crc(data_bits_bytes: bytes, bits: int) -> bytes:
    """Set the trailing 24 parity bits so checksum() == 0."""
    msg = bytearray(data_bits_bytes)
    n = bits // 8
    msg[n - 3] = msg[n - 2] = msg[n - 1] = 0
    syn = crc_ops.checksum(bytes(msg), bits)
    msg[n - 3] = (syn >> 16) & 0xFF
    msg[n - 2] = (syn >> 8) & 0xFF
    msg[n - 1] = syn & 0xFF
    return bytes(msg)


def _setbits(msg: bytearray, firstbit1: int, lastbit1: int, value: int) -> None:
    """Set bits [firstbit1..lastbit1] (1-based, MSB first) to value."""
    nbits = lastbit1 - firstbit1 + 1
    for i in range(nbits):
        bit = firstbit1 - 1 + i
        b = (value >> (nbits - 1 - i)) & 1
        if b:
            msg[bit >> 3] |= 1 << (7 - (bit & 7))
        else:
            msg[bit >> 3] &= ~(1 << (7 - (bit & 7)))


def cpr_nl(lat: float) -> int:
    if lat < 0:
        lat = -lat
    if lat < 10.47047130:
        return 59
    if lat > 87.0:
        return 1 if lat > 90.0 else 2
    nz = 15.0
    a = 1 - math.cos(math.pi / (2 * nz))
    b = math.cos(math.pi / 180.0 * lat) ** 2
    nl = 2 * math.pi / (math.acos(1 - a / b))
    return int(math.floor(nl))


def cpr_encode_airborne(lat: float, lon: float, odd: int) -> tuple[int, int]:
    """ICAO Annex 10 CPR airborne encoding -> (17-bit lat, 17-bit lon)."""
    nb = 17
    dlat = 360.0 / (60 - odd)
    yz = math.floor(2**nb * ((lat % dlat) / dlat) + 0.5)
    rlat = dlat * (yz / 2**nb + math.floor(lat / dlat))
    nl = cpr_nl(rlat) - odd
    dlon = 360.0 / nl if nl > 0 else 360.0
    xz = math.floor(2**nb * ((lon % dlon) / dlon) + 0.5)
    return int(yz) & 0x1FFFF, int(xz) & 0x1FFFF


def altitude_to_ac12(alt_ft: float) -> int:
    """12-bit AC altitude code with Q=1 (25 ft resolution)."""
    n = int(round((alt_ft + 1000) / 25))
    n = max(0, min(n, 0x7FF))
    return ((n & 0x7F0) << 1) | 0x010 | (n & 0x00F)


AIS_CHARSET = "?ABCDEFGHIJKLMNOPQRSTUVWXYZ????? ???????????????0123456789??????"


def encode_df17_position(addr: int, lat: float, lon: float, alt_ft: float, odd: int,
                         metype: int = 11, nic_b: int = 0) -> bytes:
    msg = bytearray(14)
    _setbits(msg, 1, 5, 17)
    _setbits(msg, 6, 8, 5)  # CA = airborne
    _setbits(msg, 9, 32, addr)
    me_first = 33
    _setbits(msg, me_first, me_first + 4, metype)  # airborne position metype
    # surveillance status 0, NIC-B (ME bit 8, mode_s.c:1048)
    _setbits(msg, me_first + 5, me_first + 6, 0)
    _setbits(msg, me_first + 7, me_first + 7, nic_b)
    _setbits(msg, me_first + 8, me_first + 19, altitude_to_ac12(alt_ft))
    _setbits(msg, me_first + 20, me_first + 20, 0)  # time bit
    _setbits(msg, me_first + 21, me_first + 21, odd)
    ylat, xlon = cpr_encode_airborne(lat, lon, odd)
    _setbits(msg, me_first + 22, me_first + 38, ylat)
    _setbits(msg, me_first + 39, me_first + 55, xlon)
    return append_crc(bytes(msg), 112)


def encode_df17_velocity(addr: int, gs_kt: float, track_deg: float, vr_fpm: float) -> bytes:
    msg = bytearray(14)
    _setbits(msg, 1, 5, 17)
    _setbits(msg, 6, 8, 5)
    _setbits(msg, 9, 32, addr)
    me = 33
    _setbits(msg, me, me + 4, 19)  # metype 19
    _setbits(msg, me + 5, me + 7, 1)  # subtype 1: ground velocity
    ew = gs_kt * math.sin(math.radians(track_deg))
    ns = gs_kt * math.cos(math.radians(track_deg))
    ew_sign = 1 if ew < 0 else 0
    ns_sign = 1 if ns < 0 else 0
    ew_v = min(1023, int(round(abs(ew))) + 1)  # 10-bit field: raw <= 1023
    ns_v = min(1023, int(round(abs(ns))) + 1)
    _setbits(msg, me + 13, me + 13, ew_sign)
    _setbits(msg, me + 14, me + 23, ew_v)
    _setbits(msg, me + 24, me + 24, ns_sign)
    _setbits(msg, me + 25, me + 34, ns_v)
    vr_sign = 1 if vr_fpm < 0 else 0
    vr_v = min(511, int(round(abs(vr_fpm) / 64)) + 1)  # 9-bit field
    _setbits(msg, me + 35, me + 35, 1)  # VR source: baro
    _setbits(msg, me + 36, me + 36, vr_sign)
    _setbits(msg, me + 37, me + 45, vr_v)
    return append_crc(bytes(msg), 112)


def encode_df17_ident(addr: int, callsign: str, category: int = 0xA3) -> bytes:
    msg = bytearray(14)
    _setbits(msg, 1, 5, 17)
    _setbits(msg, 6, 8, 5)
    _setbits(msg, 9, 32, addr)
    me = 33
    tc = 4 - ((category >> 4) - 0xA)  # category set A -> metype 4
    _setbits(msg, me, me + 4, tc)
    _setbits(msg, me + 5, me + 7, category & 7)
    cs = (callsign + "        ")[:8]
    for i, ch in enumerate(cs):
        code = AIS_CHARSET.index(ch) if ch in AIS_CHARSET else 32
        _setbits(msg, me + 8 + 6 * i, me + 13 + 6 * i, code)
    return append_crc(bytes(msg), 112)


def encode_df11(addr: int, ca: int = 5) -> bytes:
    msg = bytearray(7)
    _setbits(msg, 1, 5, 11)
    _setbits(msg, 6, 8, ca)
    _setbits(msg, 9, 32, addr)
    return append_crc(bytes(msg), 56)


def encode_df4(addr: int, alt_ft: float) -> bytes:
    """DF4 altitude reply; parity overlaid with the address (AP field)."""
    msg = bytearray(7)
    _setbits(msg, 1, 5, 4)
    _setbits(msg, 6, 8, 0)  # FS airborne
    _setbits(msg, 9, 13, 0)
    _setbits(msg, 14, 19, 0)
    n = int(round((alt_ft + 1000) / 25))
    n = max(0, min(n, 0x7FF))
    # AC13 with Q (bit 8 of the 13-bit field), M=0
    ac13 = ((n & 0x7F0) << 2) | 0x040 | (n & 0x00F)
    _setbits(msg, 20, 32, ac13)
    base = append_crc(bytes(msg), 56)
    out = bytearray(base)
    out[4] ^= (addr >> 16) & 0xFF
    out[5] ^= (addr >> 8) & 0xFF
    out[6] ^= addr & 0xFF
    return bytes(out)


# ---------------------------------------------------------------------------
# Modulation
# ---------------------------------------------------------------------------


def frame_envelope(msg: bytes, nbits: int, fs: float = SAMPLE_RATE, phase: float = 0.0,
                   oversample: int = 10) -> np.ndarray:
    """Amplitude envelope of preamble + PPM-modulated message.

    Rendered on a fine grid (oversample x fs) then box-averaged down to the
    sample grid; `phase` in [0,1) shifts the waveform by a fraction of a
    sample to exercise all 5 demod phases.
    """
    total_us = 8.0 + nbits * BIT_US
    fine_rate = fs * oversample
    n_fine = int(total_us * 1e-6 * fine_rate) + oversample * 4
    env = np.zeros(n_fine, dtype=np.float32)

    def pulse(start_us: float, dur_us: float = 0.5):
        a = int(round(start_us * 1e-6 * fine_rate))
        b = int(round((start_us + dur_us) * 1e-6 * fine_rate))
        env[a:b] = 1.0

    # preamble pulses at 0, 1.0, 3.5, 4.5 us
    for t in (0.0, 1.0, 3.5, 4.5):
        pulse(t)
    # data bits: 1 -> pulse in first half, 0 -> pulse in second half
    for i in range(nbits):
        bit = (msg[i >> 3] >> (7 - (i & 7))) & 1
        t0 = 8.0 + i * BIT_US + (0.0 if bit else 0.5)
        pulse(t0)

    shift = int(round(phase * oversample))
    if shift:
        env = np.concatenate([np.zeros(shift, dtype=np.float32), env])[: len(env)]
    n_out = len(env) // oversample
    return env[: n_out * oversample].reshape(n_out, oversample).mean(axis=1)


MODEAC_BIT_US = 1.45

# bit index -> modeA hex-code bit (demod_2400.c:585-606 framing layout)
_MODEAC_BIT_SRC = {
    1: 0x0010, 2: 0x1000, 3: 0x0020, 4: 0x2000, 5: 0x0040, 6: 0x4000,
    8: 0x0100, 9: 0x0001, 10: 0x0200, 11: 0x0002, 12: 0x0400, 13: 0x0004,
    17: 0x0080,
}


def modeac_envelope(modea: int, fs: float = SAMPLE_RATE, phase: float = 0.0,
                    oversample: int = 10) -> np.ndarray:
    """Amplitude envelope of a Mode A/C reply: F1/F2 framing pulses plus
    the code pulses, 0.45us wide on a 1.45us bit grid."""
    total_us = 20 * MODEAC_BIT_US + 2.0
    fine_rate = fs * oversample
    n_fine = int(total_us * 1e-6 * fine_rate) + oversample * 4
    env = np.zeros(n_fine, dtype=np.float32)

    def pulse(start_us: float, dur_us: float = 0.45):
        a = int(round(start_us * 1e-6 * fine_rate))
        b = int(round((start_us + dur_us) * 1e-6 * fine_rate))
        env[a:b] = 1.0

    for bit in range(20):
        on = bit in (0, 14) or bool(modea & _MODEAC_BIT_SRC.get(bit, 0))
        if on:
            pulse(bit * MODEAC_BIT_US)

    shift = int(round(phase * oversample))
    if shift:
        env = np.concatenate([np.zeros(shift, dtype=np.float32), env])[: len(env)]
    n_out = len(env) // oversample
    return env[: n_out * oversample].reshape(n_out, oversample).mean(axis=1)


def quantize_uc8(iq: np.ndarray) -> np.ndarray:
    """Complex IQ -> interleaved uint8 I/Q bytes (2 per sample)."""
    out = np.empty(len(iq) * 2, dtype=np.uint8)
    out[0::2] = np.clip(np.round(iq.real * 127.5 + 127.5), 0, 255).astype(np.uint8)
    out[1::2] = np.clip(np.round(iq.imag * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return out


def quantize_sc16(iq: np.ndarray) -> np.ndarray:
    """Complex IQ -> interleaved little-endian int16 I/Q (2 per sample)."""
    out = np.empty(len(iq) * 2, dtype="<i2")
    out[0::2] = np.clip(np.round(iq.real * 32767), -32768, 32767).astype("<i2")
    out[1::2] = np.clip(np.round(iq.imag * 32767), -32768, 32767).astype("<i2")
    return out


class CaptureBuilder:
    """Accumulates frames on a timeline, then renders IQ."""

    def __init__(self, duration_s: float, noise_rms: float = 0.015, seed: int = 1):
        self.fs = SAMPLE_RATE
        self.n = int(duration_s * self.fs)
        self.env = np.zeros(self.n, dtype=np.float32)
        self.noise_rms = noise_rms
        self.rng = np.random.default_rng(seed)
        self.truth: list[dict] = []

    def add_frame(self, msg: bytes, t_s: float, amplitude: float = 0.4,
                  phase: float | None = None) -> None:
        nbits = len(msg) * 8
        if phase is None:
            phase = self.rng.uniform(0, 1)
        wave = frame_envelope(msg, nbits, self.fs, phase) * amplitude
        start = int(round(t_s * self.fs))
        end = min(start + len(wave), self.n)
        if start >= self.n:
            return
        self.env[start:end] = np.maximum(self.env[start:end], wave[: end - start])
        self.truth.append(
            {"t": t_s, "hex": msg.hex(), "bits": nbits, "amp": amplitude, "phase": phase}
        )

    def add_modeac(self, modea: int, t_s: float, amplitude: float = 0.4,
                   phase: float | None = None) -> None:
        if phase is None:
            phase = self.rng.uniform(0, 1)
        wave = modeac_envelope(modea, self.fs, phase) * amplitude
        start = int(round(t_s * self.fs))
        end = min(start + len(wave), self.n)
        if start >= self.n:
            return
        self.env[start:end] = np.maximum(self.env[start:end], wave[: end - start])
        self.truth.append(
            {"t": t_s, "modeac": modea, "amp": amplitude, "phase": phase}
        )

    def render_iq(self) -> np.ndarray:
        """Complex float IQ: carrier at a small offset + Gaussian noise."""
        t = np.arange(self.n, dtype=np.float64)
        # small carrier offset so I/Q both carry signal
        carrier = np.exp(1j * (2 * np.pi * 0.031 * t + 0.7))
        iq = self.env.astype(np.complex128) * carrier
        iq += self.rng.normal(0, self.noise_rms, self.n) + 1j * self.rng.normal(
            0, self.noise_rms, self.n
        )
        return iq

    def render_uc8(self) -> np.ndarray:
        """Interleaved uint8 I/Q bytes (2 per sample) of render_iq()."""
        return quantize_uc8(self.render_iq())

    def render_sc16(self) -> np.ndarray:
        """Interleaved little-endian int16 I/Q (2 per sample) of render_iq().
        Every render draws fresh noise: quantize one render_iq() both ways
        for the same capture in two formats."""
        return quantize_sc16(self.render_iq())

    def write_uc8(self, path: str) -> None:
        self.render_uc8().tofile(path)

    def write_sc16(self, path: str) -> None:
        self.render_sc16().tofile(path)

    def write_truth(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.truth, f, indent=1)


def build_standard_capture(duration_s: float = 2.0, n_aircraft: int = 6, seed: int = 7,
                           noise_rms: float = 0.015) -> CaptureBuilder:
    """A deterministic multi-aircraft scene: DF11 + DF17 pos/vel/ident + DF4."""
    cap = CaptureBuilder(duration_s, noise_rms=noise_rms, seed=seed)
    rng = np.random.default_rng(seed)
    for a in range(n_aircraft):
        addr = 0x400000 + a * 0x1111
        lat0 = 47.0 + a * 0.3
        lon0 = 8.0 + a * 0.5
        alt = 10000 + a * 2000
        gs = 250 + 10 * a
        trk = (a * 60.0) % 360
        t = rng.uniform(0.02, 0.10)
        k = 0
        while t < duration_s - 0.01:
            kind = k % 5
            # real kinematics: gs kt -> m/s -> degrees (111.32 km/deg)
            mps = gs * 0.514444
            lat = lat0 + mps * math.cos(math.radians(trk)) * t / 111320.0
            lon = lon0 + mps * math.sin(math.radians(trk)) * t / (
                111320.0 * math.cos(math.radians(lat0))
            )
            if kind == 0:
                msg = encode_df11(addr)
            elif kind in (1, 3):
                msg = encode_df17_position(addr, lat, lon, alt, odd=k % 2)
            elif kind == 2:
                msg = encode_df17_velocity(addr, gs, trk, vr_fpm=(a - 2) * 320)
            else:
                msg = encode_df17_ident(addr, f"TPU{a:03d}", 0xA3)
            amp = 0.25 + 0.1 * ((a + k) % 4)
            cap.add_frame(msg, t, amplitude=amp)
            if kind == 1 and a % 2 == 0:
                cap.add_frame(encode_df4(addr, alt), t + 0.012, amplitude=amp)
            t += rng.uniform(0.06, 0.14)
            k += 1
    return cap


def build_traffic_capture(duration_s: float = 2.0, n_aircraft: int = 12, seed: int = 7,
                          addr_base: int = 0x400000,
                          noise_rms: float = 0.015) -> CaptureBuilder:
    """A denser scene for the app: each aircraft, from address addr_base
    on, sends DF11, odd and even DF17 positions in turn (so global CPR
    decodes within a fraction of a second), velocity, and ident or DF4,
    one every 30-80 ms, moving at its ground speed.  The seed sets the
    noise and the message times; the tracks depend on the aircraft's
    index only, so receivers with one addr_base see the same aircraft."""
    cap = CaptureBuilder(duration_s, noise_rms=noise_rms, seed=seed)
    rng = np.random.default_rng(seed)
    for a in range(n_aircraft):
        addr = addr_base + 0x101 * (a + 1)
        lat0 = 46.0 + 0.13 * a
        lon0 = 6.0 + 0.21 * a
        alt = 3000 + 1000 * (a % 30)
        gs = 180 + 7 * (a % 40)
        trk = (a * 37.0 + seed) % 360
        t = rng.uniform(0.005, 0.05)
        k = 0
        while t < duration_s - 0.01:
            mps = gs * 0.514444
            lat = lat0 + mps * math.cos(math.radians(trk)) * t / 111320.0
            lon = lon0 + mps * math.sin(math.radians(trk)) * t / (
                111320.0 * math.cos(math.radians(lat0))
            )
            kind = k % 5
            if kind == 0:
                msg = encode_df11(addr)
            elif kind in (1, 3):
                msg = encode_df17_position(addr, lat, lon, alt, odd=int(kind == 3))
            elif kind == 2:
                msg = encode_df17_velocity(addr, gs, trk, vr_fpm=((a % 7) - 3) * 256)
            elif k % 10 == 4:
                msg = encode_df17_ident(addr, f"TR{addr & 0xFFFF:04X}", 0xA3)
            else:
                msg = encode_df4(addr, alt)
            cap.add_frame(msg, t, amplitude=0.2 + 0.1 * ((a + k) % 5))
            t += rng.uniform(0.03, 0.08)
            k += 1
    return cap
