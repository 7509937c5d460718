"""Hardware sample sources: rtl-sdr USB dongles and Beast serial receivers.

A copy of readsb_tpu's `io/sdr.py`, with readsb_tpu's names.  One fault
of readsb_tpu is not copied: its HackRF callback reads `np`, which that
module never imports, so every HackRF transfer raised NameError inside
the ctypes callback; numpy is imported here.

The demodulator consumes host byte buffers, so hardware capture is a
pure host producer: a reader thread fills fixed-size UC8 buffers and
hands them to the asyncio app, which feeds the Demodulator exactly like
ifile replay.  Behavior modeled on the reference backends:

- rtl-sdr: device open by index or serial, tuner gain / AGC, center
  frequency, ppm correction, bias tee, 16 x 256 KiB buffer ring
  (reference sdr_rtlsdr.c:86-266,419, readsb.h:112).  Bound with ctypes
  against librtlsdr; when the library is absent `RtlSdrSource.available()`
  is False and the CLI reports a clear error instead of crashing.
- Mode-S Beast serial: raw tty at 3 Mbaud (1 Mbaud fallback), receiver
  options sent as 0x1a '1' <opt> frames — binary format, mlat
  timestamps, CRC check, DF filters, Mode A/C — then the byte stream is
  Beast-deframed by the existing io.beast machinery
  (reference sdr_beast.c:34-40,130-232).
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import os
import threading
from dataclasses import dataclass, field

import numpy as np

SDR_BUF_BYTES = 16 * 16384  # reference sdr_buf_size granule
SDR_N_BUFFERS = 16  # reference MODES_RTL_BUFFERS (readsb.h:112)

# rtl-sdr tuner gain steps in tenths of dB (reference help.h gain table)
RTL_GAINS = [
    0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207, 229, 254,
    280, 297, 328, 338, 364, 372, 386, 402, 421, 434, 439, 445, 480,
    496, 580,
]


def _load_librtlsdr():
    name = ctypes.util.find_library("rtlsdr")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.rtlsdr_open  # sanity: the symbol surface we need
        return lib
    except OSError:
        return None


@dataclass
class RtlSdrSource:
    """Streams UC8 IQ buffers from an rtl-sdr dongle into an asyncio queue."""

    device: str = "0"  # index, or serial string (reference verbose_device_search)
    gain_db: float | None = None  # None => max gain; <= -10 => AGC
    freq_hz: int = 1_090_000_000
    ppm: int = 0
    biastee: bool = False
    sample_rate: int = 2_400_000
    buf_bytes: int = SDR_BUF_BYTES
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=SDR_N_BUFFERS))

    _lib = None
    _dev = None
    _stop: threading.Event = field(default_factory=threading.Event)
    dropped_buffers: int = 0

    @staticmethod
    def available() -> bool:
        return _load_librtlsdr() is not None

    def open(self) -> None:
        lib = _load_librtlsdr()
        if lib is None:
            raise RuntimeError(
                "librtlsdr not found — rtl-sdr capture unavailable on this host"
            )
        self._lib = lib
        idx = self._resolve_index(lib)
        dev = ctypes.c_void_p()
        if lib.rtlsdr_open(ctypes.byref(dev), idx) < 0:
            raise RuntimeError(f"rtlsdr_open({idx}) failed")
        self._dev = dev
        # gain: explicit value snaps to the nearest tuner step; -10 => AGC;
        # unset => maximum (reference rtlsdrSetGain, sdr_rtlsdr.c:86-131)
        if self.gain_db is not None and self.gain_db <= -10:
            lib.rtlsdr_set_tuner_gain_mode(dev, 0)
        else:
            lib.rtlsdr_set_tuner_gain_mode(dev, 1)
            want = int(round((self.gain_db if self.gain_db is not None else 999) * 10))
            step = min(RTL_GAINS, key=lambda g: abs(g - want))
            lib.rtlsdr_set_tuner_gain(dev, step)
        if self.ppm:
            lib.rtlsdr_set_freq_correction(dev, int(self.ppm))
        lib.rtlsdr_set_center_freq(dev, int(self.freq_hz))
        lib.rtlsdr_set_sample_rate(dev, int(self.sample_rate))
        try:
            lib.rtlsdr_set_bias_tee(dev, 1 if self.biastee else 0)
        except AttributeError:
            pass  # older librtlsdr without bias-tee support
        lib.rtlsdr_reset_buffer(dev)

    def _resolve_index(self, lib) -> int:
        # bare integer = device index; otherwise match by serial
        try:
            return int(self.device)
        except ValueError:
            pass
        lib.rtlsdr_get_index_by_serial.argtypes = [ctypes.c_char_p]
        idx = lib.rtlsdr_get_index_by_serial(self.device.encode())
        if idx < 0:
            raise RuntimeError(f"no rtl-sdr device with serial {self.device!r}")
        return idx

    def start(self, loop: asyncio.AbstractEventLoop) -> threading.Thread:
        """Reader thread: blocking rtlsdr_read_sync into the asyncio queue.

        A full queue drops the oldest buffer (the demod is behind realtime;
        shedding whole buffers keeps sample alignment per buffer boundary).
        """
        lib, dev = self._lib, self._dev

        def reader():
            buf = ctypes.create_string_buffer(self.buf_bytes)
            n_read = ctypes.c_int(0)
            while not self._stop.is_set():
                r = lib.rtlsdr_read_sync(dev, buf, self.buf_bytes, ctypes.byref(n_read))
                if r < 0:
                    break  # USB gone — app-level watchdog restarts or exits
                data = buf.raw[: n_read.value]
                loop.call_soon_threadsafe(self._push, data)
            loop.call_soon_threadsafe(self.queue.put_nowait, b"")  # EOF marker

        t = threading.Thread(target=reader, name="rtlsdr-reader", daemon=True)
        t.start()
        self._thread = t
        return t

    def _push(self, data: bytes) -> None:
        if self.queue.full():
            try:
                self.queue.get_nowait()
                self.dropped_buffers += 1
            except asyncio.QueueEmpty:
                pass
        self.queue.put_nowait(data)

    def close(self) -> None:
        # rtlsdr_cancel_async does NOT interrupt a synchronous read, so the
        # reader thread may still be inside rtlsdr_read_sync on this handle;
        # closing under it is a use-after-free.  Signal stop, wait for the
        # in-flight read to return (one buffer period, ~55 ms), then close.
        self._stop.set()
        t = getattr(self, "_thread", None)
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        if self._lib is not None and self._dev is not None:
            try:
                self._lib.rtlsdr_cancel_async(self._dev)
            except AttributeError:
                pass
            self._lib.rtlsdr_close(self._dev)
            self._dev = None


def _load_libsoapy():
    name = ctypes.util.find_library("SoapySDR")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.SoapySDRDevice_makeStrArgs
        return lib
    except OSError:
        return None


@dataclass
class SoapySource:
    """SoapySDR capture (sdr_soapy.c behavior): device by args string,
    CS16 stream at 2.4 MS/s resampled to the UC8 pipeline via the SC16
    input format.  Gated on libSoapySDR presence like RtlSdrSource."""

    device_args: str = ""
    gain_db: float | None = None  # None/<=-10 => hardware AGC
    freq_hz: int = 1_090_000_000
    sample_rate: int = 2_400_000
    antenna: str | None = None
    bandwidth: float | None = None
    gain_elements: list = field(default_factory=list)  # "ELEMENT:DB" strings
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=SDR_N_BUFFERS))
    _lib = None
    _dev = None
    _stream = None
    _stop: threading.Event = field(default_factory=threading.Event)
    dropped_buffers: int = 0

    SOAPY_SDR_RX = 1  # SoapySDR/Constants.h

    @staticmethod
    def available() -> bool:
        return _load_libsoapy() is not None

    def open(self) -> None:
        lib = _load_libsoapy()
        if lib is None:
            raise RuntimeError(
                "libSoapySDR not found — soapy capture unavailable on this host"
            )
        self._lib = lib
        lib.SoapySDRDevice_makeStrArgs.restype = ctypes.c_void_p
        dev = lib.SoapySDRDevice_makeStrArgs(self.device_args.encode())
        if not dev:
            raise RuntimeError(f"soapy: no device for args {self.device_args!r}")
        self._dev = ctypes.c_void_p(dev)
        ch = 0
        lib.SoapySDRDevice_setSampleRate(
            self._dev, self.SOAPY_SDR_RX, ch, ctypes.c_double(self.sample_rate)
        )
        lib.SoapySDRDevice_setFrequency(
            self._dev, self.SOAPY_SDR_RX, ch, ctypes.c_double(self.freq_hz), None
        )
        if self.antenna:
            lib.SoapySDRDevice_setAntenna(
                self._dev, self.SOAPY_SDR_RX, ch, self.antenna.encode()
            )
        if self.bandwidth:
            lib.SoapySDRDevice_setBandwidth(
                self._dev, self.SOAPY_SDR_RX, ch, ctypes.c_double(self.bandwidth)
            )
        for element in self.gain_elements:
            # "<element>:<db>" (sdr_soapy.c:306-330)
            name, _, db = element.partition(":")
            if not db:
                raise RuntimeError(
                    f"soapy: gain element {element!r} must be <element>:<db>"
                )
            lib.SoapySDRDevice_setGainElement(
                self._dev, self.SOAPY_SDR_RX, ch, name.encode(),
                ctypes.c_double(float(db)),
            )
        if self.gain_db is None or self.gain_db <= -10:
            lib.SoapySDRDevice_setGainMode(self._dev, self.SOAPY_SDR_RX, ch, 1)
        else:
            lib.SoapySDRDevice_setGainMode(self._dev, self.SOAPY_SDR_RX, ch, 0)
            lib.SoapySDRDevice_setGain(
                self._dev, self.SOAPY_SDR_RX, ch, ctypes.c_double(self.gain_db)
            )
        lib.SoapySDRDevice_setupStream.restype = ctypes.c_void_p
        chans = (ctypes.c_size_t * 1)(ch)
        self._stream = ctypes.c_void_p(
            lib.SoapySDRDevice_setupStream(
                self._dev, self.SOAPY_SDR_RX, b"CS16", chans, 1, None
            )
        )
        if not self._stream:
            raise RuntimeError("soapy: setupStream(CS16) failed")
        lib.SoapySDRDevice_activateStream(self._dev, self._stream, 0, 0, 0)

    def start(self, loop: asyncio.AbstractEventLoop) -> threading.Thread:
        lib, dev, stream = self._lib, self._dev, self._stream
        n_samples = SDR_BUF_BYTES // 4  # CS16 = 4 bytes/sample

        def reader():
            buf = (ctypes.c_int16 * (2 * n_samples))()
            bufs = (ctypes.c_void_p * 1)(ctypes.addressof(buf))
            flags = ctypes.c_int(0)
            time_ns = ctypes.c_longlong(0)
            while not self._stop.is_set():
                n = lib.SoapySDRDevice_readStream(
                    dev, stream, bufs, n_samples,
                    ctypes.byref(flags), ctypes.byref(time_ns), 1_000_000,
                )
                if n <= 0:
                    if n == -1:  # SOAPY_SDR_TIMEOUT
                        continue
                    break
                data = ctypes.string_at(buf, n * 4)
                loop.call_soon_threadsafe(self._push, data)
            loop.call_soon_threadsafe(self.queue.put_nowait, b"")

        t = threading.Thread(target=reader, name="soapy-reader", daemon=True)
        t.start()
        return t

    _push = RtlSdrSource._push

    def close(self) -> None:
        self._stop.set()
        if self._lib is not None and self._dev is not None:
            if self._stream is not None:
                self._lib.SoapySDRDevice_deactivateStream(self._dev, self._stream, 0, 0)
                self._lib.SoapySDRDevice_closeStream(self._dev, self._stream)
                self._stream = None
            self._lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None


@dataclass
class BeastSerialSource:
    """Raw-tty Beast receiver: configures the port + receiver options and
    exposes the file descriptor for the app's Beast deframer."""

    path: str = "/dev/ttyUSB0"
    baud: int = 3_000_000
    mlat_timestamps: bool = True
    crc_checks: bool = True
    fec: bool = True
    filter_df1117: bool = False
    filter_df045: bool = False
    mode_ac: bool = False
    # GNS5894/HULC receiver (--device-type gnshulc, SDR_GNS): same serial
    # Beast framing, but 921600 baud and no Beast option commands; instead
    # a firmware request is sent (sdr_beast.c:162-164,231-247)
    gns: bool = False
    fd: int = -1

    def open(self) -> int:
        import termios

        self.fd = os.open(self.path, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        tios = termios.tcgetattr(self.fd)
        # raw 8N1, no flow control (reference sdr_beast.c:160-190)
        tios[0] = termios.IGNPAR  # iflag
        tios[1] = 0  # oflag
        tios[2] = termios.CS8 | termios.CREAD | termios.CLOCAL  # cflag
        tios[3] = 0  # lflag
        for b in (self.baud, 1_000_000, 115_200):
            code = getattr(termios, f"B{b}", None)
            if code is None:
                continue
            tios[4] = tios[5] = code
            try:
                termios.tcsetattr(self.fd, termios.TCSANOW, tios)
                self.baud = b
                break
            except termios.error:
                continue
        termios.tcflush(self.fd, termios.TCIOFLUSH)
        if self.gns:
            # request firmware message from GNS HULC (sdr_beast.c:231-237)
            os.write(self.fd, b"#00\r")
        else:
            for opt in self._options():
                os.write(self.fd, bytes([0x1A, ord("1"), ord(opt)]))
        return self.fd

    def _options(self) -> str:
        # case selects enable/disable, mirroring beastInit (sdr_beast.c:192-232)
        opts = ["B", "C", "H"]  # classic beast, binary format, RTS
        opts.append("D" if self.filter_df1117 else "d")
        opts.append("E" if self.mlat_timestamps else "e")
        opts.append("f" if self.crc_checks else "F")
        opts.append("G" if self.filter_df045 else "g")
        opts.append("i" if self.fec else "I")
        opts.append("J" if self.mode_ac else "j")
        return "".join(opts)

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


# ---------------------------------------------------------------------------
# HackRF (sdr_hackrf.c): libhackrf async RX, signed-8 IQ -> UC8
# ---------------------------------------------------------------------------


def _load_lib(name: str, probe: str):
    libname = ctypes.util.find_library(name)
    if not libname:
        return None
    try:
        lib = ctypes.CDLL(libname)
        getattr(lib, probe)
        return lib
    except (OSError, AttributeError):
        return None


@dataclass
class HackRfSource:
    """HackRF capture (sdr_hackrf.c:65-180 behaviors): async RX callback,
    LNA gain in 8 dB steps, VGA gain 0-62 in 2 dB steps, optional RF amp.
    Samples are interleaved signed-8 IQ; the reader rebiases to UC8."""

    device: str | None = None
    freq_hz: int = 1_090_000_000
    sample_rate: int = 2_400_000
    gain_db: float | None = None  # LNA gain; reference clamps 0..40
    vga_gain: int = 48  # --hackrf-vgagain
    enable_amp: bool = False  # --hackrf-enable-ampgain
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=SDR_N_BUFFERS))

    _lib = None
    _dev = None
    _cb = None
    dropped_buffers: int = 0

    @staticmethod
    def available() -> bool:
        return _load_lib("hackrf", "hackrf_init") is not None

    def open(self) -> None:
        lib = _load_lib("hackrf", "hackrf_init")
        if lib is None:
            raise RuntimeError(
                "libhackrf not found — HackRF capture unavailable on this "
                "host (install libhackrf, or use --device-type ifile/rtlsdr/soapy)"
            )
        self._lib = lib
        if lib.hackrf_init() != 0:
            raise RuntimeError("hackrf_init failed")
        dev = ctypes.c_void_p()
        if self.device:
            rc = lib.hackrf_open_by_serial(self.device.encode(), ctypes.byref(dev))
        else:
            rc = lib.hackrf_open(ctypes.byref(dev))
        if rc != 0:
            raise RuntimeError("hackrf_open failed")
        self._dev = dev
        lib.hackrf_set_sample_rate.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.hackrf_set_sample_rate(dev, float(self.sample_rate))
        lib.hackrf_set_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hackrf_set_freq(dev, self.freq_hz)
        # gain handling mirrors hackRFOpen: auto/overrange -> max (40 dB),
        # rounded down to the 8 dB LNA step; VGA in 2 dB steps
        g = 40.0 if self.gain_db is None or self.gain_db >= 40 else max(0.0, self.gain_db)
        lib.hackrf_set_amp_enable(dev, 1 if self.enable_amp else 0)
        lib.hackrf_set_lna_gain(dev, int(g) // 8 * 8)
        lib.hackrf_set_vga_gain(dev, max(0, min(62, self.vga_gain)) // 2 * 2)

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        lib, dev = self._lib, self._dev

        # transfer callback: struct hackrf_transfer { device*, buffer*,
        # buffer_length, valid_length, ... } — only the head is needed
        class _Transfer(ctypes.Structure):
            _fields_ = [
                ("device", ctypes.c_void_p),
                ("buffer", ctypes.POINTER(ctypes.c_uint8)),
                ("buffer_length", ctypes.c_int),
                ("valid_length", ctypes.c_int),
            ]

        CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_Transfer))

        def on_rx(tr):
            t = tr.contents
            n = t.valid_length
            raw = np.ctypeslib.as_array(t.buffer, shape=(n,))
            # signed-8 IQ -> UC8 rebias (sdr_hackrf.c converts via +128)
            data = (raw.astype(np.int16) + 128).astype(np.uint8).tobytes()
            loop.call_soon_threadsafe(self._push, data)
            return 0

        self._cb = CB(on_rx)  # keep a reference: ctypes must not GC it
        if lib.hackrf_start_rx(dev, self._cb, None) != 0:
            raise RuntimeError("hackrf_start_rx failed")

    def _push(self, data: bytes) -> None:
        if self.queue.full():
            try:
                self.queue.get_nowait()
                self.dropped_buffers += 1
            except asyncio.QueueEmpty:
                pass
        self.queue.put_nowait(data)

    def close(self) -> None:
        if self._lib is not None and self._dev is not None:
            self._lib.hackrf_stop_rx(self._dev)
            self._lib.hackrf_close(self._dev)
            self._lib.hackrf_exit()
            self._dev = None


# ---------------------------------------------------------------------------
# bladeRF (sdr_bladerf.c): libbladeRF sync RX, SC16Q11
# ---------------------------------------------------------------------------


@dataclass
class BladeRfSource:
    """bladeRF capture (sdr_bladerf.c): synchronous SC16_Q11 RX stream;
    optional FPGA image load, decimation and LPF bandwidth overrides."""

    device: str | None = None  # bladerf device identifier string
    freq_hz: int = 1_090_000_000
    sample_rate: int = 2_400_000
    fpga_path: str | None = None  # --bladerf-fpga
    decimation: int = 1  # --bladerf-decimation
    bandwidth: str | None = None  # --bladerf-bandwidth (hz or 'bypass')
    # bladeRF 2.0 Micro variant (--device-type ubladerf, sdr_ubladerf.c):
    # USB reset on open, manual overall gain, RX bias tee
    micro: bool = False
    gain_db: float | None = None
    biastee: bool = False
    buf_samples: int = SDR_BUF_BYTES // 4
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=SDR_N_BUFFERS))

    _lib = None
    _dev = None
    _stop: threading.Event = field(default_factory=threading.Event)
    dropped_buffers: int = 0

    @staticmethod
    def available() -> bool:
        return _load_lib("bladeRF", "bladerf_open") is not None

    def open(self) -> None:
        lib = _load_lib("bladeRF", "bladerf_open")
        if lib is None:
            raise RuntimeError(
                "libbladeRF not found — bladeRF capture unavailable on this "
                "host (install libbladeRF, or use --device-type ifile/rtlsdr/soapy)"
            )
        self._lib = lib
        if self.micro:
            # sdr_ubladerf.c:172 resets the USB device before opening
            try:
                lib.bladerf_set_usb_reset_on_open(True)
            except AttributeError:
                pass
        dev = ctypes.c_void_p()
        if lib.bladerf_open(ctypes.byref(dev), (self.device or "").encode() or None) != 0:
            raise RuntimeError("bladerf_open failed")
        self._dev = dev
        if self.fpga_path:
            lib.bladerf_load_fpga(dev, self.fpga_path.encode())
        BLADERF_MODULE_RX = 0
        rate = self.sample_rate * max(1, self.decimation)
        lib.bladerf_set_sample_rate(dev, BLADERF_MODULE_RX, rate, None)
        lib.bladerf_set_frequency(dev, BLADERF_MODULE_RX, self.freq_hz)
        if self.bandwidth and self.bandwidth != "bypass":
            lib.bladerf_set_bandwidth(dev, BLADERF_MODULE_RX, int(float(self.bandwidth)), None)
        if self.micro:
            # bladeRF 2.0 Micro extras (sdr_ubladerf.c:230-320): overall
            # manual gain + RX0 bias tee (no-ops on bladeRF 1 boards)
            if self.gain_db is not None:
                lib.bladerf_set_gain(dev, BLADERF_MODULE_RX, int(self.gain_db))
            if self.biastee:
                try:
                    lib.bladerf_set_bias_tee(dev, BLADERF_MODULE_RX, 1)
                except AttributeError:
                    pass
        BLADERF_FORMAT_SC16_Q11 = 0
        lib.bladerf_sync_config(dev, BLADERF_MODULE_RX, BLADERF_FORMAT_SC16_Q11,
                                16, 65536, 8, 1000)
        lib.bladerf_enable_module(dev, BLADERF_MODULE_RX, 1)

    def start(self, loop: asyncio.AbstractEventLoop) -> threading.Thread:
        lib, dev = self._lib, self._dev

        def reader():
            buf = (ctypes.c_int16 * (self.buf_samples * 2))()
            while not self._stop.is_set():
                if lib.bladerf_sync_rx(dev, buf, self.buf_samples, None, 1000) != 0:
                    break
                data = bytes(bytearray(buf))
                loop.call_soon_threadsafe(self._push, data)
            loop.call_soon_threadsafe(self.queue.put_nowait, b"")

        t = threading.Thread(target=reader, name="bladerf-reader", daemon=True)
        t.start()
        self._thread = t
        return t

    _push = RtlSdrSource._push

    def close(self) -> None:
        self._stop.set()
        t = getattr(self, "_thread", None)
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        if self._lib is not None and self._dev is not None:
            self._lib.bladerf_enable_module(self._dev, 0, 0)
            self._lib.bladerf_close(self._dev)
            self._dev = None


# ---------------------------------------------------------------------------
# ADALM-Pluto (sdr_plutosdr.c): libiio context (USB uri or network)
# ---------------------------------------------------------------------------


@dataclass
class PlutoSource:
    """PlutoSDR capture via libiio (sdr_plutosdr.c): cf-ad9361-lpc RX
    buffer stream, SC16 IQ.  Context from --pluto-uri or --pluto-network."""

    uri: str | None = None  # --pluto-uri
    network: str | None = None  # --pluto-network (default pluto.local)
    freq_hz: int = 1_090_000_000
    sample_rate: int = 2_400_000
    gain_db: float | None = None
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=SDR_N_BUFFERS))

    _lib = None
    _ctx = None
    _buf = None
    _stop: threading.Event = field(default_factory=threading.Event)
    dropped_buffers: int = 0

    @staticmethod
    def available() -> bool:
        return _load_lib("iio", "iio_create_default_context") is not None

    def open(self) -> None:
        lib = _load_lib("iio", "iio_create_default_context")
        if lib is None:
            raise RuntimeError(
                "libiio not found — PlutoSDR capture unavailable on this "
                "host (install libiio, or use --device-type ifile/rtlsdr/soapy)"
            )
        self._lib = lib
        lib.iio_create_context_from_uri.restype = ctypes.c_void_p
        lib.iio_create_network_context.restype = ctypes.c_void_p
        if self.uri:
            ctx = lib.iio_create_context_from_uri(self.uri.encode())
        else:
            ctx = lib.iio_create_network_context(
                (self.network or "pluto.local").encode()
            )
        if not ctx:
            raise RuntimeError("pluto: could not create iio context")
        self._ctx = ctypes.c_void_p(ctx)
        lib.iio_context_find_device.restype = ctypes.c_void_p
        phy = lib.iio_context_find_device(self._ctx, b"ad9361-phy")
        rxdev = lib.iio_context_find_device(self._ctx, b"cf-ad9361-lpc")
        if not phy or not rxdev:
            raise RuntimeError("pluto: ad9361 devices not found in context")
        self._phy, self._rxdev = ctypes.c_void_p(phy), ctypes.c_void_p(rxdev)
        lib.iio_device_find_channel.restype = ctypes.c_void_p
        alt = lib.iio_device_find_channel(self._phy, b"altvoltage0", True)
        lib.iio_channel_attr_write_longlong(
            ctypes.c_void_p(alt), b"frequency", ctypes.c_longlong(self.freq_hz)
        )
        ch = lib.iio_device_find_channel(self._phy, b"voltage0", False)
        lib.iio_channel_attr_write_longlong(
            ctypes.c_void_p(ch), b"sampling_frequency",
            ctypes.c_longlong(self.sample_rate),
        )
        if self.gain_db is None or self.gain_db <= -10:
            lib.iio_channel_attr_write(
                ctypes.c_void_p(ch), b"gain_control_mode", b"slow_attack"
            )
        else:
            lib.iio_channel_attr_write(
                ctypes.c_void_p(ch), b"gain_control_mode", b"manual"
            )
            lib.iio_channel_attr_write_longlong(
                ctypes.c_void_p(ch), b"hardwaregain",
                ctypes.c_longlong(int(self.gain_db)),
            )
        for name in (b"voltage0", b"voltage1"):
            rxch = lib.iio_device_find_channel(self._rxdev, name, False)
            if rxch:
                lib.iio_channel_enable(ctypes.c_void_p(rxch))
        lib.iio_device_create_buffer.restype = ctypes.c_void_p
        buf = lib.iio_device_create_buffer(
            self._rxdev, ctypes.c_size_t(SDR_BUF_BYTES // 4), False
        )
        if not buf:
            raise RuntimeError("pluto: iio buffer creation failed")
        self._buf = ctypes.c_void_p(buf)

    def start(self, loop: asyncio.AbstractEventLoop) -> threading.Thread:
        lib = self._lib

        def reader():
            lib.iio_buffer_start.restype = ctypes.c_void_p
            lib.iio_buffer_end.restype = ctypes.c_void_p
            while not self._stop.is_set():
                if lib.iio_buffer_refill(self._buf) < 0:
                    break
                start = lib.iio_buffer_start(self._buf)
                end = lib.iio_buffer_end(self._buf)
                n = int(end) - int(start)
                data = ctypes.string_at(start, n)
                loop.call_soon_threadsafe(self._push, data)
            loop.call_soon_threadsafe(self.queue.put_nowait, b"")

        t = threading.Thread(target=reader, name="pluto-reader", daemon=True)
        t.start()
        self._thread = t
        return t

    _push = RtlSdrSource._push

    def close(self) -> None:
        self._stop.set()
        t = getattr(self, "_thread", None)
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        if self._lib is not None:
            if self._buf is not None:
                self._lib.iio_buffer_destroy(self._buf)
                self._buf = None
            if self._ctx is not None:
                self._lib.iio_context_destroy(self._ctx)
                self._ctx = None
