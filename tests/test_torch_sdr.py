"""The port's SDR sources (`io/sdr.py`) and the App's SDR runners against
readsb_tpu's, in process, at tolerance 0.

- The patterns of tests/test_sdr.py through both packages: Beast serial
  options and GNS HULC over a pty, gain snapping, shedding the oldest
  buffer, every library absent.  Each source's open() drives a stand-in of
  its C library, which records the calls: both packages make the same.
- A fake source (the sources' interface over a capture's bytes, in
  SDR_BUF_BYTES pieces, waiting for room in the queue) through
  `App._run_sdr_source` on the uc8, sc16, sc16q11 and uc8 --modeac routes:
  frames, aircraft.json and stats equal readsb_tpu's `_run_sdr_source`
  (test_torch_app.run_both) and the port's `run_ifile` over the same
  whole superblocks.  Each route runs once, in a module-scoped fixture,
  on 0.6 s captures with --blocks-per-batch 1.
- A Beast serial pty feeding both Apps gives equal aircraft.
"""

import asyncio
import contextlib
import ctypes
import dataclasses
import logging
import os
import sys

import pytest
import torch

from readsb_tpu.app import main as jax_main
from readsb_tpu.io import json_out as jax_json
from readsb_tpu.io import sdr as jax_sdr
from readsb_tpu_torch.app import main
from readsb_tpu_torch.io import beast as beast_io
from readsb_tpu_torch.io import json_out, sdr, stats
from readsb_tpu_torch.synth import (
    build_traffic_capture,
    encode_df11,
    encode_df17_position,
    encode_df17_velocity,
    quantize_sc16,
    quantize_uc8,
)
from tests.test_torch_app import (
    EPOCH_MS,
    RESULT_KEYS,
    _results,
    check_run,
    check_signal_cut,
    run_both,
)
from tests.test_torch_cuda import FakeSource
from tests.test_torch_track import aircraft_state

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

PACKAGES = [jax_sdr, sdr]
PKG_IDS = ["readsb_tpu", "port"]
TIMEOUT = 30.0  # seconds for any one read or await


# --- the patterns of tests/test_sdr.py through both packages ---------------


def _read_at_least(fd, n):
    """n bytes from fd, each read bounded by TIMEOUT."""
    import select

    data = b""
    while len(data) < n:
        ready, _, _ = select.select([fd], [], [], TIMEOUT)
        assert ready, f"timed out after {len(data)} of {n} bytes"
        data += os.read(fd, 4096)
    return data


@pytest.mark.parametrize("mod", PACKAGES, ids=PKG_IDS)
def test_beast_serial_options_over_pty(mod):
    controller, follower = os.openpty()
    src = mod.BeastSerialSource(path=os.ttyname(follower), mlat_timestamps=True,
                                crc_checks=False, filter_df1117=True, mode_ac=True)
    try:
        src.open()
        data = _read_at_least(controller, 27)
    finally:
        src.close()
        os.close(controller)
        os.close(follower)
    assert all(data[i] == 0x1A and data[i + 1] == ord("1") for i in range(0, len(data), 3))
    assert [chr(data[i + 2]) for i in range(0, len(data), 3)] == list("BCHDEFgiJ")
    assert mod.BeastSerialSource()._options() == "BCHdEfgij"


@pytest.mark.parametrize("mod", PACKAGES, ids=PKG_IDS)
def test_gns_hulc_over_pty(mod):
    controller, follower = os.openpty()
    src = mod.BeastSerialSource(path=os.ttyname(follower), baud=921_600, gns=True)
    try:
        src.open()
        data = _read_at_least(controller, 4)
    finally:
        src.close()
        os.close(controller)
        os.close(follower)
    assert data == b"#00\r"


class FakeLib:
    """A C library's stand-in: records each call with its arguments made
    plain; functions that return a handle return a non-null one."""

    HANDLES = {"SoapySDRDevice_makeStrArgs", "SoapySDRDevice_setupStream",
               "iio_create_context_from_uri", "iio_create_network_context",
               "iio_context_find_device", "iio_device_find_channel",
               "iio_device_create_buffer"}

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        lib = self

        class Fn:  # takes restype / argtypes like a ctypes function
            def __call__(self, *args):
                lib.calls.append((name, tuple(_plain(a) for a in args)))
                return 0x1000 if name in FakeLib.HANDLES else 0

        fn = Fn()
        object.__setattr__(self, name, fn)
        return fn


def _plain(a):
    if isinstance(a, ctypes._SimpleCData):
        return a.value
    if type(a).__name__ == "CArgObject":
        return "byref"
    if isinstance(a, ctypes.Array):
        return list(a)
    if isinstance(a, ctypes._CFuncPtr):
        return "callback"
    return a


SOURCES = [
    ("RtlSdrSource", "_load_librtlsdr", dict(gain_db=43.5, ppm=12, biastee=True)),
    ("RtlSdrSource", "_load_librtlsdr", dict(device="00000001")),
    ("RtlSdrSource", "_load_librtlsdr", dict(gain_db=-10)),
    ("SoapySource", "_load_libsoapy", dict(gain_db=30.0, antenna="RX", bandwidth=3e6,
                                           gain_elements=["LNA:20", "VGA:10"])),
    ("SoapySource", "_load_libsoapy", dict()),
    ("HackRfSource", "_load_lib", dict(gain_db=33.0, vga_gain=41, enable_amp=True)),
    ("HackRfSource", "_load_lib", dict(device="abc")),
    ("BladeRfSource", "_load_lib", dict(fpga_path="x.rbf", decimation=2, bandwidth="1.5e6")),
    ("BladeRfSource", "_load_lib", dict(micro=True, gain_db=20, biastee=True)),
    ("PlutoSource", "_load_lib", dict(uri="usb:1.2.5", gain_db=40)),
    ("PlutoSource", "_load_lib", dict(network="pluto.lan")),
]


def _open_calls(mod, cls, loader, kw, monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(mod, loader, lambda *a: lib)
    getattr(mod, cls)(**kw).open()
    return lib.calls


@pytest.mark.parametrize("cls,loader,kw", SOURCES, ids=lambda v: str(v))
def test_open_drives_the_library_as_the_reference(cls, loader, kw, monkeypatch):
    """Gains, frequencies, rates, antennas, bias tees: the same calls with
    the same arguments in the same order."""
    want = _open_calls(jax_sdr, cls, loader, kw, monkeypatch)
    got = _open_calls(sdr, cls, loader, kw, monkeypatch)
    assert got == want and len(got) > 3


@pytest.mark.parametrize("mod", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("gain,step", [(43.5, 434), (None, 580), (0.4, 0), (100.0, 580), (15.0, 144)])
def test_rtl_gain_snaps_to_the_nearest_tuner_step(mod, gain, step, monkeypatch):
    calls = _open_calls(mod, "RtlSdrSource", "_load_librtlsdr", dict(gain_db=gain), monkeypatch)
    assert [c[1][1] for c in calls if c[0] == "rtlsdr_set_tuner_gain_mode"] == [1]  # manual
    assert [c[1][1] for c in calls if c[0] == "rtlsdr_set_tuner_gain"] == [step]
    assert mod.RTL_GAINS == sdr.RTL_GAINS


@pytest.mark.parametrize("mod", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("cls", ["RtlSdrSource", "SoapySource", "HackRfSource",
                                 "BladeRfSource", "PlutoSource"])
def test_queue_sheds_the_oldest_buffer(mod, cls):
    async def go():
        src = getattr(mod, cls)()
        for i in range(20):
            src._push(bytes([i]))
        assert src.queue.maxsize == sdr.SDR_N_BUFFERS == 16
        assert src.dropped_buffers == 20 - src.queue.maxsize
        return await asyncio.wait_for(src.queue.get(), TIMEOUT)

    assert asyncio.run(go()) == bytes([4])  # the four oldest were shed


def test_hackrf_transfer_reaches_the_queue_rebiased(monkeypatch):
    """A HackRF transfer of signed-8 IQ becomes UC8 bytes in the port's
    queue.  readsb_tpu's callback reads `np`, which its module never
    imports: its queue stays empty (the fault the port does not copy)."""
    out, raised = [], []
    monkeypatch.setattr(sys, "unraisablehook", lambda u: raised.append(u.exc_type))
    for mod in PACKAGES:
        lib = FakeLib()
        cbs = []
        monkeypatch.setattr(mod, "_load_lib", lambda *a: lib)
        lib.hackrf_start_rx = lambda dev, cb, ctx: cbs.append(cb) or 0

        async def go(mod=mod):
            src = mod.HackRfSource()
            src.open()
            src.start(asyncio.get_running_loop())
            raw = (ctypes.c_uint8 * 6)(0x80, 0xFF, 0x00, 0x7F, 0x01, 0x02)
            T = cbs[0].argtypes[0]._type_
            t = T(None, ctypes.cast(raw, ctypes.POINTER(ctypes.c_uint8)), 6, 6)
            cbs[0](ctypes.pointer(t))
            await asyncio.sleep(0.05)
            return src.queue.qsize() and src.queue.get_nowait()

        out.append(asyncio.run(go()))
    assert out == [0, bytes([0x00, 0x7F, 0x80, 0xFF, 0x81, 0x82])]
    assert raised == [NameError]  # readsb_tpu's callback, inside ctypes


LIBRARIES = [("RtlSdrSource", "librtlsdr"), ("SoapySource", "SoapySDR"),
             ("HackRfSource", "libhackrf"), ("BladeRfSource", "libbladeRF"),
             ("PlutoSource", "libiio")]


@pytest.mark.parametrize("mod", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("cls,word", LIBRARIES)
def test_every_library_absent_open_raises_naming_it(mod, cls, word):
    src = getattr(mod, cls)
    if src.available():
        pytest.skip(f"this host has {word}")
    with pytest.raises(RuntimeError, match=word):
        src().open()


DEVICE_TYPES = [("rtlsdr", "RtlSdrSource", "librtlsdr"), ("soapy", "SoapySource", "SoapySDR"),
                ("hackrf", "HackRfSource", "libhackrf"), ("bladerf", "BladeRfSource", "libbladeRF"),
                ("ubladerf", "BladeRfSource", "libbladeRF"), ("plutosdr", "PlutoSource", "libiio"),
                ("modesbeast", None, "No such file"), ("gnshulc", None, "No such file")]


@pytest.mark.parametrize("dt,cls,word", DEVICE_TYPES, ids=[d[0] for d in DEVICE_TYPES])
def test_every_device_type_without_its_library_exits_cleanly(dt, cls, word, tmp_path,
                                                              monkeypatch, caplog):
    """Each --device-type's source fails as readsb_tpu's does; the port's
    command line then logs the error and exits 1, where readsb_tpu's lets
    the exception out with a traceback.  The serial types are given a tty
    that does not exist."""
    if cls is not None and getattr(sdr, cls).available():
        pytest.skip(f"this host has {word}")
    argv = ["--device-type", dt, "--beast-serial", str(tmp_path / "none")]
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    with pytest.raises((RuntimeError, OSError), match=word):
        jax_main.main(argv)
    with caplog.at_level(logging.ERROR, logger="readsb_tpu_torch"), \
            pytest.raises(SystemExit) as e:
        main.main(argv)
    assert e.value.code == 1
    assert any(word in r.getMessage() for r in caplog.records)


# --- the fake source through _run_sdr_source ---------------------------------


def sdr_run(fmt, data):
    """run(app) for run_both: the fake source through app._run_sdr_source."""

    async def run(app):
        app._exit_event = asyncio.Event()
        src = FakeSource(data)
        await asyncio.wait_for(app._run_sdr_source(src, fmt), 300)
        assert src.opened and src.closed

    return run


ROUTES = {
    # route: (argv, format, scale, Mode A/C replies)
    "uc8": (["--device-type", "rtlsdr"], "uc8", 1.0, False),
    "sc16": (["--device-type", "soapy", "--lat", "46.3", "--lon", "6.6", "--max-range", "200"],
             "sc16", 1.0, False),
    "sc16q11": (["--device-type", "bladerf"], "sc16q11", 1 / 16, False),
    "modeac": (["--device-type", "rtlsdr", "--modeac"], "uc8", 1.0, True),
}


def route_bytes(fmt, scale, modeac, seed):
    """A 0.6 s traffic capture as the source's format; sc16q11 is the sc16
    scene at 1/16 of its scale (full scale 2048)."""
    cap = build_traffic_capture(0.6, 6, seed)
    if modeac:
        from readsb_tpu_torch.decode.mode_ac import modec_to_modea

        for i in range(12):
            cap.add_modeac(modec_to_modea(30), 0.021 + 0.045 * i, amplitude=0.5)
            cap.add_modeac(0x1200, 0.036 + 0.045 * i, amplitude=0.45)
    iq = cap.render_iq() * scale
    return (quantize_uc8(iq) if fmt == "uc8" else quantize_sc16(iq)).tobytes()


def port_run(argv, run, monkeypatch):
    """The port's App alone over argv through run(app); its results and
    every frame whole."""
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    app = main.App(main.parse_args(argv))
    app.epoch_ms = EPOCH_MS
    frames = []

    def keep(fr, epoch_ms, _decode=main.decode_frame):
        frames.append(dataclasses.asdict(fr))
        return _decode(fr, epoch_ms=epoch_ms)

    with monkeypatch.context() as m:
        m.setattr(main, "decode_frame", keep)
        asyncio.run(run(app))
    if "--modeac" in argv:
        app.tracker.match_ac(app.now_ms())
    res = _results(app, json_out, stats)
    res["frames"] = frames
    return res


async def run_ifile_unflushed(app):
    """App.run_ifile without its final flush: the whole superblocks that
    _run_sdr_source feeds, and nothing after them."""
    from readsb_tpu_torch import pipeline

    flush = pipeline.Demodulator.flush
    pipeline.Demodulator.flush = lambda self: []
    try:
        await app.run_ifile()
    finally:
        pipeline.Demodulator.flush = flush


@pytest.fixture(scope="module")
def sdr_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdr")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for k, (route, (extra, fmt, scale, modeac)) in enumerate(ROUTES.items()):
            data = route_bytes(fmt, scale, modeac, 61 + k)
            argv = [*extra, "--blocks-per-batch", "1"]
            want, got = run_both(argv, mp, run=sdr_run(fmt, data))
            sdr_alone = port_run(argv, sdr_run(fmt, data), mp)
            bps = 2 if fmt == "uc8" else 4
            whole = len(data) // (131072 * bps) * (131072 * bps)
            path = str(d / f"{route}.dat")
            with open(path, "wb") as f:
                f.write(data[:whole])
            ifile_argv = ["--device-type", "ifile", "--ifile", path, "--iformat", fmt,
                          *argv[2:]]
            ifile = port_run(ifile_argv, run_ifile_unflushed, mp)
            out[route] = (want, got, (sdr_alone, ifile), len(data) - whole)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_sdr_run_decodes_traffic(sdr_runs, route):
    want, got, _, tail = sdr_runs[route]
    check_run(want, got, 0.5)  # a 0.6 s capture less its last partial superblock
    assert 0 < tail < 131072 * 4  # the bytes short of a superblock stay unfed


@pytest.mark.parametrize("route", list(ROUTES))
def test_signal_differs_only_in_the_scan_tail(sdr_runs, route):
    check_signal_cut(sdr_runs[route][1])


@pytest.mark.parametrize("key", RESULT_KEYS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_sdr_run_equals_reference(sdr_runs, route, key):
    want, got, _, _ = sdr_runs[route]
    assert got[key] == want[key]


@pytest.mark.parametrize("key", RESULT_KEYS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_sdr_run_equals_run_ifile_over_whole_superblocks(sdr_runs, route, key):
    sdr_alone, ifile = sdr_runs[route][2]
    assert sdr_alone[key] == ifile[key]
    assert len(sdr_alone["frames"]) > 30


def test_routes_reach_their_paths(sdr_runs):
    ac = sdr_runs["modeac"][1]
    assert ac["demod"][5] >= 12 and "modec_hit=True" in ac["aircraft"]
    assert sdr_runs["uc8"][1]["demod"][5] == 0


# --- a Beast serial receiver on a pty, feeding both Apps ---------------------


def _beast_stream():
    """Beast frames of four aircraft behind 0xE8 synthetic-time prefixes."""
    out = b""
    n = 0
    for k in range(60):
        addr = 0x4B0101 + 0x101 * (k % 4)
        t_s = 0.05 * k
        msg = (encode_df11(addr), encode_df17_velocity(addr, 200, 90.0, 0),
               encode_df17_position(addr, 46.2 + 0.00002 * k, 6.4, 9000, (k // 4) % 2))[k % 3]
        out += beast_io.encode_synthetic_ts(EPOCH_MS + int(t_s * 1000))
        out += beast_io.encode_frame(msg, int(t_s * 12e6), 0.05)
        n += 1
    return out, n


def test_beast_serial_pty_feeds_both_apps_equal(tmp_path, monkeypatch):
    stream, n = _beast_stream()
    results = []
    for pkg in (jax_main, main):
        controller, follower = os.openpty()
        argv = ["--device-type", "modesbeast", "--beast-serial", os.ttyname(follower)]
        monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
        app = pkg.App(pkg.parse_args(argv))
        app.epoch_ms = EPOCH_MS

        async def go(app=app, controller=controller):
            app._exit_event = asyncio.Event()
            task = asyncio.ensure_future(app.run_beast_serial())
            await asyncio.sleep(0.1)  # the task opens the tty
            _read_at_least(controller, 27)  # the receiver options
            for i in range(0, len(stream), 100):
                os.write(controller, stream[i:i + 100])
            for _ in range(int(TIMEOUT / 0.01)):
                if len(app._net_queue) >= n:
                    break
                await asyncio.sleep(0.01)
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await asyncio.wait_for(task, TIMEOUT)

        try:
            asyncio.run(go())  # the app closes the follower
        finally:
            os.close(controller)
        assert len(app._net_queue) == n
        app.drain_net_queue()
        now = EPOCH_MS + 4000
        jo = jax_json if pkg is jax_main else json_out
        results.append((app.messages, aircraft_state(app.tracker.aircraft.values()),
                        jo.generate_aircraft_json(app.tracker, now, app.messages)))
    assert results[1] == results[0]
    assert results[1][0] == n and len(results[1][2]["aircraft"]) == 4
    assert sum("lat" in a for a in results[1][2]["aircraft"]) == 4
