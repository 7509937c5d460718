"""Application entry point: wires source -> demod -> decode -> track -> serve.

readsb_tpu's app on the port's demodulator: a single asyncio loop on the
host feeds the batched device pipeline from the default executor, from
IQ files (`--device-type ifile`) or an SDR source (`io/sdr.py`: rtlsdr,
soapy, hackrf, bladerf, ubladerf, plutosdr; modesbeast and gnshulc feed
the Beast input instead); the network engine
serves the Beast, raw, SBS, JSON, VRS, ASTERIX and UAT lanes, takes
Beast, raw, SBS, ASTERIX, UAT, planefinder and gpsd input, and answers
/re-api queries; periodic coroutines sweep the tracker and write
aircraft.json, receiver.json, stats.json and clients.json.

Network input drains as readsb_tpu's does: through the columnar drain
(`app/bulk_drain.py`, the native Beast deframer and `track/bulk.py`)
wherever its rule picks it (`config.bulk_drain_enabled`), else through the
scalar per-message path (`drain_net_queue`).  Under the columnar drain,
--device-arena keeps the tracked fields in the device arena
(`track/arena.py`) on the app's device.

--write-state persists the aircraft store (`io/state.py`): periodically,
on the getState / replaceState trigger files and at shutdown, and it is
restored at startup, as readsb does (readInternalState) and readsb_tpu
does not.  --dump-beast records network Beast input (`io/beastdump.py`).

History, as readsb_tpu's: --json-globe-index (or --heatmap) keeps a trace
per aircraft (`track/traces.py`); the periodic loop writes the trace files
and the globe tiles (`io/history.py`), the half-hour heatmap, and the
Prometheus file (--write-prom); the exit sweep writes every dirty trace.
--db-file joins the aircraft database (`track/acdb.py`), reloaded every
30 s, and --globe-history-dir with --json-globe-index logs ACAS RAs
(`io/acas.AcasLogger`).

The device is explicit.  Under READSB_TPU_PLATFORM=cpu the demodulator
runs its plain PyTorch versions on the CPU; otherwise it runs on the card,
and `main` refuses to start without one.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import sys
import time

import torch

from .. import constants, spans
from ..decode.fields import AddrType, ModesMessage, Source, decode_frame
from ..io import beast as beast_io
from ..io import json_out
from ..io import raw as raw_io
from ..io import sbs as sbs_io
from ..io.net import Connector, InputConnection, InputService, NetEngine
from ..io.stats import StatsCollector
from ..track.tracker import Tracker
from .config import bulk_drain_enabled, parse_args

log = logging.getLogger("readsb_tpu_torch")


def platform_device() -> torch.device:
    """The app's device: the CPU under READSB_TPU_PLATFORM=cpu, else the card."""
    if os.environ.get("READSB_TPU_PLATFORM") == "cpu":
        return torch.device("cpu")
    return torch.device("cuda")


def _ensure_device() -> None:
    """Refuse to start on the card without one; never fall back to the CPU."""
    if platform_device().type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "readsb-tpu-torch: no CUDA device is available; "
            "set READSB_TPU_PLATFORM=cpu to run on the CPU"
        )


class App:
    def __init__(self, args):
        self.args = args
        self.device = platform_device()
        self.tracker = Tracker(
            json_reliable=args.json_reliable,
            receiver_lat=args.lat,
            receiver_lon=args.lon,
            max_range_km=args.max_range * 1.852,
            keep_traces=bool(args.json_globe_index or args.heatmap),
            json_trace_interval=int(args.json_trace_interval * 1000),
        )
        self.net = NetEngine()
        self._net_queue = []
        self._shared_net_scorer = None
        self.bulk = None
        self.arena = None
        self._net_cols_queue: list = []
        if bulk_drain_enabled(args):
            from .bulk_drain import make_bulk

            self.bulk = make_bulk(self)
            if args.device_arena:
                from ..track.arena import Arena

                # a fixed receiver location enables the on-device surface
                # global decode (the reference chain always prefers it)
                self.arena = Arena(
                    receiver_lat=args.lat, receiver_lon=args.lon, device=self.device
                )
        elif args.device_arena:
            log.warning("--device-arena needs the columnar drain; ignored")
        self.epoch_ms = int(time.time() * 1000)
        self.messages = 0
        self.remote_modes = 0
        self.remote_bad = 0
        self.remote_modeac = 0
        self.start_time = time.time()
        self._demod = None
        self.stats_collector = StatsCollector()
        hb = args.net_heartbeat
        # heartbeat payloads per wire format (net_io.c:109-126)
        ro_kw = dict(flush_bytes=args.net_ro_size, flush_interval=args.net_ro_interval)
        if args.net_buffer != 2:  # --net-buffer: 64KiB << n per-client backlog
            ro_kw["max_backlog"] = 65536 << max(0, min(args.net_buffer, 12))
        self.out_raw = self.net.add_output(
            "raw_out", heartbeat=b"*0000;\n", heartbeat_interval=hb, **ro_kw
        )
        self.out_beast = self.net.add_output(
            "beast_out",
            heartbeat=b"\x1a1" + b"\x00" * 9,
            heartbeat_interval=hb,
            **ro_kw,
        )
        self.out_sbs = self.net.add_output(
            "sbs_out", heartbeat=b"\r\n", heartbeat_interval=hb
        )
        # SBS priority-variant lanes (net_io.c:951-984): routed by source
        self.out_sbs_mlat = self.net.add_output("sbs_out_mlat", heartbeat=b"\r\n", heartbeat_interval=hb)
        self.out_sbs_prio = self.net.add_output("sbs_out_prio", heartbeat=b"\r\n", heartbeat_interval=hb)
        self.out_sbs_jaero = self.net.add_output("sbs_out_jaero", heartbeat=b"\r\n", heartbeat_interval=hb)
        self.out_sbs_replay = self.net.add_output("sbs_out_replay", heartbeat=b"\r\n", heartbeat_interval=hb)
        self.out_json = self.net.add_output("json_out")
        self.out_garbage = self.net.add_output("garbage_out")
        self.out_uat_replay = self.net.add_output("uat_replay_out")
        self.out_vrs = self.net.add_output("vrs_out")
        self.out_asterix = self.net.add_output("asterix_out")
        self.out_beast_reduce = self.net.add_output(
            "beast_reduce_out",
            flush_bytes=args.net_ro_size,
            flush_interval=(
                args.net_ro_interval_beast_reduce
                if args.net_ro_interval_beast_reduce is not None
                else args.net_ro_interval
            ),
        )
        self.tracker.reduce_interval_ms = int(args.net_beast_reduce_interval * 1000)
        if args.net_beast_reduce_filter_dist is not None:
            self.tracker.reduce_filter_dist_m = args.net_beast_reduce_filter_dist * 1852.0
        if args.net_beast_reduce_filter_alt is not None:
            self.tracker.reduce_filter_alt_ft = args.net_beast_reduce_filter_alt
        self.tracker.reduce_optimize_mlat = args.net_beast_reduce_optimize_for_mlat
        # readsb.c: position_persistence += max(0, json_reliable - 1)
        self.tracker.position_persistence = float(
            args.position_persistence + max(0, (args.json_reliable or 1) - 1)
        )
        self.tracker.track_expire_jaero_ms = int(args.jaero_timeout * 60_000)
        self.tracker.outline.duration_ms = int(args.range_outline_hours * 3_600_000)
        self._df_filter = None
        if args.filter_DF:
            self._df_filter = {int(x) for x in str(args.filter_DF).split(",") if x}
        self.tracker.cpr_focus = args.cpr_focus
        self.beast_dump = None
        if args.dump_beast_dir:
            from ..io.beastdump import BeastDumper

            self.beast_dump = BeastDumper(
                args.dump_beast_dir, chunk_seconds=args.dump_beast_interval
            )
        if args.db_file:
            from ..track.acdb import AircraftDb

            self.tracker.db = AircraftDb(args.db_file)
            self.tracker.db_reload()
        self.acas_log = None
        if args.globe_history_dir and args.json_globe_index:
            from ..io.acas import AcasLogger

            # daily RA event logs (checkNewDayAcas, globe_index.c:3415)
            self.acas_log = AcasLogger(args.globe_history_dir)
        if args.write_state and os.path.isdir(args.write_state):
            # startup restore (readInternalState, globe_index.c:3565):
            # readsb_tpu reads the directory only on replaceState
            from ..io import state as state_io

            n = state_io.load_state(self.tracker, args.write_state)
            log.info("restored %d aircraft from %s", n, args.write_state)

    # ------------------------------------------------------------------

    def handle_frame(self, frame) -> None:
        """One accepted demodulated frame -> decode, track, fan out."""
        mm = decode_frame(frame, epoch_ms=self.epoch_ms)
        self.stats_collector.note_signal(frame.signal_power)
        self.handle_message(mm, raw_ts=frame.timestamp, signal=frame.signal_power)

    def handle_message(self, mm: ModesMessage, raw_ts: int = 0, signal: float = 0.0) -> None:
        if (
            self.args.show_only is not None
            and (mm.addr & 0xFFFFFF) != self.args.show_only
        ):
            return
        if (
            self.args.receiver_focus is not None
            and getattr(mm, "receiver_id", 0) != self.args.receiver_focus
        ):
            return  # net_io.c:2956,4976: focus on a single feeder
        self.messages += 1
        if getattr(mm, "remote", False):
            if len(mm.msg) == 2:
                self.remote_modeac += 1
            else:
                self.remote_modes += 1
        a = self.tracker.update(mm)
        if self.acas_log is not None and mm.acas_ra_valid:
            from ..io import acas as acas_io

            ra = (mm.MV if mm.msgtype == 16 else
                  mm.MB if mm.msgtype in (20, 21) else mm.ME)
            if ra and acas_io.ra_valid(bytes(ra), mm.msgtype):
                self.acas_log.log(
                    mm.addr, bytes(ra), a, mm, mm.sys_timestamp_ms
                )
        if self.args.show_raw:
            if self.args.onlyaddr:  # mode_s.c:1829: address-only display
                print("%06x" % (mm.addr & 0xFFFFFF), flush=False)
            elif self.args.mlat_display:  # Beast ASCII with mlat timestamp
                print("@%012X%s;" % (raw_ts & 0xFFFFFFFFFFFF, mm.msg.hex()),
                      flush=False)
            else:
                print("*%s;" % mm.msg.hex(), flush=False)
        if self._df_filter is not None and mm.msgtype not in self._df_filter:
            return
        is_mlat_src = mm.source == Source.MLAT
        if self.out_raw.clients and not (is_mlat_src and not self.args.forward_mlat):
            # 2-bit-corrected messages only with --net-verbatim (net_io.c:5840)
            if mm.correctedbits < 2 or self.args.net_verbatim:
                self.out_raw.send(raw_io.encode_line(mm.msg, raw_ts or None))
        if self.out_beast.clients and len(mm.msg) in (2, 7, 14):
            self._beast_send(
                self.out_beast,
                beast_io.encode_frame(mm.msg, raw_ts, signal, modeac=len(mm.msg) == 2),
                mm,
            )
        sbs_lanes = []
        is_mlat = mm.source == Source.MLAT
        if self.out_sbs.clients and not is_mlat:
            sbs_lanes.append(self.out_sbs)
        if self.out_sbs_mlat.clients and is_mlat:
            sbs_lanes.append(self.out_sbs_mlat)
        if self.out_sbs_prio.clients and mm.source == Source.PRIO:
            sbs_lanes.append(self.out_sbs_prio)
        if self.out_sbs_jaero.clients and mm.source == Source.JAERO:
            sbs_lanes.append(self.out_sbs_jaero)
        if self.out_sbs_replay.clients and getattr(mm, "sbs_in", False):
            sbs_lanes.append(self.out_sbs_replay)
        if sbs_lanes and not (self.args.net_sbs_reduce and not mm.reduce_forward):
            line = sbs_io.encode_line(
                mm, geom_delta=(a.geom_delta if a is not None else None),
                now_ms=mm.sys_timestamp_ms, use_gnss=self.args.gnss,
            )
            if line:
                for lane in sbs_lanes:
                    lane.send(line)
        if self.out_json.clients and a is not None:
            emit = mm.cpr_decoded
            if (
                not emit
                and self.args.net_json_port_include_noposition
                and mm.msgtype == 11
                and mm.sys_timestamp_ms > (a.seen_pos or 0) + 10_000
            ):
                emit = True  # state for position-quiet aircraft (help.h:141)
            iv_ms = self.args.net_json_port_interval * 1000.0
            if emit and iv_ms > 0:
                if getattr(a, "_next_json_port", 0) > mm.sys_timestamp_ms:
                    emit = False
                else:
                    a._next_json_port = mm.sys_timestamp_ms + iv_ms
            if emit:
                import json as _json

                self.out_json.send(
                    (_json.dumps(json_out.aircraft_dict(self.tracker, a, mm.sys_timestamp_ms)) + "\n").encode()
                )
        # beast_reduce: only messages the tracker flagged interesting
        # (reduce_forward decisions, track.c:2076-2326; writer net_io.c)
        if (
            self.out_beast_reduce.clients
            and mm.reduce_forward
            and len(mm.msg) in (7, 14)
        ):
            self._beast_send(
                self.out_beast_reduce,
                beast_io.encode_frame(mm.msg, raw_ts, signal),
                mm,
            )
        if (
            self.out_asterix.clients
            and mm.addr != constants.HEX_UNKNOWN
            and not (self.args.net_asterix_reduce and not mm.reduce_forward)
            # CAT020/mlat and tisb reports are not emitted (net_io.c:2429-2433)
            and mm.source != Source.MLAT
            and mm.addrtype not in (
                AddrType.TISB_ICAO, AddrType.TISB_TRACKFILE, AddrType.TISB_OTHER
            )
        ):
            from ..io import asterix as asterix_io

            pkt = asterix_io.encode_cat21(mm, now_ms=mm.sys_timestamp_ms)
            if pkt:
                self.out_asterix.send(pkt)

    def now_ms(self) -> int:
        """Current time for periodic sweeps.  During ifile replay this is
        the *synthetic* clock derived from the sample stream (the
        reference's synthetic_now, sdr_ifile.c:131-133,243-251), so
        staleness windows track capture time whether replay runs faster
        or slower than realtime."""
        if self._demod is not None:
            return self.epoch_ms + self._demod.scan_global * 5 // 12000
        return int(time.time() * 1000)

    # ------------------------------------------------------------------

    def _demod_device(self) -> torch.device:
        """The device for the demodulator, with its index fixed here on the
        loop's thread: feed() runs in an executor thread, whose current
        device is its own."""
        dev = self.device
        if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def _on_device(self, fn, *args):
        """fn(*args) with the demodulator's device current in this thread
        (the current device is per thread), so that what fn does on the
        current device happens on the demodulator's."""
        dev = self._demod.device
        if dev.type != "cuda":
            return fn(*args)
        with torch.cuda.device(dev):
            return fn(*args)

    @contextlib.contextmanager
    def _profiled(self, device: torch.device):
        """--write-profile DIR: torch.profiler over the replay (host ops, and
        the card's work on a card) with the program's spans recorded while
        it ran, written to DIR/trace.json at its end; spans past
        spans.CAPACITY are counted there and logged."""
        out = self.args.write_profile
        if not out:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            recorded, dropped = spans.recorded(), spans.dropped()
            os.makedirs(out, exist_ok=True)
            path = os.path.join(out, "trace.json")
            prof.export_chrome_trace(path)
            spans.add_to_chrome_trace(path, recorded, dropped)
            if dropped:
                log.warning("--write-profile: %d program spans past the first %d were "
                            "dropped; those in %s cover the replay's start only", dropped,
                            spans.CAPACITY, path)

    async def run_ifile(self) -> None:
        from ..pipeline import Demodulator

        args = self.args
        paths = [p for p in str(args.ifile).split(",") if p]
        if len(paths) > 1:
            await self.run_ifile_multi(paths)
            return
        demod = Demodulator(
            fmt=args.iformat,
            blocks_per_batch=args.blocks_per_batch,
            k_per_block=args.candidates_per_block,
            threshold=args.preamble_threshold,
            nfix=args.nfix_crc,
            fix_df=args.fix_df,
            modeac=args.modeac,
            device=self._demod_device(),
        )
        self._demod = demod
        f = sys.stdin.buffer if args.ifile == "-" else open(args.ifile, "rb")
        bps = 2 if args.iformat == "uc8" else 4
        chunk = demod.super_samples * bps
        loop = asyncio.get_event_loop()
        with self._profiled(demod.device):
            try:
                while True:
                    t0 = time.perf_counter()
                    data = await loop.run_in_executor(None, f.read, chunk)
                    self.stats_collector.cpu["reader"] += (time.perf_counter() - t0) * 1e3
                    if not data:
                        break
                    t0 = time.perf_counter()
                    frames = await loop.run_in_executor(None, self._on_device, demod.feed, data)
                    self.stats_collector.cpu["demod"] += (time.perf_counter() - t0) * 1e3
                    for fr in frames:
                        self.handle_frame(fr)
                    self._drain_modeac(demod)
                    if args.throttle:
                        await asyncio.sleep(len(data) / bps / constants.SAMPLE_RATE)
                    else:
                        await asyncio.sleep(0)
                for fr in self._on_device(demod.flush):
                    self.handle_frame(fr)
                self._drain_modeac(demod)
            finally:
                if f is not sys.stdin.buffer:
                    f.close()

    async def run_ifile_multi(self, paths: list[str]) -> None:
        """Channel-batched replay: one IQ file per virtual receiver
        channel, demodulated by the MultiDemodulator's single device
        dispatch.  Frames carry the channel index as receiverId, like
        distinct feeders of one aggregator."""
        from ..pipeline import MultiDemodulator

        args = self.args
        multi = MultiDemodulator(
            len(paths),
            fmt=args.iformat,
            blocks_per_batch=args.blocks_per_batch,
            k_per_block=args.candidates_per_block,
            threshold=args.preamble_threshold,
            nfix=args.nfix_crc,
            fix_df=args.fix_df,
            device=self._demod_device(),
        )
        self._demod = multi
        files = [open(p, "rb") for p in paths]
        bps = 2 if args.iformat == "uc8" else 4
        chunk = multi.seg_valid * bps
        loop = asyncio.get_event_loop()

        def read_all():
            return [f.read(chunk) for f in files]

        def emit(per_chan):
            for c, frames in enumerate(per_chan):
                for fr in frames:
                    mm = decode_frame(fr, epoch_ms=self.epoch_ms)
                    mm.receiver_id = c + 1
                    self.stats_collector.note_signal(fr.signal_power)
                    self.handle_message(
                        mm, raw_ts=fr.timestamp, signal=fr.signal_power
                    )

        with self._profiled(multi.device):
            try:
                while True:
                    t0 = time.perf_counter()
                    datas = await loop.run_in_executor(None, read_all)
                    self.stats_collector.cpu["reader"] += (time.perf_counter() - t0) * 1e3
                    if not any(datas):
                        break
                    if not all(datas):
                        break  # lockstep streams; ragged tails flush below
                    t0 = time.perf_counter()
                    per_chan = await loop.run_in_executor(
                        None, self._on_device, multi.feed, list(datas)
                    )
                    self.stats_collector.cpu["demod"] += (time.perf_counter() - t0) * 1e3
                    emit(per_chan)
                    if args.throttle:
                        await asyncio.sleep(len(datas[0]) / bps / constants.SAMPLE_RATE)
                    else:
                        await asyncio.sleep(0)
                emit(self._on_device(multi.flush))
            finally:
                for f in files:
                    f.close()

    async def run_rtlsdr(self) -> None:
        """Live rtl-sdr capture: reader thread fills UC8 buffers, the
        asyncio loop batches them to superblock size and feeds the same
        Demodulator as ifile replay (sdr_rtlsdr.c:233-419 behavior)."""
        from ..io.sdr import RtlSdrSource

        args = self.args
        src = RtlSdrSource(
            device=args.device,
            gain_db=-10.0 if args.enable_agc else args.gain,
            freq_hz=args.freq, ppm=args.ppm, biastee=args.enable_biastee,
            buf_bytes=args.sdr_buffer_size,
        )
        await self._run_sdr_source(src, "uc8")

    async def run_soapy(self) -> None:
        """SoapySDR capture (sdr_soapy.c): CS16 stream fed through the
        SC16 input path."""
        from ..io.sdr import SoapySource

        args = self.args
        src = SoapySource(
            device_args=args.soapy_device or args.device,
            gain_db=-10.0 if (args.enable_agc or args.soapy_enable_agc) else args.gain,
            freq_hz=args.freq, antenna=args.soapy_antenna,
            bandwidth=args.soapy_bandwidth,
            gain_elements=list(args.soapy_gain_element or []),
        )
        await self._run_sdr_source(src, "sc16")

    async def run_hackrf(self) -> None:
        """HackRF capture (sdr_hackrf.c): signed-8 IQ rebias to UC8."""
        from ..io.sdr import HackRfSource

        args = self.args
        src = HackRfSource(
            device=args.device if args.device != "0" else None,
            gain_db=args.gain, freq_hz=args.freq,
            vga_gain=args.hackrf_vgagain,
            enable_amp=args.hackrf_enable_ampgain,
        )
        await self._run_sdr_source(src, "uc8")

    async def run_bladerf(self, micro: bool = False) -> None:
        """bladeRF capture (sdr_bladerf.c): SC16Q11 sync stream; micro=True
        selects the bladeRF 2.0 Micro variant (sdr_ubladerf.c)."""
        from ..io.sdr import BladeRfSource

        args = self.args
        src = BladeRfSource(
            device=args.device if args.device != "0" else None,
            freq_hz=args.freq, fpga_path=args.bladerf_fpga,
            decimation=args.bladerf_decimation,
            bandwidth=args.bladerf_bandwidth,
            micro=micro, gain_db=args.gain,
            biastee=args.enable_biastee,
        )
        await self._run_sdr_source(src, "sc16q11")

    async def run_pluto(self) -> None:
        """ADALM-Pluto capture (sdr_plutosdr.c): libiio SC16 stream."""
        from ..io.sdr import PlutoSource

        args = self.args
        src = PlutoSource(
            uri=args.pluto_uri, network=args.pluto_network,
            freq_hz=args.freq, gain_db=args.gain,
        )
        await self._run_sdr_source(src, "sc16")

    def _note_timing(self, demod) -> None:
        """SDR clock-drift PPM estimation (timingStatistics,
        readsb.c:754-806): compare the 12 MHz sample clock's elapsed time
        against the system clock every ~30 s of stream."""
        now_us = time.monotonic_ns() // 1000
        sample_ts = demod.scan_global * 5  # 12 MHz units
        st = getattr(self, "_ppm_state", None)
        if st is None:
            self._ppm_state = [now_us, sample_ts]
            return
        elapsed_sys = now_us - st[0]
        if elapsed_sys > 30_000_000:
            elapsed_sample = sample_ts - st[1]
            freq_ratio = elapsed_sample / (elapsed_sys * 12.0)
            self.estimated_ppm = (freq_ratio - 1) * 1e6
            if abs(self.estimated_ppm) > 600:
                log.warning(
                    "SDR ppm out of specification or clock jumped: %.0f",
                    self.estimated_ppm,
                )
            self._ppm_state = [now_us, sample_ts]

    @staticmethod
    def _open_source(src):
        """src.open(); a missing library, device or tty ends the run with
        exit code 1 and its message, without a traceback."""
        try:
            return src.open()
        except (RuntimeError, OSError) as e:
            log.error("%s", e)
            raise SystemExit(1) from None

    async def _run_sdr_source(self, src, fmt: str) -> None:
        """Feed an SDR source's buffers to a Demodulator on the app's
        device, one superblock at a time, in the executor thread with that
        device current.  As in readsb_tpu, a source that ends is not
        flushed: the samples short of a superblock stay unread."""
        from ..pipeline import Demodulator

        args = self.args
        self._open_source(src)
        demod = Demodulator(
            fmt=fmt, blocks_per_batch=args.blocks_per_batch,
            k_per_block=args.candidates_per_block,
            threshold=args.preamble_threshold, nfix=args.nfix_crc,
            fix_df=args.fix_df, modeac=args.modeac,
            device=self._demod_device(),
        )
        self._demod = demod
        loop = asyncio.get_event_loop()
        src.start(loop)
        pending: list[bytes] = []
        pending_len = 0
        want = demod.super_samples * (2 if fmt == "uc8" else 4)
        try:
            while not self._exit_event.is_set():
                data = await src.queue.get()
                if not data:
                    log.error("rtl-sdr reader stopped (device lost?)")
                    break
                pending.append(data)
                pending_len += len(data)
                if pending_len < want:
                    continue
                buf = b"".join(pending)
                pending, pending_len = [buf[want:]], len(buf) - want
                t0 = time.perf_counter()
                frames = await loop.run_in_executor(
                    None, self._on_device, demod.feed, buf[:want]
                )
                self.stats_collector.cpu["demod"] += (time.perf_counter() - t0) * 1e3
                for fr in frames:
                    self.handle_frame(fr)
                self._drain_modeac(demod)
                self._note_timing(demod)
                if src.dropped_buffers:
                    self.stats_collector.note_sdr_drops(src.dropped_buffers)
                    src.dropped_buffers = 0
        finally:
            src.close()

    async def run_beast_serial(self, gns: bool = False) -> None:
        """Beast receiver on a raw serial tty; bytes go through the same
        deframer/scorer path as network Beast input (sdr_beast.c).
        gns=True selects the GNS5894/HULC handler (SDR_GNS)."""
        from ..io.sdr import BeastSerialSource

        args = self.args
        # default 3M for Beast, 921600 for GNS HULC (sdr_beast.c:126,162-164)
        baud = args.beast_baudrate or (921_600 if gns else 3_000_000)
        src = BeastSerialSource(
            path=args.beast_serial, baud=baud, gns=gns,
            mlat_timestamps=not args.beast_mlat_off,
            crc_checks=not args.beast_crc_off,
            fec=not args.beast_fec_off,
            filter_df1117=args.beast_df1117_on,
            filter_df045=args.beast_df045_on,
            mode_ac=args.beast_modeac or args.modeac,
        )
        fd = self._open_source(src)
        conn = self._beast_input_factory()()
        loop = asyncio.get_event_loop()
        ready = asyncio.Event()
        loop.add_reader(fd, ready.set)
        try:
            while not self._exit_event.is_set():
                await ready.wait()
                ready.clear()
                try:
                    data = os.read(fd, 65536)
                except BlockingIOError:
                    continue
                if not data:
                    await asyncio.sleep(0.05)
                    continue
                await conn.feed(data)
        finally:
            loop.remove_reader(fd)
            src.close()

    def _drain_modeac(self, demod) -> None:
        """Forward Mode A/C pseudo-messages into the tracker."""
        if not demod.modeac_msgs:
            return
        msgs, demod.modeac_msgs = demod.modeac_msgs, []
        for mm in msgs:
            mm.sys_timestamp_ms = self.epoch_ms + mm.timestamp // 12000
            self.handle_message(mm, raw_ts=mm.timestamp)

    def _beast_send(self, svc, payload: bytes, mm) -> None:
        """Beast output with optional 0xE3 receiver-id forwarding: resend
        the id frame whenever it changes on the lane (net_io.c:1657-1680)."""
        if self.args.net_receiver_id:
            rid = getattr(mm, "receiver_id", 0)
            if getattr(svc, "_last_rid", None) != rid:
                svc._last_rid = rid
                svc.send(beast_io.encode_receiver_id(rid))
        svc.send(payload)

    # ------------------------------------------------------------------

    def _beast_input_factory(self):
        app = self

        class BeastIn(InputConnection):
            def __init__(self):
                # columnar drain: the native columnar deframer (readBeast
                # analog) feeds column batches straight to the drain.
                # --dump-beast needs per-frame BeastFrame records, so it
                # takes the object deframer (the frames still drain through
                # the columnar path via drain_bulk)
                self.cols_mode = app.bulk is not None and app.beast_dump is None
                self.deframer = (
                    beast_io.ColumnarDeframer() if self.cols_mode
                    else beast_io.BeastDeframer()
                )
                self.scorer = app._net_scorer()
                self.ping_state = None  # set by InputService when ping=True

            def _drain_controls(self) -> None:
                if not self.deframer.commands:
                    return
                cmds, self.deframer.commands = self.deframer.commands, []
                ps = self.ping_state
                for c in cmds:
                    if ps is not None and c[:1] == b"W" and c[1:2] == b"O":
                        ps.enabled = True  # 'WO': high-res ping opt-in
                    elif c[:1] == b"P" and len(c) >= 4:
                        val = (c[1] << 16) | (c[2] << 8) | c[3]
                        if ps is not None:
                            # server role: the feeder echoed our ping
                            ps.pong(
                                val,
                                app.now_ms() if app._demod else int(time.time() * 1000),
                            )
                        elif getattr(self, "writer", None) is not None:
                            # client role: an upstream pinged us — echo it
                            # back (pong(), net_io.c:1316-1320)
                            from ..io.net import make_ping

                            try:
                                self.writer.write(make_ping(val))
                            except Exception:
                                pass

            async def feed(self, data: bytes) -> None:
                if self.cols_mode:
                    batch = self.deframer.feed(data)
                    if batch is not None:
                        # Mode A/C ('1') frames are rare: per-message path
                        ac = batch["mlen"] == 2
                        if ac.any():
                            from ..decode.mode_ac import decode_modeac_message

                            for i in ac.nonzero()[0]:
                                code = (int(batch["msgs"][i][0]) << 8) | int(
                                    batch["msgs"][i][1]
                                )
                                mm = decode_modeac_message(
                                    code, timestamp=int(batch["ts"][i])
                                )
                                mm.sys_timestamp_ms = (
                                    int(batch["synth"][i]) or app.now_ms()
                                )
                                mm.remote = True
                                mm.receiver_id = int(batch["rid"][i])
                                app.handle_message(
                                    mm, raw_ts=int(batch["ts"][i])
                                )
                        app._net_cols_queue.append(batch)
                        if sum(len(b["ts"]) for b in app._net_cols_queue) >= 8192:
                            app.drain_net_queue()
                    self._drain_controls()
                    return
                for bf in self.deframer.feed(data):
                    if len(bf.msg) == 2:  # Beast type '1': Mode A/C
                        from ..decode.mode_ac import decode_modeac_message

                        code = (bf.msg[0] << 8) | bf.msg[1]
                        mm = decode_modeac_message(code, timestamp=bf.timestamp)
                        mm.sys_timestamp_ms = bf.synthetic_ms or app.now_ms()
                        mm.remote = True
                        mm.receiver_id = bf.receiver_id
                        app.handle_message(mm, raw_ts=bf.timestamp, signal=bf.signal_level)
                        continue
                    if len(bf.msg) not in (7, 14):
                        continue
                    app._handle_net_frame(self.scorer, bf)
                self._drain_controls()

        return BeastIn

    def _raw_input_factory(self):
        app = self

        class RawIn(InputConnection):
            def __init__(self):
                self.deframer = raw_io.RawDeframer()
                self.scorer = app._net_scorer()

            async def feed(self, data: bytes) -> None:
                for rl in self.deframer.feed(data):
                    if len(rl.msg) not in (7, 14):
                        continue
                    app._handle_net_frame(
                        self.scorer,
                        beast_io.BeastFrame(
                            msg=rl.msg, timestamp=rl.timestamp,
                            signal_byte=rl.signal_byte, msg_type=0,
                        ),
                    )

        return RawIn

    def _planefinder_input_factory(self):
        """Planefinder DLE-stuffed binary input (net_io.c:3995-4103)."""
        app = self

        class PfIn(InputConnection):
            def __init__(self):
                from ..io import planefinder as pf_io

                self.deframer = pf_io.PfDeframer()
                self.scorer = app._net_scorer()

            async def feed(self, data: bytes) -> None:
                for pm in self.deframer.feed(data):
                    if pm.is_modeac:
                        if not app.args.modeac:
                            continue
                        from ..decode.mode_ac import decode_modeac_message

                        mm = decode_modeac_message(
                            (pm.msg[0] << 8) | pm.msg[1],
                            sys_timestamp_ms=app.now_ms(),
                        )
                        if mm is not None:
                            app.handle_message(mm)
                        continue
                    app._handle_net_frame(
                        self.scorer,
                        beast_io.BeastFrame(
                            msg=pm.msg,
                            timestamp=pm.timestamp_ns * 12 // 1000,  # ns -> 12MHz
                            signal_byte=pm.signal_byte,
                            msg_type=0,
                        ),
                    )

        return PfIn

    async def _gpsd_watch(self, writer) -> None:
        from ..io import gpsd as gpsd_io

        writer.write(gpsd_io.WATCH_COMMAND)

    def _gpsd_input_factory(self):
        """gpsd TPV JSON -> own receiver location (net_io.c:3609-3717)."""
        app = self

        class GpsdIn(InputConnection):
            def __init__(self):
                self._buf = b""

            async def feed(self, data: bytes) -> None:
                from ..io import gpsd as gpsd_io

                self._buf += data
                *lines, self._buf = self._buf.split(b"\n")
                for line in lines:
                    fix = gpsd_io.parse_tpv_line(line)
                    if fix is None:
                        continue
                    lat, lon, _alt = fix
                    app.tracker.receiver_lat = lat
                    app.tracker.receiver_lon = lon
                    log.info("gpsd: receiver position %.6f,%.6f", lat, lon)

        return GpsdIn

    def _uat_input_factory(self):
        """dump978 raw lines -> synthetic DF18 (decodeUatMessage, net_io.c:4334-4371)."""
        app = self

        class UatIn(InputConnection):
            def __init__(self):
                self._buf = b""
                self.scorer = app._net_scorer()

            async def feed(self, data: bytes) -> None:
                from ..io import uat as uat_io

                self._buf += data
                *lines, self._buf = self._buf.split(b"\n")
                for line in lines:
                    line = line.strip()
                    if not line:
                        continue
                    if app.out_uat_replay.clients:
                        app.out_uat_replay.send(line + b"\n")
                    frames, sig = uat_io.convert_line(line)
                    for frame in frames:
                        addr = int.from_bytes(frame[1:4], "big")
                        now = app.now_ms()
                        a = app.tracker.aircraft.get(addr)
                        # ignore the whole first UAT line from a
                        # (re)appearing aircraft — the reference returns
                        # from decodeUatMessage, dropping every frame the
                        # line synthesized (net_io.c:4357-4366)
                        if a is None or now > a.seen + 300_000:
                            app.tracker.get_or_create(addr, now).seen = now
                            break
                        app._handle_net_frame(
                            self.scorer,
                            beast_io.BeastFrame(
                                msg=frame,
                                timestamp=uat_io.MAGIC_UAT_TIMESTAMP,
                                signal_byte=sig,
                                msg_type=0,
                            ),
                        )

        return UatIn

    def _sbs_input_factory(self, source=Source.SBS):
        """SBS/BaseStation CSV input (decodeSbsLine, net_io.c:2952-3183)."""
        app = self

        class SbsIn(InputConnection):
            def __init__(self):
                from ..io.sbs import SbsDeframer

                self.deframer = SbsDeframer()

            async def feed(self, data: bytes) -> None:
                from ..decode.fields import AirGround

                for sl in self.deframer.feed(data):
                    mm = ModesMessage(
                        msgtype=0,
                        addr=sl.addr & 0xFFFFFF,
                        source=source,
                        sys_timestamp_ms=app.now_ms(),
                    )
                    mm.remote = True
                    if sl.callsign:
                        mm.callsign = sl.callsign
                        mm.callsign_valid = True
                    if sl.altitude is not None:
                        mm.baro_alt = sl.altitude
                    if sl.gs is not None:
                        mm.gs_selected = mm.gs_v0 = sl.gs
                    if sl.track is not None:
                        from ..decode.fields import HeadingType

                        mm.heading = sl.track
                        mm.heading_type = HeadingType.GROUND_TRACK
                    if sl.lat is not None and sl.lon is not None:
                        mm.sbs_pos_valid = True
                        mm.decoded_lat = sl.lat
                        mm.decoded_lon = sl.lon
                    if sl.vr is not None:
                        mm.baro_rate = sl.vr
                    if sl.squawk_dec is not None:
                        try:
                            mm.squawk_hex = int(str(sl.squawk_dec), 16)
                        except ValueError:
                            pass
                    if sl.alert is not None:
                        mm.alert = sl.alert
                    if sl.spi is not None:
                        mm.spi = sl.spi
                    if sl.on_ground is not None:
                        mm.airground = (
                            AirGround.GROUND if sl.on_ground else AirGround.AIRBORNE
                        )
                    app.handle_message(mm)

        return SbsIn

    def _asterix_input_factory(self):
        """ASTERIX CAT021 binary input (net_io.c:1922-2415)."""
        app = self

        class AsterixIn(InputConnection):
            def __init__(self):
                from ..io.asterix import AsterixDeframer

                self.deframer = AsterixDeframer()

            async def feed(self, data: bytes) -> None:
                from ..io.asterix import decode_cat21

                for frame in self.deframer.feed(data):
                    mm = decode_cat21(frame, now_ms=app.now_ms())
                    if mm is None:
                        continue
                    mm.remote = True
                    app.handle_message(mm)

        return AsterixIn


    def _net_scorer(self):
        """All network inputs share one Scorer — the reference's ICAO
        filter is process-global (icao_filter.c), so frames from one
        feeder teach addresses that validate frames from every other."""
        if self._shared_net_scorer is None:
            from ..decode.score import Scorer

            self._shared_net_scorer = Scorer(
                nfix=self.args.nfix_crc, fix_df=self.args.fix_df
            )
        return self._shared_net_scorer

    def _handle_net_frame(self, scorer, bf) -> None:
        """Network-received frame: queue for the batched decode drain.

        The reference fans per-frame decode over a threadpool with staged
        locks (net_io.c:5365-5474); here frames accumulate per tick and
        the CRC stage runs as ONE vectorized batch (drain_net_queue).
        """
        if self.beast_dump is not None:
            self.beast_dump.record(bf, self.now_ms())
        self._net_queue.append(bf)
        if len(self._net_queue) >= 8192:
            self.drain_net_queue()


    def drain_net_queue(self) -> None:
        """Batched CRC + serial accept/track for all queued net frames."""
        q = self._net_queue
        if not q and not self._net_cols_queue:
            return
        self._net_queue = []
        if self.bulk is not None:
            from .bulk_drain import drain_bulk, drain_cols

            if q:
                drain_bulk(self, q)
            if self._net_cols_queue:
                batches, self._net_cols_queue = self._net_cols_queue, []
                drain_cols(self, batches)
            return
        _net_t0 = time.perf_counter()
        import numpy as np

        from ..ops import crc as crc_ops
        from ..decode.score import RawFrame

        m = len(q)
        msgs = np.zeros((m, 14), dtype=np.uint8)
        for i, bf in enumerate(q):
            b = bf.msg[:14]
            msgs[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        syn112 = crc_ops.checksum_batch(msgs, 112)
        syn56 = crc_ops.checksum_batch(np.ascontiguousarray(msgs[:, :7]), 56)

        scorer = self._net_scorer()
        now_default = self.now_ms()
        for i, bf in enumerate(q):
            result, info = scorer.decode_accept(
                msgs[i], int(syn112[i]), int(syn56[i])
            )
            if result < 0:
                continue
            frame = RawFrame(
                msg=bytes(info["msg"]), msgbits=info["msgbits"],
                timestamp=bf.timestamp, score=0, phase=0,
                correctedbits=info["correctedbits"], addr=info["addr"],
                signal_power=bf.signal_level, iid=info["iid"],
            )
            mm = decode_frame(frame, epoch_ms=0)
            mm.sys_timestamp_ms = bf.synthetic_ms or now_default
            mm.remote = True
            mm.receiver_id = bf.receiver_id
            # quarantined feeders: divert to garbage (net_io.c:3943-3961)
            if bf.receiver_id and self.tracker.receivers.check_bad(
                bf.receiver_id, mm.sys_timestamp_ms
            ):
                mm.garbage = True
                if self.out_garbage.clients and len(mm.msg) in (7, 14):
                    self.out_garbage.send(
                        beast_io.encode_frame(mm.msg, bf.timestamp, bf.signal_level)
                    )
                continue
            self.handle_message(mm, raw_ts=bf.timestamp, signal=bf.signal_level)
        self.stats_collector.cpu["net"] += (time.perf_counter() - _net_t0) * 1e3

    # ------------------------------------------------------------------

    def write_json_files(self, now: int) -> None:
        """aircraft.json (and .gz), receiver.json, receivers.json and
        outline.json into --write-json."""
        args = self.args
        os.makedirs(args.write_json, exist_ok=True)
        # with the API enabled, aircraft.json byte-joins the api buffer's
        # prebuilt fragments instead of re-rendering every aircraft
        # (apiGenerateAircraftJson, api.c:2027; the reference's
        # jsonEntryPoint does exactly this)
        snap = getattr(getattr(self, "api_server", None), "snapshot", None)
        if snap is not None and now - snap.now <= args.write_json_every * 1000 + 1000:
            data = json_out.aircraft_json_bytes_from_api(snap, self.messages)
            json_out.write_bytes_atomic(data, os.path.join(args.write_json, "aircraft.json"))
            if args.write_json_gzip:
                json_out.write_bytes_atomic(
                    data, os.path.join(args.write_json, "aircraft.json.gz"), gzip_level=5
                )
        else:
            doc = json_out.generate_aircraft_json(self.tracker, now, self.messages)
            json_out.write_json_atomic(doc, os.path.join(args.write_json, "aircraft.json"))
            if args.write_json_gzip:
                json_out.write_json_atomic(
                    doc, os.path.join(args.write_json, "aircraft.json.gz"), gzip_level=5
                )
        rj = json_out.generate_receiver_json(
            int(args.write_json_every * 1000), args.lat, args.lon
        )
        rj["jaeroTimeout"] = round(args.jaero_timeout, 1)
        if args.tar1090_use_api:
            rj["reapi"] = True  # json_out.c:1906
        json_out.write_json_atomic(rj, os.path.join(args.write_json, "receiver.json"))
        if args.write_receiver_id_json or args.json_globe_index:
            json_out.write_json_atomic(
                self.tracker.receivers.receivers_json(now),
                os.path.join(args.write_json, "receivers.json"),
            )
        if args.lat is not None:
            import json as _json

            json_out.write_json_atomic(
                _json.loads(self.tracker.outline.outline_json()),
                os.path.join(args.write_json, "outline.json"),
            )

    async def run_periodic(self) -> None:
        args = self.args
        last_json = 0.0
        last_state = time.time()
        last_traces = 0.0
        last_heatmap_slot = -1
        last_vrs = 0.0
        last_db_check = time.time()
        display = None
        if args.interactive and not args.no_interactive:
            from .interactive import InteractiveDisplay

            display = InteractiveDisplay(
                self.tracker, ttl_s=args.interactive_ttl, metric=args.metric
            )
        while True:
            await asyncio.sleep(0.25)
            self._last_tick = time.time()
            _bg_t0 = time.perf_counter()
            self.drain_net_queue()
            now = self.now_ms()
            self._materialize(now)
            self.stats_collector.sample(self, now / 1000.0)
            if getattr(self, "api_server", None) is not None:
                # double-buffered query snapshot swap (apiUpdate, api.c:859)
                _api_t0 = time.perf_counter()
                self.api_server.update(now)
                self.stats_collector.cpu["api"] += (time.perf_counter() - _api_t0) * 1e3
            if display is not None:
                display.refresh(now)
            if self.tracker.db is not None and time.time() - last_db_check >= 30.0:
                last_db_check = time.time()
                self.tracker.db_reload()
            if self.out_vrs.clients and time.time() - last_vrs >= args.net_vrs_interval:
                last_vrs = time.time()
                from ..io import vrs as vrs_io

                self.out_vrs.send(vrs_io.generate_vrs(self.tracker, now))
            self.tracker.remove_stale(now)
            if args.modeac_auto and not args.modeac:
                # autoset_modeac (net_io.c:3577): demod A/C only while some
                # beast client has requested it with the '1J' command
                want = any(
                    o.get("modeac") for o in self.out_beast.client_opts.values()
                )
                if self._demod is not None and getattr(self._demod, "modeac", want) != want:
                    self._demod.modeac = want
            if args.modeac or (
                args.modeac_auto
                and self._demod is not None
                and getattr(self._demod, "modeac", False)
            ):
                self.tracker.match_ac(now)
            if args.write_json and time.time() - last_json >= args.write_json_every:
                last_json = time.time()
                self.write_json_files(now)
            self.tracker.receivers.maintenance(now, interval_ms=250)
            if args.json_globe_index and args.write_json:
                from ..io import history as history_io

                if time.time() - last_traces >= args.write_traces_every:
                    last_traces = time.time()
                    t0 = time.perf_counter()
                    _, self._trace_cursor = history_io.write_traces(
                        self.tracker, args.write_json, now,
                        cursor=getattr(self, "_trace_cursor", 0),
                        hist_only=args.json_trace_hist_only,
                    )
                    self.stats_collector.cpu["background"] += (
                        time.perf_counter() - t0
                    ) * 1e3
                history_io.write_globe_bincraft(self.tracker, args.write_json, now)
            if args.heatmap and (args.globe_history_dir or args.heatmap_dir):
                from ..io import history as history_io

                slot = now // (30 * 60 * 1000)
                if last_heatmap_slot < 0:
                    last_heatmap_slot = slot
                elif slot != last_heatmap_slot:
                    last_heatmap_slot = slot
                    start = (slot - 1) * 30 * 60 * 1000
                    history_io.write_heatmap(
                        self.tracker, args.heatmap_dir or args.globe_history_dir,
                        start, start + 30 * 60 * 1000,
                        interval_ms=int(args.heatmap * 1000),
                    )
            if args.write_prom:
                from ..io import stats as stats_io

                stats_io.write_prom(self, args.write_prom, now)
            if args.write_json:
                json_out.write_json_atomic(
                    self.stats_collector.stats_json(self, now / 1000.0),
                    os.path.join(args.write_json, "stats.json"),
                )
                json_out.write_json_atomic(
                    self.clients_json(now),
                    os.path.join(args.write_json, "clients.json"),
                )
                self._check_state_triggers(now)
            self.stats_collector.cpu["background"] += (
                time.perf_counter() - _bg_t0
            ) * 1e3
            if (args.write_state and not args.write_state_only_on_exit
                    and time.time() - last_state >= args.write_state_every):
                last_state = time.time()
                from ..io import state as state_io

                state_io.save_state(self.tracker, args.write_state, now)
            # arena maintenance last, as readsb_tpu orders it
            if self.arena is not None:
                self.arena.sweep(now)

    def _materialize(self, now: int) -> None:
        """Sync the columnar store (and the device arena) into the dict
        Aircraft views that every serving surface reads."""
        if self.bulk is None:
            return
        from .bulk_drain import materialize, materialize_arena

        materialize(self, now)
        if self.arena is not None:
            materialize_arena(self, now)

    def _uuid_bytes(self) -> bytes:
        """16-byte receiver UUID (sendUUID, net_io.c:372)."""
        if getattr(self, "_uuid_cache", None) is None:
            import uuid as _uuid

            u = None
            if self.args.uuid_file and os.path.exists(self.args.uuid_file):
                try:
                    u = _uuid.UUID(open(self.args.uuid_file).read().strip())
                except ValueError:
                    u = None
            self._uuid_cache = (u or _uuid.uuid4()).bytes
        return self._uuid_cache

    async def _command_socket(self, path: str) -> None:
        """Unix command socket (handleCommandSocket, net_io.c:3718)."""

        async def handle(reader, writer):
            try:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    toks = line.decode("latin1", "replace").split()
                    if not toks:
                        continue
                    if toks[0] == "deleteTrace" and len(toks) >= 4:
                        try:
                            hexid = int(toks[1], 16)
                            t_from, t_to = int(toks[2]), int(toks[3])
                        except ValueError:
                            continue
                        a = self.tracker.aircraft.get(hexid)
                        if a is not None and getattr(a, "trace", None) is not None:
                            a.trace.delete_range(t_from * 1000, t_to * 1000)
                        log.warning("cmd.sock: deleteTrace %06x %d %d", hexid, t_from, t_to)
                    else:
                        log.warning("cmd.sock: unrecognized command %r", toks[0])
            except Exception:
                pass
            finally:
                try:
                    writer.close()
                except Exception:
                    pass

        try:
            server = await asyncio.start_unix_server(handle, path=path)
            self.net.servers.append(server)
        except (OSError, NotImplementedError) as e:
            log.warning("cmd.sock unavailable: %s", e)


    def _check_state_triggers(self, now: int) -> None:
        """getState / replaceState trigger files: zero-downtime state
        export / hot-swap (readsb.c:2412-2485, replicate_state.sh)."""
        from ..io import state as state_io

        jd = self.args.write_json
        if not jd:
            return
        get_dir = os.path.join(jd, "getState")
        trig = os.path.join(get_dir, "writeState")
        if os.path.exists(trig):
            try:
                txt = open(trig).read().strip()
                if len(txt) == 2:  # single blob by hex suffix
                    state_io.save_blob(self.tracker, get_dir, int(txt, 16))
                else:
                    state_io.save_state(self.tracker, get_dir, now)
            finally:
                # unlink after writing: shell scripts poll for completion
                try:
                    os.unlink(trig)
                except OSError:
                    pass
            log.warning("getState: state written to %s", get_dir)
        rep_dir = os.path.join(jd, "replaceState")
        if os.path.isdir(rep_dir):
            n = state_io.load_state(self.tracker, rep_dir)
            import shutil

            shutil.rmtree(rep_dir, ignore_errors=True)
            log.warning("replaceState: %d aircraft hot-swapped in", n)

    def clients_json(self, now: int) -> dict:
        """clients.json: connected-client inventory (json_out.c:2247)."""
        clients = []
        for name, svc in self.net.outputs.items():
            for w in svc.clients:
                peer = w.get_extra_info("peername")
                opts = svc.client_opts.get(id(w), {})
                clients.append(
                    {
                        "service": name,
                        "host": (peer[0] if peer else "?"),
                        "port": (peer[1] if peer else 0),
                        "modeac": bool(opts.get("modeac")),
                    }
                )
        return {"now": now / 1000.0, "clients": clients,
                "clients_shed": sum(s.clients_shed for s in self.net.outputs.values())}

    async def setup_net(self) -> None:
        args = self.args
        if not (args.net or args.net_only):
            return
        # --net-bind-address for every listener
        import functools as _ft

        self.net.listen_output = _ft.partial(self.net.listen_output, host=args.net_bind_address) \
            if args.net_bind_address != "0.0.0.0" else self.net.listen_output
        self.net.listen_input = _ft.partial(self.net.listen_input, host=args.net_bind_address) \
            if args.net_bind_address != "0.0.0.0" else self.net.listen_input
        if args.net_ro_port:
            for _p in args.net_ro_port:
                await self.net.listen_output(self.out_raw, _p)
        if args.net_bo_port:
            for _p in args.net_bo_port:
                await self.net.listen_output(self.out_beast, _p)
        if args.net_sbs_port:
            for _p in args.net_sbs_port:
                await self.net.listen_output(self.out_sbs, _p)
            base = args.net_sbs_port[0]
            if base % 10 == 5:
                await self.net.listen_output(self.out_sbs_replay, base + 1)
                await self.net.listen_output(self.out_sbs_mlat, base + 2)
                await self.net.listen_output(self.out_sbs_prio, base + 3)
                await self.net.listen_output(self.out_sbs_jaero, base + 4)
        if args.net_json_port:
            for _p in args.net_json_port:
                await self.net.listen_output(self.out_json, _p)
        if args.net_garbage_port:
            for _p in args.net_garbage_port:
                await self.net.listen_output(self.out_garbage, _p)
        if args.net_bi_port:
            await self.net.listen_input(
                InputService(
                    "beast_in", self._beast_input_factory(),
                    ping=args.net_ingest, reject_ms=args.ping_reject,
                    on_rtt=self.stats_collector.note_rtt,
                ), args.net_bi_port[0]
            )
            for _p in args.net_bi_port[1:]:
                await self.net.listen_input(
                    InputService(
                        "beast_in", self._beast_input_factory(),
                        ping=args.net_ingest, reject_ms=args.ping_reject,
                        on_rtt=self.stats_collector.note_rtt,
                    ), _p
                )
        if args.net_ri_port:
            await self.net.listen_input(
                InputService("raw_in", self._raw_input_factory()), args.net_ri_port[0]
            )
            for _p in args.net_ri_port[1:]:
                await self.net.listen_input(
                    InputService("raw_in", self._raw_input_factory()), _p
                )
        if args.net_uat_in_port:
            await self.net.listen_input(
                InputService("uat_in", self._uat_input_factory()),
                args.net_uat_in_port[0],
            )
        if args.net_uat_replay_port:
            for _p in args.net_uat_replay_port:
                await self.net.listen_output(self.out_uat_replay, _p)
        if args.net_vrs_port:
            for _p in args.net_vrs_port:
                await self.net.listen_output(self.out_vrs, _p)
        if args.net_sbs_in_port:
            await self.net.listen_input(
                InputService("sbs_in", self._sbs_input_factory()),
                args.net_sbs_in_port[0],
            )
            if args.net_sbs_in_port[0] % 10 == 5:
                await self.net.listen_input(
                    InputService("sbs_in_mlat", self._sbs_input_factory(Source.MLAT)),
                    args.net_sbs_in_port[0] + 2,
                )
                await self.net.listen_input(
                    InputService("sbs_in_prio", self._sbs_input_factory(Source.PRIO)),
                    args.net_sbs_in_port[0] + 3,
                )
                await self.net.listen_input(
                    InputService("sbs_in_jaero", self._sbs_input_factory(Source.JAERO)),
                    args.net_sbs_in_port[0] + 4,
                )
        if args.net_sbs_jaero_port:
            for _p in args.net_sbs_jaero_port:
                await self.net.listen_output(self.out_sbs_jaero, _p)
        if args.net_sbs_jaero_in_port:
            for _p in args.net_sbs_jaero_in_port:
                await self.net.listen_input(
                    InputService("sbs_in_jaero", self._sbs_input_factory(Source.JAERO)),
                    _p,
                )
        if args.net_ai_port:
            await self.net.listen_input(
                InputService("asterix_in", self._asterix_input_factory()),
                args.net_ai_port[0],
            )
        if args.net_ao_port:
            for _p in args.net_ao_port:
                await self.net.listen_output(self.out_asterix, _p)
        if args.net_beast_reduce_out_port:
            for _p in args.net_beast_reduce_out_port:
                await self.net.listen_output(self.out_beast_reduce, _p)
        if args.write_json:
            os.makedirs(args.write_json, exist_ok=True)
            await self._command_socket(os.path.join(args.write_json, "cmd.sock"))
        if args.net_api_port:
            from ..io.api import ApiServer

            self.api_server = ApiServer(self)
            port = args.net_api_port
            if isinstance(port, str) and not port.isdigit():
                # a path: unix-socket listener (api.c:1967)
                await self.api_server.listen_unix(port)
            else:
                await self.api_server.listen(int(port))
        # shadow locally so a non-default delay applies to every connector
        Connector = _ft.partial(  # noqa: F841 (shadows the module import)
            globals()["Connector"], reconnect_delay=args.net_connector_delay
        )
        for spec in args.net_connector:
            parts = spec.split(",")
            host, port, proto = parts[0], int(parts[1]), parts[2]
            if proto == "beast_reduce_plus_out":
                # UUID + high-res-ping handshake on connect
                # (net_io.c:372,1064-1066,4897)
                async def _hello(w, app=self):
                    w.write(b"\x1a\xe4" + app._uuid_bytes() + b"\x1aWO")

                self.net.add_connector(
                    Connector(host, port, output=self.out_beast_reduce, on_connect=_hello)
                )
                continue
            if proto in ("sbs_in_mlat", "sbs_in_jaero", "sbs_in_prio"):
                src = {
                    "sbs_in_mlat": Source.MLAT,
                    "sbs_in_jaero": Source.JAERO,
                    "sbs_in_prio": Source.PRIO,
                }[proto]
                self.net.add_connector(
                    Connector(host, port, input_factory=self._sbs_input_factory(src))
                )
                continue
            if proto in ("beast_in",):
                self.net.add_connector(
                    Connector(host, port, input_factory=self._beast_input_factory())
                )
            elif proto in ("raw_in",):
                self.net.add_connector(
                    Connector(host, port, input_factory=self._raw_input_factory())
                )
            elif proto == "uat_in":
                self.net.add_connector(
                    Connector(host, port, input_factory=self._uat_input_factory())
                )
            elif proto == "gpsd_in":
                self.net.add_connector(
                    Connector(
                        host, port,
                        input_factory=self._gpsd_input_factory(),
                        on_connect=self._gpsd_watch,
                    )
                )
            elif proto == "planefinder_in":
                self.net.add_connector(
                    Connector(host, port, input_factory=self._planefinder_input_factory())
                )
            elif proto == "vrs_out":
                self.net.add_connector(Connector(host, port, output=self.out_vrs))
            elif proto == "beast_out":
                self.net.add_connector(Connector(host, port, output=self.out_beast))
            elif proto in ("beast_reduce_out", "beast_reduce_plus_out"):
                self.net.add_connector(
                    Connector(host, port, output=self.out_beast_reduce)
                )
            elif proto == "sbs_in":
                self.net.add_connector(
                    Connector(host, port, input_factory=self._sbs_input_factory())
                )
            elif proto == "asterix_in":
                self.net.add_connector(
                    Connector(host, port, input_factory=self._asterix_input_factory())
                )
            elif proto == "asterix_out":
                self.net.add_connector(Connector(host, port, output=self.out_asterix))
            elif proto == "raw_out":
                self.net.add_connector(Connector(host, port, output=self.out_raw))
            elif proto == "sbs_out":
                self.net.add_connector(Connector(host, port, output=self.out_sbs))
            elif proto == "json_out":
                self.net.add_connector(Connector(host, port, output=self.out_json))
            else:
                log.warning("unsupported connector protocol: %s", proto)


    # ------------------------------------------------------------------

    def print_stats(self) -> None:
        t = self.tracker
        elapsed = time.time() - self.start_time
        print(f"readsb-tpu-torch statistics ({elapsed:.1f}s):", file=sys.stderr)
        if self._demod is not None:
            st = self._demod.stats
            samples = self._demod.scan_global
            print(f"  {samples} samples processed", file=sys.stderr)
            print(f"  {st.preambles} Mode-S message preambles received", file=sys.stderr)
            print(f"    {st.rejected_bad} with bad message format or invalid CRC", file=sys.stderr)
            print(f"    {st.rejected_unknown_icao} with unrecognized ICAO address", file=sys.stderr)
            print(f"    {st.accepted[0]} accepted with correct CRC", file=sys.stderr)
            print(f"    {st.accepted[1]} accepted with 1-bit error repaired", file=sys.stderr)
        print(f"  {self.messages} messages total", file=sys.stderr)
        print(f"  {len(t.aircraft)} aircraft tracked", file=sys.stderr)
        print(
            f"  CPR: {t.cpr_global_ok} global ok, {t.cpr_global_bad} global bad, "
            f"{t.cpr_local_ok} local ok",
            file=sys.stderr,
        )

    def _start_watchdog(self) -> None:
        """Hang watchdog (readsb.c:2884-2904): a daemon thread that kills
        the process if the asyncio loop stops ticking for 60 s — a thread
        catches genuine event-loop hangs that a coroutine cannot."""
        import threading

        self._last_tick = time.time()

        def watch():
            while not getattr(self, "_exiting", False):
                time.sleep(15.0)
                stall = time.time() - self._last_tick
                if stall > 60.0 and not getattr(self, "_exiting", False):
                    log.critical("main loop hung for %.0f s, exiting", stall)
                    os._exit(1)

        threading.Thread(target=watch, daemon=True).start()

    def _install_signals(self) -> None:
        """SIGTERM/SIGINT -> ordered shutdown with a final state write
        (readsb.c:2649, 2917-3011)."""
        import signal as _signal

        loop = asyncio.get_event_loop()

        def request_exit():
            if not self._exit_event.is_set():
                log.info("caught signal, shutting down")
                self._exit_event.set()

        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                loop.add_signal_handler(sig, request_exit)
            except (NotImplementedError, RuntimeError):
                pass

    async def amain(self) -> int:
        self._exit_event = asyncio.Event()
        self._exiting = False
        if self.args.decode_threads > 1:
            import concurrent.futures as _cf

            asyncio.get_event_loop().set_default_executor(
                _cf.ThreadPoolExecutor(max_workers=self.args.decode_threads)
            )
        await self.setup_net()
        self._install_signals()
        self._start_watchdog()
        if self.args.auto_exit > 0:
            asyncio.get_event_loop().call_later(
                self.args.auto_exit, self._exit_event.set
            )
        if "provokeSegfault" in (self.args.devel or []):
            # fault injection (--devel=provokeSegfault, readsb.c:2831-2836):
            # deliberately crash shortly after startup so crash handling /
            # supervisor restart paths can be exercised
            import threading as _th

            def _provoke():
                time.sleep(1.0)
                import ctypes as _ct

                _ct.string_at(0)  # NULL dereference

            _th.Thread(target=_provoke, daemon=True).start()
        periodic = asyncio.ensure_future(self.run_periodic())
        try:
            if self.args.device_type == "ifile":
                await self.run_ifile()
                if self.args.net or self.args.net_only:
                    await asyncio.sleep(0.2)  # let outputs flush
            elif self.args.device_type == "rtlsdr":
                await self.run_rtlsdr()
            elif self.args.device_type == "soapy":
                await self.run_soapy()
            elif self.args.device_type == "modesbeast":
                await self.run_beast_serial()
            elif self.args.device_type == "gnshulc":
                await self.run_beast_serial(gns=True)
            elif self.args.device_type == "hackrf":
                await self.run_hackrf()
            elif self.args.device_type == "bladerf":
                await self.run_bladerf()
            elif self.args.device_type == "ubladerf":
                await self.run_bladerf(micro=True)
            elif self.args.device_type == "plutosdr":
                await self.run_pluto()
            elif self.args.net or self.args.net_only:
                await self._exit_event.wait()
            else:
                log.error("no source: use --device-type ifile or --net-only")
                return 1
        finally:
            # ordered shutdown (readsb.c:2917-3011): stop periodic work,
            # drain pending decode, final state write, flush, close
            self._exiting = True
            if (
                getattr(self, "api_server", None) is not None
                and self.args.api_shutdown_delay > 0
            ):
                # keep serving in-flight API queries; new ones get 503
                self.api_server.draining = True
                await asyncio.sleep(self.args.api_shutdown_delay)
            periodic.cancel()
            self.drain_net_queue()
            self._materialize(self.now_ms())
            if self.args.json_globe_index and self.args.write_json:
                # flush dirty traces so short runs / clean exits leave
                # complete trace files (the reference's exit sweep)
                from ..io import history as history_io

                history_io.write_traces(self.tracker, self.args.write_json,
                                        self.now_ms(), time_budget_s=None,
                                        hist_only=self.args.json_trace_hist_only)
            if self.args.write_json:
                os.makedirs(self.args.write_json, exist_ok=True)
                doc = json_out.generate_aircraft_json(
                    self.tracker, self.now_ms(), self.messages
                )
                json_out.write_json_atomic(
                    doc, os.path.join(self.args.write_json, "aircraft.json")
                )
            if self.args.write_state:
                from ..io import state as state_io

                state_io.save_state(self.tracker, self.args.write_state, self.now_ms())
                log.info("final state written to %s", self.args.write_state)
            if self.beast_dump is not None:
                self.beast_dump.close()
            for svc in self.net.outputs.values():
                svc.flush()
            await self.net.close()
            if self.args.stats:
                self.print_stats()
        return 0


def snip_mode(level: int, fin=None, fout=None) -> None:
    """--snip: squelch quiet IQ runs to shrink example captures.

    Keeps the first 32 samples of any quiet run (|i-127|<level and
    |q-127|<level) and drops the rest, like the reference's snipMode
    (readsb.c:1192-1206), but vectorized over chunks with a carried
    run length instead of a per-byte getchar loop."""
    import numpy as np

    fin = fin if fin is not None else sys.stdin.buffer
    fout = fout if fout is not None else sys.stdout.buffer
    keep_n = 32  # MODES_PREAMBLE_SIZE (readsb.h:118-120)
    run = 0  # quiet samples carried across chunk boundaries
    while True:
        raw = fin.read(1 << 20)
        if not raw:
            break
        if len(raw) % 2:
            raw = raw[:-1]
        iq = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 2).astype(np.int16)
        quiet = (np.abs(iq[:, 0] - 127) < level) & (np.abs(iq[:, 1] - 127) < level)
        # per-sample quiet-run length: position minus last loud position
        idx = np.arange(len(quiet), dtype=np.int64)
        loud_idx = np.where(~quiet, idx, -1)
        last_loud = np.maximum.accumulate(loud_idx)
        runs = np.where(quiet, idx - last_loud, 0)
        # a fully-quiet prefix continues the carried run
        prefix = quiet.argmin() if not quiet.all() else len(quiet)
        runs[:prefix] += run
        run = int(runs[-1]) if quiet[-1] else 0
        keep = ~(quiet & (runs > keep_n))
        fout.write(iq[keep].astype(np.uint8).tobytes())
    fout.flush()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    if args.snip is not None:
        snip_mode(args.snip)
        return 0
    _ensure_device()
    app = App(args)
    try:
        return asyncio.run(app.amain())
    except KeyboardInterrupt:
        return 0


def viewadsb_main(argv=None) -> int:
    """viewadsb equivalent: connect to a beast source and display aircraft."""
    argv = list(argv if argv is not None else sys.argv[1:])
    argv = ["--net-only", "--interactive", "--net-connector", "127.0.0.1,30005,beast_in"] + argv
    return main(argv)


if __name__ == "__main__":
    sys.exit(main())
