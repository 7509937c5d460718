"""Application entry point: IQ file -> demod -> decode -> track -> JSON.

The `--device-type ifile` part of readsb_tpu's app, on the port's
demodulator: a single asyncio loop on the host feeds the batched device
pipeline from the default executor, and periodic coroutines sweep the
tracker and write aircraft.json, receiver.json and stats.json.

The device is explicit.  Under READSB_TPU_PLATFORM=cpu the demodulator
runs its plain PyTorch versions on the CPU; otherwise it runs on the card,
and `main` refuses to start without one.  Options whose layers are not
ported yet raise NotImplementedError at argument time
(`config.refuse_deferred`).
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import time

import torch

from .. import constants
from ..decode.fields import ModesMessage, decode_frame
from ..io import json_out
from ..io.stats import StatsCollector
from ..track.tracker import Tracker
from .config import parse_args

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
        )
        self.epoch_ms = int(time.time() * 1000)
        self.messages = 0
        self.start_time = time.time()
        self._demod = None
        self.stats_collector = StatsCollector()
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
        self.tracker.cpr_focus = args.cpr_focus

    # ------------------------------------------------------------------

    def handle_frame(self, frame) -> None:
        """One accepted demodulated frame -> decode, track."""
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
        self.tracker.update(mm)
        if self.args.show_raw:
            if self.args.onlyaddr:  # mode_s.c:1829: address-only display
                print("%06x" % (mm.addr & 0xFFFFFF), flush=False)
            elif self.args.mlat_display:  # Beast ASCII with mlat timestamp
                print("@%012X%s;" % (raw_ts & 0xFFFFFFFFFFFF, mm.msg.hex()),
                      flush=False)
            else:
                print("*%s;" % mm.msg.hex(), flush=False)
        # --filter-DF gates only the network outputs (ROADMAP item 8b)

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
        """fn(*args) with the demodulator's device current in this thread:
        the kernel libraries record the device they are loaded on."""
        dev = self._demod.device
        if dev.type != "cuda":
            return fn(*args)
        with torch.cuda.device(dev):
            return fn(*args)

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
        prof = None
        if args.write_profile:
            # device-op level tracing of the replay, written at its end
            acts = [torch.profiler.ProfilerActivity.CPU]
            if demod.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        f = sys.stdin.buffer if args.ifile == "-" else open(args.ifile, "rb")
        bps = 2 if args.iformat == "uc8" else 4
        chunk = demod.super_samples * bps
        loop = asyncio.get_event_loop()
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
            if prof is not None:
                prof.stop()
                os.makedirs(args.write_profile, exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.write_profile, "trace.json"))
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

    def _drain_modeac(self, demod) -> None:
        """Forward Mode A/C pseudo-messages into the tracker."""
        if not demod.modeac_msgs:
            return
        msgs, demod.modeac_msgs = demod.modeac_msgs, []
        for mm in msgs:
            mm.sys_timestamp_ms = self.epoch_ms + mm.timestamp // 12000
            self.handle_message(mm, raw_ts=mm.timestamp)

    # ------------------------------------------------------------------

    def write_json_files(self, now: int) -> None:
        """aircraft.json (and .gz), receiver.json, receivers.json and
        outline.json into --write-json."""
        args = self.args
        os.makedirs(args.write_json, exist_ok=True)
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
        if args.write_receiver_id_json:
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
        while True:
            await asyncio.sleep(0.25)
            self._last_tick = time.time()
            _bg_t0 = time.perf_counter()
            now = self.now_ms()
            self.stats_collector.sample(self, now / 1000.0)
            self.tracker.remove_stale(now)
            if args.modeac:
                self.tracker.match_ac(now)
            if args.write_json and time.time() - last_json >= args.write_json_every:
                last_json = time.time()
                self.write_json_files(now)
            self.tracker.receivers.maintenance(now, interval_ms=250)
            if args.write_json:
                json_out.write_json_atomic(
                    self.stats_collector.stats_json(self, now / 1000.0),
                    os.path.join(args.write_json, "stats.json"),
                )
            self.stats_collector.cpu["background"] += (
                time.perf_counter() - _bg_t0
            ) * 1e3

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
        """SIGTERM/SIGINT -> ordered shutdown (readsb.c:2649, 2917-3011)."""
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
            else:
                log.error("no source: use --device-type ifile")
                return 1
        finally:
            # ordered shutdown (readsb.c:2917-3011): stop periodic work,
            # final aircraft.json so short runs / clean exits leave a
            # current snapshot even if no periodic tick completed
            self._exiting = True
            periodic.cancel()
            if self.args.write_json:
                os.makedirs(self.args.write_json, exist_ok=True)
                doc = json_out.generate_aircraft_json(
                    self.tracker, self.now_ms(), self.messages
                )
                json_out.write_json_atomic(
                    doc, os.path.join(self.args.write_json, "aircraft.json")
                )
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
    """viewadsb connects to a Beast source: the network engine and the
    interactive display are ROADMAP item 8b of the port."""
    raise NotImplementedError("viewadsb: the network engine is ROADMAP item 8b of the port")


if __name__ == "__main__":
    sys.exit(main())
