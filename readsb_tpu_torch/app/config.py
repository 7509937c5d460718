"""CLI / configuration (analog of readsb's argp table, help.h).

Option names mirror the reference so a readsb user can switch with the
same flags (configSetDefaults readsb.c:109-245, parse readsb.c:1440-2126).
Every option of readsb_tpu parses here as it does there; the options whose
layers the port does not have yet raise NotImplementedError naming their
ROADMAP item (`refuse_deferred`), before any work starts.
"""

from __future__ import annotations

import argparse


def _ports(v: str) -> list[int]:
    """Comma-separated listen port list (the reference accepts e.g.
    --net-bi-port 30004,30104; serviceListen splits on commas)."""
    out = []
    for tok in str(v).split(","):
        tok = tok.strip()
        if tok and int(tok):
            out.append(int(tok))
    return out

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="readsb-tpu-torch",
        description="Mode-S/ADS-B receiver and decoder on PyTorch + CUDA",
    )
    # --- source
    p.add_argument("--device-type",
                   choices=["ifile", "rtlsdr", "soapy", "modesbeast",
                            "gnshulc", "hackrf", "bladerf", "ubladerf",
                            "plutosdr", "none"],
                   default="none",
                   help="sample source (ifile=IQ replay, rtlsdr=USB dongle, "
                        "soapy=SoapySDR device, modesbeast=Beast serial "
                        "receiver, gnshulc=GNS5894/HULC serial receiver, "
                        "ubladerf=bladeRF 2.0 Micro; handler table "
                        "sdr.c:94-122)")
    p.add_argument("--device", default="0",
                   help="rtl-sdr device index or serial string")
    p.add_argument("--gain", type=float, default=None,
                   help="tuner gain in dB (default max; <=-10 enables AGC)")
    p.add_argument("--freq", type=int, default=1_090_000_000,
                   help="center frequency in Hz")
    p.add_argument("--ppm", type=int, default=0, help="frequency correction ppm")
    p.add_argument("--enable-biastee", action="store_true",
                   help="enable bias tee on supporting rtl-sdr dongles")
    p.add_argument("--soapy-device", default=None,
                   help="SoapySDR device args string (e.g. driver=sdrplay)")
    p.add_argument("--soapy-antenna", default=None)
    p.add_argument("--soapy-bandwidth", type=float, default=None)
    p.add_argument("--soapy-enable-agc", action="store_true")
    p.add_argument("--soapy-gain-element", action="append", default=[],
                   metavar="ELEMENT:DB", help="set a SoapySDR gain element, "
                   "repeatable (sdr_soapy.c:306-330)")
    p.add_argument("--hackrf-enable-ampgain", action="store_true",
                   help="enable HackRF RF amp stage (~11 dB)")
    p.add_argument("--hackrf-vgagain", type=int, default=48,
                   help="HackRF baseband VGA gain (0-62, 2 dB steps)")
    p.add_argument("--bladerf-fpga", default=None, metavar="PATH",
                   help="bladeRF alternative FPGA bitstream ('' disables load)")
    p.add_argument("--bladerf-decimation", type=int, default=1,
                   help="assume the bladeRF FPGA decimates by N")
    p.add_argument("--bladerf-bandwidth", default=None, metavar="HZ",
                   help="bladeRF LPF bandwidth in Hz ('bypass' to bypass)")
    p.add_argument("--pluto-uri", default=None,
                   help="PlutoSDR USB context URI (e.g. usb:1.2.5)")
    p.add_argument("--pluto-network", default=None,
                   help="PlutoSDR network context host (default pluto.local)")
    p.add_argument("--beast-serial", default="/dev/ttyUSB0",
                   help="Beast serial port path")
    p.add_argument("--beast-baudrate", type=int, default=0,
                   help="serial baudrate override (0 = auto: 3000000 for "
                        "modesbeast, 921600 for gnshulc; sdr_beast.c:126-171)")
    p.add_argument("--beast-mlat-off", action="store_true",
                   help="disable Beast mlat timestamps")
    p.add_argument("--beast-crc-off", action="store_true",
                   help="disable Beast CRC checks")
    p.add_argument("--beast-fec-off", action="store_true",
                   help="disable Beast FEC")
    p.add_argument("--beast-df1117-on", action="store_true",
                   help="enable Beast DF11/17-only filter")
    p.add_argument("--beast-df045-on", action="store_true",
                   help="enable Beast DF0/4/5 filter")
    p.add_argument("--beast-modeac", action="store_true",
                   help="enable Beast Mode A/C delivery")
    p.add_argument("--ifile", default=None, help="IQ capture path ('-' for stdin)")
    p.add_argument("--iformat", default="uc8", choices=["uc8", "UC8", "sc16", "SC16", "sc16q11", "SC16Q11"])
    p.add_argument("--throttle", action="store_true", help="replay at capture realtime")
    p.add_argument("--preamble-threshold", type=int, default=58)
    p.add_argument("--modeac", action="store_true",
                   help="decode Mode A/C (SSR) replies as well")
    p.add_argument("--fix", dest="nfix_crc", action="store_const", const=1, default=1)
    p.add_argument("--no-fix", dest="nfix_crc", action="store_const", const=0)
    p.add_argument("--no-fix-df", dest="fix_df", action="store_false", default=True)
    p.add_argument("--aggressive", dest="nfix_crc", action="store_const", const=2)
    p.add_argument("--dcfilter", action="store_true",
                   help="1-pole DC-block IIR before demodulation (convert.c:477)")
    p.add_argument("--show-only", type=lambda v: int(v, 16), default=None,
                   metavar="HEX", help="only process this ICAO address")
    p.add_argument("--cpr-focus", type=lambda v: int(v, 16), default=None,
                   metavar="HEX", help="log CPR decisions for this aircraft")
    p.add_argument("--trace-focus", type=lambda v: int(v, 16), default=None,
                   metavar="HEX", help="log trace additions for this aircraft")
    p.add_argument("--leg-focus", type=lambda v: int(v, 16), default=None,
                   metavar="HEX", help="log leg segmentation for this aircraft")
    p.add_argument("--filter-DF", default=None, metavar="N[,N...]",
                   help="only forward these downlink formats")
    p.add_argument("--net-verbatim", action="store_true",
                   help="forward 2-bit-corrected messages on raw output")
    p.add_argument("--forward-mlat", action="store_true",
                   help="forward MLAT-sourced messages on raw/beast outputs")
    p.add_argument("--forward-mlat-sbs", action="store_true",
                   help="forward MLAT-sourced messages on SBS main output")
    p.add_argument("--net-bind-address", default="0.0.0.0")
    p.add_argument("--interactive-ttl", type=float, default=60.0,
                   help="interactive display retention seconds")
    p.add_argument("--metric", action="store_true",
                   help="interactive display in metric units")
    p.add_argument("--write-profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the replay to DIR/trace.json")
    p.add_argument("--debug", default="", metavar="FLAGS",
                   help="debug flag string (subset: C=CPR, n=net, S=speed)")

    # --- position
    p.add_argument("--lat", type=float, default=None)
    p.add_argument("--lon", type=float, default=None)
    p.add_argument("--max-range", type=float, default=300.0, help="max range in nmi")
    p.add_argument("--json-reliable", type=int, default=None)

    # --- net
    p.add_argument("--net", action="store_true", help="enable networking")
    p.add_argument("--net-only", action="store_true", help="no SDR, network input only")
    p.add_argument(
        "--net-bulk-drain", action="store_true", default=None,
        help="columnar aggregator ingest: drain network frames through the "
             "batch accept stage + BulkTracker (the decodePool analog, "
             "net_io.c:5365-5474); the dict tracker becomes a serving view "
             "refreshed each tick.  DEFAULT: auto-enabled for network "
             "ingest unless an output lane that needs per-message decoded "
             "fields is configured (SBS/ASTERIX/json-position/beast-reduce "
             "out) or --modeac is on; --no-net-bulk-drain forces the "
             "scalar per-message path",
    )
    p.add_argument(
        "--no-net-bulk-drain", dest="net_bulk_drain", action="store_false",
        help=argparse.SUPPRESS,
    )
    p.add_argument(
        "--device-arena", action="store_true",
        help="mirror the drained batches into the device aircraft arena "
             "(track/arena.py: SoA state + accept lattice + altitude/"
             "squawk logic + global airborne CPR decode ON DEVICE); the "
             "serving tracker materializes arena-owned fields from the "
             "device snapshot each tick.  Requires the columnar drain.",
    )
    p.add_argument("--net-ri-port", type=_ports, default=[], help="raw input listen port")
    p.add_argument("--net-ro-port", type=_ports, default=[], help="raw output listen port")
    p.add_argument("--net-bi-port", type=_ports, default=[], help="beast input listen port")
    p.add_argument("--net-bo-port", type=_ports, default=[], help="beast output listen port")
    p.add_argument("--net-sbs-port", type=_ports, default=[], help="SBS output listen port")
    p.add_argument("--net-sbs-in-port", type=_ports, default=[], help="SBS input listen port")
    p.add_argument("--net-json-port", type=_ports, default=[], help="per-position json output port")
    p.add_argument("--net-garbage", dest="net_garbage_port", type=int, default=0,
                   help="beast output port for frames from quarantined feeders")
    p.add_argument("--net-api-port", default=0,
                   help="/re-api query port, or a unix socket path (api.c:1967)")
    p.add_argument("--net-uat-in-port", type=_ports, default=[],
                   help="dump978 raw text input listen port (UAT -> synthetic DF18)")
    p.add_argument("--net-uat-replay-port", type=_ports, default=[],
                   help="replay received UAT raw lines to clients")
    p.add_argument("--net-vrs-port", type=_ports, default=[], help="VRS-format json output port")
    p.add_argument("--net-vrs-interval", type=float, default=5.0)
    p.add_argument("--net-ai-port", "--net-asterix-in-port", dest="net_ai_port",
                   type=_ports, default=[],
                   help="ASTERIX CAT021 input listen port")
    p.add_argument("--net-ao-port", "--net-asterix-out-port", dest="net_ao_port",
                   type=_ports, default=[],
                   help="ASTERIX CAT021 output listen port")
    p.add_argument("--net-sbs-jaero-port", type=_ports, default=[],
                   help="SBS output for JAERO-sourced traffic")
    p.add_argument("--net-sbs-jaero-in-port", type=_ports, default=[],
                   help="SBS input ingested as JAERO source")
    p.add_argument("--net-beast-reduce-out-port", type=_ports, default=[],
                   help="rate-limited/deduplicated beast output (reduce_forward)")
    p.add_argument("--net-beast-reduce-interval", type=float, default=0.125,
                   help="per-aircraft reduce forwarding interval (s)")
    p.add_argument("--net-beast-reduce-filter-dist", type=float, default=None,
                   metavar="NMI",
                   help="beast-reduce: drop aircraft further than this from the receiver")
    p.add_argument("--net-beast-reduce-filter-alt", type=float, default=None,
                   metavar="FT",
                   help="beast-reduce: drop aircraft above this pressure altitude")
    p.add_argument("--net-beast-reduce-optimize-for-mlat", action="store_true",
                   help="beast-reduce: keep all messages relevant to mlat-client")
    p.add_argument("--dump-beast", default=None, metavar="DIR,INTERVAL",
                   help="dump compressed beast files to DIR, new file every "
                        "INTERVAL seconds (help.h:104)")
    p.add_argument("--dump-beast-dir", default=None,
                   help="record the incoming beast message stream (zstd chunks)")
    p.add_argument("--dump-beast-interval", type=float, default=30.0,
                   help="seconds per recorded beast chunk file")
    p.add_argument("--net-connector", action="append", default=[],
                   help="host,port,protocol outbound connection")
    p.add_argument("--net-heartbeat", type=float, default=60.0)
    p.add_argument("--net-ingest", action="store_true",
                   help="aggregator ingest mode: ping/RTT feeder health checks")
    p.add_argument("--ping-reject", type=float, default=300.0,
                   help="shed feeders whose ping RTT EMA exceeds this (ms)")
    p.add_argument("--uuid-file", default=None,
                   help="receiver UUID sent on beast_reduce_plus connections")
    p.add_argument("--net-receiver-id", action="store_true",
                   help="forward receiver IDs as 0xE3 frames on beast outputs")
    p.add_argument("--net-buffer", type=int, default=2,
                   help="per-client output backlog: 64KiB << n")
    p.add_argument("--decode-threads", type=int, default=1,
                   help="worker threads for the decode executor")
    p.add_argument("--net-ro-interval", type=float, default=0.05,
                   help="TCP output flush interval (s) for raw/beast outputs")
    p.add_argument("--net-ro-size", type=int, default=1200,
                   help="TCP output flush size (bytes)")
    p.add_argument("--net-ro-interval-beast-reduce", type=float, default=None,
                   help="flush interval override for beast-reduce outputs (s)")
    p.add_argument("--net-sbs-reduce", action="store_true",
                   help="apply beast-reduce gating and interval to SBS outputs")
    p.add_argument("--net-asterix-reduce", action="store_true",
                   help="apply beast-reduce gating and interval to ASTERIX outputs")
    p.add_argument("--net-json-port-interval", type=float, default=0.0,
                   help="minimum per-aircraft interval for TCP json output (s)")
    p.add_argument("--net-json-port-include-noposition", action="store_true",
                   help="TCP json output: also emit aircraft without position")
    p.add_argument("--api-shutdown-delay", type=float, default=0.0,
                   help="serve remaining API queries this long at shutdown (s)")
    p.add_argument("--position-persistence", type=int, default=4,
                   help="position reliability cap against outliers "
                       "(incremented by json-reliable minus 1)")
    p.add_argument("--jaero-timeout", type=float, default=33.0, metavar="MIN",
                   help="minutes JAERO aircraft stay valid without updates")
    p.add_argument("--range-outline-hours", type=float, default=24.0,
                   help="range outline data retention (hours)")
    p.add_argument("--mlat", dest="mlat_display", action="store_true",
                   help="stdout display in Beast ASCII @ts...; form")
    p.add_argument("--write-receiver-id-json", action="store_true",
                   help="write receivers.json snapshots")
    p.add_argument("--tar1090-use-api", action="store_true",
                   help="advertise the query API to tar1090 via receiver.json")

    # --- output
    p.add_argument("--write-json", default=None, metavar="DIR")
    p.add_argument("--write-json-every", type=float, default=1.0)
    p.add_argument("--json-globe-index", "--write-json-globe-index",
                   dest="json_globe_index", action="store_true",
                   help="write globe_NNNN.binCraft.zst tile snapshots + traces")
    p.add_argument("--json-trace-interval", type=float, default=30.0,
                   help="aircraft trace point interval, seconds")
    p.add_argument("--write-traces-every", type=float, default=15.0)
    p.add_argument("--json-trace-hist-only", type=int, default=0, metavar="MASK",
                   help="suppress live trace files: 1=recent, 2=full, 3=both "
                        "(archive still written via globe history)")
    p.add_argument("--heatmap", type=float, default=0.0, metavar="SECONDS",
                   help="enable heatmap sampling at this interval")
    p.add_argument("--heatmap-dir", default=None)
    p.add_argument("--globe-history-dir", "--write-globe-history",
                   dest="globe_history_dir", default=None)
    p.add_argument("--json-location-accuracy", type=int, default=1)
    p.add_argument("--write-prom", default=None, metavar="PATH")
    p.add_argument("--write-state", default=None, metavar="DIR",
                   help="checkpoint directory (state save/load)")
    p.add_argument("--write-state-every", type=float, default=60.0)
    p.add_argument("--quiet", action="store_true", default=True)
    p.add_argument("--snip", type=int, default=None, metavar="LEVEL",
                   help="filter UC8 IQ on stdin->stdout: squelch quiet runs "
                        "beyond 32 samples (readsb.c:1192)")
    p.add_argument("--receiver-focus", type=lambda v: int(v, 16), default=None,
                   metavar="HEX64", help="only process messages from this receiverId")
    p.add_argument("--onlyaddr", action="store_true",
                   help="stdout display shows only ICAO addresses (mode_s.c:1829)")
    p.add_argument("--auto-exit", type=float, default=0.0, metavar="SEC",
                   help="exit after this many seconds of operation")
    p.add_argument("--net-connector-delay", type=float, default=30.0,
                   help="max delay between outbound reconnect attempts (s)")
    p.add_argument("--write-json-gzip", action="store_true",
                   help="also write aircraft.json.gz alongside aircraft.json")
    p.add_argument("--write-state-only-on-exit", action="store_true",
                   help="skip periodic state checkpoints; write state only at shutdown")
    p.add_argument("--no-interactive", action="store_true",
                   help="disable the interactive display")
    p.add_argument("--stats-range", action="store_true",
                   help="collect polar range statistics into stats.json")
    p.add_argument("--modeac-auto", action="store_true",
                   help="enable Mode A/C only when a connected client requests it")
    p.add_argument("--gnss", action="store_true",
                   help="prefer GNSS (HAE) altitudes on text outputs when available")
    p.add_argument("--enable-agc", action="store_true",
                   help="rtl-sdr: enable tuner AGC (same as --gain -10)")
    p.add_argument("--sdr-buffer-size", type=int, default=16 * 16384,
                   help="SDR read buffer size in bytes")
    p.add_argument("--raw", dest="show_raw", action="store_true",
                   help="print frame hex to stdout")
    p.add_argument("--stats", action="store_true", help="print stats at exit")
    p.add_argument("--stats-every", type=float, default=0)
    p.add_argument("--interactive", action="store_true")

    p.add_argument("--db-file", default=None, metavar="PATH",
                   help="tar1090 aircraft.csv.gz database (registration/type/dbFlags)")
    p.add_argument("--db-file-lt", action="store_true",
                   help="accepted for compatibility (long-type always loaded)")

    # --- demodulator tuning
    p.add_argument("--blocks-per-batch", type=int, default=4,
                   help="demod superblock size in 131072-sample blocks")
    p.add_argument("--candidates-per-block", type=int, default=2048)
    p.add_argument("--devel", action="append", default=[])
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args.iformat = args.iformat.lower()
    if args.json_reliable is None:
        args.json_reliable = 1
    if args.device_type == "ifile" and not args.ifile:
        build_parser().error("--device-type ifile requires --ifile")
    if args.dump_beast:
        # reference form: --dump-beast <dir>,<interval> (help.h:104)
        parts = str(args.dump_beast).rsplit(",", 1)
        args.dump_beast_dir = parts[0]
        if len(parts) > 1:
            args.dump_beast_interval = float(parts[1])
    refuse_deferred(args)
    return args


# (ROADMAP item, what it brings, options) of the layers still to port;
# each option's default is falsy, so an option is given when its value is
# truthy ("0" is the API port's default spelled out)
_NET_PORTS = (
    "net_ri_port", "net_ro_port", "net_bi_port", "net_bo_port", "net_sbs_port",
    "net_sbs_in_port", "net_json_port", "net_garbage_port", "net_api_port",
    "net_uat_in_port", "net_uat_replay_port", "net_vrs_port", "net_ai_port",
    "net_ao_port", "net_sbs_jaero_port", "net_sbs_jaero_in_port",
    "net_beast_reduce_out_port", "net_connector",
)
DEFERRED = (
    ("8b", "the network engine, its protocols and the API",
     ("net", "net_only", *_NET_PORTS, "modeac_auto", "interactive")),
    ("8c", "persistence and history",
     ("write_state", "write_prom", "json_globe_index", "heatmap",
      "globe_history_dir", "db_file", "dump_beast", "dump_beast_dir")),
    ("8d", "the columnar bulk path", ("net_bulk_drain",)),
    ("10", "the device arena", ("device_arena",)),
)


def refuse_deferred(args) -> None:
    """Raise NotImplementedError for an option or a source whose layer
    the port does not have yet, naming its ROADMAP item."""
    for item, what, dests in DEFERRED:
        for dest in dests:
            value = getattr(args, dest)
            if value and value != "0":
                flag = "--" + dest.replace("_", "-")
                raise NotImplementedError(
                    f"{flag}: {what} is ROADMAP item {item} of the port"
                )
    if args.device_type not in ("ifile", "none"):
        raise NotImplementedError(
            f"--device-type {args.device_type}: the SDR and serial sources are "
            "ROADMAP item 8e of the port"
        )
