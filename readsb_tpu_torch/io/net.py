"""TCP network engine: listeners, outbound connectors, output fan-out.

Asyncio analog of the reference's epoll service registry (net_io.c:735-1120):
- output services hold a set of connected clients and broadcast writers'
  accumulated buffers with flush-by-size/interval (net_io.c:1466-1580)
- input services run a per-connection deframer feeding decoded messages
  into the application callback
- outbound connectors reconnect with exponential backoff
  (serviceConnect, net_io.c:527-691)
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Optional

log = logging.getLogger("readsb_tpu_torch.net")


def escape_beast(payload: bytes) -> bytes:
    """Double 0x1a bytes inside a beast payload (net_io.c:1296-1310)."""
    return payload.replace(b"\x1a", b"\x1a\x1a")


def make_ping(value: int) -> bytes:
    """0x1a 'P' + escaped 24-bit value (pingClient, net_io.c:1292-1314)."""
    v = value & 0xFFFFFF
    return b"\x1aP" + escape_beast(bytes([v >> 16, (v >> 8) & 0xFF, v & 0xFF]))


class PingState:
    """Per-connection ping/pong RTT tracking + latency-based rejection
    (net_io.c:1264-1465).  The server sends 0x1a 'P' <24-bit ms> pings;
    the feeder echoes them (plus its hold time); RTT EMAs above the
    reject threshold shed the connection."""

    # seconds (pingSenders, net_io.c:1322); env override for tests
    PING_INTERVAL = float(__import__("os").environ.get("READSB_PING_INTERVAL", "5"))

    def __init__(self, reject_ms: float = 300.0, on_rtt=None):
        self.enabled = False  # set by the client's 'W' 'O' command
        self.reject_ms = reject_ms
        self.on_rtt = on_rtt  # e.g. StatsCollector.note_rtt
        self.rtt = 0.0
        self.recent_rtt = -1.0
        self.latest_rtt = -1.0
        self.pongs = 0
        self.last_sent = 0.0

    def pong(self, value: int, now_ms: int) -> None:
        current = now_ms & 0xFFFFFF
        pong = value & 0xFFFFFF
        # 24-bit wraparound (pongReceived, net_io.c:1355-1363)
        if abs(current - pong) > (1 << 24) * 7 // 8:
            if current < pong:
                current += 1 << 24
            else:
                pong += 1 << 24
        self.rtt = max(0, current - pong)
        if self.recent_rtt <= 0:
            self.recent_rtt = self.rtt
        else:
            self.recent_rtt = self.recent_rtt * 0.9 + self.rtt * 0.1
        if self.latest_rtt <= 0:
            self.latest_rtt = self.rtt
        else:
            self.latest_rtt = self.latest_rtt * 0.9 + self.rtt * 0.1
        self.pongs += 1
        if self.on_rtt is not None:
            self.on_rtt(float(self.rtt))

    @property
    def should_shed(self) -> bool:
        return self.pongs >= 3 and self.latest_rtt > self.reject_ms


class OutputService:
    """A listen port whose clients all receive the same byte stream.

    Slow-client shedding: a client whose kernel send buffer stays above
    `max_backlog` bytes for longer than `shed_after` seconds is
    disconnected — the analog of the reference's latency-based rejection
    (net_io.c:1345-1465).  Without it one stalled TCP consumer grows the
    process's buffered output without bound.
    """

    def __init__(
        self,
        name: str,
        flush_bytes: int = 1200,
        flush_interval: float = 0.05,
        max_backlog: int = 4 * 1024 * 1024,
        shed_after: float = 15.0,
        heartbeat: bytes | None = None,
        heartbeat_interval: float = 60.0,
    ):
        self.name = name
        self.clients: set[asyncio.StreamWriter] = set()
        self._buf = bytearray()
        self.flush_bytes = flush_bytes
        self.flush_interval = flush_interval
        self.max_backlog = max_backlog
        self.shed_after = shed_after
        self._lagging: dict[int, float] = {}  # id(writer) -> since
        self.clients_shed = 0
        self._flusher: Optional[asyncio.Task] = None
        # idle-channel heartbeat (send_heartbeat, net_io.c:1794)
        self.heartbeat = heartbeat
        self.heartbeat_interval = heartbeat_interval
        self._last_write = 0.0
        # per-client command state (handleBeastCommand, net_io.c:3750):
        # id(writer) -> {"modeac": bool, "ping": bool}
        self.client_opts: dict[int, dict] = {}
        self._modeac_buf = bytearray()

    def send(self, data: bytes) -> None:
        if not self.clients:
            return
        NetEngine.count_out(len(data) * len(self.clients))
        self._buf += data
        if len(self._buf) >= self.flush_bytes:
            self.flush()

    def send_modeac(self, data: bytes) -> None:
        """Second lane: only clients that enabled Mode A/C ('1J' Beast
        command / autoset_modeac, net_io.c:3577-3782) receive it."""
        if not any(o.get("modeac") for o in self.client_opts.values()):
            return
        self._modeac_buf += data

    def _shed(self, w, reason: str) -> None:
        import time as _t  # local to keep the hot path import-free

        self.clients.discard(w)
        self._lagging.pop(id(w), None)
        self.clients_shed += 1
        log.warning("%s: shedding client (%s)", self.name, reason)
        try:
            w.close()
        except Exception:
            pass

    def flush(self) -> None:
        if not self._buf and not self._modeac_buf:
            return
        data = bytes(self._buf)
        self._buf.clear()
        data_ac = bytes(self._modeac_buf)
        self._modeac_buf.clear()
        now = time.time()
        if data:
            self._last_write = now
        for w in list(self.clients):
            try:
                transport = getattr(w, "transport", None)
                backlog = transport.get_write_buffer_size() if transport else 0
                if backlog > self.max_backlog:
                    since = self._lagging.setdefault(id(w), now)
                    if now - since > self.shed_after:
                        self._shed(w, f"{backlog} bytes backlogged")
                        continue
                else:
                    self._lagging.pop(id(w), None)
                if data:
                    w.write(data)
                if data_ac and self.client_opts.get(id(w), {}).get("modeac"):
                    w.write(data_ac)
            except Exception:
                self.clients.discard(w)
                self._lagging.pop(id(w), None)

    async def run_flusher(self) -> None:
        # no per-client drain(): awaiting one slow client would stall the
        # shared flusher; backlog shedding in flush() handles laggards
        while True:
            await asyncio.sleep(self.flush_interval)
            self.flush()
            if (
                self.heartbeat
                and self.clients
                and time.time() - self._last_write > self.heartbeat_interval
            ):
                self._last_write = time.time()
                for w in list(self.clients):
                    try:
                        w.write(self.heartbeat)
                    except Exception:
                        self.clients.discard(w)

    async def handle_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if not self.clients:
            self._last_write = time.time()  # arm the heartbeat clock
        self.clients.add(writer)
        self.client_opts[id(writer)] = {"modeac": False, "ping": False}
        peer = writer.get_extra_info("peername")
        log.info("%s: client %s connected (%d)", self.name, peer, len(self.clients))
        pending = b""
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    break
                # Beast command bytes from output clients
                # (handleBeastCommand, net_io.c:3750-3803)
                pending = self._handle_commands(writer, pending + data)
        except Exception:
            pass
        finally:
            self.clients.discard(writer)
            self.client_opts.pop(id(writer), None)
            try:
                writer.close()
            except Exception:
                pass

    def _handle_commands(self, writer, buf: bytes) -> bytes:
        opts = self.client_opts.get(id(writer))
        i = 0
        while i + 2 < len(buf) + 1:
            j = buf.find(b"\x1a", i)
            if j < 0 or j + 2 > len(buf):
                return buf[j:] if j >= 0 else b""
            t = buf[j + 1 : j + 2]
            if t in (b"1", b"W"):
                if j + 3 > len(buf):
                    # third byte not yet received — keep the partial command
                    # pending instead of consuming 2 bytes and losing it
                    return buf[j:]
                c = buf[j + 2 : j + 3]
                if opts is not None:
                    if t == b"1" and c in (b"J", b"j"):
                        opts["modeac"] = c == b"J"  # 1J on / 1j off
                    elif t == b"W" and c == b"O":
                        opts["ping"] = True  # high-res ping enable (net_io.c:4897)
                i = j + 3
            else:
                i = j + 2
        return b""

    @property
    def modeac_wanted(self) -> bool:
        return any(o.get("modeac") for o in self.client_opts.values())


class InputService:
    """A listen port whose connections feed a deframer into a callback.

    ping=True adds the reference's feeder-health machinery: the service
    pings feeders that enabled it ('W' 'O' command) every 5 s, tracks
    RTT EMAs from the echoed pongs, and sheds feeders whose latency
    exceeds reject_ms (net_io.c:1264-1465).  PROXY v1 header lines
    (net_io.c:5020) are stripped and the real peer recorded.
    """

    def __init__(
        self,
        name: str,
        connection_factory: Callable[[], "InputConnection"],
        *,
        ping: bool = False,
        reject_ms: float = 300.0,
        on_rtt=None,
    ):
        self.name = name
        self.connection_factory = connection_factory
        self.ping = ping
        self.reject_ms = reject_ms
        self.on_rtt = on_rtt
        self.clients_shed = 0
        self.connections = 0

    async def _ping_loop(self, writer, ping_state: PingState):
        try:
            while True:
                await asyncio.sleep(PingState.PING_INTERVAL)
                if ping_state.should_shed:
                    self.clients_shed += 1
                    log.warning(
                        "%s: shedding feeder (rtt %.0f ms > %.0f ms)",
                        self.name, ping_state.latest_rtt, ping_state.reject_ms,
                    )
                    writer.close()
                    return
                if ping_state.enabled:
                    writer.write(make_ping(int(time.time() * 1000)))
                    ping_state.last_sent = time.time()
        except (asyncio.CancelledError, ConnectionError):
            pass

    async def handle_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = self.connection_factory()
        peer = writer.get_extra_info("peername")
        self.connections += 1
        log.info("%s: feeder %s connected", self.name, peer)
        ping_state = (
            PingState(self.reject_ms, on_rtt=self.on_rtt) if self.ping else None
        )
        conn.ping_state = ping_state
        conn.writer = writer
        ping_task = (
            asyncio.ensure_future(self._ping_loop(writer, ping_state))
            if ping_state
            else None
        )
        first = True
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                if first:
                    first = False
                    if data.startswith(b"PROXY "):
                        # PROXY protocol v1: strip the header line, keep
                        # the real peer for logs (net_io.c:5020)
                        nl = data.find(b"\r\n")
                        if nl >= 0:
                            conn.proxy_peer = data[6:nl].decode("latin1", "replace")
                            log.info("%s: PROXY %s", self.name, conn.proxy_peer)
                            data = data[nl + 2 :]
                            if not data:
                                continue
                NetEngine.count_in(len(data))
                await conn.feed(data)
        except Exception as e:
            log.debug("%s: feeder %s error: %s", self.name, peer, e)
        finally:
            if ping_task:
                ping_task.cancel()
            conn.close()
            try:
                writer.close()
            except Exception:
                pass


class InputConnection:
    """Abstract per-connection parser: subclasses implement feed() to
    deframe and dispatch (the NotImplementedError is the abstract-method
    contract; every concrete protocol in app/main.py overrides it)."""

    async def feed(self, data: bytes) -> None:
        raise NotImplementedError("subclasses implement feed()")

    def close(self) -> None:
        pass


class Connector:
    """Outbound connection with reconnect/backoff (net_connector)."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        on_connect: Optional[Callable[[asyncio.StreamWriter], Awaitable[None]]] = None,
        input_factory: Optional[Callable[[], InputConnection]] = None,
        output: Optional[OutputService] = None,
        reconnect_delay: float = 30.0,
    ):
        self.host = host
        self.port = port
        self.on_connect = on_connect
        self.input_factory = input_factory
        self.output = output
        self.reconnect_delay = reconnect_delay

    async def run(self) -> None:
        backoff = 1.0
        while True:
            try:
                reader, writer = await asyncio.open_connection(self.host, self.port)
                log.info("connector %s:%d up", self.host, self.port)
                backoff = 1.0
                if self.on_connect:
                    await self.on_connect(writer)
                if self.output is not None:
                    self.output.clients.add(writer)
                conn = self.input_factory() if self.input_factory else None
                if conn is not None:
                    conn.writer = writer  # back-channel (pong replies etc.)
                try:
                    while True:
                        data = await reader.read(65536)
                        if not data:
                            break
                        if conn:
                            NetEngine.count_in(len(data))
                            await conn.feed(data)
                finally:
                    if self.output is not None:
                        self.output.clients.discard(writer)
                    if conn:
                        conn.close()
                    writer.close()
            except OSError as e:
                log.debug("connector %s:%d: %s", self.host, self.port, e)
            await asyncio.sleep(min(backoff, self.reconnect_delay))
            backoff *= 2


class NetEngine:
    def __init__(self):
        self.outputs: dict[str, OutputService] = {}
        self.servers: list[asyncio.AbstractServer] = []
        self.tasks: list[asyncio.Task] = []
        self.connectors: list[Connector] = []
        # cumulative wire accounting (stats.h network_bytes_in/out)
        self.bytes_in = 0
        self.bytes_out = 0
        NetEngine._current = self

    _current = None

    @classmethod
    def count_in(cls, n: int) -> None:
        if cls._current is not None:
            cls._current.bytes_in += n

    @classmethod
    def count_out(cls, n: int) -> None:
        if cls._current is not None:
            cls._current.bytes_out += n

    def add_output(self, name: str, **kw) -> OutputService:
        svc = self.outputs.setdefault(name, OutputService(name, **kw))
        return svc

    async def listen_output(self, svc: OutputService, port: int, host: str = "0.0.0.0"):
        server = await asyncio.start_server(svc.handle_client, host, port)
        self.servers.append(server)
        self.tasks.append(asyncio.ensure_future(svc.run_flusher()))
        log.info("%s: listening on %s:%d", svc.name, host, port)

    async def listen_input(self, svc: InputService, port: int, host: str = "0.0.0.0"):
        server = await asyncio.start_server(svc.handle_client, host, port)
        self.servers.append(server)
        log.info("%s: listening on %s:%d", svc.name, host, port)

    def add_connector(self, c: Connector) -> None:
        self.connectors.append(c)
        self.tasks.append(asyncio.ensure_future(c.run()))

    async def close(self) -> None:
        for t in self.tasks:
            t.cancel()
        for s in self.servers:
            s.close()
        # force-close lingering client connections (their read loops would
        # otherwise keep wait_closed blocked forever on py3.12)
        for svc in self.outputs.values():
            for w in list(svc.clients):
                try:
                    w.close()
                except Exception:
                    pass
            svc.clients.clear()
        for s in self.servers:
            try:
                await asyncio.wait_for(s.wait_closed(), timeout=1.0)
            except Exception:
                pass
