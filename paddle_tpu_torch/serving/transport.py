"""Cross-host serving transport (doc/serving.md "Cross-host fleet").

The fleet router of PR 16 reached replicas only through subprocess
pipes — one host, no network to drop, stall, or tear. This module is
the socket analog of the reference's custom TCP parameter-server
transport, rebuilt on three contracts the repo already enforces:

- **Framing**: length-prefixed JSON — a 4-byte big-endian payload size
  then UTF-8 JSON. :class:`FrameReader` is torn-frame tolerant: a
  partial frame at connection close is discarded (and logged), never a
  crash — the same discipline as the metrics torn-tail readers.
- **State machine**: each :class:`SocketTransport` connection walks
  CONNECTING -> UP -> BACKOFF -> CLOSED, reconnecting on the shared
  :class:`~paddle_tpu_torch.utils.retry.RetryPolicy` schedule (exponential
  backoff + jitter + deadline). A reconnect replays the hello
  handshake so undelivered requests are re-offered (at-least-once;
  dedupe by id on both ends absorbs the duplicates).
- **Deadlines on the wire**: :class:`SocketReplica` stamps an absolute
  wall-clock ``deadline_unix`` on each request (preserved across
  re-offers and hedges), so a remote replica sheds expired work
  *itself* through the PR-14 deadline-aware admission path.

Heartbeat ping/pong frames carry the remote ``Engine.status()`` doc
back into the router's ``replica_score`` health path; ``net.connect``
and ``net.rpc`` ``kind=span`` hops join the PR-18 trace timeline; the
``net.drop`` / ``net.stall`` / ``net.torn_frame`` / ``net.dup`` chaos
sites live on the shared frame read/write paths (`paddle faults`).

jax-free; every thread/lock/clock/sleep goes through the
``utils/concurrency`` seam so `paddle race` can explore the
reconnect-vs-send and hedge-vs-first-answer interleavings
(tests/race_specs/spec_transport.py) with fake wires.
"""

from __future__ import annotations

import errno
import json
import logging
import random
import socket
import struct
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger("paddle_tpu")

# frame header: 4-byte big-endian payload length, then UTF-8 JSON
HEADER = struct.Struct("!I")
# a frame this large is a corrupt header, not a request — treat as a
# protocol error (disconnect), never an attempted 4 GiB allocation
MAX_FRAME_BYTES = 16 << 20
# client ping cadence and the bound past which a silent peer reads as
# stale (mirrors the fleet router's file-status staleness bound)
HEARTBEAT_PERIOD_S = 1.0
STALE_AFTER_S = 5.0
CONNECT_TIMEOUT_S = 5.0
# short socket timeouts keep every read/accept loop interruptible
# (close() takes effect within one tick; no unbounded blocking)
IO_TICK_S = 0.25

CONNECTING, UP, BACKOFF, CLOSED = "connecting", "up", "backoff", "closed"


def wall_time() -> float:
    """Wall-clock UNIX seconds, for ON-THE-WIRE deadlines only.

    Monotonic clocks are per-process: a deadline stamped by the router
    must be comparable on a different host, so the wire format uses
    wall time (hosts are NTP-disciplined; the skew bound is the same
    one the trace aligner already tolerates). Everything else in this
    module reads ``cc.monotonic``.
    """
    return time.time()  # lint: disable=PTL001 -- deadline_unix crosses hosts; monotonic clocks are per-process and incomparable on the wire


def parse_addr(addr: str) -> Tuple[str, int]:
    """``HOST:PORT`` -> ``(host, port)``. Bare ``:PORT`` means all
    interfaces (listen) / localhost (connect is given the full form by
    the flag author)."""
    host, sep, port = str(addr).rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"bad address {addr!r} (want HOST:PORT)")
    return host or "0.0.0.0", int(port)


class FrameError(ValueError):
    """A frame the protocol cannot have produced (oversized header) —
    the connection is poisoned and gets dropped, the process survives."""


def encode_frame(doc: Dict[str, Any]) -> bytes:
    payload = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameError(f"frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    return HEADER.pack(len(payload)) + payload


class FrameReader:
    """Accumulating, torn-tolerant frame decoder.

    ``feed(bytes)`` returns every complete frame decoded so far; a
    partial frame simply stays buffered until the next feed. At
    connection close the owner checks :meth:`pending_bytes` and
    discards the fragment — the torn-tail contract. A frame whose
    payload is not a JSON object is skipped (logged), not fatal.
    """

    def __init__(self) -> None:
        self._lock = cc.Lock()
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        with self._lock:
            self._buf.extend(data)
            while len(self._buf) >= HEADER.size:
                (n,) = HEADER.unpack_from(self._buf)
                if n > MAX_FRAME_BYTES:
                    raise FrameError(
                        f"frame header claims {n} bytes "
                        f"(> {MAX_FRAME_BYTES}) — corrupt stream")
                if len(self._buf) < HEADER.size + n:
                    break
                payload = bytes(self._buf[HEADER.size:HEADER.size + n])
                del self._buf[:HEADER.size + n]
                try:
                    doc = json.loads(payload)
                except ValueError as e:
                    log.warning("transport: skipping undecodable frame "
                                "(%s)", e)
                    continue
                if isinstance(doc, dict):
                    out.append(doc)
                else:
                    log.warning("transport: skipping non-object frame")
        return out

    def pending_bytes(self) -> int:
        with self._lock:
            return len(self._buf)


def _close_wire(wire) -> None:
    try:
        wire.close()
    except OSError:
        pass


def framed_send(wire, doc: Dict[str, Any]) -> None:
    """Write one frame, with the net.* wire chaos sites planted.

    ``net.torn_frame`` sends a strict prefix then resets; ``net.drop``
    resets before any byte; ``net.dup`` sends the frame twice (the
    id-dedupe on the receiving side must absorb it). All three surface
    to the caller as the OSError a real flaky network would raise.
    """
    data = encode_frame(doc)
    try:
        faultinject.fault_point("net.torn_frame")
    except faultinject.FaultInjected as e:
        try:
            wire.sendall(data[:max(1, len(data) // 2)])
        except OSError:
            pass
        _close_wire(wire)
        raise ConnectionResetError(
            errno.ECONNRESET, f"injected torn frame: {e}")
    try:
        faultinject.fault_point("net.drop")
    except faultinject.FaultInjected as e:
        _close_wire(wire)
        raise ConnectionResetError(
            errno.ECONNRESET, f"injected connection reset: {e}")
    wire.sendall(data)
    try:
        faultinject.fault_point("net.dup")
    except faultinject.FaultInjected:
        wire.sendall(data)  # duplicate delivery — dedupe-by-id absorbs


def _emit_span(name: str, t0_mono: float, dur_s: float, **fields) -> None:
    """One transport-side ``kind=span`` hop (net.connect / net.rpc)."""
    from paddle_tpu_torch.observability import metrics as obsm

    if not obsm.enabled():
        return
    obsm.emit("span", name=name, t0=obsm.rel_time(t0_mono),
              dur_s=round(max(float(dur_s), 0.0), 6),
              **{k: v for k, v in fields.items() if v not in ("", None)})


def _count(name: str, n: float = 1.0) -> None:
    from paddle_tpu_torch.observability import metrics as obsm

    obsm.registry().counter(name).inc(n)


def _tcp_connect(addr: str):
    host, port = parse_addr(addr)
    s = socket.create_connection((host or "127.0.0.1", port),
                                 timeout=CONNECT_TIMEOUT_S)
    s.settimeout(IO_TICK_S)
    return s


class SocketTransport:
    """One framed connection with the CONNECTING/UP/BACKOFF/CLOSED
    state machine and RetryPolicy-scheduled reconnects.

    A connector daemon thread owns the lifecycle: connect (or back
    off), then read frames inline until disconnect, then decide —
    reconnect (BACKOFF) or give up (CLOSED: the retry budget is
    exhausted, the owner called :meth:`close`, or reconnection was
    disabled for a drain). ``on_frame(doc)`` fires from that thread
    for every decoded frame; ``on_up()`` after each (re)connect —
    where :class:`SocketReplica` replays its hello handshake; and
    ``on_down()`` exactly once, on reaching CLOSED.

    ``connect_fn(addr)`` is injectable (any object with ``sendall`` /
    ``recv`` / ``close``), so the race spec drives this exact state
    machine over in-memory wires under the virtualized scheduler.
    """

    def __init__(self, name: str, addr: str, *,
                 on_frame: Callable[[Dict[str, Any]], None],
                 on_up: Optional[Callable[[], None]] = None,
                 on_down: Optional[Callable[[], None]] = None,
                 policy: Optional[RetryPolicy] = None,
                 connect_fn: Optional[Callable[[str], Any]] = None):
        self.name = name
        self.addr = addr
        self._on_frame = on_frame
        self._on_up = on_up
        self._on_down = on_down
        self._policy = policy or RetryPolicy(retry_on=(OSError,),
                                             name=f"net.{name}")
        self._connect_fn = connect_fn or _tcp_connect
        self._rng = random.Random(self._policy.seed)
        self._lock = cc.Lock()
        self._state = CONNECTING
        self._wire = None
        self._closing = False
        self._reconnect = True
        self._reconnects = 0
        self._send_lock = cc.Lock()
        self._thread = None

    # ------------------------------------------------------------ state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def reconnects(self) -> int:
        with self._lock:
            return self._reconnects

    def closed(self) -> bool:
        return self.state == CLOSED

    # ------------------------------------------------------- lifecycle

    def start(self) -> "SocketTransport":
        t = cc.Thread(target=self._run, name=f"transport-{self.name}",
                      daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return self

    def disable_reconnect(self) -> None:
        """The next disconnect goes straight to CLOSED — the drain
        path, where the peer closing the connection is the *success*
        signal, not a failure to retry."""
        with self._lock:
            self._reconnect = False

    def close(self) -> None:
        with self._lock:
            self._closing = True
            wire, self._wire = self._wire, None
        if wire is not None:
            _close_wire(wire)

    def join(self, timeout: float = 30.0) -> bool:
        with self._lock:
            t = self._thread
        if t is None:
            return True
        t.join(timeout=timeout)
        return not t.is_alive()

    # ------------------------------------------------------------ send

    def send(self, doc: Dict[str, Any]) -> bool:
        """Frame ``doc`` onto the live connection. False when not UP or
        the write fails (the failed wire is closed, which wakes the
        reader and triggers the reconnect machinery)."""
        with self._lock:
            wire = self._wire if self._state == UP else None
        if wire is None:
            return False
        try:
            with self._send_lock:
                framed_send(wire, doc)
            return True
        except (OSError, FrameError) as e:
            log.warning("transport %s: send failed (%s)", self.name, e)
            _close_wire(wire)
            return False

    # ------------------------------------------------------- connector

    def _run(self) -> None:
        attempt = 0
        first = True
        give_up_at = (cc.monotonic() + self._policy.deadline
                      if self._policy.deadline > 0 else None)
        while True:
            with self._lock:
                if self._closing:
                    self._state = CLOSED
                    break
                self._state = CONNECTING
            t0 = cc.monotonic()
            try:
                wire = self._connect_fn(self.addr)
            except OSError as e:
                attempt += 1
                if attempt >= self._policy.max_attempts or (
                        give_up_at is not None
                        and cc.monotonic() >= give_up_at):
                    log.warning("transport %s: giving up on %s after "
                                "%d attempt(s) (%s)", self.name,
                                self.addr, attempt, e)
                    with self._lock:
                        self._state = CLOSED
                    break
                delay = self._policy.delay_for(attempt, self._rng)
                with self._lock:
                    self._state = BACKOFF
                if not self._backoff(delay):
                    with self._lock:
                        self._state = CLOSED
                    break
                continue
            with self._lock:
                if self._closing:
                    self._state = CLOSED
                    _close_wire(wire)
                    break
                self._wire = wire
                self._state = UP
                if not first:
                    self._reconnects += 1
            if not first:
                _count("net.reconnects")
            first = False
            attempt = 0
            if give_up_at is not None:
                give_up_at = cc.monotonic() + self._policy.deadline
            _emit_span("net.connect", t0, cc.monotonic() - t0,
                       replica=self.name, addr=self.addr)
            if self._on_up is not None:
                try:
                    self._on_up()
                except Exception as e:  # a hello hiccup is a reconnect,
                    log.warning("transport %s: on_up failed (%s)",
                                self.name, e)   # not a crash
            self._read_until_disconnect(wire)
            _close_wire(wire)
            with self._lock:
                self._wire = None
                if self._closing or not self._reconnect:
                    self._state = CLOSED
                    break
                self._state = BACKOFF
        if self._on_down is not None:
            try:
                self._on_down()
            except Exception as e:
                log.warning("transport %s: on_down failed (%s)",
                            self.name, e)

    def _backoff(self, delay: float) -> bool:
        """RetryPolicy-scheduled sleep, interruptible by close().
        Returns False when the owner closed us mid-backoff."""
        deadline = cc.monotonic() + max(delay, 0.0)
        while cc.monotonic() < deadline:
            with self._lock:
                if self._closing:
                    return False
            cc.sleep(min(0.05, max(deadline - cc.monotonic(), 0.0)))
        with self._lock:
            return not self._closing

    def _read_until_disconnect(self, wire) -> None:
        reader = FrameReader()
        while True:
            with self._lock:
                if self._closing:
                    return
            try:
                # net.stall (sleep action) wedges reads right here:
                # heartbeats stop, health goes stale, the router
                # reroutes — the read-wedge drill
                faultinject.fault_point("net.stall", info=self.name)
            except faultinject.FaultInjected:
                return  # raise action: treat as a disconnect
            try:
                data = wire.recv(65536)
            except TimeoutError:
                continue
            except OSError:
                data = b""
            if not data:
                if reader.pending_bytes():
                    log.warning(
                        "transport %s: discarding %d-byte partial frame "
                        "at close (torn tail)", self.name,
                        reader.pending_bytes())
                return
            try:
                docs = reader.feed(data)
            except FrameError as e:
                log.warning("transport %s: %s — dropping connection",
                            self.name, e)
                return
            for doc in docs:
                try:
                    self._on_frame(doc)
                except Exception as e:
                    log.warning("transport %s: frame handler failed "
                                "(%s)", self.name, e)


class SocketReplica:
    """A remote `paddle serve --listen` replica behind the ProcReplica
    duck-type (``send`` / ``health`` / ``alive`` / ``poll_exit`` /
    ``pending_requests`` / ``begin_drain`` / ``kill`` / ``join`` /
    ``start``), so :class:`~paddle_tpu_torch.serving.fleet.FleetRouter` is
    transport-agnostic.

    Transport death (retry budget exhausted) surfaces as a synthetic
    nonzero exit from :meth:`poll_exit` — the router's death path
    re-offers this replica's outstanding requests to survivors and
    charges its restart budget, exactly as for a dead pipe child; a
    restart here is a fresh transport with a fresh retry budget.

    Requests are tracked until answered; every (re)connect sends a
    ``hello`` listing them, and the server answers the already-done
    ones from its answered-map and names the ``unknown`` ones, which
    are re-sent — the at-least-once contract over the wire. The first
    send stamps ``deadline_unix`` (wall clock) into the request doc
    itself, so a re-offer or hedge carries the *shrunken* remaining
    budget, and the remote admission sheds expired work locally.
    """

    def __init__(self, name: str, addr: str, *,
                 deliver: Callable[[str, Dict[str, Any]], None],
                 timeout_s: float = 60.0,
                 policy: Optional[RetryPolicy] = None,
                 connect_fn: Optional[Callable[[str], Any]] = None):
        self.name = name
        self.addr = addr
        self._deliver = deliver
        self._timeout_s = float(timeout_s)
        self._policy = policy
        self._connect_fn = connect_fn
        self._lock = cc.Lock()
        self._transport: Optional[SocketTransport] = None
        self._incarnation = 0
        self._exit: Optional[int] = None
        self._draining = False
        self._health: Optional[Dict[str, Any]] = None
        self._health_at = 0.0
        self._ping_at = -1e18
        # rid -> (request doc, send monotonic) until answered — the
        # hello re-offer set and the net.rpc span timebase
        self._sent: Dict[str, Tuple[Dict[str, Any], float]] = {}

    # ------------------------------------------------------- lifecycle

    def start(self) -> "SocketReplica":
        with self._lock:
            self._exit = None
            self._draining = False
            self._incarnation += 1
            inc = self._incarnation
            t = SocketTransport(
                f"{self.name}#{inc}", self.addr,
                on_frame=self._on_frame,
                on_up=self._on_up,
                on_down=lambda: self._on_down(inc),
                policy=self._policy,
                connect_fn=self._connect_fn)
            self._transport = t
        t.start()
        return self

    def alive(self) -> bool:
        with self._lock:
            t, ec = self._transport, self._exit
        return t is not None and ec is None and not t.closed()

    def poll_exit(self) -> Optional[int]:
        with self._lock:
            return self._exit

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True
            t = self._transport
        if t is not None:
            # the peer closing the connection after it drains is the
            # clean-exit signal, not a failure to retry
            t.disable_reconnect()
            t.send({"op": "drain"})

    def kill(self) -> None:
        with self._lock:
            t = self._transport
        if t is not None:
            t.disable_reconnect()
            t.close()

    def join(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            t = self._transport
        if t is None:
            return True
        return t.join(timeout if timeout is not None else 30.0)

    # ---------------------------------------------------------- duties

    def send(self, doc: Dict[str, Any]) -> bool:
        rid = str(doc.get("id", ""))
        with self._lock:
            t = self._transport
            if t is None or self._exit is not None or self._draining:
                return False
            if rid and "deadline_unix" not in doc and self._timeout_s > 0:
                # stamped ONCE into the shared doc: re-offers and
                # hedges of this request carry the shrunken remainder
                doc["deadline_unix"] = round(
                    wall_time() + self._timeout_s, 3)
            if rid:
                self._sent[rid] = (doc, cc.monotonic())
        ok = t.send(doc)
        if not ok and rid:
            with self._lock:
                self._sent.pop(rid, None)
        return ok

    def pending_requests(self) -> List[str]:
        # the remote journal replays on the REMOTE side at restart; on
        # a transport death everything owed is already in the router's
        # _outstanding set, so there is no local journal to read
        return []

    def health(self, now: float) -> Dict[str, Any]:
        with self._lock:
            t = self._transport
            ping_due = now - self._ping_at >= HEARTBEAT_PERIOD_S
            if ping_due:
                self._ping_at = now
            h, h_at = self._health, self._health_at
        if ping_due and t is not None:
            t.send({"op": "ping"})
        if h is not None and now - h_at <= STALE_AFTER_S:
            out = dict(h)
            out["age_s"] = round(max(now - h_at, 0.0), 3)
            return out
        return {"stale": True,
                "age_s": round(max(now - h_at, 0.0), 3) if h else None,
                "detail": f"no pong from {self.addr}"}

    # -------------------------------------------------------- internal

    def _on_up(self) -> None:
        with self._lock:
            t = self._transport
            rids = sorted(self._sent)
        if t is not None:
            t.send({"op": "hello", "replica": self.name,
                    "outstanding": rids})

    def _on_down(self, inc: int) -> None:
        with self._lock:
            if inc != self._incarnation:
                return  # a superseded transport's last gasp
            if self._exit is None:
                self._exit = 0 if self._draining else 1

    def _on_frame(self, doc: Dict[str, Any]) -> None:
        op = doc.get("op")
        if op == "pong":
            with self._lock:
                self._health = doc.get("status") or {}
                self._health_at = cc.monotonic()
            return
        if op == "hello_ack":
            # frames that never reached the server: re-send the full
            # request docs (at-least-once; server dedupes by id)
            unknown = [str(r) for r in doc.get("unknown") or []]
            with self._lock:
                t = self._transport
                docs = [self._sent[r][0] for r in unknown
                        if r in self._sent]
            if docs:
                log.info("transport %s: re-offering %d undelivered "
                         "request(s) after reconnect", self.name,
                         len(docs))
            for d in docs:
                if t is None or not t.send(d):
                    break
            return
        if "id" in doc:
            rid = str(doc["id"])
            with self._lock:
                ent = self._sent.pop(rid, None)
            if ent is not None:
                _emit_span("net.rpc", ent[1], cc.monotonic() - ent[1],
                           trace=str(doc.get("trace_id") or ""),
                           replica=self.name)
            self._deliver(self.name, doc)


class EngineSocketServer:
    """The replica-side front door: accepts framed requests for an
    in-process :class:`~paddle_tpu_torch.serving.engine.Engine` and answers
    them IN SUBMISSION ORDER over the live connection (the same
    ordering contract as the stdin front-end).

    One router connection is live at a time — a newer accept replaces
    the old (a reconnecting router must not split the answer stream).
    Answered results are kept by id: a ``hello`` after reconnect gets
    the already-answered subset re-sent and the never-seen subset named
    in ``hello_ack.unknown`` so the client re-offers them. With a
    journal, the done-mark lands only after a result actually went out
    on a live wire — an unsent answer is re-offered by journal replay
    on the next incarnation (at-least-once; dedupe by id).
    """

    def __init__(self, engine, listen: str, *, journal=None,
                 on_drain: Optional[Callable[[], None]] = None):
        self.engine = engine
        self.journal = journal
        self._on_drain = on_drain
        self._lock = cc.Lock()
        self._cv = cc.Condition(self._lock)
        self._pending: List[Tuple[str, Any, str]] = []  # submission order
        self._inflight: set = set()
        self._answered: Dict[str, Dict[str, Any]] = {}
        self._conn = None
        self._closing = False
        self._threads: List[Any] = []
        host, port = parse_addr(listen)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self._srv.settimeout(IO_TICK_S)
        self.host, self.port = self._srv.getsockname()[:2]

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "EngineSocketServer":
        acceptor = cc.Thread(target=self._accept, daemon=True,
                             name="transport-accept")
        pump = cc.Thread(target=self._pump, daemon=True,
                         name="transport-pump")
        with self._lock:
            self._threads = [acceptor, pump]
        acceptor.start()
        pump.start()
        return self

    def replay(self, doc: Dict[str, Any]) -> None:
        """Journal re-offer at startup: submit past queue_cap (the
        backlog was durably accepted by a previous incarnation) and
        queue its answer for whichever router connects."""
        rid = str(doc["id"])
        trace = str(doc.get("trace_id") or "")
        fut = self.engine.submit(
            doc.get("prompt") or [],
            max_new_tokens=doc.get("max_new_tokens"),
            rid=rid, replay=True, trace=trace)
        with self._lock:
            self._inflight.add(rid)
            self._pending.append((rid, fut, trace))
            self._cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        """True when every submitted request has been answered."""
        deadline = cc.monotonic() + timeout
        with self._lock:
            while self._pending:
                remaining = deadline - cc.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.25))
            return True

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closing = True
            conn, self._conn = self._conn, None
            threads = list(self._threads)
            self._cv.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass
        if conn is not None:
            _close_wire(conn)
        for t in threads:
            t.join(timeout=timeout)

    # -------------------------------------------------------- internal

    def _accept(self) -> None:
        while True:
            with self._lock:
                if self._closing:
                    return
            try:
                wire, _peer = self._srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            wire.settimeout(IO_TICK_S)
            with self._lock:
                old, self._conn = self._conn, wire
            if old is not None:
                _close_wire(old)  # latest router connection wins
            cc.Thread(target=self._serve_conn, args=(wire,),
                      daemon=True, name="transport-conn").start()

    def _serve_conn(self, wire) -> None:
        reader = FrameReader()
        while True:
            with self._lock:
                if self._closing:
                    break
            try:
                faultinject.fault_point("net.stall", info="server")
            except faultinject.FaultInjected:
                break
            try:
                data = wire.recv(65536)
            except TimeoutError:
                continue
            except OSError:
                data = b""
            if not data:
                break
            try:
                docs = reader.feed(data)
            except FrameError as e:
                log.warning("transport server: %s — dropping "
                            "connection", e)
                break
            for doc in docs:
                try:
                    self._handle(doc, wire)
                except Exception as e:
                    log.warning("transport server: frame handler "
                                "failed (%s)", e)
        if reader.pending_bytes():
            log.warning("transport server: discarding %d-byte partial "
                        "frame at close (torn tail)",
                        reader.pending_bytes())
        _close_wire(wire)

    def _send(self, wire, doc: Dict[str, Any]) -> bool:
        if wire is None:
            return False
        try:
            framed_send(wire, doc)
            return True
        except (OSError, FrameError) as e:
            log.warning("transport server: send failed (%s)", e)
            _close_wire(wire)
            return False

    def _handle(self, doc: Dict[str, Any], wire) -> None:
        op = doc.get("op")
        if op == "ping":
            self._send(wire, {"op": "pong",
                              "status": self.engine.status()})
            return
        if op == "hello":
            outstanding = [str(r) for r in doc.get("outstanding") or []]
            with self._lock:
                resend = [self._answered[r] for r in outstanding
                          if r in self._answered]
                unknown = [r for r in outstanding
                           if r not in self._answered
                           and r not in self._inflight]
            for out in resend:
                if not self._send(wire, out):
                    return
            self._send(wire, {"op": "hello_ack", "unknown": unknown})
            return
        if op == "drain":
            if self._on_drain is not None:
                self._on_drain()
            return
        if op is not None:
            log.warning("transport server: unknown op %r", op)
            return
        # a request frame
        rid = str(doc.get("id", "")) or f"req-?-{id(doc)}"
        trace = str(doc.get("trace_id") or "")
        prompt = doc.get("prompt")
        if not isinstance(prompt, list) or not all(
                isinstance(t, int) for t in prompt):
            self._send(wire, {"id": rid, "outcome": "error",
                              "tokens": [],
                              "error": "prompt must be a list of "
                                       "token ids"})
            return
        with self._lock:
            done = self._answered.get(rid)
            dup = done is not None or rid in self._inflight
        if done is not None:
            self._send(wire, done)  # hedge/dup re-ask: answer again
            return
        if dup:
            return  # in flight — exactly one answer will go out
        # deadline-aware admission, now remote: the wall-clock deadline
        # the router stamped decides whether any budget remains here
        timeout_s = None
        dl = doc.get("deadline_unix")
        if dl:
            timeout_s = float(dl) - wall_time()
            if timeout_s <= 0:
                out = {"id": rid, "outcome": "timeout", "tokens": [],
                       "error": "deadline expired on arrival"}
                with self._lock:
                    self._answered[rid] = out
                self._send(wire, out)
                return
        if self.journal is not None:
            jt0 = cc.monotonic()
            accepted = self.journal.accept(doc)
            if trace:
                _emit_span("replica.journal", jt0,
                           cc.monotonic() - jt0, trace=trace)
            if not accepted:
                # journaled by a previous incarnation: replayed already
                # (its answer will flow) or done before the crash
                log.info("transport server: duplicate request id %r "
                         "skipped (journal)", rid)
                return
        fut = self.engine.submit(
            prompt, max_new_tokens=doc.get("max_new_tokens"),
            rid=rid, timeout_s=timeout_s, trace=trace)
        with self._lock:
            self._inflight.add(rid)
            self._pending.append((rid, fut, trace))
            self._cv.notify_all()

    def _pump(self) -> None:
        """Resolve futures in submission order and frame the answers
        out — the socket analog of the stdin front-end's flush loop."""
        while True:
            with self._lock:
                while not self._pending and not self._closing:
                    self._cv.wait(timeout=0.25)
                if self._closing and not self._pending:
                    return
                rid, fut, trace = self._pending[0]
            if not fut.done():
                # head-of-line blocking is the ordering contract; the
                # bounded wait keeps close() able to interrupt
                with self._lock:
                    self._cv.wait(timeout=0.05)
                continue
            res = fut.result(timeout=600.0)
            out: Dict[str, Any] = {"id": rid, "outcome": res.outcome,
                                   "tokens": res.tokens}
            if trace:
                out["trace_id"] = trace  # echoed verbatim
            if res.error:
                out["error"] = res.error
            if res.retry_after_s is not None:
                out["retry_after_s"] = res.retry_after_s
            with self._lock:
                self._pending.pop(0)
                self._inflight.discard(rid)
                self._answered[rid] = out
                conn = self._conn
                self._cv.notify_all()
            sent = self._send(conn, out)
            if self.journal is not None and sent:
                # done-mark only after the answer actually left on a
                # live wire: an unsent answer must replay next run
                self.journal.answer(rid, res.outcome)


class _WireFuture:
    """Result future for :class:`SocketEngineClient` (bench tcp
    driver) — resolves with the raw answer doc."""

    def __init__(self) -> None:
        self._ev = cc.Event()
        self.doc: Optional[Dict[str, Any]] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout=timeout if timeout is not None
                             else 600.0):
            raise TimeoutError("no answer on the wire")
        return self.doc

    def _resolve(self, doc: Dict[str, Any]) -> None:
        self.doc = doc
        self._ev.set()


class SocketEngineClient:
    """Minimal framed request/response client for the bench harness's
    ``transport=tcp`` mode: the same engines, driven through a real
    loopback socket, so serialization + framing + syscall cost lands
    in the measured ``router_share`` instead of being assumed away."""

    def __init__(self, addr: str, *, name: str = "bench-client",
                 policy: Optional[RetryPolicy] = None,
                 connect_fn: Optional[Callable[[str], Any]] = None):
        self._lock = cc.Lock()
        self._futs: Dict[str, _WireFuture] = {}
        self._transport = SocketTransport(
            name, addr, on_frame=self._on_frame, policy=policy,
            connect_fn=connect_fn)

    def start(self) -> "SocketEngineClient":
        self._transport.start()
        return self

    def close(self) -> None:
        self._transport.close()
        self._transport.join(5.0)

    def submit(self, doc: Dict[str, Any],
               connect_timeout_s: float = 10.0) -> _WireFuture:
        rid = str(doc["id"])
        fut = _WireFuture()
        with self._lock:
            self._futs[rid] = fut
        deadline = cc.monotonic() + connect_timeout_s
        while not self._transport.send(doc):
            if (self._transport.closed()
                    or cc.monotonic() >= deadline):
                with self._lock:
                    self._futs.pop(rid, None)
                raise OSError(f"transport to {self._transport.addr} "
                              "unavailable")
            cc.sleep(0.01)
        return fut

    def _on_frame(self, doc: Dict[str, Any]) -> None:
        if "id" not in doc:
            return
        with self._lock:
            fut = self._futs.pop(str(doc["id"]), None)
        if fut is not None:
            fut._resolve(doc)
