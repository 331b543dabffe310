"""On-the-wire serving: socket transport for :class:`ServingFrontend`.

The session tier (:mod:`repro_torch.serve.frontend`) runs in one
process.  This module puts the front-end on a real socket with two perf
properties the in-process path already had and the wire must not lose:

* **zero-copy ingest** — event chunks travel as length-prefixed binary
  frames whose payload is the raw struct-of-arrays columns of an
  :class:`EventBatch`; the server decodes them as ``np.frombuffer`` views
  over the received buffer (no per-event Python objects, no copy until
  the batcher merges);
* **churn-free delivery** — deliveries are batched per frame and encoded
  columnar with a per-frame string-intern table (kind / query / aggregate
  names), so a flush that fans out to hundreds of windows serializes
  without building per-record dicts.

Flow control is **credit-based** instead of drop-based: the server grants
each session a window of event credits sized off the serving staging /
ingress high-water mark, frees a submission's credits once the scheduler
seal passes its max timestamp (or sooner, while staging has headroom),
and withholds grants while staging sits above the high-water gate.  A compliant client blocks at zero credits, so
overload surfaces to the producer as backpressure — bounded staging
memory, nothing shed.  A client that keeps pushing past its window is
still shed at the door by ``SessionAdmission`` exactly as in-process.
Grant/withhold counters and the per-session blocked-time histogram land
in the front-end's :class:`Observability` registry (``serve.credits_*``,
``serve.blocked_ms.session.*``).

Wire protocol (all integers little-endian; frame = ``u32 length`` +
``u8 type`` + payload; one TCP connection carries exactly one session):

====  =========  ==========================================================
type  direction  payload
====  =========  ==========================================================
1     C -> S     HELLO: pickled ``{"tenant": int, "groups": ...}``
2     C -> S     SUBMIT: chunk columns (``u32 n, u8 has_seq`` + raw
                 int32/int64/f64 column bytes)
3     C -> S     ADVANCE: ``i64 t`` watermark heartbeat
4     C -> S     CLOSE: end of submit side (deliveries keep flowing)
5     C -> S     BYE: stop consuming; server closes the connection
16    S -> C     SESSION: ``u32 sid, i64 credits, i64 pane``
17    S -> C     CREDIT: ``i64 delta`` freed event credits
18    S -> C     DELIVER: ``f64 t_enc`` + intern table + columnar records
19    S -> C     END: pickled final subscribed ``results()`` (sent on
                 drain; the channel's close sentinel)
====  =========  ==========================================================

Failure semantics: a dropped connection closes its session (the watermark
no longer waits on it), drops its credit state, and cancels its delivery
writer — in-flight deliveries for other sessions are unaffected.  The
END frame doubles as the clean-shutdown marker: a client that sees EOF
without END knows the stream was cut, not drained.

Determinism: TCP preserves per-connection order and the server stages
each connection's submissions in arrival order, so the front-end's
seq-stamping sees exactly the per-session submission sequence — loopback
results are bitwise equal to driving the same sessions in-process.

The protocol is the JAX package's, byte for byte (frames, column codec,
delivery codec), so either package's client talks to either package's
server.  HELLO, END and a delivery's non-numeric aggregate value are the
only pickled payloads; they hold builtins and numpy only, never a tensor
or an object of this package, and this package reads them with
:func:`repro_torch.interop.plain_loads`, which refuses anything else.
The server's event-loop thread makes the front-end engine's device its
current CUDA device (the END frame reads the engine's results from that
thread).
"""

from __future__ import annotations

import asyncio
import pickle
import socket
import struct
import threading
import time
from collections import deque

import numpy as np

from ..core.events import EventBatch
from ..interop import plain_loads
from ..kernels import ops
from ..obs.metrics import serve_blocked_series
from .session import Delivery

__all__ = ["ServingServer", "ServingClient", "CreditGate",
           "encode_chunk", "decode_chunk",
           "encode_deliveries", "decode_deliveries"]

# frame types ---------------------------------------------------------------
_HELLO, _SUBMIT, _ADVANCE, _CLOSE, _BYE = 1, 2, 3, 4, 5
_SESSION, _CREDIT, _DELIVER, _END = 16, 17, 18, 19

_HDR = struct.Struct("<IB")            # frame length (excl. itself) + type
_CHUNK_HDR = struct.Struct("<IB")      # n events, has_seq
_SESSION_S = struct.Struct("<IqQ")     # sid, credits, pane
_CREDIT_S = struct.Struct("<q")        # credit delta
_REC_S = struct.Struct("<HHqqid")      # kind_id, query_id, group, w0,
                                       # revision, latency_ms
_VAL_F64, _VAL_I64, _VAL_PKL = 0, 1, 2


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------

def encode_chunk(batch: EventBatch) -> bytes:
    """Event columns as raw bytes (the zero-copy wire form of a batch)."""
    has_seq = batch.seq is not None
    parts = [_CHUNK_HDR.pack(len(batch), 1 if has_seq else 0),
             np.ascontiguousarray(batch.type_id).tobytes(),
             np.ascontiguousarray(batch.time).tobytes(),
             np.ascontiguousarray(batch.attrs).tobytes(),
             np.ascontiguousarray(batch.group).tobytes()]
    if has_seq:
        parts.append(np.ascontiguousarray(batch.seq).tobytes())
    return b"".join(parts)


def decode_chunk(schema, payload) -> EventBatch:
    """Decode a SUBMIT payload as zero-copy views over ``payload``.

    The returned batch's arrays are read-only ``np.frombuffer`` views into
    the received buffer — nothing is copied until the batcher merges the
    staged prefix (which concatenates, and therefore copies, anyway).
    """
    buf = memoryview(payload)
    n, has_seq = _CHUNK_HDR.unpack_from(buf, 0)
    off = _CHUNK_HDR.size
    a = max(1, len(schema.attrs))
    type_id = np.frombuffer(buf, np.int32, n, off)
    off += 4 * n
    t = np.frombuffer(buf, np.int64, n, off)
    off += 8 * n
    attrs = np.frombuffer(buf, np.float64, n * a, off).reshape(n, a)
    off += 8 * n * a
    group = np.frombuffer(buf, np.int64, n, off)
    off += 8 * n
    seq = np.frombuffer(buf, np.int64, n, off) if has_seq else None
    return EventBatch(schema, type_id, t, attrs, group, seq=seq)


def encode_deliveries(deliveries, t_enc: float) -> bytes:
    """Columnar DELIVER payload: one string-intern table per frame, one
    fixed-width record per delivery, values tagged f64/i64 (pickle only
    for exotic aggregate values).  No per-record dicts are built."""
    strings: list[bytes] = []
    index: dict[str, int] = {}

    def intern(s: str) -> int:
        i = index.get(s)
        if i is None:
            i = index[s] = len(strings)
            strings.append(s.encode())
        return i

    body = bytearray()
    for d in deliveries:
        body += _REC_S.pack(intern(d.kind), intern(d.query), d.group,
                            d.w0, d.revision, d.latency_ms)
        vals = d.vals
        if vals is None:
            body += struct.pack("<H", 0xFFFF)
            continue
        body += struct.pack("<H", len(vals))
        for k, v in vals.items():
            if type(v) is float:
                body += struct.pack("<HBd", intern(k), _VAL_F64, v)
            elif type(v) is int:
                body += struct.pack("<HBq", intern(k), _VAL_I64, v)
            else:
                p = pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL)
                body += struct.pack("<HBI", intern(k), _VAL_PKL, len(p))
                body += p
    head = bytearray(struct.pack("<dHI", t_enc, len(strings),
                                 len(deliveries)))
    for s in strings:
        head += struct.pack("<H", len(s))
        head += s
    return bytes(head) + bytes(body)


def decode_deliveries(payload) -> tuple[float, list[Delivery]]:
    """Inverse of :func:`encode_deliveries`; returns ``(t_enc, records)``."""
    buf = memoryview(payload)
    t_enc, n_strings, n_rec = struct.unpack_from("<dHI", buf, 0)
    off = struct.calcsize("<dHI")
    strings: list[str] = []
    for _ in range(n_strings):
        (ln,) = struct.unpack_from("<H", buf, off)
        off += 2
        strings.append(bytes(buf[off:off + ln]).decode())
        off += ln
    out: list[Delivery] = []
    for _ in range(n_rec):
        kind_id, query_id, group, w0, rev, lat = _REC_S.unpack_from(buf, off)
        off += _REC_S.size
        (n_vals,) = struct.unpack_from("<H", buf, off)
        off += 2
        vals = None
        if n_vals != 0xFFFF:
            vals = {}
            for _ in range(n_vals):
                key_id, tag = struct.unpack_from("<HB", buf, off)
                off += 3
                if tag == _VAL_F64:
                    (v,) = struct.unpack_from("<d", buf, off)
                    off += 8
                elif tag == _VAL_I64:
                    (v,) = struct.unpack_from("<q", buf, off)
                    off += 8
                else:
                    (ln,) = struct.unpack_from("<I", buf, off)
                    off += 4
                    v = plain_loads(bytes(buf[off:off + ln]))
                    off += ln
                vals[strings[key_id]] = v
        out.append(Delivery(strings[kind_id], strings[query_id], group,
                            w0, vals, rev, lat))
    return t_enc, out


# --------------------------------------------------------------------------
# credit gate (server side)
# --------------------------------------------------------------------------

class CreditGate:
    """Per-session event-credit accounting against the staging high-water.

    A session starts with ``window`` event credits.  ``on_submit`` charges
    a submission and remembers its max timestamp.  Credits recirculate on
    two conditions, checked at every poll:

    * the front-end's seal boundary passed the submission's max timestamp
      — its events left staging and are owned by the engine; or
    * total staged events sit *below* ``staging_high`` — staging has
      headroom, so staged-but-unsealed submissions may recirculate too.
      This clause matters for the session currently holding the seal
      watermark: its last staged pane cannot seal until *future* events
      arrive, so seal-only freeing would deadlock a compliant producer at
      zero credits.

    Grants are withheld — accumulated, not lost — while staged events sit
    at/above ``staging_high``, so a burst across many sessions cannot
    inflate staging memory past the gate: staging is bounded by
    ``staging_high + sessions x window`` (each producer holds at most its
    window past the gate).  ``staging_high`` must comfortably exceed one
    pane's arrival volume: the unsealed tail pane is held in staging by
    the watermark itself, and a gate it keeps shut cannot reopen.
    """

    def __init__(self, frontend, window: int, staging_high: int, obs=None):
        self.frontend = frontend
        self.window = int(window)
        self.staging_high = int(staging_high)
        self.obs = obs
        self.granted = 0               # credits granted (events), lifetime
        self.withheld = 0              # credits that sat gated at least once
        self._lock = threading.Lock()
        self._inflight: dict[int, deque] = {}    # sid -> (t_max, n)
        self._pending: dict[int, int] = {}       # freed but gated
        self._balance: dict[int, int] = {}       # server-side mirror
        self._blocked_since: dict[int, float] = {}

    def register(self, sid: int) -> int:
        with self._lock:
            self._inflight[sid] = deque()
            self._pending[sid] = 0
            self._balance[sid] = self.window
        return self.window

    def forget(self, sid: int) -> None:
        """Session gone (closed or connection dropped): drop its state so
        its in-flight charge never wedges the accounting."""
        with self._lock:
            self._inflight.pop(sid, None)
            self._pending.pop(sid, None)
            self._balance.pop(sid, None)
            self._blocked_since.pop(sid, None)

    def on_submit(self, sid: int, n: int, t_max: int, now: float) -> None:
        if n <= 0:
            return
        with self._lock:
            q = self._inflight.get(sid)
            if q is None:
                return
            q.append((t_max, n))
            self._balance[sid] -= n
            if self._balance[sid] <= 0:
                self._blocked_since.setdefault(sid, now)

    def poll(self, sid: int, now: float) -> int:
        """Free credits whose submissions the seal consumed — plus, while
        staging has headroom, staged-but-unsealed ones; return how many to
        grant right now (0 while the staging gate is shut)."""
        sealed = self.frontend.sealed_to()
        staged = self.frontend.staged_events()
        with self._lock:
            q = self._inflight.get(sid)
            if q is None:
                return 0
            freed = 0
            while q and q[0][0] < sealed:
                freed += q.popleft()[1]
            if staged < self.staging_high:
                while q:
                    freed += q.popleft()[1]
            if staged >= self.staging_high:
                if freed and self.obs is not None:
                    self.obs.count("serve.credits_withheld", freed)
                self.withheld += freed
                self._pending[sid] += freed
                return 0
            grant = freed + self._pending[sid]
            self._pending[sid] = 0
            if grant:
                self.granted += grant
                self._balance[sid] += grant
                t0 = self._blocked_since.pop(sid, None)
                if self.obs is not None:
                    self.obs.count("serve.credits_granted", grant)
                    if t0 is not None:
                        self.obs.observe_blocked(sid, (now - t0) * 1e3)
            return grant

    def summary(self) -> dict:
        with self._lock:
            return {"window": self.window,
                    "staging_high": self.staging_high,
                    "granted": self.granted,
                    "withheld": self.withheld,
                    "inflight": {s: sum(n for _, n in q)
                                 for s, q in self._inflight.items()}}


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

class _Conn:
    __slots__ = ("sid", "handle", "writer", "alive", "tasks", "wlock")

    def __init__(self):
        self.sid = None
        self.handle = None
        self.writer = None
        self.alive = True
        self.tasks = []
        self.wlock = None


class ServingServer:
    """Asyncio socket server fronting one :class:`ServingFrontend`.

    The event loop runs on a background thread; each accepted connection
    runs a reader coroutine (frames in), a delivery writer (poll the
    session inbox, batch into DELIVER frames), and a credit loop (free /
    grant against the :class:`CreditGate`).  ``drain()`` drains the
    front-end, lets every live writer flush its END frame, and returns the
    final results; ``stop()`` tears the loop down.
    """

    def __init__(self, frontend, host: str = "127.0.0.1", port: int = 0, *,
                 credit_window: int = 2048, staging_high: int | None = None,
                 poll_interval: float = 0.002,
                 clock=time.perf_counter):
        if staging_high is None:
            # size the gate off the ingress high watermark when the
            # backend has one, else a serving-level default
            rt = getattr(frontend._backend, "rt", None)
            q = getattr(rt, "queue", None)
            staging_high = q.high if q is not None else 1 << 12
        self.frontend = frontend
        self.host = host
        self.port = port
        self.poll_interval = poll_interval
        self._clock = clock
        self.gate = CreditGate(frontend, credit_window, staging_high,
                               obs=_GateObs(frontend.obs))
        self.frames_in = 0
        self.frames_out = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.disconnects = 0
        self.late_frames = 0        # SUBMITs that raced a close / drain
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[_Conn] = set()
        self._conn_tasks: set[asyncio.Task] = set()
        self._ready = threading.Event()
        self._drained = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def start(self, pump_interval: float = 0.002) -> tuple[str, int]:
        """Start the loop thread, bind the listener, start the front-end
        pump; returns the bound ``(host, port)``."""
        self._thread = threading.Thread(target=self._run_loop,
                                        name="serve-transport")
        self._thread.start()
        self._ready.wait()
        if self._server is None:        # bind failed in the loop thread
            self._thread.join()
            raise OSError(f"could not bind {self.host}:{self.port}")
        self.frontend.start(pump_interval)
        return self.host, self.port

    def _run_loop(self) -> None:
        with ops.on_device(self.frontend.device):
            self._serve_forever()

    def _serve_forever(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            srv = self._loop.run_until_complete(asyncio.start_server(
                self._accept, self.host, self.port))
            self._server = srv
            self.port = srv.sockets[0].getsockname()[1]
        finally:
            self._ready.set()
        if self._server is None:
            self._loop.close()
            return
        try:
            self._loop.run_forever()
        finally:
            self._loop.run_until_complete(self._loop.shutdown_asyncgens())
            self._loop.close()

    def drain(self, timeout: float = 60.0) -> dict:
        """Drain the front-end and flush END down every live connection.

        The owner should drain only once every session is closed (poll
        ``frontend.summary()["sessions"]``): a producer's ``close()``
        returns when the CLOSE frame hits its socket, not when the server
        has processed it, so frames may trail in the socket buffer.  Such
        stragglers don't kill their connection — they are dropped and
        counted as ``late_frames`` — but any events they carried are lost
        to the drained engine."""
        res = self.frontend.drain()
        self._drained.set()
        fut = asyncio.run_coroutine_threadsafe(self._wait_conns(),
                                               self._loop)
        fut.result(timeout=timeout)
        return res

    async def _wait_conns(self) -> None:
        # wait for every live connection's delivery writer to flush its
        # END frame — NOT for the reader (which blocks until the client's
        # BYE), so a single-threaded owner can drain before its clients
        # acknowledge
        ts = [c.tasks[0] for c in list(self._conns) if c.tasks]
        if ts:
            await asyncio.gather(*ts, return_exceptions=True)

    def stop(self) -> None:
        if self._loop is None:
            return
        self.frontend.stop()
        asyncio.run_coroutine_threadsafe(self._shutdown(),
                                         self._loop).result(timeout=30.0)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join()
        self._loop = None
        self._thread = None

    async def _shutdown(self) -> None:
        self._server.close()
        await self._server.wait_closed()
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*list(self._conn_tasks),
                                 return_exceptions=True)

    # ----------------------------------------------------------- connection

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Conn()
        conn.writer = writer
        conn.wlock = asyncio.Lock()
        self._conns.add(conn)
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            await self._serve_conn(conn, reader)
        except (asyncio.CancelledError, Exception):
            pass
        finally:
            self._conns.discard(conn)
            try:
                # stay in _conn_tasks until teardown finishes: stop() must
                # be able to cancel/await a connection mid-teardown, else
                # the loop closes under a still-pending task
                await self._teardown(conn)
            finally:
                self._conn_tasks.discard(task)

    async def _serve_conn(self, conn: _Conn,
                          reader: asyncio.StreamReader) -> None:
        fe = self.frontend
        try:
            while True:
                ftype, payload = await self._read_frame(reader)
                if ftype == _HELLO:
                    opts = plain_loads(payload)
                    h = fe.open_session(tenant=opts.get("tenant", 0),
                                        groups=opts.get("groups"))
                    conn.sid = h.id
                    conn.handle = h
                    credits = self.gate.register(h.id)
                    await self._send(conn, _SESSION, _SESSION_S.pack(
                        h.id, credits, fe.pane))
                    conn.tasks.append(asyncio.ensure_future(
                        self._delivery_writer(conn)))
                    conn.tasks.append(asyncio.ensure_future(
                        self._credit_loop(conn)))
                elif ftype == _SUBMIT:
                    chunk = decode_chunk(fe.workload.schema, payload)
                    n = len(chunk)
                    t_max = int(chunk.time[-1]) if n else -1
                    try:
                        fe.submit(conn.sid, chunk)
                    except RuntimeError:
                        # the session closed (or the owner drained) while
                        # this frame sat in the socket buffer; its events
                        # are past the seal and nothing may consume them —
                        # drop the frame, keep the connection, so END
                        # still reaches a compliant client
                        self.late_frames += 1
                        continue
                    self.gate.on_submit(conn.sid, n, t_max, self._clock())
                elif ftype == _ADVANCE:
                    (t,) = struct.unpack("<q", payload)
                    fe.advance(conn.sid, t)
                elif ftype == _CLOSE:
                    fe.close_session(conn.sid)
                    self.gate.forget(conn.sid)
                elif ftype == _BYE:
                    return
                else:
                    raise ConnectionError(f"bad frame type {ftype}")
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            # mid-stream drop: the session must not wedge the watermark
            # or hold credits hostage
            if conn.sid is not None:
                self.disconnects += 1
            conn.alive = False
            raise ConnectionError from None

    async def _teardown(self, conn: _Conn) -> None:
        if conn.sid is not None:
            self.frontend.close_session(conn.sid)
            self.gate.forget(conn.sid)
        alive = conn.alive
        conn.alive = False
        try:
            for t in conn.tasks:
                # clean BYE after drain: let the writer flush END first;
                # everything else is cancelled outright
                if alive and (t.done() or self._drained.is_set()):
                    try:
                        await asyncio.wait_for(asyncio.shield(t),
                                               timeout=30.0)
                    except (asyncio.TimeoutError, Exception):
                        t.cancel()
                else:
                    t.cancel()
            if conn.tasks:
                await asyncio.gather(*conn.tasks, return_exceptions=True)
        except asyncio.CancelledError:
            for t in conn.tasks:
                t.cancel()
        try:
            conn.writer.close()
            await conn.writer.wait_closed()
        except (asyncio.CancelledError, ConnectionError, OSError):
            pass

    # ------------------------------------------------------------ coroutines

    async def _delivery_writer(self, conn: _Conn) -> None:
        """Poll the session inbox; batch everything pending into one
        columnar DELIVER frame per poll; send END when the front-end
        drains."""
        h = conn.handle
        try:
            while conn.alive:
                ds = h.poll()
                if ds:
                    await self._send(conn, _DELIVER, encode_deliveries(
                        ds, self._clock()))
                if h.drained:
                    res = {k: v for k, v in
                           self.frontend.results().items()
                           if h.subscribes(k[1])}
                    await self._send(conn, _END, pickle.dumps(
                        res, protocol=pickle.HIGHEST_PROTOCOL))
                    return
                await asyncio.sleep(self.poll_interval)
        except (ConnectionError, OSError, asyncio.CancelledError):
            conn.alive = False

    async def _credit_loop(self, conn: _Conn) -> None:
        try:
            while conn.alive and not self._drained.is_set():
                grant = self.gate.poll(conn.sid, self._clock())
                if grant:
                    await self._send(conn, _CREDIT, _CREDIT_S.pack(grant))
                await asyncio.sleep(self.poll_interval)
        except (ConnectionError, OSError, asyncio.CancelledError):
            conn.alive = False

    # ----------------------------------------------------------------- io

    async def _read_frame(self, reader) -> tuple[int, bytes]:
        head = await reader.readexactly(_HDR.size)
        length, ftype = _HDR.unpack(head)
        payload = await reader.readexactly(length) if length else b""
        self.frames_in += 1
        self.bytes_in += _HDR.size + length
        return ftype, payload

    async def _send(self, conn: _Conn, ftype: int, payload: bytes) -> None:
        async with conn.wlock:
            conn.writer.write(_HDR.pack(len(payload), ftype) + payload)
            await conn.writer.drain()
        self.frames_out += 1
        self.bytes_out += _HDR.size + len(payload)

    # ------------------------------------------------------------- summary

    def summary(self) -> dict:
        return {"host": self.host, "port": self.port,
                "frames_in": self.frames_in, "frames_out": self.frames_out,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "disconnects": self.disconnects,
                "late_frames": self.late_frames,
                "credit": self.gate.summary()}


class _GateObs:
    """Adapter giving :class:`CreditGate` its two obs hooks while keeping
    the gate importable without an :class:`Observability` attached."""

    __slots__ = ("obs",)

    def __init__(self, obs):
        self.obs = obs

    def count(self, name, n=1):
        if self.obs is not None:
            self.obs.count(name, n)

    def observe_blocked(self, sid, ms):
        if self.obs is not None:
            from ..obs.metrics import SERVE_LATENCY_MS_BUCKETS
            self.obs.observe(serve_blocked_series(sid), ms,
                             edges=SERVE_LATENCY_MS_BUCKETS)


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------

class ServingClient:
    """Synchronous socket client: one connection, one session.

    ``submit`` blocks while the credit balance cannot cover the batch (the
    compliant-producer contract; ``block=False`` submits regardless, which
    the server answers with admission-level shedding under overload).
    ``deliveries()`` iterates records until the server's END frame; after
    that :attr:`results` holds the final subscribed window aggregates.
    """

    def __init__(self, host: str, port: int, *, tenant: int = 0,
                 groups=None, timeout: float | None = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(None)     # reads block; waits carry timeouts
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._cv = threading.Condition()
        self._credits = 0
        self._inbox: deque = deque()
        self._results: dict | None = None
        self._ended = False
        self._dead = False
        self.sid: int | None = None
        self.pane: int | None = None
        self.blocked_s = 0.0            # client-side credit-wait time
        self.t_enc_last: float | None = None
        # per-DELIVER-frame (t_encoded, t_received, n_records); clocks are
        # comparable only when client and server share a host (loopback)
        self.wire_samples: list[tuple[float, float, int]] = []
        self._send(_HELLO, pickle.dumps({"tenant": tenant,
                                         "groups": groups}))
        self._reader = threading.Thread(target=self._read_loop,
                                        name="serve-client-rx")
        self._reader.start()
        with self._cv:
            if not self._cv.wait_for(lambda: self.sid is not None
                                     or self._dead, timeout=timeout):
                raise TimeoutError("no SESSION reply")
            if self.sid is None:
                raise ConnectionError("server closed before SESSION")

    # ------------------------------------------------------------- producer

    def submit(self, batch: EventBatch, block: bool = True,
               timeout: float | None = 60.0) -> int:
        n = len(batch)
        if n and block:
            t0 = time.perf_counter()
            with self._cv:
                if not self._cv.wait_for(
                        lambda: self._credits >= n or self._dead,
                        timeout=timeout):
                    raise TimeoutError("credit starvation")
                if self._dead:
                    raise ConnectionError("connection lost")
                self._credits -= n
            self.blocked_s += time.perf_counter() - t0
        elif n:
            with self._cv:
                self._credits -= n
        self._send(_SUBMIT, encode_chunk(batch))
        return n

    def advance_to(self, t: int) -> None:
        self._send(_ADVANCE, struct.pack("<q", int(t)))

    def close(self) -> None:
        """End the submit side (server releases the watermark hold)."""
        self._send(_CLOSE, b"")

    # ------------------------------------------------------------- consumer

    def deliveries(self):
        """Blocking record iterator; ends at the server's END frame."""
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._inbox or self._ended
                                  or self._dead)
                if self._inbox:
                    d = self._inbox.popleft()
                else:
                    if self._dead and not self._ended:
                        raise ConnectionError(
                            "connection lost before END")
                    return
            yield d

    def poll(self) -> list:
        with self._cv:
            out = list(self._inbox)
            self._inbox.clear()
        return out

    @property
    def results(self) -> dict | None:
        """Final subscribed results (None until END)."""
        with self._cv:
            return self._results

    @property
    def drained(self) -> bool:
        with self._cv:
            return self._ended

    @property
    def credits(self) -> int:
        with self._cv:
            return self._credits

    def wait_end(self, timeout: float | None = 60.0) -> dict:
        with self._cv:
            if not self._cv.wait_for(lambda: self._ended or self._dead,
                                     timeout=timeout):
                raise TimeoutError("no END frame")
            if not self._ended:
                raise ConnectionError("connection lost before END")
            return self._results

    def shutdown(self) -> None:
        """Best-effort BYE, close the socket, join the reader."""
        try:
            self._send(_BYE, b"")
        except (ConnectionError, OSError):
            pass
        self._close_sock()
        self._reader.join()

    def kill(self) -> None:
        """Hard drop (no BYE) — the disconnect-race test hook."""
        self._close_sock()
        self._reader.join()

    # ------------------------------------------------------------ internals

    def _close_sock(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def _send(self, ftype: int, payload: bytes) -> None:
        try:
            self._sock.sendall(_HDR.pack(len(payload), ftype) + payload)
        except OSError as e:
            with self._cv:
                self._dead = True
                self._cv.notify_all()
            raise ConnectionError(str(e)) from e

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            part = self._sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("EOF")
            buf += part
        return bytes(buf)

    def _read_loop(self) -> None:
        try:
            while True:
                length, ftype = _HDR.unpack(self._recv_exact(_HDR.size))
                payload = self._recv_exact(length) if length else b""
                if ftype == _SESSION:
                    sid, credits, pane = _SESSION_S.unpack(payload)
                    with self._cv:
                        self.sid = sid
                        self._credits += credits
                        self.pane = pane
                        self._cv.notify_all()
                elif ftype == _CREDIT:
                    (delta,) = _CREDIT_S.unpack(payload)
                    with self._cv:
                        self._credits += delta
                        self._cv.notify_all()
                elif ftype == _DELIVER:
                    t_enc, ds = decode_deliveries(payload)
                    with self._cv:
                        self.t_enc_last = t_enc
                        self.wire_samples.append(
                            (t_enc, time.perf_counter(), len(ds)))
                        self._inbox.extend(ds)
                        self._cv.notify_all()
                elif ftype == _END:
                    res = plain_loads(payload)
                    with self._cv:
                        self._results = res
                        self._ended = True
                        self._cv.notify_all()
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            with self._cv:
                self._dead = True
                self._cv.notify_all()
