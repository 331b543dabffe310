"""Client session handles for the Hamlet serving front-end.

A :class:`SessionHandle` is one client's half of the serving contract:
``submit`` trickles events in (any number of sessions submit concurrently —
the front-end merges them into shared micro-batched flushes), and the
session's **inbox** receives the deliveries for the groups it subscribes
to: ``emit`` records for newly closed windows, and ``retract``/``amend``
pairs when a previously delivered value is revised (event-time backends).

Consumption is pull- or push-style:

* ``poll()`` — non-blocking drain (the deterministic test/pump mode);
* ``for d in session:`` — blocking iterator that ends when the front-end
  drains the stream and closes the channel;
* ``async for d in session.stream():`` — the asyncio twin, for clients
  living on an event loop while the engine runs on threads.

Sessions are *producers with a promise*: events within one session arrive
in time order up to the front-end's configured ``skew``.  The scheduler's
watermark is the minimum promise over open sessions, so one silent session
can hold the whole stream back — ``advance_to`` (an application-level
heartbeat) or ``close`` releases the hold.
"""

from __future__ import annotations

import asyncio
import queue as _queue
from dataclasses import dataclass, field

__all__ = ["Delivery", "SessionHandle"]

_CLOSE = object()        # inbox sentinel: no further deliveries will arrive


@dataclass(frozen=True)
class Delivery:
    """One record on a session's emission/retraction channel.

    kind        "emit" (first value for this window), "retract" (withdraws
                the previous value) or "amend" (the replacement, always
                immediately preceded by its retract)
    query       user-level query name (atomic name on event-time revision
                records, which revise at atomic granularity)
    group       group partition key
    w0          window start (ticks)
    vals        aggregate values; on a retract, the *withdrawn* values
    revision    0 for first emission, incremented per amendment
    latency_ms  wall-clock delay from the window's pane being sealed by the
                scheduler watermark to this delivery entering the inbox
    """

    kind: str
    query: str
    group: int
    w0: int
    vals: dict | None = None
    revision: int = 0
    latency_ms: float = 0.0


@dataclass
class _SessionState:
    """Front-end-private bookkeeping (kept off the public handle)."""

    seq_next: int = 0
    frontier: int | None = None    # promise: future events have time >= this
    shed: int = 0
    submitted: int = 0
    delivered: int = 0
    closed: bool = False
    opened_at: float = field(default=0.0)


class SessionHandle:
    """One client session: submit side + delivery inbox.

    All methods are thread-safe; the inbox is a ``SimpleQueue`` so any
    number of front-end pump threads may deliver while the client drains.
    """

    def __init__(self, frontend, sid: int, tenant: int, groups=None):
        self.id = int(sid)
        self.tenant = int(tenant)
        self.groups = (None if groups is None
                       else frozenset(int(g) for g in groups))
        self._frontend = frontend
        self._inbox: _queue.SimpleQueue = _queue.SimpleQueue()
        self._done = False

    # ------------------------------------------------------------- producer

    def submit(self, events) -> int:
        """Trickle one time-ordered :class:`EventBatch` in; returns the
        number of events accepted (admission may shed)."""
        return self._frontend.submit(self.id, events)

    def advance_to(self, t: int) -> None:
        """Promise that every future submission has ``time >= t`` (an idle
        session's watermark heartbeat)."""
        self._frontend.advance(self.id, t)

    def close(self) -> None:
        """End the submit side: the session stops holding the watermark.
        The inbox keeps receiving deliveries for its groups until the
        front-end drains."""
        self._frontend.close_session(self.id)

    # ------------------------------------------------------------- consumer

    def subscribes(self, group: int) -> bool:
        return self.groups is None or group in self.groups

    def poll(self, max_n: int | None = None) -> list[Delivery]:
        """Non-blocking drain of everything currently in the inbox."""
        out: list[Delivery] = []
        while max_n is None or len(out) < max_n:
            try:
                d = self._inbox.get_nowait()
            except _queue.Empty:
                break
            if d is _CLOSE:
                self._done = True
                break
            out.append(d)
        return out

    def __iter__(self):
        """Blocking delivery iterator; ends when the front-end drains."""
        while True:
            d = self._inbox.get()
            if d is _CLOSE:
                self._done = True
                return
            yield d

    async def stream(self):
        """Async delivery iterator (``async for d in session.stream()``).

        The inbox get blocks on a worker thread so the event loop stays
        free; back-to-back deliveries short-circuit through the
        non-blocking fast path.
        """
        loop = asyncio.get_running_loop()
        while True:
            try:
                d = self._inbox.get_nowait()
            except _queue.Empty:
                d = await loop.run_in_executor(None, self._inbox.get)
            if d is _CLOSE:
                self._done = True
                return
            yield d

    # ------------------------------------------------------------ internals

    @property
    def drained(self) -> bool:
        """True once the close sentinel has been consumed."""
        return self._done

    def _deliver(self, d: Delivery) -> None:
        self._inbox.put(d)

    def _finish(self) -> None:
        self._inbox.put(_CLOSE)
