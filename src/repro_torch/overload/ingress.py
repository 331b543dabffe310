"""Bounded ingress queue with watermark-based backpressure.

The queue sits between producers and the pane loop.  It is bounded in event
count; crossing the high watermark flips ``accepting`` off (the backpressure
signal a producer should honour — offers made while not accepting are counted
as ``rejected`` and dropped, since this process cannot block a remote
producer), and draining below the low watermark flips it back on.  Offers that
would overflow the hard capacity are truncated and counted as ``dropped``.

Events inside one offered batch are time-ordered (``EventBatch`` enforces it),
but producers do **not** necessarily feed batches in global time order —
retried producers and clock-skewed sources interleave.  The queue therefore
guards the order assumption instead of silently relying on it: an offer that
starts before the buffered tail marks the buffer disordered (``poll_until``
then re-sorts before splitting, so its contract — every buffered event with
``time < t``, time-sorted — always holds), and events that *straddle* the
poll frontier (arrive with a timestamp older than the last ``poll_until``
boundary, so their pane has already been handed out) are counted in
``straddled_late`` and still delivered on the next poll; the consumer decides
whether to revise them in (the event-time layer) or charge them to the
shedding accountant (the plain pane loop).

The queue is safe under **concurrent producers**: every state transition
(offer, poll, the backpressure flips) happens under one internal lock, so
any number of session threads may ``offer`` while a single consumer polls.
The consumer side stays single-threaded by contract (the pane loop owns the
poll frontier); concurrent *pollers* would race the frontier semantics, not
the data structure.
"""

from __future__ import annotations

import threading

import numpy as np

from ..core.events import EventBatch, StreamSchema

__all__ = ["IngressQueue"]


class IngressQueue:
    def __init__(self, schema: StreamSchema, capacity: int = 1 << 16,
                 high_watermark: float = 0.75, low_watermark: float = 0.5):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.schema = schema
        self.capacity = int(capacity)
        self.high = int(np.ceil(high_watermark * capacity))
        self.low = int(np.floor(low_watermark * capacity))
        self.accepting = True
        self.rejected = 0        # offered while backpressure was asserted
        self.dropped = 0         # truncated against the hard capacity
        self.straddled_late = 0  # offered with time < the last poll boundary
        self._batches: list[EventBatch] = []
        self._n = 0
        self._tail_time = -(1 << 62)    # max buffered timestamp
        self._polled_until = -(1 << 62)  # last poll_until boundary
        self._disordered = False
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def headroom(self) -> int:
        """Events admissible before the high watermark flips ``accepting``
        off — the budget a credit-granting transport may hand to producers
        without ever tripping queue-side backpressure (0 when already
        at/above the high watermark)."""
        with self._lock:
            return max(0, self.high - self._n)

    def offer(self, batch: EventBatch) -> int:
        """Enqueue as much of ``batch`` as admission allows; returns accepted
        event count and updates the backpressure state.  Safe to call from
        any number of producer threads concurrently."""
        n = len(batch)
        if n == 0:
            return 0
        with self._lock:
            if not self.accepting:
                self.rejected += n
                return 0
            space = self.capacity - self._n
            take = min(n, space)
            if take < n:
                self.dropped += n - take
            if take > 0:
                b = batch if take == n else batch.select(np.arange(take))
                # straddle guard: an offer reaching behind the buffered tail
                # or the poll frontier breaks the global-order assumption —
                # flag it instead of letting searchsorted split a non-sorted
                # buffer
                if int(b.time[0]) < self._tail_time:
                    self._disordered = True
                self.straddled_late += int(np.sum(b.time
                                                  < self._polled_until))
                self._tail_time = max(self._tail_time, int(b.time[-1]))
                self._batches.append(b)
                self._n += take
            if self._n >= self.high:
                self.accepting = False
            return take

    def poll_until(self, t_exclusive: int) -> EventBatch:
        """Dequeue every buffered event with ``time < t_exclusive``."""
        with self._lock:
            self._polled_until = max(self._polled_until, int(t_exclusive))
            if self._n == 0:
                return self._empty()
            if self._disordered:
                merged = EventBatch.merge(self._batches)
                self._disordered = False
            else:
                merged = (self._batches[0] if len(self._batches) == 1
                          else EventBatch.concat(self._batches))
            hi = int(np.searchsorted(merged.time, t_exclusive, side="left"))
            out = merged.select(np.arange(hi))
            rest = merged.select(np.arange(hi, len(merged)))
            self._batches = [rest] if len(rest) else []
            self._n = len(rest)
            if self._n <= self.low:
                self.accepting = True
            return out

    def _empty(self) -> EventBatch:
        return EventBatch(self.schema, np.array([], np.int32),
                          np.array([], np.int64), None)
