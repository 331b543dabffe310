"""Continuous-batching scheduler: session trickles -> watermark-sealed panes.

The epoch-synchronous service hands the runtime pre-chunked epochs; real
serving is N concurrent sessions trickling small batches at their own pace.
The :class:`ContinuousBatcher` turns those trickles into the engine's unit
of work — complete panes — *continuously*: a flush forms from whatever is
sealed right now, not from a fixed epoch grid.

Mechanics:

* every submission is staged (already seq-stamped by the front-end, so the
  eventual merge order is a pure function of the submissions, never of
  their interleaving);
* each open session carries a **frontier** — the promise that its future
  events have ``time >= frontier`` (advanced by its own submissions, by
  ``advance_to`` heartbeats, or released by ``close``);
* the **serving watermark** is ``min(session frontiers) - skew``; every
  pane ending at or below it is complete *regardless of which session the
  events came from*;
* ``seal()`` merges the staged events below the pane-aligned watermark into
  one time-ordered chunk and hands it (plus the boundary) to the caller —
  the backend then steps exactly the panes that are ready, and the
  runtime's ``micro_batch`` fuses them across sessions into shared
  launches: concurrent trickle streams fill the same K-pane micro-batches
  a batch workload would.

Determinism: seq stamps are session-scoped (``sid << 32 | counter``), so
``EventBatch.merge`` produces one canonical order for any interleaving of
session submissions — the foundation of the serving determinism contract.
"""

from __future__ import annotations

import numpy as np

from ..core.events import EventBatch, StreamSchema

__all__ = ["ContinuousBatcher", "SessionAdmission"]

_SEQ_SPAN = 1 << 32      # per-session seq namespace width


class ContinuousBatcher:
    """Stage per-session submissions; seal pane-complete prefixes.

    Not thread-safe by itself — the owning front-end serializes access
    (it holds its staging lock around ``stage``/``seal``).
    """

    def __init__(self, schema: StreamSchema, pane: int, skew: int = 0):
        if pane <= 0:
            raise ValueError("pane must be positive")
        if skew < 0:
            raise ValueError("skew must be non-negative")
        self.schema = schema
        self.pane = int(pane)
        self.skew = int(skew)
        self._staged: list[EventBatch] = []
        self._n_staged = 0
        self._frontiers: dict[int, int] = {}     # open sessions only
        self._max_staged = -1
        self.sealed_to = 0
        self.sealed_events = 0

    def __len__(self) -> int:
        return self._n_staged

    # ------------------------------------------------------------- staging

    def stage(self, sid: int, batch: EventBatch) -> None:
        """Stage one session's submission (time-ordered, seq-stamped)."""
        if len(batch):
            self._staged.append(batch)
            self._n_staged += len(batch)
            t_max = int(batch.time[-1])
            self._max_staged = max(self._max_staged, t_max)
            cur = self._frontiers.get(sid)
            self._frontiers[sid] = max(cur if cur is not None else 0,
                                       t_max + 1)
        elif sid not in self._frontiers:
            self._frontiers[sid] = 0

    def advance(self, sid: int, t: int) -> None:
        """Session promise: no future event of ``sid`` has ``time < t``."""
        cur = self._frontiers.get(sid)
        if cur is not None:
            self._frontiers[sid] = max(cur, int(t))

    def track(self, sid: int) -> None:
        """Register an open session (holds the watermark at 0 until its
        first submission or heartbeat)."""
        self._frontiers.setdefault(sid, 0)

    def release(self, sid: int) -> None:
        """Session closed: it no longer holds the watermark back."""
        self._frontiers.pop(sid, None)

    # ------------------------------------------------------------- sealing

    def watermark(self) -> int:
        """Event time below which every open session's promise holds."""
        if self._frontiers:
            return min(self._frontiers.values()) - self.skew
        # No open sessions: HOLD, don't finalize.  close() only ends the
        # submit side — a session opening a moment later (a wire client
        # connecting after an earlier client already closed) must not find
        # its whole stream pre-sealed into straggler territory.  The
        # explicit drain() is the only "no more sessions ever" signal, and
        # it seals by its own computed boundary, not through here.
        return self.sealed_to

    def seal(self, upto: int | None = None) -> tuple[EventBatch | None, int]:
        """Merge and hand out every staged event below the pane-aligned
        watermark (or the explicit ``upto``); returns ``(chunk, boundary)``
        with ``chunk=None`` when nothing new is ready.

        A staged event *below* the already-sealed boundary (a straggler in
        a seq-preserving replayed trace) is handed out on the next seal
        even when the boundary itself does not advance — the event-time
        backend revises it into the emitted windows; in-order backends
        treat it as late by their own accounting."""
        wm = self.watermark() if upto is None else int(upto)
        boundary = max((wm // self.pane) * self.pane, self.sealed_to)
        advanced = boundary > self.sealed_to
        if not self._staged:
            if not advanced:
                return None, self.sealed_to
            self.sealed_to = boundary
            return self._empty(), boundary
        merged = (self._staged[0] if len(self._staged) == 1
                  else EventBatch.merge(self._staged))
        hi = int(np.searchsorted(merged.time, boundary, side="left"))
        if hi == 0 and not advanced:
            return None, self.sealed_to
        out = merged.select(np.arange(hi))
        rest = merged.select(np.arange(hi, len(merged)))
        self._staged = [rest] if len(rest) else []
        self._n_staged = len(rest)
        self.sealed_to = boundary
        self.sealed_events += len(out)
        return out, boundary

    def _empty(self) -> EventBatch:
        return EventBatch(self.schema, np.array([], np.int32),
                          np.array([], np.int64), None)


class SessionAdmission:
    """Per-session admission hook into the backend's PID controller.

    The overload runtime's :class:`~repro_torch.overload.controller.
    LatencyController` observes amortized pane-processing latency and
    publishes a shed ratio; this hook actuates that ratio *per session at
    submit time* (drop-tail within the submission), so a hot session is
    shed at the door instead of inflating every shared flush.  Shed events
    are charged to the backend's error accountant (unwitnessed), keeping
    the ``true <= 3^s * emitted`` certificates sound.

    With admission off (the default) the serving path sheds nothing and
    the determinism contract vs the merged-stream oracle is exact.
    """

    def __init__(self, controller, accountant=None):
        self.controller = controller
        self.accountant = accountant
        self.shed_total = 0

    def admit(self, batch: EventBatch) -> tuple[EventBatch, int]:
        """Returns ``(kept prefix, shed count)`` for one submission."""
        n = len(batch)
        if n == 0 or self.controller is None:
            return batch, 0
        ratio = float(self.controller.shed_ratio)
        keep = min(n, max(0, int(n * (1.0 - ratio) + 1e-9)))
        if keep == n:
            return batch, 0
        kept = batch.select(np.arange(keep))
        shed = batch.select(np.arange(keep, n))
        if self.accountant is not None:
            self.accountant.record(shed, witnessed=False)
        self.shed_total += n - keep
        return kept, n - keep
