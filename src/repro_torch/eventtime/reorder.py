"""Reorder buffer: disordered arrivals in, watermark-sealed panes out.

The buffer accepts event chunks in *arrival* order (timestamps arbitrary),
holds them until the watermark policy promises no earlier event can still
arrive, and releases **contiguous, time-sorted panes** — including empty
panes for gaps, so the consumer's window clock always advances pane by pane.

Arrivals behind the already-sealed frontier cannot be buffered (their pane
has been released); they come back in :attr:`ReorderResult.late` and the
caller decides — the speculative runtime revises them into their pane, the
buffer-everything baseline and the overload path charge them to the shedding
accountant.  When a ``lateness_horizon`` is set, events more than that many
ticks behind the watermark are split off into :attr:`ReorderResult.expired`
directly (the principled shed class for hopeless stragglers).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.events import EventBatch, StreamSchema
from .watermark import WatermarkPolicy

__all__ = ["ReorderBuffer", "ReorderResult", "SealedPane"]


@dataclass(frozen=True)
class SealedPane:
    t0: int
    events: EventBatch       # time-sorted, all inside [t0, t0 + pane)


@dataclass
class ReorderResult:
    sealed: list[SealedPane] = field(default_factory=list)
    late: EventBatch | None = None      # behind the sealed frontier, in horizon
    expired: EventBatch | None = None   # behind watermark - lateness_horizon

    @property
    def n_late(self) -> int:
        return 0 if self.late is None else len(self.late)

    @property
    def n_expired(self) -> int:
        return 0 if self.expired is None else len(self.expired)


class ReorderBuffer:
    def __init__(self, schema: StreamSchema, pane: int,
                 policy: WatermarkPolicy, lateness_horizon: int | None = None):
        if pane <= 0:
            raise ValueError("pane must be positive")
        self.schema = schema
        self.pane = int(pane)
        self.policy = policy
        self.lateness_horizon = lateness_horizon
        self._pending: list[EventBatch] = []
        self._n_pending = 0
        self._sealed_end = 0          # panes [0, _sealed_end) are released
        self.late_total = 0
        self.expired_total = 0

    def __len__(self) -> int:
        return self._n_pending

    @property
    def watermark(self) -> int:
        return self.policy.watermark()

    @property
    def sealed_end(self) -> int:
        return self._sealed_end

    def heartbeat(self, group: int, t: int) -> "ReorderResult":
        """Per-group liveness signal; may advance the watermark and seal."""
        self.policy.heartbeat(group, t)
        return self._seal(ReorderResult())

    def push(self, chunk: EventBatch) -> ReorderResult:
        """Feed an arrival chunk (internally time-sorted; build disordered
        wire chunks with :meth:`EventBatch.from_unsorted`)."""
        res = ReorderResult()
        if len(chunk):
            # lateness is judged against the watermark as it stood *before*
            # this chunk was observed — a chunk must never expire its own
            # (perfectly orderly) events just because it advanced the clock
            wm_before = self.policy.watermark()
            self.policy.observe(chunk.time, chunk.group)
            late_mask = chunk.time < self._sealed_end
            if self.lateness_horizon is not None:
                # only already-late events can expire; a fresh event's pane
                # is still open, so dropping it would be plain data loss
                exp_mask = late_mask & (
                    chunk.time < wm_before - self.lateness_horizon)
                if exp_mask.any():
                    res.expired = chunk.select(np.nonzero(exp_mask)[0])
                    self.expired_total += len(res.expired)
                late_mask &= ~exp_mask
            if late_mask.any():
                res.late = chunk.select(np.nonzero(late_mask)[0])
                self.late_total += len(res.late)
            fresh_mask = chunk.time >= self._sealed_end
            if fresh_mask.any():
                fresh = chunk.select(np.nonzero(fresh_mask)[0])
                self._pending.append(fresh)
                self._n_pending += len(fresh)
        return self._seal(res)

    def flush(self) -> ReorderResult:
        """Seal everything pending (stream end)."""
        res = ReorderResult()
        if self._n_pending:
            end = int(max(int(b.time.max()) for b in self._pending)) + 1
            end = -(-end // self.pane) * self.pane
            self._release(res, end)
        return res

    # -- internals --

    def _seal(self, res: ReorderResult) -> ReorderResult:
        wm = self.policy.watermark()
        # pane [t0, t0+pane) is final once no event with time <= t0+pane-1
        # can still arrive, i.e. wm >= t0 + pane - 1
        end = ((wm + 1) // self.pane) * self.pane
        if end > self._sealed_end:
            self._release(res, end)
        return res

    def _release(self, res: ReorderResult, end: int) -> None:
        merged = (EventBatch.merge(self._pending) if self._pending
                  else self._empty())
        cut = int(np.searchsorted(merged.time, end, side="left"))
        out = merged.select(np.arange(cut))
        rest = merged.select(np.arange(cut, len(merged)))
        self._pending = [rest] if len(rest) else []
        self._n_pending = len(rest)
        for t0 in range(self._sealed_end, end, self.pane):
            res.sealed.append(SealedPane(t0, out.time_slice(t0, t0 + self.pane)))
        self._sealed_end = end

    def _empty(self) -> EventBatch:
        return EventBatch(self.schema, np.array([], np.int32),
                          np.array([], np.int64), None)
