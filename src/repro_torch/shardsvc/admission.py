"""Global admission control: shed at the router, before events enqueue.

Per-operator shedding (each shard's PID loop acting on its own ingress)
cannot see fleet imbalance: a flash crowd saturates one shard while the
others idle, and the saturated shard's shedder throws work away *after* it
was queued, routed and buffered.  This module moves the actuation upstream
— the router sheds arrival chunks before they are enqueued anywhere — in
one of three modes:

``none``
    Admit everything.  Shards keep whatever local policy their config says.

``global_fixed``
    Shed a fixed ratio pane-by-pane on the **full chunk before routing**.
    Because the shed decision is a pure function of the (pane-sliced)
    arrival stream, the admitted event set is identical for every shard
    count — this is the mode under which the N-shard/1-shard differential
    contract covers shedding.  Shards run with local shedding disabled.

``per_shard``
    Read each shard's PID controller state (`LatencyController.state()`)
    and shed each shard's routed sub-chunk at that shard's current ratio —
    the controllers keep *observing* local pane latency, but *actuation*
    happens here, before the queue.  Deliberately not shard-count
    invariant: the ratios follow per-shard latency, which follows
    placement.  (The same observation-cadence trade as the micro-batched
    PID loop, documented in ``overload/runtime.py``.)

All router-shed events are charged to a router-level
:class:`ErrorAccountant`; ``global_accountant``/``global_report`` union it
with the per-shard accountants into one fleet certificate (subset
guarantee + ``3^s`` bound) via :meth:`ErrorAccountant.merged`.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.events import EventBatch, pane_size_for
from ..core.query import Workload
from ..overload.accountant import ErrorAccountant, merge_error_reports
from ..overload.config import OverloadConfig
from ..overload.shedding import make_shedder

__all__ = ["GlobalAdmissionController", "ADMISSION_MODES"]

ADMISSION_MODES = ("none", "global_fixed", "per_shard")


class GlobalAdmissionController:
    def __init__(self, workload: Workload, cfg: OverloadConfig,
                 mode: str = "global_fixed", pane: int | None = None):
        if mode not in ADMISSION_MODES:
            raise ValueError(f"unknown admission mode {mode!r}; "
                             f"have {ADMISSION_MODES}")
        self.mode = mode
        self.cfg = cfg
        self.pane = int(pane) if pane else pane_size_for(workload.windows)
        self.fixed = cfg.fixed_shed if cfg.fixed_shed is not None else 0.0
        self.shedder = make_shedder(
            cfg.shed_policy if cfg.shed_policy != "none" else "drop_tail",
            workload, seed=cfg.seed, min_burst_keep=cfg.min_burst_keep,
            benefit_model=cfg.benefit_model)
        self.accountant = ErrorAccountant(workload, pane=self.pane)
        self.offered = 0
        self.admitted = 0

    # ---------------------------------------------------------- admission

    def admit_global(self, chunk: EventBatch) -> EventBatch:
        """``global_fixed`` / ``none`` actuation: shed the full chunk
        (pane-sliced) before routing.  Shard-count invariant."""
        self.offered += len(chunk)
        if self.mode != "global_fixed" or self.fixed <= 0.0 \
                or not len(chunk):
            self.admitted += len(chunk)
            return chunk
        out = self._shed_paned(chunk, self.fixed)
        self.admitted += len(out)
        return out

    def admit_for_shard(self, sub: EventBatch, state: dict) -> EventBatch:
        """``per_shard`` actuation: shed one shard's routed sub-chunk at
        that shard's controller ratio (its PID keeps observing; the router
        actuates)."""
        self.offered += len(sub)
        ratio = float(state["shed_ratio"])
        if ratio <= 0.0 or not len(sub):
            self.admitted += len(sub)
            return sub
        out = self._shed_paned(sub, ratio)
        self.admitted += len(out)
        return out

    def _shed_paned(self, chunk: EventBatch, ratio: float) -> EventBatch:
        """Shed ``ratio`` per pane slice (the same granularity the in-shard
        loop uses, so ``global_fixed`` matches a single runtime's fixed-shed
        admitted set bit for bit)."""
        kept: list[EventBatch] = []
        t0 = (int(chunk.time[0]) // self.pane) * self.pane
        t_end = int(chunk.time.max()) + 1
        for t in range(t0, t_end, self.pane):
            ev = chunk.time_slice(t, t + self.pane)
            n = len(ev)
            if not n:
                continue
            keep_n = int(math.floor(n * (1.0 - ratio) + 1e-9))
            keep_n = min(max(keep_n, 0), n)
            if keep_n < n:
                plan = self.shedder.plan(ev, keep_n)
                kept.append(ev.select(plan.keep))
                self.accountant.record(ev.select(plan.shed),
                                       witnessed=plan.witnessed)
            else:
                kept.append(ev)
        if not kept:
            return chunk.select(np.arange(0))
        return EventBatch.concat(kept)

    # -------------------------------------------------------- certificates

    def global_accountant(self, shard_accountants) -> ErrorAccountant:
        """Cell-exact fleet accountant: router + every shard."""
        return ErrorAccountant.merged([self.accountant,
                                       *shard_accountants])

    def global_report(self, shard_reports) -> dict:
        """Fleet certificate from report dicts (counts sum, subset
        guarantee ANDs)."""
        return merge_error_reports([self.accountant.report(),
                                    *shard_reports])

    def summary(self) -> dict:
        return {"mode": self.mode, "offered": self.offered,
                "admitted": self.admitted,
                "shed": self.offered - self.admitted,
                "router_shed_total": self.accountant.total_shed}
