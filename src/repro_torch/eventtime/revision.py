"""Speculative execution + snapshot-based pane revision.

:class:`EventTimeRuntime` is the pane-granular out-of-order runtime.  It
drives the HAMLET plan-then-execute machinery (:class:`PaneProcessor`)
*optimistically*: a pane is executed as soon as any of its events arrive, and
its per-query transfer matrix ``M`` (the pane's fold state — a linear map
over the window state channels, see ``core/engine.py``) is stored.  A window
is **emitted speculatively** once the stream frontier passes its close time —
long before the watermark certifies the window complete.

A late event that lands in an already-executed pane triggers *revision*:

* the dirty pane is **re-planned** through the same plan-then-execute
  pipeline over its merged event set — one pane's graphlets, one bucketed
  batched launch, not a from-scratch rerun of the stream;
* every already-emitted window covering that pane is **re-folded** from the
  stored transfer matrices: the clean panes' ``M`` are reused as-is, only
  the dirty pane contributes new work — and all dirty windows of a
  revision storm fold together as one stacked launch set through the
  runtime's :class:`~repro_torch.core.fold_exec.FoldExecutor`
  (:meth:`~repro_torch.core.fold_exec.FoldExecutor.fold_windows`, the batched
  twin of :func:`~repro_torch.core.engine.fold_panes`);
* windows whose value changed produce a ``retract`` record (the superseded
  value) followed by an ``amend`` record (the new value) on the output
  channel — changelog semantics a downstream sink can apply idempotently.

An event is *expired* only when its pane state has been retired — once no
still-revisable window covers the pane (``watermark - lateness_horizon -
max(within)`` behind); anything landing in a live pane is absorbed exactly,
however late.  ``max_retained_panes`` additionally bounds revision *memory*:
beyond the per-group cap the oldest panes are evicted — their transfer
matrices survive (emission and re-folds of other panes stay exact) but the
raw events are expired into the accountant and later stragglers into them
expire too.  Expired events are counted, never folded in, and — when an
:class:`ErrorAccountant` is attached — charged as (unwitnessed) shed events,
so the overload subsystem's ``true <= 3^s * emitted`` accounting stays sound
under disorder.

With ``speculative=False`` the runtime degrades to the buffer-everything
baseline: arrivals sit in a :class:`ReorderBuffer` and a window is emitted
exactly once, after the watermark seals its last pane; the emission lag
(``EventTimeMetrics.emit_lag``) measures the gap between the two modes.

The runtime's ``backend``/``device`` are those of
:class:`~repro_torch.core.engine.HamletRuntime`: the default runs the panes
on the hand-written CUDA kernels on ``cuda:0`` and raises without a GPU.
Revision storms re-fold their windows through ``ops.fold_stacked`` on that
device, with one host fetch per storm.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter

import numpy as np

from ..core.engine import (HamletRuntime, PaneMicroBatcher, PaneProcessor,
                           _Instance, fold_panes, vals_equal)
from ..core.events import EventBatch
from ..core.query import Workload
from ..obs.metrics import DEPTH_BUCKETS, LAG_BUCKETS
from .config import EventTimeConfig
from .reorder import ReorderBuffer
from .watermark import WM_MIN, make_watermark

__all__ = ["EventTimeRuntime", "EventTimeMetrics", "EmissionRecord"]


@dataclass(frozen=True)
class EmissionRecord:
    """One entry on the output channel.

    kind        "emit" (first value for this window), "retract" (withdraws
                the previous value), or "amend" (the replacement value —
                always immediately preceded by its retract)
    query       atomic query name (user-level Or/And combination is applied
                by :meth:`EventTimeRuntime.results`)
    group       group partition key
    w0          window start (ticks)
    vals        aggregate values ({repr(agg): value})
    revision    0 for the first emission, incremented per amendment
    speculative True when emitted past the frontier but before the watermark
                sealed the window (the value may still be amended)
    """

    kind: str
    query: str
    group: int
    w0: int
    vals: dict | None
    revision: int
    speculative: bool = False


@dataclass
class EventTimeMetrics:
    ingested: int = 0
    expired: int = 0
    evicted_panes: int = 0       # bounded revision memory (max_retained_panes)
    panes_executed: int = 0
    panes_revised: int = 0
    windows_emitted: int = 0
    speculative_emits: int = 0
    amendments: int = 0
    retractions: int = 0
    noop_revisions: int = 0      # re-folds whose value did not change
    emit_lag: list = field(default_factory=list)  # stream progress past close

    def lag_percentile(self, q: float) -> float:
        if not self.emit_lag:
            return 0.0
        return float(np.percentile(self.emit_lag, q))

    def summary(self) -> dict:
        return {
            "ingested": self.ingested,
            "expired": self.expired,
            "evicted_panes": self.evicted_panes,
            "panes_executed": self.panes_executed,
            "panes_revised": self.panes_revised,
            "windows_emitted": self.windows_emitted,
            "speculative_emits": self.speculative_emits,
            "amendments": self.amendments,
            "retractions": self.retractions,
            "noop_revisions": self.noop_revisions,
            "revision_rate": (self.amendments / self.windows_emitted
                              if self.windows_emitted else 0.0),
            "p50_emit_lag": self.lag_percentile(50),
            "p99_emit_lag": self.lag_percentile(99),
        }


@dataclass
class _PaneState:
    events: EventBatch
    M: list[np.ndarray] | None = None    # per component: [k, C, C]
    evicted: bool = False                # events dropped (bounded memory)


class EventTimeRuntime:
    def __init__(self, workload: Workload, config: EventTimeConfig,
                 policy=None, backend: str = "cuda", batch_exec: bool = True,
                 accountant=None, micro_batch: int = 1,
                 fold_exec: bool = True, obs=None, device=None):
        self.workload = workload
        self.config = config
        self.obs = obs
        self.micro_batch = max(1, int(micro_batch))
        self.rt = HamletRuntime(workload, policy=policy, backend=backend,
                                batch_exec=batch_exec, fold_exec=fold_exec,
                                obs=obs, device=device)
        self.pane = self.rt.pane
        self.stats = self.rt.stats
        self.metrics = EventTimeMetrics()
        self.accountant = accountant
        self.wm = make_watermark(config)
        self.max_within = max((q.within for q in workload.atomic), default=1)
        self._buffer = (None if config.speculative else ReorderBuffer(
            workload.schema, self.pane, self.wm,
            lateness_horizon=config.lateness_horizon))
        # per group: pane states, one PaneProcessor per component
        self._panes: dict[int, dict[int, _PaneState]] = {}
        self._procs: dict[int, list[PaneProcessor]] = {}
        self._frontier = WM_MIN
        self._atomic: dict[tuple[int, int, int], dict] = {}
        self._revno: dict[tuple[int, int, int], int] = {}
        self._next_w0: dict[tuple[int, int], int] = {}
        # bounded revision memory: (group, t0) eviction log, oldest first
        # (itself bounded — metrics.evicted_panes carries the full count)
        self.evictions: list[tuple[int, int]] = []
        self._evictions_keep = 4096

    # -- producer side -----------------------------------------------------

    def ingest(self, chunk: EventBatch) -> list[EmissionRecord]:
        """Feed an arrival chunk (build disordered chunks with
        :meth:`EventBatch.from_unsorted`); returns new emission records."""
        self.metrics.ingested += len(chunk)
        if len(chunk):
            # arrival frontier: max event time seen, regardless of mode —
            # emission lag is measured against it in both modes
            self._frontier = max(self._frontier, int(chunk.time.max()))
        if self._buffer is not None:
            return self._ingest_sealed(self._buffer.push(chunk))
        records: list[EmissionRecord] = []
        if len(chunk):
            # expiry is judged against the watermark *before* this chunk
            # advanced it — a chunk never expires its own orderly events
            wm_before = self.wm.watermark()
            self.wm.observe(chunk.time, chunk.group)
            if self.obs is not None:
                wm = self.wm.watermark()
                if wm > WM_MIN:
                    self.obs.observe("eventtime.watermark_lag",
                                     max(0, self._frontier - wm),
                                     LAG_BUCKETS)
            chunk = self._route_expired(chunk, wm_before)
        if len(chunk):
            dirty = self._absorb(chunk)
            records += self._revise(dirty)
        # speculative boundary: a window is emitted once an event *past* its
        # close has been seen — an in-order stream therefore never amends
        records += self._emit_ready(self._frontier)
        self._retire()
        return records

    def heartbeat(self, group: int, t: int) -> list[EmissionRecord]:
        """Group liveness signal (only the group_heartbeat policy reacts)."""
        if self._buffer is not None:
            return self._ingest_sealed(self._buffer.heartbeat(group, t))
        self.wm.heartbeat(group, t)
        return self._emit_ready(self._frontier)

    def flush(self, t_end: int | None = None) -> list[EmissionRecord]:
        """Stream end: emit every window closing inside [0, t_end), default
        the frontier rounded up to a pane — matching ``HamletRuntime.run``'s
        window set for the same ``t_end``.  An explicit ``t_end`` is honoured
        both ways: beyond the frontier it extends emission over the empty
        tail, below it it truncates flush-time emission (windows already
        emitted speculatively during streaming are never withdrawn)."""
        if self._buffer is not None:
            res = self._buffer.flush()
            records = self._ingest_sealed(res, emit=False)
            end = self._buffer.sealed_end
        else:
            records = []
            end = max(self._frontier + 1, 0)
        if t_end is not None:
            end = t_end
        end = -(-end // self.pane) * self.pane
        records += self._emit_ready(end, final=True)
        return records

    # -- consumer side -----------------------------------------------------

    def results(self) -> dict:
        """Current (post-revision) values of every emitted window, combined
        to user queries — comparable against ``HamletRuntime.run``."""
        from ..core.engine import combine_results

        return combine_results(self.workload, self._atomic)

    @property
    def watermark(self) -> int:
        return self.wm.watermark()

    # -- internals ---------------------------------------------------------

    def _route_expired(self, chunk: EventBatch, wm_before: int
                       ) -> EventBatch:
        """Split off events whose pane state has been retired.

        Expiry mirrors :meth:`_retire` exactly: an event is hopeless iff its
        pane was dropped (t0 + max_within behind watermark - horizon), since
        folding into a partial, rebuilt pane would corrupt final windows.
        Any event whose pane is still live is absorbed — even when it is
        more than ``lateness_horizon`` behind the watermark — because
        absorption into retained state is always exact; the horizon bounds
        *state retention*, it is not a license to drop revisable data."""
        if self.config.lateness_horizon is None:
            return chunk
        bound = wm_before - self.config.lateness_horizon
        pane_t0 = (chunk.time // self.pane) * self.pane
        mask = pane_t0 + self.max_within <= bound   # = _retire's condition
        if not mask.any():
            return chunk
        expired = chunk.select(np.nonzero(mask)[0])
        self.metrics.expired += len(expired)
        if self.accountant is not None:
            self.accountant.record(expired, witnessed=False, late=True)
        return chunk.select(np.nonzero(~mask)[0])

    def _group_procs(self, g: int) -> list[PaneProcessor]:
        if g not in self._procs:
            rt = self.rt
            # every group partition shares the runtime's executors
            self._procs[g] = [rt.make_processor(ci)
                              for ci in range(len(rt.ctxs))]
            self._panes[g] = {}
        return self._procs[g]

    def _prefetch(self, jobs: list) -> None:
        """Cross-pane fused execution: plan the given ``(group, pane-state)``
        pairs in first-touch order — identical to the order the lazy
        :meth:`_ensure_executed` walk would execute them, so sharing
        decisions and results stay bitwise reproducible — and flush the
        propagation backlog once per ``micro_batch`` panes."""
        if self.micro_batch <= 1 or not jobs:
            return
        mb = PaneMicroBatcher(self.rt.executor, k=self.micro_batch,
                              fold_exec=self.rt.fold_exec, obs=self.rt.obs)
        batch: list = []
        seen: set[int] = set()

        def drain():
            for ps, pends in batch:
                ps.M = [p.finalize() for p in pends]
                self.metrics.panes_executed += 1
            batch.clear()

        for g, ps in jobs:
            if ps.M is not None or id(ps) in seen:
                continue
            seen.add(id(ps))
            batch.append((ps, [mb.submit(proc, ps.events, self.stats)
                               for proc in self._procs[g]]))
            if len(batch) >= self.micro_batch:
                mb.drain()
                drain()
        mb.drain()
        drain()

    def _absorb(self, chunk: EventBatch) -> list[tuple[int, int]]:
        """Merge a chunk into per-(group, pane) state and mark the panes
        dirty.  Returns every touched (group, t0) — a *new* pane can also
        dirty already-emitted windows when the frontier raced ahead of it.

        Execution is lazy (:meth:`_ensure_executed`): a pane whose events
        arrive over several wire chunks is planned once, at the first
        emission or revision that folds it, not once per chunk."""
        dirty: list[tuple[int, int]] = []
        # canonicalize tie order up front: wire chunks are stable-sorted by
        # arrival, but pane content must follow the producer's (time, seq)
        # total order even when one chunk covers a whole pane and no merge
        # with prior state would have re-sorted it
        chunk = EventBatch.merge([chunk])
        for g, gb in chunk.partition_by_group().items():
            self._group_procs(g)
            panes = self._panes[g]
            pids = gb.time // self.pane
            for p in np.unique(pids):
                t0 = int(p) * self.pane
                sub = gb.select(np.nonzero(pids == p)[0])
                ps = panes.get(t0)
                if ps is None:
                    panes[t0] = _PaneState(events=sub)
                elif ps.evicted:
                    # bounded revision memory: the pane's raw events are
                    # gone, so a merge would rebuild a partial pane and
                    # corrupt final windows — expire the straggler instead
                    self.metrics.expired += len(sub)
                    if self.accountant is not None:
                        self.accountant.record(sub, witnessed=False,
                                               late=True)
                    continue
                else:
                    ps.events = EventBatch.merge([ps.events, sub])
                    ps.M = None
                dirty.append((g, t0))
        return dirty

    def _ensure_executed(self, g: int, ps: _PaneState) -> list[np.ndarray]:
        if ps.M is None:
            ps.M = [proc.process(ps.events, self.stats)
                    for proc in self._procs[g]]
            self.metrics.panes_executed += 1
        return ps.M

    def _ingest_sealed(self, res, emit: bool = True) -> list[EmissionRecord]:
        """Baseline path: sealed panes from the reorder buffer are executed
        in order; late/expired arrivals cannot be revised here and are all
        charged as expired."""
        for batch in (res.late, res.expired):
            if batch is not None and len(batch):
                self.metrics.expired += len(batch)
                if self.accountant is not None:
                    self.accountant.record(batch, witnessed=False, late=True)
        sealed_jobs: list = []
        for sp in res.sealed:
            if not len(sp.events):
                continue
            g_parts = sp.events.partition_by_group()
            for g, gb in g_parts.items():
                self._group_procs(g)
                ps = self._panes[g][sp.t0] = _PaneState(events=gb)
                sealed_jobs.append((g, ps))
                if self.obs is not None:
                    self.obs.lifecycle("seal", (int(g), sp.t0),
                                       args={"events": len(gb)})
            self._frontier = max(self._frontier, int(sp.events.time.max()))
        # fused execution across the sealed panes (lazy fallback when K=1)
        self._prefetch(sealed_jobs)
        for g, ps in sealed_jobs:
            self._ensure_executed(g, ps)
        if not emit:
            return []
        return self._emit_ready(self._buffer.sealed_end)

    # -- window folding ----------------------------------------------------

    def _window_chain(self, g: int, ic: int, ci: int, ctx, q,
                      w0: int) -> tuple[list, list]:
        """Gather one window's pane transfer-matrix chain (executing any
        still-pending pane lazily, in ascending ``t0`` order) plus the
        retained events MIN/MAX aggregates need."""
        panes = self._panes.get(g, {})
        empty_M = self.rt.empty_pane_matrices()[ic]
        needs_minmax = ci in ctx.minmax_queries
        Ms = []
        evs: list[EventBatch] = []
        for t0 in range(w0, w0 + q.within, self.pane):
            ps = panes.get(t0)
            if ps is None:
                Ms.append(empty_M[ci])
            else:
                Ms.append(self._ensure_executed(g, ps)[ic][ci])
                if needs_minmax and len(ps.events):
                    evs.append(ps.events)
        return Ms, evs

    def _fold_windows(self, wins: list) -> list[dict]:
        """Fold + emit a batch of windows (``wins`` rows as produced by
        ``_emit_ready``/``_revise``).  The chain gather walks the windows in
        order (pane execution order — and with it every sharing decision —
        stays the sequential one); the folds then run as **one stacked
        launch set** through the runtime's :class:`~repro_torch.core.fold_exec
        .FoldExecutor` (per-window :func:`fold_panes` when it is detached) —
        a revision storm re-folds every dirty window together."""
        rt = self.rt
        chains = [self._window_chain(g, ic, ci, ctx, q, w0)
                  for g, ic, ci, ctx, q, _aqi, w0 in wins]
        t_f = perf_counter()
        if rt.fold_exec is not None:
            us = rt.fold_exec.fold_windows(
                [(wins[i][3].layout.fresh_state(), Ms)
                 for i, (Ms, _evs) in enumerate(chains)])
        else:
            us = [fold_panes(Ms, wins[i][3].layout.fresh_state())
                  for i, (Ms, _evs) in enumerate(chains)]
        dt = perf_counter() - t_f
        self.stats.fold_s += dt
        if self.obs is not None and wins:
            # the stacked fold spans many windows/groups: an engine-track
            # span, not a per-pane one
            self.obs.pane_phase("fold", t_f, dt, key=None)
        return [rt._emit(ctx, ci, q, _Instance(w0, u, events=evs), g)
                for (g, _ic, ci, ctx, q, _aqi, w0), u, (_Ms, evs)
                in zip(wins, us, chains)]

    def _unexecuted_panes(self, g: int, w0: int, q) -> list:
        """The window's pane states still awaiting execution, in the fold's
        own (ascending ``t0``) order — the one definition both the fused
        prefetch and the lazy :meth:`_window_chain` walk derive from, so
        their execution orders cannot drift apart."""
        panes = self._panes.get(g, {})
        out = []
        for t0 in range(w0, w0 + q.within, self.pane):
            ps = panes.get(t0)
            if ps is not None and ps.M is None:
                out.append((g, ps))
        return out

    def _emit_ready(self, end: int, final: bool = False
                    ) -> list[EmissionRecord]:
        """Emit every window with ``w0 + within <= end`` not yet emitted.

        One traversal builds the ordered window list; the fused prefetch
        (``micro_batch > 1``) and the emission fold both consume it, so
        pane execution order — which the optimizer's running event count,
        and hence bitwise reproducibility, depends on — has a single
        source of truth."""
        records: list[EmissionRecord] = []
        rt = self.rt
        wins: list[tuple] = []
        for g in sorted(self._panes):
            for ic, (comp, ctx) in enumerate(zip(rt.components, rt.ctxs)):
                for ci, aqi in enumerate(comp):
                    q = rt.workload.atomic[aqi]
                    w0 = self._next_w0.get((aqi, g), 0)
                    while w0 + q.within <= end:
                        wins.append((g, ic, ci, ctx, q, aqi, w0))
                        w0 += q.slide
                    self._next_w0[(aqi, g)] = w0
        if self.micro_batch > 1:
            self._prefetch([job for g, _ic, _ci, _ctx, q, _aqi, w0 in wins
                            for job in self._unexecuted_panes(g, w0, q)])
        sealed = ((self.wm.watermark() + 1) // self.pane) * self.pane
        vals_list = self._fold_windows(wins)
        for (g, ic, ci, ctx, q, aqi, w0), vals in zip(wins, vals_list):
            key = (aqi, g, w0)
            self._atomic[key] = vals
            self._revno[key] = 0
            spec = (not final) and (w0 + q.within > sealed)
            records.append(EmissionRecord("emit", q.name, g, w0, vals, 0,
                                          speculative=spec))
            self.metrics.windows_emitted += 1
            self.metrics.speculative_emits += int(spec)
            lag = self._frontier - (w0 + q.within)
            self.metrics.emit_lag.append(lag)
            if self.obs is not None:
                self.obs.observe("eventtime.emit_lag", max(0, lag),
                                 LAG_BUCKETS)
                if self.obs.tracing:
                    self.obs.lifecycle(
                        "emit", (int(g), (w0 // self.pane) * self.pane),
                        args={"w0": w0, "q": aqi, "speculative": spec})
        return records

    def _revise(self, dirty: list[tuple[int, int]]) -> list[EmissionRecord]:
        """Re-fold every already-emitted window covering a revised pane."""
        if not dirty:
            return []
        rt = self.rt
        affected: dict[tuple[int, int, int], tuple[int, int]] = {}
        for g, t0 in dirty:
            pane_hit = False
            for ic, (comp, ctx) in enumerate(zip(rt.components, rt.ctxs)):
                for ci, aqi in enumerate(comp):
                    q = rt.workload.atomic[aqi]
                    nxt = self._next_w0.get((aqi, g), 0)
                    lo = max(0, t0 + self.pane - q.within)
                    w0 = -(-lo // q.slide) * q.slide
                    while w0 <= t0 and w0 < nxt:
                        affected[(aqi, g, w0)] = (ic, ci)
                        pane_hit = True
                        w0 += q.slide
            # a pane counts as *revised* only when its (re-)execution
            # reached back behind the emitted frontier
            self.metrics.panes_revised += int(pane_hit)
            if pane_hit and self.obs is not None:
                self.obs.lifecycle("revise", (int(g), t0))
        ordered = sorted(affected.items())
        if self.obs is not None:
            # storm depth: emitted windows re-folded by one dirty batch
            self.obs.observe("eventtime.revision_storm_depth", len(ordered),
                             DEPTH_BUCKETS)
        if self.micro_batch > 1:
            self._prefetch([job for (aqi, g, w0), _ in ordered
                            for job in self._unexecuted_panes(
                                g, w0, rt.workload.atomic[aqi])])
        records: list[EmissionRecord] = []
        win_rows = [(g, ic, ci, rt.ctxs[ic], rt.workload.atomic[aqi], aqi, w0)
                    for (aqi, g, w0), (ic, ci) in ordered]
        news = self._fold_windows(win_rows)
        for ((aqi, g, w0), (_ic, _ci)), new in zip(ordered, news):
            q = rt.workload.atomic[aqi]
            old = self._atomic[(aqi, g, w0)]
            if vals_equal(old, new):
                self.metrics.noop_revisions += 1
                continue
            rev = self._revno[(aqi, g, w0)] + 1
            records.append(EmissionRecord("retract", q.name, g, w0, old,
                                          rev - 1))
            records.append(EmissionRecord("amend", q.name, g, w0, new, rev))
            self.metrics.retractions += 1
            self.metrics.amendments += 1
            self._atomic[(aqi, g, w0)] = new
            self._revno[(aqi, g, w0)] = rev
        return records

    def _retire(self) -> None:
        """Drop pane state no still-revisable window can reference: with a
        lateness horizon, panes older than ``watermark - horizon -
        max(within)`` only serve windows that are already final.  With
        ``max_retained_panes`` set, additionally bound revision *memory*:
        evict the oldest event-retaining panes beyond the per-group cap."""
        if self.config.lateness_horizon is not None:
            bound = self.wm.watermark() - self.config.lateness_horizon
            for g, panes in self._panes.items():
                for t0 in [t for t in panes if t + self.max_within <= bound]:
                    del panes[t0]
        cap = self.config.max_retained_panes
        if cap is None:
            return
        for g, panes in self._panes.items():
            live = sorted(t0 for t0, ps in panes.items() if not ps.evicted)
            for t0 in live[:max(0, len(live) - cap)]:
                self._evict(g, t0)

    def _evict(self, g: int, t0: int) -> None:
        """Bounded revision memory: keep the pane's transfer matrices (so
        emission and re-folds of *other* dirty panes stay exact) but drop
        its raw events.  The dropped events are expired into the shedding
        accountant — every certificate a straggler into this pane could
        have invalidated is withdrawn — and later stragglers into the pane
        expire instead of absorbing (see :meth:`_absorb`)."""
        ps = self._panes[g][t0]
        self._ensure_executed(g, ps)
        if len(ps.events):
            # the events *were* folded (the pane's M survives), so they are
            # not counted as expired — but their revisability is gone, so
            # the accountant withdraws every certificate they back
            if self.accountant is not None:
                self.accountant.record(ps.events, witnessed=False, late=True)
        ps.events = EventBatch(self.workload.schema, np.array([], np.int32),
                               np.array([], np.int64), None)
        ps.evicted = True
        self.metrics.evicted_panes += 1
        if self.obs is not None:
            self.obs.lifecycle("evict", (int(g), t0))
        self.evictions.append((g, t0))
        if len(self.evictions) > self._evictions_keep:
            del self.evictions[:len(self.evictions) - self._evictions_keep]

    # -- convenience driver ------------------------------------------------

    def run_disordered(self, base: EventBatch, order: np.ndarray,
                       chunk: int = 64, t_end: int | None = None) -> dict:
        """Feed ``base`` in the arrival order ``order`` (chunked), flush,
        and return combined results — the differential-test entry point."""
        for i in range(0, len(order), chunk):
            idx = np.asarray(order[i:i + chunk])
            self.ingest(EventBatch.from_unsorted(
                base.schema, base.type_id[idx], base.time[idx],
                base.attrs[idx], base.group[idx], seq=idx))
        self.flush(t_end=t_end)
        return self.results()
