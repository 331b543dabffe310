"""Bounded-latency streaming runtime wrapping :class:`HamletRuntime`.

``OverloadRuntime`` drives the HAMLET pane dataplane *incrementally* — one
pane at a time instead of one batch call — and puts an overload-control loop
around it:

    producers --offer()--> IngressQueue --poll (pane)--> admission control
        --> shedding policy --> PaneProcessor --> window instances --> results
                 ^                                    |
                 '---- PID controller <--- pane latency observation

Per pane: arrivals are pulled from the ingress queue, the admission budget is
``min(n * (1 - shed_ratio), pane_budget_events)``, the shedding policy picks
*which* events survive, the survivors run through the unchanged HAMLET pane
machinery, the measured pane-processing time feeds the PID controller, and
the shed events feed the error accountant.  With ``tick_seconds`` set, the
metrics additionally report end-to-end latency against a simulated arrival
timeline (sequential processing: backlog carries over), which is what makes
sustained overload visible as unbounded latency when shedding is off.

Cross-pane fused execution: with ``config.micro_batch = K > 1`` admitted
panes accumulate in a processing backlog and execute together — every group
driver's propagation jobs for K pane steps flush as one launch per size
bucket (see ``core/engine.py``).  Admission and shedding still happen per
pane at poll time; the controller and the per-pane metrics are then fed the
*amortized* per-pane processing time of the fused batch, so the control loop
reacts once per micro-batch instead of once per pane.  Results are bitwise
identical to ``K=1`` whenever the shed decisions agree (e.g. under
``fixed_shed``); with the live PID loop the coarser observation cadence can
shift shed ratios — that is the documented latency/efficiency trade.

A group partition seen for the first time at pane ``t`` starts with fresh
window state — correct because an absent group's earlier panes are empty and
the empty-pane transfer matrix is the identity.

On the device backends (``"cuda"``, the default, and ``"torch"`` on a CUDA
device) the pane-processing time is the device's time too: every flush,
single-pane or micro-batched, ends on its executors' one host fetch
(``ops.device_get_all``) before the second clock read, so ``proc_ms``
holds the kernels and copies, not only their launches.  With
``pipeline_flush`` the one worker thread launches on the current stream of
the runtime's own device, as the caller's thread does, so a later fetch
waits for it.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..core.engine import (HamletRuntime, PaneMicroBatcher, RunStats,
                           _Instance, advance_instances, combine_results)
from ..core.events import EventBatch
from ..core.query import Workload
from ..kernels import ops
from ..obs.metrics import LATENCY_MS_BUCKETS
from .accountant import ErrorAccountant
from .config import OverloadConfig
from .controller import LatencyController
from .ingress import IngressQueue
from .shedding import make_shedder

__all__ = ["OverloadRuntime", "OverloadMetrics", "PaneMetric"]


@dataclass(frozen=True)
class PaneMetric:
    t0: int
    offered: int
    admitted: int
    shed: int
    proc_ms: float
    lat_ms: float
    shed_ratio: float
    late: int = 0   # arrivals behind this pane's start (routed to accountant)


@dataclass
class OverloadMetrics:
    panes: list[PaneMetric] = field(default_factory=list)

    def add(self, m: PaneMetric) -> None:
        self.panes.append(m)

    def percentile(self, q: float, what: str = "lat_ms") -> float:
        if not self.panes:
            return 0.0
        return float(np.percentile([getattr(p, what) for p in self.panes], q))

    def summary(self) -> dict:
        # one pane-list pass per field (the percentile() helper would
        # re-extract the list for every quantile — 5 passes instead of 2)
        panes = self.panes
        offered = sum(p.offered for p in panes)
        admitted = sum(p.admitted for p in panes)
        shed = sum(p.shed for p in panes)
        if panes:
            proc = np.fromiter((p.proc_ms for p in panes), float, len(panes))
            lat = np.fromiter((p.lat_ms for p in panes), float, len(panes))
            mean_ratio = float(np.mean(
                np.fromiter((p.shed_ratio for p in panes), float,
                            len(panes))))
            p50_proc, p99_proc = np.percentile(proc, [50, 99])
            p50_lat, p99_lat, max_lat = np.percentile(lat, [50, 99, 100])
        else:
            mean_ratio = 0.0
            p50_proc = p99_proc = p50_lat = p99_lat = max_lat = 0.0
        return {
            "panes": len(panes),
            "offered": offered,
            "admitted": admitted,
            "shed": shed,
            "shed_frac": shed / offered if offered else 0.0,
            "mean_shed_ratio": mean_ratio,
            "p50_proc_ms": float(p50_proc),
            "p99_proc_ms": float(p99_proc),
            "p50_lat_ms": float(p50_lat),
            "p99_lat_ms": float(p99_lat),
            "max_lat_ms": float(max_lat),
        }


class _GroupDriver:
    """Pane-incremental window-instance state for one group partition."""

    def __init__(self, rt: HamletRuntime, group_key: int, t_now: int):
        self.rt = rt
        self.group_key = group_key
        # shed and admitted panes alike reuse the runtime's batched executor
        self.procs = [rt.make_processor(ci) for ci in range(len(rt.ctxs))]
        # insts[component][member] : {window_start: _Instance}
        self.insts: list[list[dict[int, _Instance]]] = []
        for comp, ctx in zip(rt.components, rt.ctxs):
            per: list[dict[int, _Instance]] = []
            for aqi in comp:
                q = rt.workload.atomic[aqi]
                d: dict[int, _Instance] = {}
                # windows opened before this driver existed but still open;
                # their elapsed panes were empty for this group (identity
                # transfer), so fresh state is exact
                w0_min = max(0, ((t_now - q.within) // q.slide + 1) * q.slide)
                for w0 in range(w0_min, t_now, q.slide):
                    d[w0] = _Instance(w0, ctx.layout.fresh_state())
                per.append(d)
            self.insts.append(per)

    def plan(self, pane_ev: EventBatch, mb: PaneMicroBatcher,
             stats: RunStats) -> list:
        """Plan this group's pane across all components into the shared
        micro-batch; returns the pending handles ``apply`` consumes."""
        return [mb.submit(proc, pane_ev, stats) for proc in self.procs]

    def apply(self, pends: list, pane_ev: EventBatch, t0: int, out: dict,
              stats: RunStats) -> None:
        """Finalize + fold this group's pane (after the micro-batch drained)."""
        rt = self.rt
        pane = rt.pane
        obs = rt.obs
        key = (self.group_key, t0) if obs is not None and obs.tracing \
            else None
        fold_t0 = None
        fold_dt = 0.0
        for comp, ctx, pend, per in zip(rt.components, rt.ctxs, pends,
                                        self.insts):
            M = pend.finalize()
            for ci, aqi in enumerate(comp):
                q = rt.workload.atomic[aqi]
                insts = per[ci]
                if t0 % q.slide == 0:
                    insts[t0] = _Instance(t0, ctx.layout.fresh_state())
                needs_minmax = ci in ctx.minmax_queries
                t_fold = time.perf_counter()
                advance_instances(M[ci], insts)
                dt = time.perf_counter() - t_fold
                stats.fold_s += dt
                if fold_t0 is None:
                    fold_t0 = t_fold
                fold_dt += dt
                for w0, inst in list(insts.items()):
                    if needs_minmax and len(pane_ev):
                        inst.events.append(pane_ev)
                    if w0 + q.within == t0 + pane:
                        out[(aqi, self.group_key, w0)] = rt._emit(
                            ctx, ci, q, inst, self.group_key)
                        del insts[w0]
                        stats.windows_emitted += 1
                        if key is not None:
                            obs.lifecycle("emit", key,
                                          args={"w0": w0, "q": aqi})
        if obs is not None and fold_t0 is not None:
            obs.pane_phase("fold", fold_t0, fold_dt, key=key)

    def advance(self, pane_ev: EventBatch, t0: int, out: dict,
                stats: RunStats) -> None:
        """Single-pane convenience: plan, drain, apply."""
        mb = PaneMicroBatcher(self.rt.executor, k=1,
                              fold_exec=self.rt.fold_exec,
                              obs=self.rt.obs)
        pends = self.plan(pane_ev, mb, stats)
        mb.drain()
        self.apply(pends, pane_ev, t0, out, stats)


class OverloadRuntime:
    def __init__(self, workload: Workload, config: OverloadConfig,
                 policy=None, backend: str = "cuda", clock=time.perf_counter,
                 batch_exec: bool = True, obs=None, device=None):
        self.workload = workload
        self.config = config
        self.obs = obs
        self.rt = HamletRuntime(workload, policy=policy, backend=backend,
                                batch_exec=batch_exec,
                                fold_exec=config.fold_exec, obs=obs,
                                device=device)
        self.pane = self.rt.pane
        self.stats = self.rt.stats
        self.micro_batch = max(1, int(config.micro_batch))
        self.queue = IngressQueue(workload.schema,
                                  capacity=config.queue_capacity,
                                  high_watermark=config.high_watermark,
                                  low_watermark=config.low_watermark)
        self.controller = LatencyController.from_config(config)
        self.shedder = make_shedder(
            config.shed_policy, workload, seed=config.seed,
            min_burst_keep=config.min_burst_keep,
            benefit_model=config.benefit_model)
        self.accountant = ErrorAccountant(workload, pane=self.pane)
        self.metrics = OverloadMetrics()
        self._drivers: dict[int, _GroupDriver] = {}
        self._atomic: dict = {}
        self._t = 0
        self._clock = clock
        self._done_s = 0.0   # completion time on the simulated timeline
        # admitted panes awaiting fused execution (micro_batch > 1)
        self._backlog: list[tuple[int, int, int, int, EventBatch]] = []
        # pipelined flush: one worker thread runs flushes FIFO while the
        # caller polls/admits/sheds the next micro-batch (depth-1 pipeline)
        self._flush_pool = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="flush")
            if config.pipeline_flush else None)
        self._flush_fut = None

    # -- producer side --

    def offer(self, batch: EventBatch) -> int:
        """Offer arrivals; honours ingress backpressure.  Returns accepted.
        With an ``obs`` attached the call is the ``ingress`` phase."""
        obs = self.obs
        if obs is None:
            return self.queue.offer(batch)
        t0 = time.perf_counter()
        n = self.queue.offer(batch)
        obs.host_phase("ingress", "ingress_s", self.stats, t0,
                       time.perf_counter())
        return n

    @property
    def t_now(self) -> int:
        """Pane-clock frontier: panes ``[0, t_now)`` have been admitted and
        shed (execution may still be deferred in the micro-batch backlog)."""
        return self._t

    # -- pane loop --

    def step_pane(self) -> None:
        """Admit, shed, and process the next pane ``[t, t + pane)``.

        The pane loop assumes time order; arrivals that straddled the poll
        frontier (time < t0 — their pane was already processed) cannot be
        folded in here.  They are charged to the error accountant as late,
        unwitnessed shed events so every certificate they could invalidate
        is withdrawn (the event-time layer is the path that *revises* such
        events instead of dropping them).  With an ``obs`` attached the
        poll, late split and shedding are the ``admit`` phase, as is the
        partition by group ahead of the micro-batcher."""
        obs = self.obs
        t_admit = time.perf_counter() if obs is not None else 0.0
        t0 = self._t
        ev = self.queue.poll_until(t0 + self.pane)
        n_late = 0
        if len(ev) and int(ev.time[0]) < t0:
            stale = np.nonzero(ev.time < t0)[0]
            n_late = len(stale)
            self.accountant.record(ev.select(stale), witnessed=False,
                                   late=True)
            ev = ev.select(np.arange(n_late, len(ev)))
        n = len(ev)

        if self.shedder is None:
            keep_n = n
        else:
            keep_n = int(math.floor(n * (1.0 - self.controller.shed_ratio)
                                    + 1e-9))
            if self.config.pane_budget_events is not None:
                keep_n = min(keep_n, self.config.pane_budget_events)
            keep_n = min(max(keep_n, 0), n)

        if keep_n < n:
            plan = self.shedder.plan(ev, keep_n)
            kept = ev.select(plan.keep)
            self.accountant.record(ev.select(plan.shed),
                                   witnessed=plan.witnessed)
        else:
            kept = ev

        self._backlog.append((t0, n, keep_n, n_late, kept))
        self._t = t0 + self.pane
        if obs is not None:
            obs.host_phase("admit", "admit_s", self.stats, t_admit,
                           time.perf_counter())
        if len(self._backlog) >= self.micro_batch:
            self._drain_backlog()

    def flush_panes(self) -> None:
        """Execute any panes still deferred in the processing backlog (and,
        in pipelined mode, wait for the in-flight flush to land)."""
        self._drain_backlog()
        self._await_flush()

    def shutdown(self) -> None:
        """Drain everything and stop the pipelined flush worker (no-op when
        ``pipeline_flush`` is off)."""
        self.flush_panes()
        if self._flush_pool is not None:
            self._flush_pool.shutdown(wait=True)
            self._flush_pool = None

    def _await_flush(self) -> None:
        if self._flush_fut is not None:
            fut, self._flush_fut = self._flush_fut, None
            fut.result()

    def _drain_backlog(self) -> None:
        backlog, self._backlog = self._backlog, []
        if not backlog:
            return
        if self._flush_pool is not None:
            # depth-1 pipeline: wait for flush N-1, then hand flush N to the
            # worker and return — the caller overlaps its host-side staging
            # (poll, admission, shedding) with this flush's execution
            self._await_flush()
            self._flush_fut = self._flush_pool.submit(self._flush_on_device,
                                                      backlog)
            return
        self._flush_one(backlog)

    def _flush_on_device(self, backlog: list) -> None:
        """The pipelined flush, on the worker thread: the thread's current
        CUDA device is made the runtime's own, so every launch and fetch of
        the flush goes to that device's current (default) stream."""
        with ops.on_device(self.rt.device):
            return self._flush_one(backlog)

    def _flush_one(self, backlog: list) -> None:
        c0 = self._clock()
        if len(backlog) == 1:
            t0, _n, _keep, _late, kept = backlog[0]
            self._process(kept, t0)
        else:
            self._process_batch([(t0, kept)
                                 for t0, _n, _k, _l, kept in backlog])
        # the controller acts on pane-processing time (the directly
        # controllable quantity), amortized across the fused micro-batch;
        # end-to-end latency is reported alongside
        proc_s = (self._clock() - c0) / len(backlog)
        obs = self.obs
        for t0, n, keep_n, n_late, kept in backlog:
            lat_ms = self._latency_ms(t0, proc_s)
            self.controller.update(proc_s * 1e3)
            self.metrics.add(PaneMetric(
                t0=t0, offered=n, admitted=len(kept), shed=n - keep_n,
                proc_ms=proc_s * 1e3, lat_ms=lat_ms,
                shed_ratio=self.controller.shed_ratio, late=n_late))
            if obs is not None:
                obs.observe("overload.pane_proc_ms", proc_s * 1e3,
                            LATENCY_MS_BUCKETS)
                obs.observe("overload.pane_shed_lat_ms", lat_ms,
                            LATENCY_MS_BUCKETS)
                obs.set_gauge("overload.shed_ratio",
                              self.controller.shed_ratio)
                if n > keep_n:
                    obs.count("overload.shed_events", n - keep_n)

    def _process(self, kept: EventBatch, t0: int) -> None:
        """Process one admitted pane through the group drivers."""
        self._process_batch([(t0, kept)])

    def _process_batch(self, panes: list[tuple[int, EventBatch]]) -> None:
        """Fused execution of K admitted panes: plan every (pane, group,
        component) into one micro-batch, drain once — one launch per size
        bucket per K panes — then finalize and fold in stream order."""
        obs = self.rt.obs
        t_admit = time.perf_counter() if obs is not None else 0.0
        mb = PaneMicroBatcher(self.rt.executor, k=len(panes),
                              fold_exec=self.rt.fold_exec, obs=obs)
        planned: list = []
        for t0, kept in panes:
            parts = kept.partition_by_group() if len(kept) else {}
            for g in parts:
                if g not in self._drivers:
                    self._drivers[g] = _GroupDriver(self.rt, int(g), t0)
            empty = self._empty()
            planned.append([
                (drv, parts.get(g, empty), drv.plan(parts.get(g, empty),
                                                    mb, self.stats))
                for g, drv in self._drivers.items()])
        if obs is not None:
            obs.host_phase("admit", "admit_s", self.stats, t_admit,
                           time.perf_counter())
        mb.drain()
        for (t0, _kept), per in zip(panes, planned):
            for drv, pane_ev, pends in per:
                drv.apply(pends, pane_ev, t0, self._atomic, self.stats)

    def _latency_ms(self, t0: int, proc_s: float) -> float:
        ts = self.config.tick_seconds
        if ts is None:
            return proc_s * 1e3
        # sequential server on the arrival timeline: work queues behind the
        # previous pane's completion, so backlog shows up as latency
        arrival_end = (t0 + self.pane) * ts
        self._done_s = max(self._done_s, arrival_end) + proc_s
        return (self._done_s - arrival_end) * 1e3

    def _empty(self) -> EventBatch:
        return EventBatch(self.workload.schema, np.array([], np.int32),
                          np.array([], np.int64), None)

    # -- results --

    def results(self) -> dict:
        """User-query results for every window closed so far (drains any
        deferred micro-batch first)."""
        self.flush_panes()
        return combine_results(self.workload, self._atomic)

    def run(self, batch: EventBatch, t_end: int | None = None) -> dict:
        """Convenience driver: feed ``batch`` pane-by-pane in arrival order
        and process through ``t_end`` (rounded up to a pane boundary)."""
        if t_end is None:
            t_end = int(batch.time.max()) + 1 if len(batch) else 0
        t_end = ((t_end + self.pane - 1) // self.pane) * self.pane
        for t0 in range(self._t, t_end, self.pane):
            self.offer(batch.time_slice(t0, t0 + self.pane))
            self.step_pane()
        return self.results()
