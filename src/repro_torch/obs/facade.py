"""The ``Observability`` facade the engine threads everywhere.

One handle bundling the three obs primitives — span :class:`Tracer`,
:class:`MetricsRegistry`, :class:`SharingAuditLog` — behind the hooks the
runtime calls.  Every hook is safe to call with tracing disabled (the
tracer degenerates to guarded no-ops) and every engine call site guards
on ``obs is not None`` first, so a runtime constructed without
observability pays nothing.

``collect()`` is the single read-side facade over the previously
disconnected stat silos: it folds ``RunStats`` and the executor counters
into one dict next to the registry series and the audit summary, plus the
``summary()`` of any overload, event-time or serving object it is handed.
It imports none of those layers: it reads them only through
``summary()``.
"""

from __future__ import annotations

from .audit import SharingAuditLog
from .metrics import (DEPTH_BUCKETS, LAG_BUCKETS, LATENCY_MS_BUCKETS,
                      OCCUPANCY_BUCKETS, MetricsRegistry)
from .trace import Tracer

PHASES = ("plan", "execute", "finalize", "fold")


class Observability:
    """Span tracer + metrics registry + sharing-decision audit log."""

    def __init__(self, *, trace: bool = True, audit: bool = True,
                 capacity: int = 1 << 18, sample: int = 1,
                 audit_capacity: int = 1 << 16):
        self.tracer = Tracer(capacity=capacity if trace else 0,
                             sample=sample)
        self.registry = MetricsRegistry()
        self.audit = SharingAuditLog(capacity=audit_capacity) if audit \
            else None
        self.pane_ticks: int | None = None  # set by the owning runtime
        # hot-path instrument handles, cached by name: registry lookups
        # re-validate histogram edges per call, too costly per pane
        self._phase_hist = {}
        self._counters = {}
        self._gauges = {}
        self._hists = {}

    @classmethod
    def disabled(cls) -> "Observability":
        """Tracing and audit off; the registry still collects series."""
        return cls(trace=False, audit=False)

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    # ------------------------------------------------------------ pane keys

    def pane_key(self, pane):
        """(group, pane_t0) trace key for an event batch's pane.

        ``pane_ticks`` (set by the owning runtime) snaps the first event
        time to the pane grid so plan/execute/fold spans and event-time
        lifecycle marks land on the same track.
        """
        if pane is None or len(pane) == 0:
            return (-1, -1)
        t = int(pane.time[0])
        if self.pane_ticks:
            t -= t % self.pane_ticks
        return (int(pane.group[0]), t)

    # ----------------------------------------------------------- span hooks

    def pane_phase(self, phase, t_start, dur_s, key=None) -> None:
        """Record one pipeline-phase span (and its latency histogram)."""
        h = self._phase_hist.get(phase)
        if h is None:
            h = self._phase_hist[phase] = self.registry.histogram(
                f"engine.phase.{phase}_ms", LATENCY_MS_BUCKETS)
        h.observe(dur_s * 1e3)
        if self.tracer.enabled:
            self.tracer.complete(phase, t_start, dur_s, key=key,
                                 cat="phase")

    def pane_phase_n(self, phase, dur_s, n: int) -> None:
        """``n`` panes' worth of the same amortized phase duration, one
        call — the tracing-off twin of ``n`` ``pane_phase`` calls."""
        h = self._phase_hist.get(phase)
        if h is None:
            h = self._phase_hist[phase] = self.registry.histogram(
                f"engine.phase.{phase}_ms", LATENCY_MS_BUCKETS)
        h.observe_n(dur_s * 1e3, n)

    def lifecycle(self, stage, key=None, args=None) -> None:
        if self.tracer.enabled:
            self.tracer.instant(stage, key=key, cat="lifecycle", args=args)

    def cache_event(self, hit: bool, key=None) -> None:
        if self.tracer.enabled:
            self.tracer.instant("plan_cache_hit" if hit
                                else "plan_cache_miss", key=key, cat="cache")

    def span(self, name, cat="span", args=None):
        return self.tracer.span(name, cat, args)

    # -------------------------------------------------------- metrics hooks

    def count(self, name, n: int = 1) -> None:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = self.registry.counter(name)
        c.value += n

    def set_gauge(self, name, v) -> None:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = self.registry.gauge(name)
        g.value = v

    def observe(self, name, value, edges=LATENCY_MS_BUCKETS) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self.registry.histogram(name, edges)
        h.observe(value)

    # ------------------------------------------------------------ audit hook

    def audit_decision(self, **kw) -> None:
        if self.audit is not None:
            self.audit.record(**kw)

    # ---------------------------------------------------------------- merge

    def merge_from(self, other: "Observability") -> None:
        """Fold another instance's metric series into this one.

        Cross-instance merge for fleets (one ``Observability`` per shard):
        counters and histogram buckets sum, gauges take the other's last
        write, matching histogram names must share bucket layouts.  Traces
        and audit logs are deliberately not merged — they are per-instance
        diagnostic streams, and interleaving them would destroy the
        per-shard timelines."""
        self.registry.merge(other.registry)

    # --------------------------------------------------------------- export

    def export_trace(self, path) -> int:
        return self.tracer.export_jsonl(path)

    def phase_totals(self) -> dict:
        return self.tracer.phase_totals()

    def collect(self, stats=None, overload=None, eventtime=None,
                runtime=None, serving=None) -> dict:
        """One unified read-side view over every stat silo.

        ``stats`` is a ``RunStats``; ``runtime`` a ``HamletRuntime`` (for
        executor / fold-executor counters, which are also mirrored into
        registry gauges here); ``overload``, ``eventtime`` and ``serving``
        are any objects with a ``summary()`` (an overload metrics record,
        an event-time metrics record, a serving front-end), or for
        ``serving`` a ready dict; each summary lands under its own key.
        """
        out = {"metrics": self.registry.collect(),
               "trace": {"events": len(self.tracer),
                         "dropped": self.tracer.dropped,
                         "sample": self.tracer.sample}}
        if self.audit is not None:
            out["audit"] = self.audit.summary()
        if stats is not None:
            eng = {k: v for k, v in vars(stats).items()
                   if isinstance(v, (int, float))}
            eng["phase_split"] = stats.phase_split()
            out["engine"] = eng
        if overload is not None:
            out["overload"] = overload.summary()
        if serving is not None:
            out["serving"] = (serving if isinstance(serving, dict)
                              else serving.summary())
        if eventtime is not None:
            out["eventtime"] = eventtime.summary()
        if runtime is not None:
            ex = runtime.executor
            out["executors"] = {
                "batch": {"jobs": ex.jobs, "launches": ex.launches,
                          "flushes": ex.flushes}}
            fe = getattr(runtime, "fold_exec", None)
            if fe is not None:
                out["executors"]["fold"] = {
                    "flushes": fe.flushes, "launches": fe.launches,
                    "window_folds": fe.window_folds,
                    "flush_plan_hits": fe.plan_hits,
                    "flush_plan_misses": fe.plan_misses,
                    "flush_plan_evictions": fe.plan_evictions}
                for k in ("hits", "misses", "evictions"):
                    # sync the live series to the executor's lifetime total
                    # (they can lag when obs was attached mid-stream)
                    c = self.registry.counter(f"fold_exec.flush_plan.{k}")
                    c.value = getattr(fe, f"plan_{k}")
            out["plan_cache"] = runtime.plan_cache_stats()
        return out


__all__ = ["Observability", "PHASES", "LATENCY_MS_BUCKETS",
           "OCCUPANCY_BUCKETS", "LAG_BUCKETS", "DEPTH_BUCKETS"]
