"""The ``Observability`` facade the engine threads everywhere.

One handle bundling the three obs primitives — span :class:`Tracer`,
:class:`MetricsRegistry`, :class:`SharingAuditLog` — behind the hooks the
runtime calls.  Every hook is safe to call with tracing disabled (the
tracer degenerates to guarded no-ops) and every engine call site guards
on ``obs is not None`` first, so a runtime constructed without
observability pays nothing.

Step clocks: while attached, the facade times the steps inside the
phases into the ``RunStats`` fields of ``RunStats.STEP_FIELDS``.  A
micro-batch flush opens with :meth:`Observability.flush_begin`; each step
is timed once by its caller, and :meth:`Observability.step` charges that
one pair of readings to the flush's ``RunStats`` and, with tracing on, to
an ``X`` span of category ``"step"`` carrying the flush id.  A phase of
a flush of K > 1 panes is one measured span on the engine track
(:meth:`Observability.flush_phase`); K = 1 keeps its pane-track span.
:meth:`Observability.host_phase` records the streaming layer's
top-level ``ingress`` and ``admit`` phases.  :meth:`Observability.attach`
counts the collector's pauses through ``gc.callbacks``.  None of these
adds a registry series.  The tracer's export starts with a ``clock_sync``
event pairing its origin on ``perf_counter`` and the Unix epoch, the
clock of ``torch.profiler`` (see :mod:`repro_torch.obs.trace`).

``collect()`` is the single read-side facade over the previously
disconnected stat silos: it folds ``RunStats`` and the executor counters
into one dict next to the registry series and the audit summary, plus the
``summary()`` of any overload, event-time or serving object it is handed.
It imports none of those layers: it reads them only through
``summary()``.
"""

from __future__ import annotations

import gc
import threading
import weakref
from time import perf_counter

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
        # the open flush: its RunStats with their share of its panes, and
        # the step spans' track and args
        self._flush_seq = 0
        self._shares: list = []
        self._step_key = None
        self._step_args = None
        self._phase_args = None
        # host phases may be timed on two threads at once (a pipelined
        # flush admits on its worker while the caller admits the next pane)
        self._host_lock = threading.Lock()
        # the collector hook while attached (see attach)
        self._gc_runtime = None
        self._gc_t0 = None
        self._gc_fin = None

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
        self._phase_hist_for(phase).observe(dur_s * 1e3)
        if self.tracer.enabled:
            self.tracer.complete(phase, t_start, dur_s, key=key,
                                 cat="phase")

    def _phase_hist_for(self, phase):
        h = self._phase_hist.get(phase)
        if h is None:
            h = self._phase_hist[phase] = self.registry.histogram(
                f"engine.phase.{phase}_ms", LATENCY_MS_BUCKETS)
        return h

    # ----------------------------------------------------- flushes and steps

    def flush_begin(self, stats: list, keys: list) -> dict | None:
        """Open a micro-batch flush of ``len(stats)`` panes: ``stats`` are
        their ``RunStats`` (one a pane, often the same object), ``keys``
        their trace keys.  Returns the flush's span ``args`` (None with
        tracing off)."""
        self._flush_seq += 1
        n = len(stats)
        count: dict = {}
        for s in stats:
            count[id(s)] = (s, count.get(id(s), (s, 0))[1] + 1)
        self._shares = [(s, c / n) for s, c in count.values()]
        if not self.tracer.enabled:
            return None
        self._step_key = keys[0] if n == 1 else None
        self._step_args = {"flush": self._flush_seq}
        self._phase_args = {"flush": self._flush_seq, "panes": n,
                            "pane_keys": keys}
        return self._phase_args

    def flush_end(self) -> None:
        """Close the open flush: steps timed after it charge nothing."""
        self._shares = []
        self._step_key = self._step_args = None

    def flush_phase(self, phase, t_start, t_end, n: int) -> None:
        """A phase of the open flush, timed once over its ``n`` panes:
        ``n`` observations of the pane's share in the phase histogram,
        and with tracing on one span — on the pane's track at ``n == 1``,
        else on the engine track with the flush's pane keys."""
        dur = t_end - t_start
        self._phase_hist_for(phase).observe_n(dur / n * 1e3, n)
        if self.tracer.enabled:
            if n == 1:
                self.tracer.complete(phase, t_start, dur,
                                     key=self._step_key, cat="phase",
                                     args=self._step_args)
            else:
                self.tracer.complete(phase, t_start, dur, cat="phase",
                                     args=self._phase_args)

    def step(self, name, field, t_start, t_end, stats=None) -> None:
        """One step, timed once by the caller: ``t_end - t_start`` seconds
        go to ``field`` of ``stats`` (default: of the open flush's
        ``RunStats``, by their share of its panes; nothing when no flush
        is open) and, with tracing on, to an ``X`` span of category
        ``"step"`` on the open flush's track, with its ``flush`` id."""
        dt = t_end - t_start
        if stats is not None:
            setattr(stats, field, getattr(stats, field) + dt)
        elif self._shares:
            for s, share in self._shares:
                setattr(s, field, getattr(s, field) + dt * share)
        else:
            return
        if self.tracer.enabled:
            self.tracer.complete(name, t_start, dt, key=self._step_key,
                                 cat="step", args=self._step_args)

    def step_count(self, field, n: int) -> None:
        """Add ``n`` to the integer ``field`` of the open flush's
        ``RunStats``, by their share of its panes."""
        for s, share in self._shares:
            setattr(s, field, getattr(s, field) + round(n * share))

    def host_phase(self, name, field, stats, t_start, t_end) -> None:
        """A top-level host phase outside the pane pipeline (the streaming
        layer's ``ingress`` and ``admit``): its seconds to ``field`` of
        ``stats`` and, with tracing on, an engine-track phase span.  No
        histogram: the registry keeps the reference's series."""
        dt = t_end - t_start
        with self._host_lock:
            setattr(stats, field, getattr(stats, field) + dt)
        if self.tracer.enabled:
            self.tracer.complete(name, t_start, dt, cat="phase")

    # ------------------------------------------------------------ collector

    def attach(self, runtime) -> None:
        """Count the collector's pauses into ``runtime.stats`` (``gc_s``,
        ``gc_collections``; a full pass also into ``gc_full_collections``
        and as a ``gc`` step span) until
        :meth:`detach`, or until this facade is freed.  The collector
        pauses the whole process, whatever it was doing: every attached
        facade counts each pause, and a runtime attached later takes over
        this facade's count."""
        self.detach()
        self._gc_runtime = weakref.ref(runtime)
        ref = weakref.ref(self)

        def hook(phase, info):
            o = ref()
            if o is not None:
                o._on_gc(phase, info)

        gc.callbacks.append(hook)
        self._gc_fin = weakref.finalize(self, _remove_gc_hook, hook)

    def detach(self) -> None:
        """Remove the collector hook :meth:`attach` installed."""
        if self._gc_fin is not None:
            self._gc_fin()
            self._gc_fin = self._gc_runtime = self._gc_t0 = None

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = perf_counter()
            return
        t0, self._gc_t0 = self._gc_t0, None
        if t0 is None:      # attached during a collection
            return
        dt = perf_counter() - t0
        rt = self._gc_runtime()
        if rt is None:
            return
        st = rt.stats
        st.gc_s += dt
        st.gc_collections += 1
        if info.get("generation") == 2:
            st.gc_full_collections += 1
            if self.tracer.enabled:
                self.tracer.complete("gc", t0, dt, cat="step")

    def lifecycle(self, stage, key=None, args=None) -> None:
        if self.tracer.enabled:
            self.tracer.instant(stage, key=key, cat="lifecycle", args=args)

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
                    "window_folds": fe.window_folds}
        return out


def _remove_gc_hook(hook) -> None:
    try:
        gc.callbacks.remove(hook)
    except ValueError:
        pass


__all__ = ["Observability", "PHASES", "LATENCY_MS_BUCKETS",
           "OCCUPANCY_BUCKETS", "LAG_BUCKETS", "DEPTH_BUCKETS"]
