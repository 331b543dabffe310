"""Asynchronous serving front-end for the Hamlet trend-aggregation engine.

:class:`ServingFrontend` is the session tier the batch service never had:
N clients open sessions (mapped to tenants), trickle events in at their own
pace, and consume per-group emission/retraction channels — while ONE shared
engine underneath keeps doing what makes Hamlet fast: fusing panes from all
sessions into the same K-pane micro-batched flushes a batch workload would
fill, sharing Kleene bursts across queries inside each flush.

The pieces:

* :class:`~repro_torch.serve.session.SessionHandle` — the per-client API
  (``submit`` / ``poll`` / sync+async delivery iterators);
* :class:`~repro_torch.serve.scheduler.ContinuousBatcher` — stages submissions,
  seals pane-complete prefixes against the session watermark, so flushes
  form from whatever is ready instead of a fixed epoch grid;
* three backend adapters sharing one small interface::

      ingest(chunk, boundary) -> records|None   # sealed prefix, in order
      finish(t_end)           -> records|None   # stream end
      pending_flush()         -> bool           # micro-batch still open?
      results() / stats() / shutdown()

  - ``overload``  — one :class:`OverloadRuntime` (admission + shedding +
    micro-batched pane pipeline, optional ``pipeline_flush`` overlap);
    emissions are computed by diffing ``results()`` snapshots;
  - ``sharded``   — a :class:`ShardedHamletService`; with
    ``ShardServiceConfig.parallel`` the shard drive cycles run on a
    thread pool and the watermark aligner is a real rendezvous barrier;
  - ``eventtime`` — an :class:`EventTimeRuntime`; its
    :class:`EmissionRecord` channel (emit/retract/amend) is forwarded
    verbatim, giving sessions a true retraction channel under disorder.

Determinism contract: submissions are seq-stamped per session
(``sid << 32 | counter``), staged events merge via the canonical
``lexsort(time, seq)`` order, and panes seal on the session watermark —
so for ANY interleaving of session submissions the engine consumes the
exact event sequence of the merged stream, and final ``results()`` are
bitwise equal to the single-threaded epoch-synchronous run.  Pumping from
a background thread, from callers' threads, or inline makes no difference.

Latency accounting: every seal records ``(boundary, wall_clock)``; a
window ``(q, g, w0)`` becomes *ready* at the first seal whose boundary
reaches ``w0 + within(q)``, and its delivery latency is the wall-clock
distance from that seal to the delivery entering the session inbox.
Histograms are kept per session and per tenant (see ``obs/metrics.py``
``serve_latency_series``) and surfaced through ``summary()`` /
``Observability.collect()``.

Backend and device: the engine under every adapter runs on the
front-end's ``np_backend``/``device`` (the keyword keeps the JAX package's
name, so one call can build either package's front-end).  Here its
default is ``"cuda"``, the hand-written kernels on ``cuda:0``, which
raises without a GPU; pass ``np_backend="np"`` or ``np_backend="torch",
device="cpu"`` to run on the host.  The ``sharded`` adapter forwards both
to its :class:`ShardedHamletService`, where the JAX package's adapter
drops them and always runs numpy.  The background pump thread makes the
engine's device its current CUDA device.  On the np backend the
determinism contract above is bitwise; on the device backends the drained
results hold COUNT exact (below 2^53) and the other values to rtol 1e-12
against the epoch-synchronous run, whose flushes may fuse other panes.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable

import numpy as np

from ..core.engine import vals_equal
from ..core.events import EventBatch
from ..kernels import ops
from ..obs.metrics import (SERVE_LATENCY_MS_BUCKETS, Histogram,
                           serve_latency_series)
from .scheduler import _SEQ_SPAN, ContinuousBatcher, SessionAdmission
from .session import Delivery, SessionHandle, _SessionState

__all__ = ["ServingFrontend"]


# --------------------------------------------------------------------------
# backend adapters
# --------------------------------------------------------------------------

class _OverloadBackend:
    """Adapter over one shared :class:`OverloadRuntime`."""

    name = "overload"
    retracts = False

    def __init__(self, workload, cfg=None, policy=None, backend="cuda",
                 device=None, obs=None):
        from ..overload.config import OverloadConfig
        from ..overload.runtime import OverloadRuntime
        self.rt = OverloadRuntime(workload, cfg or OverloadConfig(
            shed_policy="none"), policy=policy, backend=backend, obs=obs,
            device=device)
        self.device = self.rt.rt.device
        self.pane = self.rt.pane
        self.controller = self.rt.controller
        self.accountant = self.rt.accountant

    def ingest(self, chunk, boundary):
        if chunk is not None and len(chunk):
            self.rt.offer(chunk)
        while self.rt.t_now + self.pane <= boundary:
            self.rt.step_pane()
        return None

    def finish(self, t_end):
        while self.rt.t_now + self.pane <= t_end:
            self.rt.step_pane()
        self.rt.flush_panes()
        return None

    def pending_flush(self):
        return len(self.rt._backlog) > 0

    def results(self):
        return self.rt.results()

    def stats(self):
        return {"backend": self.name, "metrics": self.rt.metrics.summary(),
                "errors": self.rt.accountant.report()}

    def shutdown(self):
        self.rt.shutdown()


class _ShardedBackend:
    """Adapter over a :class:`ShardedHamletService` (optionally with
    ``parallel=True`` thread-pool shard drives), on the front-end's
    backend and device (the JAX package's adapter runs numpy whatever it
    is asked)."""

    name = "sharded"
    retracts = False

    def __init__(self, workload, cfg, backend="cuda", device=None,
                 obs=None):
        # (shard workers own their observability via cfg.obs; the serving
        # facade's registry is merged at collect time, not pushed down)
        from ..shardsvc.service import ShardedHamletService
        self.svc = ShardedHamletService(workload, cfg, backend=backend,
                                        device=device)
        self.device = self.svc.device
        self.pane = self.svc.pane
        self.controller = None          # admission lives per shard
        self.accountant = None
        self._closed = False

    def ingest(self, chunk, boundary):
        # The scheduler's watermark is a stronger order promise than the
        # router's max-seen heuristic: honour it so shards seal panes the
        # routed chunk alone would leave open.
        self.svc.promise(boundary - 1)
        self.svc.ingest(chunk)
        return None

    def finish(self, t_end):
        self.svc.promise(t_end - 1)
        if not self._closed:
            self.svc.close()
            self._closed = True
        return None

    def pending_flush(self):
        return any(w.pending_flush() for w in self.svc.workers)

    def results(self):
        return self.svc.results()

    def stats(self):
        return {"backend": self.name, **self.svc.collect()}

    def shutdown(self):
        if not self._closed:
            self.svc.close()
            self._closed = True


class _EventTimeBackend:
    """Adapter over an :class:`EventTimeRuntime` — the only backend with a
    native emission channel (including retract/amend revisions), so
    deliveries forward its :class:`EmissionRecord` stream verbatim.
    Note the records carry *atomic* query names (revision granularity);
    final ``results()`` are combined to user queries as everywhere else."""

    name = "eventtime"
    retracts = True

    def __init__(self, workload, cfg=None, policy=None, backend="cuda",
                 device=None, micro_batch=1, obs=None):
        from ..eventtime.config import EventTimeConfig
        from ..eventtime.revision import EventTimeRuntime
        self.rt = EventTimeRuntime(workload, cfg or EventTimeConfig(),
                                   policy=policy, backend=backend,
                                   micro_batch=micro_batch, obs=obs,
                                   device=device)
        self.device = self.rt.rt.device
        self.pane = self.rt.pane
        self.controller = None
        self.accountant = None

    def ingest(self, chunk, boundary):
        if chunk is None or not len(chunk):
            return []
        return self.rt.ingest(chunk)

    def finish(self, t_end):
        return self.rt.flush(t_end)

    def pending_flush(self):
        return False

    def results(self):
        return self.rt.results()

    def stats(self):
        return {"backend": self.name, "metrics": self.rt.metrics.summary()}

    def shutdown(self):
        pass


def _make_backend(workload, backend, *, overload=None, shard_cfg=None,
                  eventtime=None, policy=None, np_backend="cuda",
                  device=None, micro_batch=1, obs=None):
    if backend == "overload":
        return _OverloadBackend(workload, overload, policy=policy,
                                backend=np_backend, device=device, obs=obs)
    if backend == "sharded":
        if shard_cfg is None:
            raise ValueError("sharded backend needs a ShardServiceConfig")
        return _ShardedBackend(workload, shard_cfg, backend=np_backend,
                               device=device, obs=obs)
    if backend == "eventtime":
        return _EventTimeBackend(workload, eventtime, policy=policy,
                                 backend=np_backend, device=device,
                                 micro_batch=micro_batch, obs=obs)
    raise ValueError(f"unknown serving backend {backend!r}")


# --------------------------------------------------------------------------
# front-end
# --------------------------------------------------------------------------

class ServingFrontend:
    """Session front-end + continuous-batching pump over one engine.

    Thread model: ``submit``/``advance``/``close_session`` take the staging
    lock only (cheap, many producers); ``pump`` takes the pump lock (one
    flush former at a time — either the background thread started by
    ``start()`` or callers pumping inline) and holds the staging lock only
    while sealing.  Delivery inboxes are lock-free queues.

    Parameters
    ----------
    workload        the shared :class:`Workload`
    backend         "overload" (default) | "sharded" | "eventtime"
    skew            serving-level disorder allowance subtracted from the
                    session watermark before sealing (event-time backends
                    additionally revise stragglers past it)
    groups_per_tenant
                    tenancy layout: group ``g`` belongs to tenant
                    ``g // groups_per_tenant`` (used when a session
                    subscribes by tenant and for per-tenant latency series)
    session_admission
                    actuate the backend PID controller's shed ratio per
                    session at submit time (overload backend only)
    np_backend, device
                    the engine's kernel backend (``"cuda"``, the default,
                    ``"torch"`` or ``"np"``; the JAX package's keyword) and
                    torch device (default ``cuda:0``), for every adapter
                    (module docstring)
    """

    def __init__(self, workload, *, backend: str = "overload",
                 overload=None, shard_cfg=None, eventtime=None,
                 policy=None, np_backend: str = "cuda", device=None,
                 micro_batch: int = 1, skew: int = 0,
                 groups_per_tenant: int = 1, session_admission: bool = False,
                 obs=None, clock: Callable[[], float] = time.perf_counter):
        self.workload = workload
        self.obs = obs
        self._clock = clock
        self._backend = _make_backend(
            workload, backend, overload=overload, shard_cfg=shard_cfg,
            eventtime=eventtime, policy=policy, np_backend=np_backend,
            device=device, micro_batch=micro_batch, obs=obs)
        # the engine's torch.device (None on np)
        self.device = self._backend.device
        self.pane = self._backend.pane
        self.groups_per_tenant = max(1, int(groups_per_tenant))
        self._batcher = ContinuousBatcher(workload.schema, self.pane,
                                          skew=skew)
        self._admission = (SessionAdmission(self._backend.controller,
                                            self._backend.accountant)
                           if session_admission else None)
        # user-query readiness horizon: a window (q, g, w0) is complete
        # once the seal boundary reaches w0 + within(q)
        self._within = {qname: max(workload.atomic[i].within for i in idxs)
                        for qname, idxs, _ in workload.combines}
        self._atomic_within = {q.name: q.within for q in workload.atomic}

        self._lock = threading.Lock()        # staging + session registry
        self._pump_lock = threading.Lock()   # one flush former at a time
        self._sessions: dict[int, SessionHandle] = {}
        self._states: dict[int, _SessionState] = {}
        self._next_sid = 0
        self._drained = False

        # delivery bookkeeping (guarded by the pump lock)
        self._published: dict = {}           # (q, g, w0) -> vals
        self._revno: dict = {}               # (q, g, w0) -> revision counter
        self._seal_bounds: list[int] = []    # sorted seal boundaries ...
        self._seal_walls: list[float] = []   # ... and their wall clocks
        self._dirty = False                  # panes stepped since last diff

        # observability (histograms live here; mirrored into obs when set)
        self._lat_all = Histogram("serve.latency_ms.all",
                                  SERVE_LATENCY_MS_BUCKETS)
        self._lat_session: dict[int, Histogram] = {}
        self._lat_tenant: dict[int, Histogram] = {}
        self.deliveries = 0
        self.submitted = 0
        self.pump_cycles = 0
        self.pump_wall_s = 0.0
        self.staging_hwm = 0          # high-water of staged-not-yet-sealed

        self._pump_thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- sessions

    def open_session(self, tenant: int = 0, groups=None) -> SessionHandle:
        """Open a client session.  ``groups=None`` subscribes the session to
        its tenant's group block; pass an iterable for an explicit set, or
        ``groups="all"`` for everything."""
        if groups is None:
            lo = tenant * self.groups_per_tenant
            groups = range(lo, lo + self.groups_per_tenant)
        elif groups == "all":
            groups = None
        with self._lock:
            if self._drained:
                raise RuntimeError("front-end already drained")
            sid = self._next_sid
            self._next_sid += 1
            h = SessionHandle(self, sid, tenant, groups)
            self._sessions[sid] = h
            self._states[sid] = _SessionState(opened_at=self._clock())
            self._batcher.track(sid)
        return h

    def submit(self, sid: int, events) -> int:
        """Stage one session's submission (called via the handle).  Events
        must be a time-ordered :class:`EventBatch`.

        Merge-order keys: when the batch carries no ``seq``, stamps are
        assigned here as ``sid << 32 | submit counter`` — merge order is a
        pure function of per-session submission order, never of
        cross-session interleaving.  A batch that *does* carry ``seq`` is
        taken as producer-assigned order keys and staged verbatim (the
        replayed-trace regime: equal-timestamp events across sessions
        order by producer seq, exactly as ``EventBatch.from_unsorted``
        traces do in the event-time layer); the caller then owns
        cross-session key uniqueness."""
        if not isinstance(events, EventBatch):
            raise TypeError("submit() takes an EventBatch")
        with self._lock:
            st = self._states[sid]
            if st.closed or self._drained:
                raise RuntimeError(f"session {sid} is closed")
            batch, shed = events, 0
            if self._admission is not None:
                batch, shed = self._admission.admit(events)
                st.shed += shed
            n = len(batch)
            if n and batch.seq is None:
                seq = (np.arange(st.seq_next, st.seq_next + n,
                                 dtype=np.int64) + sid * _SEQ_SPAN)
                st.seq_next += n
                batch = EventBatch(batch.schema, batch.type_id, batch.time,
                                   batch.attrs, batch.group, seq=seq)
            self._batcher.stage(sid, batch)
            st.submitted += n
            self.submitted += n
            staged = len(self._batcher)
            if staged > self.staging_hwm:
                self.staging_hwm = staged
        if self.obs is not None:
            self.obs.count("serve.submitted", n)
            self.obs.set_gauge("serve.staging_events", staged)
            self.obs.set_gauge("serve.staging_hwm", self.staging_hwm)
            if shed:
                self.obs.count("serve.session_shed", shed)
        return n

    def advance(self, sid: int, t: int) -> None:
        with self._lock:
            self._batcher.advance(sid, t)

    def close_session(self, sid: int) -> None:
        with self._lock:
            st = self._states.get(sid)
            if st is None or st.closed:
                return
            st.closed = True
            self._batcher.release(sid)

    @property
    def sessions(self) -> list[SessionHandle]:
        with self._lock:
            return list(self._sessions.values())

    def staged_events(self) -> int:
        """Events staged but not yet sealed (the transport's credit gate
        reads this as the serving-side occupancy signal)."""
        with self._lock:
            return len(self._batcher)

    def sealed_to(self) -> int:
        """Boundary below which every staged event has been sealed (credit
        accounting: a producer's in-flight batch is 'consumed' once the
        seal boundary passes its max timestamp)."""
        with self._lock:
            return self._batcher.sealed_to

    # ---------------------------------------------------------------- pump

    def pump(self) -> int:
        """Form one flush from whatever is sealed right now: merge the
        pane-complete staged prefix, feed it to the backend, route the new
        emissions.  Returns the number of events forwarded (0 when no new
        pane was complete).  Safe to call from any thread."""
        with self._pump_lock:
            return self._pump_locked()

    def _pump_locked(self, upto: int | None = None) -> int:
        c0 = self._clock()
        with self._lock:
            chunk, boundary = self._batcher.seal(upto)
        n = 0
        if chunk is not None:
            self._log_seal(boundary)
            if self.obs is not None:
                with self.obs.span("serve.flush", cat="serve",
                                   args={"events": len(chunk),
                                         "boundary": boundary}):
                    records = self._backend.ingest(chunk, boundary)
            else:
                records = self._backend.ingest(chunk, boundary)
            n = len(chunk)
            self._dirty = True
            if records:
                self._route_records(records)
        # diff-based backends emit only on flush boundaries: collect when
        # the micro-batch has actually flushed, never force a partial one
        if (not self._backend.retracts and self._dirty
                and not self._backend.pending_flush()):
            self._route_diff()
            self._dirty = False
        self.pump_cycles += 1
        self.pump_wall_s += self._clock() - c0
        return n

    def start(self, interval_s: float = 0.002) -> None:
        """Run the pump on a background thread until ``stop``/``drain``;
        the thread makes the engine's device its current CUDA device."""
        if self._pump_thread is not None:
            return
        self._stop.clear()

        def loop():
            with ops.on_device(self.device):
                while not self._stop.is_set():
                    self.pump()
                    self._stop.wait(interval_s)

        self._pump_thread = threading.Thread(target=loop, name="serve-pump")
        self._pump_thread.start()

    def stop(self) -> None:
        if self._pump_thread is not None:
            self._stop.set()
            self._pump_thread.join()
            self._pump_thread = None

    def drain(self) -> dict:
        """Stream end: close every session, seal everything staged, flush
        the backend, deliver the tail, post the close sentinel on every
        inbox, and shut worker pools down.  Returns final ``results()``."""
        self.stop()
        with self._pump_lock:
            with self._lock:
                self._drained = True
                for sid, st in self._states.items():
                    if not st.closed:
                        st.closed = True
                        self._batcher.release(sid)
                t_hi = max(self._batcher._max_staged + 1,
                           self._batcher.sealed_to)
                t_end = ((t_hi + self.pane - 1) // self.pane) * self.pane
            self._pump_locked(upto=t_end)
            self._log_seal(t_end)
            records = self._backend.finish(t_end)
            if records:
                self._route_records(records)
            if not self._backend.retracts:
                self._route_diff()
                self._dirty = False
            res = self._backend.results()
            with self._lock:
                for h in self._sessions.values():
                    h._finish()
            self._backend.shutdown()
            return res

    # ------------------------------------------------------------ delivery

    def _log_seal(self, boundary: int) -> None:
        if not self._seal_bounds or boundary > self._seal_bounds[-1]:
            self._seal_bounds.append(boundary)
            self._seal_walls.append(self._clock())

    def _ready_wall(self, close_t: int, now: float) -> float:
        """Wall clock of the first seal whose boundary covered ``close_t``
        (the moment the window *could* first have been delivered)."""
        i = bisect.bisect_left(self._seal_bounds, close_t)
        return self._seal_walls[i] if i < len(self._seal_bounds) else now

    def _route_diff(self) -> None:
        res = self._backend.results()
        now = self._clock()
        for key, vals in res.items():
            old = self._published.get(key)
            if old is not None and vals_equal(old, vals):
                continue
            q, g, w0 = key
            rev = self._revno.get(key, -1) + 1
            self._revno[key] = rev
            ready = self._ready_wall(w0 + self._within[q], now)
            lat = max(0.0, (now - ready) * 1e3)
            if old is not None:
                self._deliver(Delivery("retract", q, g, w0, old, rev - 1,
                                       lat), count=False)
                kind = "amend"
            else:
                kind = "emit"
            self._published[key] = vals
            self._deliver(Delivery(kind, q, g, w0, vals, rev, lat))

    def _route_records(self, records) -> None:
        now = self._clock()
        for r in records:
            within = self._atomic_within.get(r.query,
                                             self._within.get(r.query, 0))
            ready = self._ready_wall(r.w0 + within, now)
            lat = max(0.0, (now - ready) * 1e3)
            self._deliver(Delivery(r.kind, r.query, r.group, r.w0, r.vals,
                                   r.revision, lat),
                          count=r.kind != "retract")

    def _deliver(self, d: Delivery, count: bool = True) -> None:
        tenant = d.group // self.groups_per_tenant
        with self._lock:
            targets = [h for h in self._sessions.values()
                       if h.subscribes(d.group)]
            for h in targets:
                self._states[h.id].delivered += 1
        for h in targets:
            h._deliver(d)
        self.deliveries += len(targets)
        if count and targets:
            self._lat_all.observe(d.latency_ms)
            t_h = self._lat_tenant.get(tenant)
            if t_h is None:
                t_h = self._lat_tenant[tenant] = Histogram(
                    serve_latency_series("tenant", tenant),
                    SERVE_LATENCY_MS_BUCKETS)
            t_h.observe(d.latency_ms)
            for h in targets:
                s_h = self._lat_session.get(h.id)
                if s_h is None:
                    s_h = self._lat_session[h.id] = Histogram(
                        serve_latency_series("session", h.id),
                        SERVE_LATENCY_MS_BUCKETS)
                s_h.observe(d.latency_ms)
            if self.obs is not None:
                self.obs.count("serve.deliveries", len(targets))
                self.obs.observe("serve.latency_ms", d.latency_ms,
                                 edges=SERVE_LATENCY_MS_BUCKETS)

    # ------------------------------------------------------------- results

    def results(self) -> dict:
        return self._backend.results()

    def summary(self) -> dict:
        """Serving-tier summary (merged into ``Observability.collect``)."""
        with self._lock:
            sess = {sid: {"tenant": self._sessions[sid].tenant,
                          "submitted": st.submitted,
                          "delivered": st.delivered,
                          "shed": st.shed,
                          "closed": st.closed}
                    for sid, st in self._states.items()}
        for sid, h in self._lat_session.items():
            if sid in sess:
                sess[sid]["p50_ms"] = h.quantile(0.50)
                sess[sid]["p99_ms"] = h.quantile(0.99)
        return {
            "backend": self._backend.name,
            "sessions": sess,
            "tenants": {t: {"p50_ms": h.quantile(0.50),
                            "p99_ms": h.quantile(0.99),
                            "n": h.count}
                        for t, h in self._lat_tenant.items()},
            "latency_ms": {"p50": self._lat_all.quantile(0.50),
                           "p90": self._lat_all.quantile(0.90),
                           "p99": self._lat_all.quantile(0.99),
                           "n": self._lat_all.count},
            "submitted": self.submitted,
            "deliveries": self.deliveries,
            "sealed_events": self._batcher.sealed_events,
            "sealed_to": self._batcher.sealed_to,
            "staging": {"staged": len(self._batcher),
                        "hwm": self.staging_hwm},
            "session_shed": (self._admission.shed_total
                             if self._admission else 0),
            "pump_cycles": self.pump_cycles,
            "pump_wall_s": self.pump_wall_s,
        }

    def collect(self) -> dict:
        out = {"serving": self.summary()}
        out["engine"] = self._backend.stats()
        return out
