"""Streaming service wrapper: out-of-order arrival handling and dynamic
workload changes.

The paper assumes in-order arrival and a static workload, citing standard
techniques for both relaxations (Sec. 2.1 [11,26,27,41] and [24,48]).  This
module supplies those substrate pieces:

* ``OutOfOrderBuffer`` — bounded-lateness reordering: events are released in
  timestamp order once the watermark (max seen time − lateness) passes them;
  stragglers inside the bound merge correctly, later ones are counted and
  dropped.
* ``HamletService`` — incremental execution in *epochs* (the LCM of all
  windows/slides).  Because sliding windows span any boundary, each epoch is
  evaluated over a replayed history tail of ``max(within)`` and only the
  windows **closing** inside the epoch are emitted — bounded re-processing
  (overlap factor ≤ 1 + max(within)/epoch), exact results.  Query add/remove
  takes effect at the next epoch boundary (plan migration at epoch
  granularity, after [48]).

Passing an :class:`repro_torch.overload.OverloadConfig` opts the service
into load shedding at its natural (epoch) granularity: released events are
shed by the configured policy before entering history, the PID controller
is fed the measured epoch-processing latency (``slo_ms`` is therefore a
per-*epoch* target here; the pane-granular loop lives in
``repro_torch.overload.runtime``), and every shed event is charged to the
error accountant.  The state is exposed as ``service.overload``.

Passing an :class:`repro_torch.eventtime.EventTimeConfig` replaces the
fixed-bound ``OutOfOrderBuffer`` with the event-time layer's policy-driven
:class:`~repro_torch.eventtime.ReorderBuffer` *and* opens the revision path: a
straggler behind the already-emitted frontier but inside the lateness horizon
is merged into the retained history tail and every emitted window it touches
is re-evaluated — value changes append retract/amend records to
``service.revisions`` and update ``service.results`` in place (``feed`` keeps
returning only first-time emissions).  Stragglers beyond the horizon are
expired: counted in ``service.expired_late`` and, when overload is attached,
charged to the error accountant so the shedding bounds survive disorder.
History retention is widened from ``max(within)`` to ``max(within) +
horizon`` to make that replay exact.  (The pane-granular speculative path —
emit optimistically, revise from stored pane matrices — lives in
``repro_torch.eventtime.revision``.)

This wrapper is single-instance: one runtime, one epoch clock.  The
multi-tenant tier above it lives in :mod:`repro_torch.shardsvc`: a router
places tenants' groups on N shard workers, each an
:class:`~repro_torch.overload.OverloadRuntime` of its own, and under
``none``/``global_fixed`` admission the N-shard results match the 1-shard
run's.

The replay runtime runs on the service's ``backend``/``device``, as
:class:`~repro_torch.core.engine.HamletRuntime` does: the default is the
hand-written CUDA kernels on ``cuda:0``, which raises without a GPU; pass
``backend="torch", device="cpu"`` or ``backend="np"`` to run on the host.
Each replay ends on the runtime's host fetch, so an epoch's measured
latency includes its device work.
"""

from __future__ import annotations

import math
import time

import numpy as np

from ..kernels.ops import resolve_device
from .engine import HamletRuntime, RunStats, vals_equal
from .events import EventBatch
from .query import Query, Workload

__all__ = ["OutOfOrderBuffer", "HamletService", "ServiceOverloadState"]


class ServiceOverloadState:
    """Overload machinery attached to a :class:`HamletService`."""

    def __init__(self, workload: Workload, config):
        from ..overload.accountant import ErrorAccountant
        from ..overload.controller import LatencyController
        from ..overload.shedding import make_shedder

        self.config = config
        self.controller = LatencyController.from_config(config)
        self.accountant = ErrorAccountant(workload)
        self.shedder = make_shedder(
            config.shed_policy, workload, seed=config.seed,
            min_burst_keep=config.min_burst_keep,
            benefit_model=config.benefit_model)
        self.shed_events = 0

    def rebind(self, workload: Workload) -> None:
        """Refresh the workload-derived pieces after query add/remove;
        controller state and accounting history survive the migration."""
        from ..overload.shedding import make_shedder

        self.shedder = make_shedder(
            self.config.shed_policy, workload, seed=self.config.seed,
            min_burst_keep=self.config.min_burst_keep,
            benefit_model=self.config.benefit_model)
        self.accountant.migrate(workload)

    def shed(self, batch: EventBatch) -> EventBatch:
        """Shed from a released batch, pane by pane.

        The batch may span several panes (the service drains at epoch
        granularity), but burst segmentation — and the per-burst witness the
        accountant's multiplicative bound relies on — is pane-scoped in the
        engine, so the plan must be too: a run spanning two panes is two
        engine bursts, and a witness in the first says nothing about the
        second."""
        if self.shedder is None or not len(batch):
            return batch
        ratio = self.controller.shed_ratio
        if ratio <= 0.0:
            return batch
        pane = self.accountant.pane
        kept: list[EventBatch] = []
        for t0 in range(int(batch.time.min()) // pane * pane,
                        int(batch.time.max()) + 1, pane):
            chunk = batch.time_slice(t0, t0 + pane)
            if not len(chunk):
                continue
            keep_n = math.floor(len(chunk) * (1.0 - ratio) + 1e-9)
            if keep_n >= len(chunk):
                kept.append(chunk)
                continue
            plan = self.shedder.plan(chunk, keep_n)
            self.accountant.record(chunk.select(plan.shed),
                                   witnessed=plan.witnessed)
            self.shed_events += plan.n_shed
            kept.append(chunk.select(plan.keep))
        return EventBatch.concat(kept) if kept else batch.select(
            np.array([], dtype=np.int64))


class OutOfOrderBuffer:
    """Bounded-lateness reordering buffer (accepts arbitrary arrival order)."""

    def __init__(self, schema, lateness: int):
        self.schema = schema
        self.lateness = int(lateness)
        self._held: list[tuple[int, int, int, np.ndarray, int]] = []
        self._arrival = 0
        self._released_upto = -(1 << 62)
        self.dropped_late = 0

    def feed_arrays(self, type_id, time, attrs=None, group=None) -> EventBatch:
        n = len(type_id)
        attrs = (np.zeros((n, max(1, len(self.schema.attrs))))
                 if attrs is None else np.asarray(attrs))
        group = np.zeros(n, np.int64) if group is None else np.asarray(group)
        for i in range(n):
            t = int(time[i])
            if t < self._released_upto:
                self.dropped_late += 1
                continue
            self._held.append((t, self._arrival, int(type_id[i]),
                               attrs[i].copy(), int(group[i])))
            self._arrival += 1
        if not self._held:
            return self._empty()
        watermark = max(t for t, *_ in self._held) - self.lateness
        return self._release(watermark)

    def feed(self, batch: EventBatch) -> EventBatch:
        return self.feed_arrays(batch.type_id, batch.time, batch.attrs,
                                batch.group)

    def flush(self) -> EventBatch:
        return self._release(1 << 62)

    def _release(self, watermark: int) -> EventBatch:
        out = sorted([e for e in self._held if e[0] <= watermark])
        self._held = [e for e in self._held if e[0] > watermark]
        if not out:
            return self._empty()
        # events with time == the last released tick may still arrive (e.g.
        # duplicate timestamps split across feeds); only strictly older
        # arrivals are late
        self._released_upto = max(self._released_upto, out[-1][0])
        return EventBatch(
            self.schema,
            np.array([e[2] for e in out], np.int32),
            np.array([e[0] for e in out], np.int64),
            np.stack([e[3] for e in out]),
            np.array([e[4] for e in out], np.int64),
        )

    def _empty(self) -> EventBatch:
        return EventBatch(self.schema, np.array([], np.int32),
                          np.array([], np.int64), None)


class HamletService:
    """Incremental HAMLET with dynamic workload changes at epoch boundaries.

    ``micro_batch`` / ``fold_exec`` pass through to the replay
    :class:`HamletRuntime` (cross-pane fused launches, the stacked
    finalize/fold executor — see ``core/engine.py``); the runtime is reused
    while the workload is unchanged.  ``obs`` attaches
    a :class:`repro_torch.obs.Observability` facade: it is threaded into the
    replay runtime (pane spans, metrics, sharing audit) and each epoch
    replay additionally gets an ``epoch`` span on the engine track.
    ``backend`` / ``device`` pick where the replay runtime runs (module
    docstring)."""

    def __init__(self, schema, queries: list[Query], policy=None,
                 lateness: int = 0, sharable_mode: str = "units",
                 overload=None, batch_exec: bool = True, eventtime=None,
                 micro_batch: int = 1, fold_exec: bool = True, obs=None,
                 backend: str = "cuda",
                 device=None):
        from .events import pane_size_for

        self.schema = schema
        self.obs = obs
        self.backend = backend
        # raises when a GPU is asked for (the default) and none is present
        self.device = resolve_device(backend, device)
        self.sharable_mode = sharable_mode
        self.policy = policy
        self.batch_exec = batch_exec
        self.micro_batch = max(1, int(micro_batch))
        self.fold_exec = fold_exec
        # the replay runtime is reused while the workload is unchanged, so
        # the executor's staging buffers stay warm across epochs; query
        # add/remove rebuilds it
        self._rt: HamletRuntime | None = None
        self._rt_stale = True
        self._queries: dict[str, Query] = {q.name: q for q in queries}
        self._pending_add: dict[str, Query] = {}
        self._pending_remove: set[str] = set()
        self.eventtime = eventtime
        if eventtime is None:
            self._ooo = OutOfOrderBuffer(schema, lateness)
            self._reorder = None
        else:
            from ..eventtime.reorder import ReorderBuffer
            from ..eventtime.watermark import make_watermark

            # pane granularity is fixed at construction, like the
            # accountant's (a migrated workload keeps the original sealing
            # grid; it stays sound because sealing only ever under-promises)
            pane = pane_size_for([(q.within, q.slide)
                                  for q in queries] or [(1, 1)])
            self._ooo = None
            self._reorder = ReorderBuffer(
                schema, pane, make_watermark(eventtime),
                lateness_horizon=eventtime.lateness_horizon)
        self.revisions: list = []                # retract/amend records
        self._rev_seen = 0                       # revisions already charged
        self._revno: dict = {}                   # window key -> revision no
        # when each query became active (epoch time): revision must never
        # resurrect windows that closed before a query existed
        self._query_since: dict[str, int] = {q.name: 0 for q in queries}
        self.expired_late = 0
        self._events: EventBatch | None = None   # history tail
        self._t_done = 0                         # epochs emitted up to here
        self.results: dict = {}
        self.stats = RunStats()
        self._refresh_derived()
        self.overload = (None if overload is None else
                         ServiceOverloadState(self._workload(), overload))

    def _workload(self) -> Workload:
        return Workload(self.schema, list(self._queries.values()),
                        sharable_mode=self.sharable_mode)

    def _refresh_derived(self) -> None:
        self._epoch_len = 1
        self._max_within = 1
        for q in self._queries.values():
            self._epoch_len = math.lcm(self._epoch_len, q.within, q.slide)
            self._max_within = max(self._max_within, q.within)

    # -- dynamic workload (takes effect at the next epoch boundary) --

    def add_query(self, q: Query) -> None:
        self._pending_add[q.name] = q

    def remove_query(self, name: str) -> None:
        self._pending_remove.add(name)

    def _apply_pending(self) -> None:
        if not (self._pending_add or self._pending_remove):
            return
        for name in self._pending_remove:
            self._queries.pop(name, None)
            self._pending_add.pop(name, None)
            self._query_since.pop(name, None)
        for name, q in self._pending_add.items():
            if name not in self._queries:
                self._query_since[name] = self._t_done
            self._queries[name] = q
        self._pending_add.clear()
        self._pending_remove.clear()
        self._refresh_derived()
        self._rt_stale = True
        if self.overload is not None:
            self.overload.rebind(self._workload())

    # -- streaming --

    def feed(self, batch: EventBatch) -> dict:
        if self._reorder is not None:
            return self._feed_eventtime(batch)
        ready = self._ooo.feed(batch)
        if self.overload is not None:
            ready = self.overload.shed(ready)
        self._append(ready)
        return self._drain(final=False)

    def close(self) -> dict:
        if self._reorder is not None:
            res = self._reorder.flush()
            self._absorb_sealed(res)
            return self._drain(final=True)
        self._append(self._ooo.flush())
        return self._drain(final=True)

    def heartbeat(self, group: int, t: int) -> dict:
        """Group liveness signal (event-time mode with the group_heartbeat
        watermark policy); may seal panes and emit windows."""
        if self._reorder is None:
            return {}
        self._absorb_sealed(self._reorder.heartbeat(group, t))
        return self._drain(final=False)

    def _feed_eventtime(self, batch: EventBatch) -> dict:
        res = self._reorder.push(batch)
        self._absorb_sealed(res)
        if res.late is not None and len(res.late):
            self.revise(res.late)
        return self._drain(final=False)

    def _absorb_sealed(self, res) -> None:
        if res.expired is not None and len(res.expired):
            self._expire(res.expired)
        ready = [sp.events for sp in res.sealed if len(sp.events)]
        if not ready:
            return
        released = EventBatch.concat(ready)
        if self.overload is not None:
            released = self.overload.shed(released)
        self._append(released)

    def _expire(self, batch: EventBatch) -> None:
        self.expired_late += len(batch)
        if self.overload is not None:
            self.overload.accountant.record(batch, witnessed=False, late=True)

    @property
    def _horizon(self) -> int:
        if self.eventtime is None:
            return 0
        h = self.eventtime.lateness_horizon
        # retention is widened by the horizon (see _run_epoch), so any
        # configured depth replays exactly; None (unbounded in the config's
        # contract) defaults to max(within) here to keep retention finite
        return self._max_within if h is None else h

    # -- revision (event-time mode) --

    def revise(self, late: EventBatch) -> list:
        """Fold stragglers that arrived behind the emitted frontier into the
        retained history and re-evaluate every emitted window they touch.

        Events inside the lateness horizon are merged (by time, provenance
        ties by ``seq``); affected windows are re-run over the retained tail
        with the epoch replay arithmetic, and every value change appends a
        ``retract`` + ``amend`` record pair to ``self.revisions`` and
        updates ``self.results``.  Events behind the horizon are expired
        (counted; charged to the overload accountant when attached).
        Returns the new records."""
        from ..eventtime.revision import EmissionRecord

        if not len(late):
            return []
        bound = self._t_done - self._horizon
        old_mask = late.time < bound
        if old_mask.any():
            self._expire(late.select(np.nonzero(old_mask)[0]))
            late = late.select(np.nonzero(~old_mask)[0])
        if not len(late):
            return []
        self._events = (late if self._events is None
                        else EventBatch.merge([self._events, late]))

        # replay the affected region: only windows that actually contain a
        # straggler (per group), were already emitted (close <= t_done), and
        # belong to a query that existed when they closed
        t_from = int(late.time.min())
        L = self._epoch_len
        shift = max(0, (t_from - self._max_within) // L * L)
        end = self._t_done
        if end <= shift:
            return []
        res = self._replay(shift, end)
        late_by_group = {int(g): b.time
                         for g, b in late.partition_by_group().items()}

        records: list = []
        for (qn, gk, w0), vals in res.items():
            q = self._queries.get(qn)
            if q is None:
                continue
            close_t = w0 + shift + q.within
            if not (t_from < close_t <= end):
                continue        # unaffected or not yet emitted
            if close_t <= self._query_since.get(qn, 0):
                continue        # window predates the query
            lt = late_by_group.get(int(gk))
            if lt is None or not ((lt >= w0 + shift) & (lt < close_t)).any():
                continue        # no straggler landed inside this window
            key = (qn, gk, w0 + shift)
            old = self.results.get(key)
            if old is None:
                # a straggler made this window's group visible for the
                # first time: a late first emission, not an amendment
                records.append(EmissionRecord("emit", qn, gk, w0 + shift,
                                              vals, 0))
            elif vals_equal(old, vals):
                continue
            else:
                rev = self._revno.get(key, 0) + 1
                self._revno[key] = rev
                records.append(EmissionRecord("retract", qn, gk,
                                              w0 + shift, old, rev - 1))
                records.append(EmissionRecord("amend", qn, gk, w0 + shift,
                                              vals, rev))
            self.results[key] = vals
        self.revisions.extend(records)
        return records

    def _append(self, batch: EventBatch) -> None:
        if not len(batch):
            return
        self._events = (batch if self._events is None
                        else EventBatch.concat([self._events, batch]))

    def _drain(self, final: bool) -> dict:
        new: dict = {}
        while self._events is not None and len(self._events):
            horizon = int(self._events.time.max())
            end = self._t_done + self._epoch_len
            if horizon < end and not final:
                break
            if horizon < self._t_done and final:
                break
            new.update(self._run_epoch(end))
            if final and (self._events is None or
                          not len(self._events) or
                          int(self._events.time.max()) < self._t_done):
                break
        return new

    def _replay(self, shift: int, end: int) -> dict:
        """Run the current workload over retained history in [shift, end),
        window starts re-aligned by ``shift`` (a multiple of the epoch) —
        the one replay primitive shared by epoch emission and revision, so
        their arithmetic cannot drift apart."""
        ev = self._events
        sel = np.nonzero((ev.time >= shift) & (ev.time < end))[0]
        sub = ev.select(sel)
        shifted = EventBatch(self.schema, sub.type_id, sub.time - shift,
                             sub.attrs, sub.group)
        rt = self._runtime()
        res = rt.run(shifted, t_end=end - shift)
        self.stats.merge(rt.stats)
        return res

    def _runtime(self) -> HamletRuntime:
        """The replay runtime, rebuilt only after a workload migration; its
        stats are reset per replay (the service merges them itself)."""
        if self._rt is None or self._rt_stale:
            self._rt = HamletRuntime(self._workload(), policy=self.policy,
                                     backend=self.backend,
                                     device=self.device,
                                     batch_exec=self.batch_exec,
                                     micro_batch=self.micro_batch,
                                     fold_exec=self.fold_exec,
                                     obs=self.obs)
            self._rt_stale = False
        self._rt.stats = RunStats()
        return self._rt

    def _run_epoch(self, end: int) -> dict:
        t_start = time.perf_counter()
        L = self._epoch_len
        # replay shift: a multiple of L (window starts stay slide-aligned)
        k_hist = math.ceil(self._max_within / L)
        shift = max(0, (end // L - 1 - k_hist)) * L
        res = self._replay(shift, end)

        # emit only windows that close inside this epoch
        out: dict = {}
        for (qn, gk, w0), vals in res.items():
            q = self._queries.get(qn)
            if q is None:
                continue
            close_t = w0 + shift + q.within
            if self._t_done < close_t <= end:
                out[(qn, gk, w0 + shift)] = vals
        self.results.update(out)
        if self.obs is not None and self.obs.tracing:
            self.obs.tracer.complete(
                "epoch", t_start, time.perf_counter() - t_start,
                cat="service", args={"end": end, "emitted": len(out)})

        # retire history older than any future window — or, in event-time
        # mode, any still-revisable emitted window — needs
        keep_from = end - self._max_within - self._horizon
        ev = self._events
        keep = np.nonzero(ev.time >= keep_from)[0]
        self._events = ev.select(keep) if len(keep) else None
        self._t_done = end
        self._apply_pending()
        if self.overload is not None:
            # disorder-aware admission control: besides epoch latency, feed
            # the controller the revision load this epoch — retract/amend
            # records per window emitted — so a revision storm under heavy
            # disorder raises the shed ratio (see overload/controller.py)
            n_rev = len(self.revisions) - self._rev_seen
            self._rev_seen = len(self.revisions)
            rev_load = n_rev / max(1, len(out))
            self.overload.controller.update(
                (time.perf_counter() - t_start) * 1e3,
                revision_load=rev_load)
        return out
