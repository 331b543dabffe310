"""Sharded multi-tenant HAMLET service: router, shard workers, alignment.

Topology (one process, N independent shard states):

    arrivals --> GlobalAdmissionController --> PlacementTable router
                      (shed at the router)      (tenant,group) -> shard
                           |                               |
                           v                               v
                 router ErrorAccountant        ShardWorker[0..N-1], each:
                                                 ReorderBuffer(RoutedFrontier)
                                                 OverloadRuntime (own
                                                   HamletRuntime,
                                                   PaneMicroBatcher, PID loop,
                                                   ErrorAccountant)
                           ^                               |
                           |                               v
                 WatermarkAligner  <---- FrontierSnapshot per drive cycle

Group partitions are fully independent in the pane dataplane, so sharding
by group is semantically free: each shard runs the *unchanged* engine over
its own groups.  The service's job is everything groups don't isolate —
admission, routing, time, and the merged read side:

* **Admission** happens at the router (``shardsvc/admission.py``), before
  any queue.  In ``global_fixed`` mode the shed decision is a pure
  function of the pane-sliced arrival stream, so the admitted set — and
  therefore every downstream result — is identical for every shard count.
* **Time** is per shard: each worker seals panes against its own
  :class:`RoutedFrontier` (local bounded-skew estimate ∨ router promises),
  so no shard waits on another to seal, and the per-shard retract/amend
  accounting of the event-time layer is untouched.  The router heartbeats
  its global watermark after every chunk; since routing is synchronous
  (every arrival at or below the router watermark has already been
  forwarded), the promise is sound, and a quiet shard's frontier advances
  with global stream progress.  Fleet-level finality is negotiated by the
  :class:`WatermarkAligner` (aligned-epoch protocol — laggards are
  excluded, not waited on).
* **Rebalancing** moves one group between shards at a pane-aligned
  boundary strictly above every event seen so far: old-time events keep
  routing to the source shard, the two involved shards cap their pane
  clocks at the boundary (a barrier *only* for the pair, *only* while the
  move is pending), and at the barrier the group's open-window instances
  are handed to the target shard.  Untouched shards never stall; the
  handoff is exact for in-flight windows.

**Differential contract**: with ``none``/``global_fixed`` admission, the
results of an N-shard service are a permutation-stable bitwise match of
the 1-shard service on the same stream — same keys, same values, only the
emission interleaving differs.  ``per_shard`` admission (PID-driven
ratios actuated at the router) intentionally departs from this: shed
ratios then depend on per-shard latency, which depends on placement.

**Backend and device.** Every shard's runtime runs on the service's
``backend``/``device``, as :class:`~repro_torch.core.engine.HamletRuntime`
does: the default is the hand-written CUDA kernels on ``cuda:0``, which
raises without a GPU; pass ``backend="np"`` or ``backend="torch",
device="cpu"`` to run on the host.  N shards on one card are N runtimes,
each with its own executors, on that card's current stream.  In thread
mode each pool thread makes the runtime's device its current CUDA device
before it drives; in process mode each worker process opens its own CUDA
context (:mod:`repro_torch.shardsvc.procdrive`).  A rebalance hands the
moved group's open-window instances over as host numpy state: no tensor
moves between shards.

On the np backend the contract above is bitwise, as in the JAX package.
On the device backends the N-shard results hold COUNT exact (below 2^53),
the same keys and the same non-finite pattern, and every other value to
rtol 1e-12 against the 1-shard run: each shard's ``PaneMicroBatcher``
fuses the panes of its own groups only, so the bucket shapes of a flush
differ with the shard count and the kernels may add in another order.
The serial, thread and process drives of one backend stay bitwise equal:
the workers share no state.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np

from ..core.engine import RunStats
from ..core.events import EventBatch
from ..core.query import Workload
from ..eventtime.frontier import FrontierSnapshot, RoutedFrontier
from ..eventtime.reorder import ReorderBuffer
from ..kernels import ops
from ..obs.facade import Observability
from ..overload.config import OverloadConfig
from ..overload.runtime import OverloadRuntime, _GroupDriver
from .admission import ADMISSION_MODES, GlobalAdmissionController
from .coordinator import WatermarkAligner
from .placement import PlacementTable

__all__ = ["ShardServiceConfig", "ShardWorker", "ShardedHamletService"]


@dataclass
class ShardServiceConfig:
    """Knobs of the sharded service tier.

    n_shards           shard worker count (1 = the differential baseline)
    groups_per_tenant  tenant granularity: ``tenant = group // this``
    admission          "none" | "global_fixed" | "per_shard" (see
                       ``shardsvc/admission.py``); under the first two the
                       N-shard/1-shard differential contract holds
    eventtime          run each shard behind a reorder buffer with a
                       :class:`RoutedFrontier` (disordered arrival); off =
                       arrival order is event-time order
    skew               bounded-skew allowance of every shard frontier and
                       of the router watermark (eventtime mode)
    lateness_horizon   per-shard expiry horizon (ticks behind watermark)
    align_every_panes  aligned-epoch granularity, in panes
    max_lag_epochs     how far a shard may trail the fleet max before the
                       aligner excludes it
    overload           the per-shard overload config template; when the
                       router owns admission, shards get a copy with local
                       shedding disabled (actuation moves to the router,
                       observation stays on the shard)
    obs                give every shard a registry-only Observability and
                       expose the merged + per-shard tracks in ``collect()``
    ring_replicas      consistent-hash ring points per shard
    parallel           how drive cycles overlap across shard workers:

                       * ``False`` — serial: drive every worker in turn
                         on the caller thread (the differential baseline);
                       * ``True`` / ``"thread"`` — thread pool: each cycle
                         dispatches (offer, heartbeat, drive) per worker
                         concurrently and the workers meet at the
                         aligner's rendezvous barrier.  Measured wall
                         clock, but numpy pane work still serializes on
                         the GIL;
                       * ``"process"`` — long-lived worker processes
                         (:mod:`repro_torch.shardsvc.procdrive`): engine state
                         pinned per process, chunks shipped via shared
                         memory, rendezvous over the command pipe — the
                         mode that can actually exceed 1.0x measured
                         speedup on multi-core hosts.  Rebalance is not
                         supported in this mode.

                       All modes are bitwise identical to the serial drive
                       (workers share no mutable state; the aligner sees
                       the same frontier sequence per cycle).
    """

    n_shards: int = 2
    groups_per_tenant: int = 1
    admission: str = "global_fixed"
    eventtime: bool = False
    skew: int = 0
    lateness_horizon: int | None = None
    align_every_panes: int = 4
    max_lag_epochs: int = 2
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    obs: bool = False
    ring_replicas: int = 64
    parallel: bool | str = False

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.admission not in ADMISSION_MODES:
            raise ValueError(f"unknown admission mode {self.admission!r}")
        if self.skew < 0:
            raise ValueError("skew must be non-negative")
        if self.align_every_panes < 1:
            raise ValueError("align_every_panes must be >= 1")
        if self.parallel not in (False, True, "thread", "process"):
            raise ValueError(
                f"parallel must be False, True, 'thread' or 'process', "
                f"got {self.parallel!r}")

    @property
    def drive_mode(self) -> str:
        """Normalized drive mode: ``serial`` | ``thread`` | ``process``."""
        if self.parallel is False:
            return "serial"
        if self.parallel is True:
            return "thread"
        return self.parallel


@dataclass
class _PendingMove:
    group: int
    src: int
    dst: int
    boundary: int      # pane-aligned handoff time, > max_seen at registration


def foreign_modules() -> list[str]:
    """Modules of this process that belong to jax or to the JAX package."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))


class ShardWorker:
    """One shard: reorder buffer + overload runtime + busy accounting.

    ``throttle`` (max panes stepped per drive cycle) simulates a slow or
    degraded shard — the aligner's laggard-exclusion path and the
    weak-scaling benchmark's slow-shard scenario both use it.  ``cap_t``
    is the rebalance barrier: while set, the pane clock will not advance
    past it.  ``backend``/``device`` pick where the shard's runtime runs
    (module docstring); ``device`` is the resolved ``torch.device`` (None
    on np).
    """

    def __init__(self, shard_id: int, workload: Workload,
                 cfg: OverloadConfig, *, policy=None, backend: str = "cuda",
                 device=None, eventtime: bool = False, skew: int = 0,
                 lateness_horizon: int | None = None, obs=None,
                 clock=time.perf_counter):
        self.shard_id = int(shard_id)
        self.obs = obs
        self.rt = OverloadRuntime(workload, cfg, policy=policy,
                                  backend=backend, obs=obs, device=device)
        self.device = self.rt.rt.device
        self.pane = self.rt.pane
        if eventtime:
            self.frontier_policy = RoutedFrontier(skew=skew)
            self.reorder = ReorderBuffer(workload.schema, self.pane,
                                         self.frontier_policy,
                                         lateness_horizon=lateness_horizon)
        else:
            self.frontier_policy = None
            self.reorder = None
        self._safe_end = 0       # ordered-mode step limit (router max_seen)
        self.cap_t: int | None = None
        self.throttle: int | None = None
        self.busy_s = 0.0
        self.late_total = 0
        self.expired_total = 0
        self._clock = clock

    @property
    def t_now(self) -> int:
        return self.rt.t_now

    # ------------------------------------------------------------- ingest

    def offer(self, sub: EventBatch, safe_end: int) -> None:
        """Accept this shard's routed slice of one arrival chunk.

        ``safe_end`` (ordered mode) is the router's promise that every
        future arrival — for any shard — has time >= it, so panes ending
        at or before it are complete."""
        c0 = self._clock()
        if self.reorder is None:
            if len(sub):
                self.rt.offer(sub)
            self._safe_end = max(self._safe_end, safe_end)
        elif len(sub):
            self._ingest(self.reorder.push(sub))
        self.busy_s += self._clock() - c0

    def heartbeat(self, t: int) -> None:
        """Router promise: no event with time < t is still in flight."""
        if self.reorder is not None:
            c0 = self._clock()
            self._ingest(self.reorder.heartbeat(-1, t))
            self.busy_s += self._clock() - c0

    def _ingest(self, res) -> None:
        for sp in res.sealed:
            if len(sp.events):
                self.rt.offer(sp.events)
        for late in (res.late, res.expired):
            if late is not None:
                # behind this shard's sealed frontier: charge like the
                # in-runtime stale path so every certificate stays sound
                self.rt.accountant.record(late, witnessed=False, late=True)
        self.late_total += res.n_late
        self.expired_total += res.n_expired

    # -------------------------------------------------------------- drive

    def _step_limit(self) -> int:
        lim = self._safe_end
        if self.reorder is not None:
            lim = max(lim, self.reorder.sealed_end)
        if self.cap_t is not None:
            lim = min(lim, self.cap_t)
        return lim

    def drive(self) -> int:
        """Step every complete pane (bounded by throttle/cap); returns the
        number of panes stepped."""
        c0 = self._clock()
        stepped = 0
        lim = self._step_limit()
        while self.rt.t_now + self.pane <= lim:
            if self.throttle is not None and stepped >= self.throttle:
                break
            self.rt.step_pane()
            stepped += 1
        self.busy_s += self._clock() - c0
        return stepped

    def close(self, t_end: int) -> None:
        """Stream end: flush the reorder buffer, release the step limit."""
        c0 = self._clock()
        self.throttle = None
        if self.reorder is not None:
            self._ingest(self.reorder.flush())
        self._safe_end = max(self._safe_end, t_end)
        self.busy_s += self._clock() - c0

    # ------------------------------------------------------------ exports

    def frontier(self) -> FrontierSnapshot:
        if self.reorder is not None:
            wm = self.reorder.watermark
            sealed = self.reorder.sealed_end
        else:
            wm = self._safe_end - 1
            sealed = (self._safe_end // self.pane) * self.pane
        return FrontierSnapshot(shard=self.shard_id, watermark=wm,
                                sealed_end=sealed, processed_end=self.t_now)

    def results(self) -> dict:
        c0 = self._clock()
        out = self.rt.results()
        self.busy_s += self._clock() - c0
        return out

    # The read-side accessors below exist so the service never reaches
    # through ``w.rt`` directly: a process-mode proxy can then forward the
    # same calls over its command pipe instead of exposing live state.

    def stats(self) -> RunStats:
        return self.rt.stats

    def accountant(self):
        return self.rt.accountant

    def controller_state(self):
        return self.rt.controller.state()

    def pending_flush(self) -> bool:
        return len(self.rt._backlog) > 0

    def obs_registry(self):
        return self.obs.registry if self.obs is not None else None

    def shutdown(self) -> None:
        self.rt.shutdown()       # joins per-shard pipelined flush workers

    def summary(self) -> dict:
        """The shard's read side.  ``executor_launches`` counts this shard's
        bucket launches; ``kernel_launches`` are the kernels' counters of the
        process the worker runs in (all shards of a serial or thread drive
        share them; a process-mode worker has its own), and
        ``foreign_modules`` lists any module of the JAX package or of jax
        that this process has imported (none is expected)."""
        return {
            "shard": self.shard_id,
            "busy_s": self.busy_s,
            "t_now": self.t_now,
            "overload": self.rt.metrics.summary(),
            "controller": self.rt.controller.state(),
            "late": self.late_total,
            "expired": self.expired_total,
            "ingress_dropped": self.rt.queue.dropped,
            "executor_launches": self.rt.rt.executor.launches,
            "kernel_launches": ops.kernel_launches(),
            "foreign_modules": foreign_modules(),
        }


class ShardedHamletService:
    """N shard workers behind one router, admission controller and aligner.

    ``ingest`` accepts wire chunks in arrival order (time-sorted inside a
    chunk; across chunks arbitrary when ``eventtime`` is on), ``close``
    seals the stream, ``results``/``stats``/``error_report``/``collect``
    are the merged read side.  ``run`` is the batch convenience driver.
    ``backend``/``device`` go to every shard (module docstring).
    """

    def __init__(self, workload: Workload,
                 cfg: ShardServiceConfig | None = None, *, policy=None,
                 backend: str = "cuda", device=None,
                 clock=time.perf_counter):
        self.workload = workload
        self.cfg = cfg = cfg if cfg is not None else ShardServiceConfig()
        # raises when a GPU is asked for (the default) and none is present
        self.backend = backend
        self.device = ops.resolve_device(backend, device)
        self.placement = PlacementTable(cfg.n_shards,
                                        cfg.groups_per_tenant,
                                        replicas=cfg.ring_replicas)
        shard_cfg = self._shard_overload_cfg()
        self._mode = cfg.drive_mode
        if self._mode == "process":
            from .procdrive import ProcShardWorker
            self.workers = [
                ProcShardWorker(s, workload, shard_cfg, policy=policy,
                                backend=backend,
                                device=None if self.device is None
                                else str(self.device),
                                eventtime=cfg.eventtime,
                                skew=cfg.skew,
                                lateness_horizon=cfg.lateness_horizon,
                                obs=cfg.obs, clock=clock)
                for s in range(cfg.n_shards)]
            for w in self.workers:       # spawns overlap; then handshake
                w.wait_ready()
        else:
            self.workers = [
                ShardWorker(s, workload, shard_cfg, policy=policy,
                            backend=backend, device=self.device,
                            eventtime=cfg.eventtime,
                            skew=cfg.skew,
                            lateness_horizon=cfg.lateness_horizon,
                            obs=Observability.disabled() if cfg.obs
                            else None,
                            clock=clock)
                for s in range(cfg.n_shards)]
        self.pane = self.workers[0].pane
        self.admission = GlobalAdmissionController(
            workload, cfg.overload, mode=cfg.admission, pane=self.pane)
        self.aligner = WatermarkAligner(
            cfg.n_shards, align_every=cfg.align_every_panes * self.pane,
            max_lag_epochs=cfg.max_lag_epochs)
        self._within = {qname: max(workload.atomic[i].within for i in idxs)
                        for qname, idxs, _ in workload.combines}
        self._max_seen = -1
        self._moves: list[_PendingMove] = []
        self._closed = False
        self.chunks = 0
        self.router_busy_s = 0.0
        self.drive_cycles = 0
        self.drive_wall_s = 0.0     # measured wall clock across drive cycles
        self._pool = (ThreadPoolExecutor(
            max_workers=cfg.n_shards, thread_name_prefix="shard")
            if self._mode == "thread" and cfg.n_shards > 1 else None)
        self._clock = clock

    def _shard_overload_cfg(self) -> OverloadConfig:
        cfg = self.cfg.overload
        if self.cfg.admission == "none":
            return cfg
        # the router owns actuation; shards observe latency but do not shed
        return replace(cfg, shed_policy="none", fixed_shed=None)

    # -------------------------------------------------------------- write

    def promise(self, t: int) -> None:
        """External order promise: no future arrival has ``time <= t``.

        The serving scheduler seals panes against the session watermark
        before forwarding, which is a stronger guarantee than the router's
        own max-seen heuristic — honouring it lets shards seal panes the
        routed chunks alone would leave open."""
        self._max_seen = max(self._max_seen, int(t))

    def ingest(self, chunk: EventBatch) -> None:
        """Route one arrival chunk and run a drive cycle."""
        if self._closed:
            raise RuntimeError("service is closed")
        c0 = self._clock()
        self.chunks += 1
        if len(chunk):
            self._max_seen = max(self._max_seen, int(chunk.time.max()))
        if self.admission.mode != "per_shard":
            chunk = self.admission.admit_global(chunk)
        subs = self._route(chunk)
        if self.admission.mode == "per_shard":
            subs = [self.admission.admit_for_shard(
                sub, self.workers[s].controller_state())
                for s, sub in enumerate(subs)]
        self.router_busy_s += self._clock() - c0
        hb = self._max_seen - self.cfg.skew if self.cfg.eventtime else None
        if self._pool is not None or self._mode == "process":
            # offers ride the worker tasks: ingest + drive overlap per shard
            self._drive(subs, hb)
            return
        for w, sub in zip(self.workers, subs):
            w.offer(sub, self._max_seen)
        if hb is not None:
            for w in self.workers:
                w.heartbeat(hb)
        self._drive()

    def _route(self, chunk: EventBatch) -> list[EventBatch]:
        if not len(chunk):
            return [chunk] * self.cfg.n_shards
        shard_of = self.placement.shard_of_groups(chunk.group)
        # pending moves route by time: < boundary to the source shard (its
        # placement entry is untouched until commit), >= boundary to the
        # target — no event at or past the boundary has arrived before the
        # move was registered, so the split is exact
        for mv in self._moves:
            hot = (chunk.group == mv.group) & (chunk.time >= mv.boundary)
            if hot.any():
                shard_of = np.where(hot, mv.dst, shard_of)
        return [chunk.select(np.nonzero(shard_of == s)[0])
                for s in range(self.cfg.n_shards)]

    def _drive(self, subs: list[EventBatch] | None = None,
               hb: int | None = None) -> None:
        """One drive cycle.  Serial mode: drive every worker in turn, then
        feed the aligner.  Thread mode: dispatch one task per worker onto
        the thread pool — (offer, heartbeat, drive) — and let the workers
        meet at the aligner's concurrent rendezvous; the cycle's wall
        clock is *measured*, not modeled.  Process mode: dispatch one
        ``cycle`` command per worker process, collect the replies (each
        carries the post-drive frontier), then feed the aligner in shard
        order — the same frontier sequence as the serial drive.
        Rebalance commits stay on the caller thread, strictly between
        cycles."""
        self._maybe_commit_moves()
        self.drive_cycles += 1
        c0 = self._clock()
        if self._mode == "process":
            safe = self._max_seen
            for s, w in enumerate(self.workers):
                w.cycle_async(subs[s] if subs is not None else None,
                              safe, hb)
            fronts = [w.cycle_wait() for w in self.workers]
            self.drive_wall_s += self._clock() - c0
            c0 = self._clock()
            for f in fronts:
                self.aligner.update(f)
            self.aligner.align()
            self.router_busy_s += self._clock() - c0
            return
        if self._pool is not None:
            safe = self._max_seen
            futs = [self._pool.submit(
                self._worker_cycle, w,
                subs[s] if subs is not None else None, safe, hb)
                for s, w in enumerate(self.workers)]
            for f in futs:
                f.result()
            self.drive_wall_s += self._clock() - c0
            self._maybe_commit_moves()
            return
        for w in self.workers:
            w.drive()
        self.drive_wall_s += self._clock() - c0
        self._maybe_commit_moves()
        c0 = self._clock()
        for w in self.workers:
            self.aligner.update(w.frontier())
        self.aligner.align()
        self.router_busy_s += self._clock() - c0

    def _worker_cycle(self, w: ShardWorker, sub: EventBatch | None,
                      safe_end: int, hb: int | None) -> None:
        """Per-worker task of one parallel drive cycle, on a pool thread
        whose current CUDA device is made the shard runtime's own.  The
        ``finally`` guarantees the rendezvous completes even when a worker
        errors — the exception still surfaces through the future, but no
        sibling deadlocks at the barrier."""
        try:
            with ops.on_device(w.device):
                if sub is not None:
                    w.offer(sub, safe_end)
                if hb is not None:
                    w.heartbeat(hb)
                w.drive()
        finally:
            self.aligner.arrive(w.frontier())

    def close(self) -> None:
        """Seal the stream: flush reorder buffers, drive every shard to the
        final pane boundary (releasing rebalance barriers on the way)."""
        if self._closed:
            return
        self._closed = True
        t_end = ((self._max_seen + self.pane) // self.pane) * self.pane
        for w in self.workers:
            w.close(t_end)
        stalls = 0
        while any(w.t_now < t_end for w in self.workers):
            before = [w.t_now for w in self.workers]
            self._drive()
            stalls = stalls + 1 if [w.t_now for w in self.workers] == before \
                else 0
            if stalls > 2:
                raise RuntimeError(
                    "close() stalled; a rebalance barrier cannot be "
                    f"reached (moves={self._moves})")
        self._drive()
        for w in self.workers:
            w.shutdown()       # joins flush workers / worker processes
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ---------------------------------------------------------- rebalance

    def plan_rebalance(self, group: int, to_shard: int) -> int:
        """Register a targeted move of ``group``; returns the pane-aligned
        handoff boundary.  Only the two involved shards barrier (cap their
        pane clocks at the boundary); the move commits — open-window state
        handed off, placement overridden — once both reach it."""
        if self._mode == "process":
            raise NotImplementedError(
                "rebalance is not supported with parallel='process': the "
                "open-window instance handoff would require shipping live "
                "engine state across the process boundary")
        g, dst = int(group), int(to_shard)
        if not (0 <= dst < self.cfg.n_shards):
            raise ValueError(f"shard {dst} out of range")
        src = self.placement.shard_of(g)
        if src == dst:
            return self.workers[src].t_now
        lo = max(self.workers[src].t_now, self.workers[dst].t_now,
                 self._max_seen + 1)
        boundary = ((lo + self.pane - 1) // self.pane) * self.pane
        self._moves.append(_PendingMove(g, src, dst, boundary))
        self._apply_caps()
        return boundary

    def _apply_caps(self) -> None:
        caps: dict[int, int] = {}
        for mv in self._moves:
            for s in (mv.src, mv.dst):
                caps[s] = min(caps.get(s, mv.boundary), mv.boundary)
        for s, w in enumerate(self.workers):
            w.cap_t = caps.get(s)

    def _maybe_commit_moves(self) -> None:
        if not self._moves:
            return
        still: list[_PendingMove] = []
        for mv in self._moves:
            src, dst = self.workers[mv.src], self.workers[mv.dst]
            if src.t_now >= mv.boundary and dst.t_now >= mv.boundary:
                self._transfer(mv)
            else:
                still.append(mv)
        if len(still) != len(self._moves):
            self._moves = still
            self._apply_caps()

    def _transfer(self, mv: _PendingMove) -> None:
        """Hand the group's open-window instances to the target shard.

        Both shards sit exactly at the boundary (their caps made passing it
        impossible), so after flushing deferred micro-batches the source
        driver's instances are precisely the group's open windows at the
        boundary — and a fresh driver on the target at ``t_now=boundary``
        with those instances continues them bit-for-bit.  Shards not party
        to the move were never paused.  The
        instances are host numpy state (each open window's ``u`` vector),
        so they change runtimes as they are: no tensor moves.  The flushes
        run on the caller's thread, with the shards' device made current."""
        src, dst = self.workers[mv.src], self.workers[mv.dst]
        with ops.on_device(self.device):
            src.rt.flush_panes()
            dst.rt.flush_panes()
        drv = src.rt._drivers.pop(mv.group, None)
        if drv is not None:
            moved = _GroupDriver(dst.rt.rt, mv.group, mv.boundary)
            moved.insts = drv.insts
            dst.rt._drivers[mv.group] = moved
        self.placement.override(mv.group, mv.dst)

    # --------------------------------------------------------------- read

    def run(self, batch: EventBatch, chunk_ticks: int | None = None) -> dict:
        """Feed a time-sorted batch chunk-by-chunk, close, return results."""
        if len(batch):
            step = int(chunk_ticks) if chunk_ticks else self.pane
            t_hi = int(batch.time.max()) + 1
            for t0 in range(0, t_hi, step):
                self.ingest(batch.time_slice(t0, t0 + step))
        self.close()
        return self.results()

    def run_chunks(self, chunks) -> dict:
        """Feed wire chunks (e.g. ``DisorderedStream.chunks``), close,
        return results."""
        for chunk in chunks:
            self.ingest(chunk)
        self.close()
        return self.results()

    def results(self) -> dict:
        """Merged user-query results, keyed ``(query, group, w0)``.  Groups
        are disjoint per shard (and a rebalanced group's windows close on
        exactly one side of the boundary), so the union is collision-free."""
        out: dict = {}
        for w in self.workers:
            out.update(w.results())
        return out

    def aligned_results(self) -> tuple[dict, dict]:
        """Results split at the aligned frontier: ``(final, pending)``.

        A window is *final* when it closed at or before the aligned time
        and its owner is not currently a laggard; everything else —
        windows past the frontier, and every window of an excluded shard —
        is *pending* (complete on its shard, not yet fleet-final)."""
        at = self.aligner.aligned_time
        lag = self.aligner.laggards()
        final: dict = {}
        pending: dict = {}
        for s, w in enumerate(self.workers):
            for key, v in w.results().items():
                qname, _gk, w0 = key
                if s not in lag and w0 + self._within[qname] <= at:
                    final[key] = v
                else:
                    pending[key] = v
        return final, pending

    def stats(self) -> RunStats:
        """Fleet RunStats (count fields are shard-count invariant; wall
        timers sum)."""
        return RunStats.merged([w.stats() for w in self.workers])

    def error_report(self) -> dict:
        """Global certificate: router + shard accountants, cell-exact."""
        return self.admission.global_accountant(
            [w.accountant() for w in self.workers]).report()

    def window_bound(self, query: str, group: int, w0: int):
        """Global ``3^s`` / subset bound for one window (all accountants)."""
        return self.admission.global_accountant(
            [w.accountant() for w in self.workers]).window_bound(
                query, group, w0)

    def collect(self) -> dict:
        """Unified read side: router, alignment, per-shard tracks, merged
        metrics registry (when per-shard observability is on)."""
        out = {
            "router": {
                "admission": self.admission.summary(),
                "placement": {"n_shards": self.cfg.n_shards,
                              "version": self.placement.version,
                              "overrides": self.placement.overrides},
                "alignment": self.aligner.status(),
                "busy_s": self.router_busy_s,
                "chunks": self.chunks,
                "parallel": self.cfg.parallel,
                "drive_mode": self._mode,
                "drive_cycles": self.drive_cycles,
                "drive_wall_s": round(self.drive_wall_s, 4),
            },
            "shards": [w.summary() for w in self.workers],
            "stats": {k: v for k, v in vars(self.stats()).items()},
        }
        if self.cfg.obs:
            regs = [w.obs_registry() for w in self.workers]
            merged = Observability.disabled()
            for r in regs:
                if r is not None:
                    merged.registry.merge(r)
            out["metrics"] = merged.registry.collect()
            out["shard_metrics"] = [r.collect() if r is not None else {}
                                    for r in regs]
        return out
