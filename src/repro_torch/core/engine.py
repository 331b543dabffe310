"""HAMLET executor (paper Sec. 3.3 / Algorithm 1) and windowed runtime.

Execution model
---------------
Events arrive in panes (gcd of all windows/slides).  Within a pane, events of
the types relevant to a sharable component are segmented into *bursts*
(maximal same-type runs — Def. 10); each burst forms a new *graphlet*
(Def. 6).  Per burst the sharing policy decides which queries share the
graphlet (Sec. 4).  Shared propagation maintains per-event *coefficient rows*
over a small local snapshot basis:

    idx 0          gate entry      (start contributions; value = query's gate)
    idx 1..nu      x_u             graphlet-level snapshot per linear unit
                                   (Def. 8: value = sum of predecessor-type
                                   running aggregates)
    idx nu+1..     z               event-level snapshots for divergent events
                                   (Def. 9: predicate differences)

Four-phase pipeline (plan → execute → finalize → fold)
------------------------------------------------------
A pane is processed in three engine phases plus the runtime's window fold:

1. **plan** — the *prologue* runs batched across all K panes of a
   micro-batch flush (:meth:`PaneProcessor.plan_prologues`): one
   concatenated relevance filter, one run-length segmentation (memoized on
   the flush's type sequence — the same structural recurrence the plan
   cache banks on), and one stacked per-(query, type) predicate pass over
   every event of each type across the whole flush, sliced back per pane;
   the packed signature bytes the cache probe consumes are assembled in
   the same pass.  The order-sensitive *finish* then walks panes in
   submission order: the sharing policy decides each burst's groups (a
   whole-pane decision memo keyed on the divergence image replays
   decisions while the running event count stays inside the policy's
   replay-stable interval), and each group's masks/adjacency/injection
   rows are captured as propagation *jobs*.  Nothing here depends on the
   running aggregates, so the whole pane plans up front.  The structural
   output of this phase is memoized in a
   :class:`~repro_torch.core.plan_cache.PanePlanCache`: the cache key is the
   pane signature — type run-length encoding, packed per-burst predicate /
   edge-mask bits, negation hits, and the optimizer's decided groups — so a
   repeated pane shape skips group construction, adjacency/injection-row
   building and the snapshot column layout entirely and only swaps in fresh
   attribute data (or reuses the cached step list zero-copy).  The sharing
   decision is recomputed every pane and lives in the *key*, so plan reuse
   never freezes the share/no-share choice.
2. **execute** — jobs go to a :class:`~repro_torch.core.batch_exec
   .PaneBatchExecutor`, which buckets them by size (ragged edges padded
   where exact) and solves each bucket with **one** batched launch of the
   masked prefix-propagation primitive (``repro_torch.kernels``) or the dense
   closed form.  Two rounds: count-unit jobs first, then the sum-unit jobs
   that inject their coefficients.  A :class:`PaneMicroBatcher` extends the
   backlog *across panes*: up to ``micro_batch`` planned panes flush
   together, one launch per size bucket per K panes, with finalize deferred
   per pane.
3. **finalize** — executed coefficients fold into per-query *state
   functionals* (linear maps over the pane-entry state channels), so the
   pane yields one transfer matrix ``M[q]`` per query.  By default this
   phase runs through the :class:`~repro_torch.core.fold_exec.FoldExecutor`: the
   pane's steps are *levelized* (each per-query chain of graphlets — and
   its negation gates — stays strictly ordered; query-disjoint steps share
   a level) and every level folds as one stacked launch per shape bucket,
   across the pane **and** across every pane of a micro-batch flush.  The
   level schedule is cached on the :class:`~repro_torch.core.plan_cache.PanePlan`
   and the merged K-pane flush plan in the executor's own LRU, so warm
   panes skip fold planning entirely.  A *scannable* flush plan (no
   negation splits, one d == 0 bucket per round) carries a compiled
   execution form: on the torch/cuda backends the whole warm flush is
   **one** logical device launch
   (:func:`repro_torch.kernels.ops.fold_rounds_scan`: torch ops over the
   rounds on the device) and one host sync however deep the fold chain is
   — and on the numpy backend its fused host twin (one flush-wide
   segmented ``S`` fill + gather, then the identical stacked ops per
   round).  :meth:`PaneProcessor.finalize` keeps the sequential
   per-graphlet replay as the reference path (``fold_exec=False``).
4. **fold** — sliding-window instances advance with a single batched [C×C]
   matmul per pane — overlapping windows share all per-event work (the
   paper's pane sharing, Sec. 3.1).  Under micro-batching the drained panes
   fold as one stacked matmul chain, in stream order, so the fold stays
   bitwise identical to per-pane execution.  Window *replays* (the
   event-time revision path) go through the same executor:
   :meth:`FoldExecutor.fold_windows` is the batched twin of
   :func:`fold_panes`, re-folding every dirty window of a revision storm
   as one stacked launch set.

``RunStats`` carries wall-clock timers for all four phases (``plan_s`` /
``execute_s`` / ``finalize_s`` / ``fold_s``) and the plan-cache hit/miss
counters, so benchmarks read the phase split straight from the engine.

Observability: every layer accepts an optional ``obs=`` handle (a
:class:`repro_torch.obs.Observability` facade — span tracer, metrics registry,
sharing-decision audit log).  Phase spans are recorded from the *same*
``perf_counter`` readings that feed ``RunStats``, so phase spans sum to
the phase totals (a flush of K > 1 panes is one span a phase, timed once);
the steps inside the phases are timed the same way into the
``RunStats.STEP_FIELDS`` clocks and ``"step"`` spans; the audit log
captures each optimizer share/no-share decision verbatim as it enters the
plan-cache key.  With ``obs=None`` (default) every hook is a single
guarded attribute test — zero cost.

Host/device residency on a fully-warm flush: the host side is the batched
prologue (numpy vector passes), the plan-cache dict probes, and the
executor submit bookkeeping; everything shape-dependent was precomputed
into cached plans.  On the torch/cuda backends the execute phase launches
every bucket before syncing once via ``ops.device_get_all`` (bucket
outputs stay device-resident until that fetch — see ``batch_exec.py``),
and the fold phase is one scan program whose index operands and fresh
state already live on the device; its single fetch of the scanned state
is the flush's one fold-side sync point.  On the numpy backend the
executor reuses host staging buffers across flushes instead.

Devices: ``HamletRuntime`` defaults to ``backend="cuda"`` (the
hand-written kernels) on ``cuda:0`` and raises when no GPU is present;
``backend="torch"`` runs the plain PyTorch versions on any ``device``, and
``backend="np"`` the numpy host oracles.  MIN/MAX aggregates take the
side path of :mod:`.minmax` at window close, with their trend counts from
the same backend and device.

Trend counts grow like 2^g and overflow fixed-width types for realistic panes
(the paper is silent on this); the engine computes in float64 by default.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from time import perf_counter
from typing import ClassVar

import numpy as np

from ..kernels.ops import DENSE_B_MAX, resolve_device
from ..obs.trace import NULL_SPAN
from .batch_exec import PaneBatchExecutor, PropagateJob
from .events import EventBatch, StreamSchema, pane_size_for, split_panes
from .fold_exec import FoldExecutor
from .gc_hold import collector_held
from .plan_cache import PanePlan, PanePlanCache
from .query import AtomicQuery, Workload
from .template import QueryTemplate, build_template

__all__ = ["ComponentContext", "PaneProcessor", "PaneMicroBatcher",
           "HamletRuntime", "RunStats", "fold_panes", "vals_equal"]


# --------------------------------------------------------------------------
# static per-component context
# --------------------------------------------------------------------------


@dataclass
class _NegRule:
    kind: str                 # "leading" | "mid" | "trailing"
    before_local: np.ndarray  # local type indices whose A-sums are cut (mid)


class ComponentContext:
    """Prepared static info for one sharable component of the workload."""

    def __init__(self, schema: StreamSchema, queries: list[AtomicQuery]):
        self.schema = schema
        self.queries = list(queries)
        self.k = len(queries)
        self.templates: list[QueryTemplate] = [build_template(schema, q) for q in queries]

        pos: set[int] = set()
        neg: set[int] = set()
        for t in self.templates:
            pos |= set(np.nonzero(t.match)[0].tolist())
            neg |= set(np.nonzero(t.negative)[0].tolist())
        self.pos_type_ids = sorted(pos)
        self.neg_type_ids = sorted(neg)
        self.relevant_type_ids = sorted(pos | neg)
        # O(1) relevance filter: keep = lut[type_id] (np.isin re-sorts the
        # needle list on every pane; the plan prologue is on the warm path)
        self.relevant_lut = np.zeros(len(schema.types), dtype=bool)
        self.relevant_lut[self.relevant_type_ids] = True
        self.local = {e: i for i, e in enumerate(self.pos_type_ids)}

        units: set[tuple] = set()
        for q in queries:
            units |= set(u for u in q.units if u[0] in ("count", "sum"))
        from .snapshot import ChannelLayout

        self.units = tuple(sorted(units, key=lambda u: (u[0] != "count",
                                                        tuple(str(x) for x in u))))
        self.layout = ChannelLayout(list(self.units), self.pos_type_ids)
        self.nu = len(self.units)

        # channel-column lookup tables for the vectorized pane assembly
        self.a_cols = np.array(
            [[self.layout.a_idx(u, e) for e in self.pos_type_ids]
             for u in self.units], dtype=int).reshape(self.nu, -1)
        self.rp_cols = np.array([self.layout.rp_idx(u) for u in self.units],
                                dtype=int)

        t = len(self.pos_type_ids)
        self.start_flag = np.zeros((self.k, t), dtype=bool)
        self.end_flag = np.zeros((self.k, t), dtype=bool)
        self.match_flag = np.zeros((self.k, t), dtype=bool)
        self.kleene_flag = np.zeros((self.k, t), dtype=bool)
        # pt_mask[q, e, e'] over local positive types
        self.pt_mask = np.zeros((self.k, t, t), dtype=bool)
        for qi, tmpl in enumerate(self.templates):
            for e, el in self.local.items():
                self.start_flag[qi, el] = tmpl.start[e]
                self.end_flag[qi, el] = tmpl.end[e]
                self.match_flag[qi, el] = tmpl.match[e]
                self.kleene_flag[qi, el] = tmpl.kleene[e]
                for e2, el2 in self.local.items():
                    self.pt_mask[qi, el, el2] = tmpl.pred_type[e, e2]

        # negation rules: neg type id -> list[(query idx, _NegRule)]
        self.neg_rules: dict[int, list[tuple[int, _NegRule]]] = {}
        for qi, q in enumerate(self.queries):
            for nc in q.info.negatives:
                nid = schema.type_id(nc.neg_type)
                if nc.before is None:
                    rule = _NegRule("leading", np.array([], dtype=int))
                elif nc.after is None:
                    rule = _NegRule("trailing", np.array([], dtype=int))
                else:
                    bl = np.array(sorted(self.local[schema.type_id(b)]
                                         for b in nc.before), dtype=int)
                    rule = _NegRule("mid", bl)
                self.neg_rules.setdefault(nid, []).append((qi, rule))

        # per-(query,type) predicate/edge-pred lookup
        self._preds = {}
        self._edge_preds = {}
        for qi, q in enumerate(self.queries):
            for tname, ps in q.preds:
                self._preds[(qi, schema.type_id(tname))] = ps
            for tname, eps in q.edge_preds:
                self._edge_preds[(qi, schema.type_id(tname))] = eps

        # queries that share E+ (Def. 4): kleene flag per local type
        self.kleene_queries = {
            el: [qi for qi in range(self.k) if self.kleene_flag[qi, el]]
            for el in range(t)
        }
        # per-local-type query sets, hoisted out of the per-burst plan walk
        self.q_pos = {el: [qi for qi in range(self.k)
                           if self.match_flag[qi, el]] for el in range(t)}
        self.kle_pos = {el: [qi for qi in self.q_pos[el]
                             if self.kleene_flag[qi, el]] for el in range(t)}
        # type ids whose kleene query set is too wide for the dyn-fast
        # signature walk (empty on every shipped workload, so the per-pane
        # gate is one isdisjoint probe instead of a max() genexpr)
        self.kle_big = frozenset(tid for tid, el in self.local.items()
                                 if len(self.kle_pos[el]) >= 60)
        # local types with at least one edge-predicated query (the per-burst
        # edge-mask walk is skipped entirely for the rest)
        self.edge_pred_els = {
            el: any((qi, self.pos_type_ids[el]) in self._edge_preds
                    for qi in self.q_pos[el]) for el in range(t)}
        # sum units resolved to (unit idx, source type id, attr column | None)
        self.sum_unit_cols = [
            (ui, schema.type_id(u[1]),
             None if u[2] is None else schema.attr_col(u[2]))
            for ui, u in enumerate(self.units) if u[0] == "sum"]
        # which queries need the min/max side path
        self.minmax_queries = [qi for qi, q in enumerate(self.queries)
                               if any(u[0] == "minmax" for u in q.units)]

    def match_vec(self, qi: int, type_id: int, attrs: np.ndarray) -> np.ndarray:
        ps = self._preds.get((qi, type_id), ())
        m = np.ones(len(attrs), dtype=bool)
        for p in ps:
            m &= p.eval(attrs, self.schema)
        return m

    def match_stack(self, q_pos: list[int], type_id: int,
                    attrs: np.ndarray) -> np.ndarray:
        """Stacked :meth:`match_vec` for several queries: one ``[nq, n]``
        allocation instead of ``nq`` vectors plus an ``np.stack`` copy.
        Row ``i`` is bitwise ``match_vec(q_pos[i], ...)`` (elementwise
        predicate evaluation into a preallocated row)."""
        m = np.ones((len(q_pos), len(attrs)), dtype=bool)
        for i, qi in enumerate(q_pos):
            for p in self._preds.get((qi, type_id), ()):
                m[i] &= p.eval(attrs, self.schema)
        return m

    def edge_mask(self, qi: int, type_id: int, attrs: np.ndarray) -> np.ndarray | None:
        """[successor, predecessor]-oriented edge-predicate mask, or None."""
        eps = self._edge_preds.get((qi, type_id), ())
        if not eps:
            return None
        b = len(attrs)
        m = np.ones((b, b), dtype=bool)
        for ep in eps:
            col = attrs[:, self.schema.attr_col(ep.attr)]
            m &= ep.eval_pairs(col, col).T
        return m


# --------------------------------------------------------------------------
# statistics (drives the benefit model and the benchmark metrics)
# --------------------------------------------------------------------------


@dataclass
class RunStats:
    events: int = 0
    bursts: int = 0
    shared_bursts: int = 0
    split_bursts: int = 0
    graphlets: int = 0
    shared_graphlets: int = 0
    snapshots_created: int = 0
    snapshots_propagated: int = 0
    propagate_cells: int = 0      # total solved cells (rows x basis cols)
    decisions: int = 0
    # decisions the policy evaluated fresh (a v1 memo miss, a v2 call);
    # the rest replayed from its memo or the pane memo
    decide_evals: int = 0
    # event-level snapshots (Def. 9): sum of b^2 over the per-query edge
    # masks the per-burst walk built; rows of shared Kleene graphlets, and
    # those of them that carry an event-level snapshot (divergent rows)
    edge_mask_cells: int = 0
    shared_rows: int = 0
    snapshot_rows: int = 0
    panes: int = 0
    windows_emitted: int = 0
    # four-phase wall-clock split (seconds) — the engine times itself so
    # benchmark phase breakdowns need no external profiler
    plan_s: float = 0.0
    execute_s: float = 0.0
    finalize_s: float = 0.0
    fold_s: float = 0.0
    # plan-cache traffic (counted only when a cache is attached)
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    # step clocks (seconds) and counts inside the phases, kept only while
    # an Observability is attached (see STEP_FIELDS)
    plan_prologue_s: float = 0.0
    plan_decide_s: float = 0.0
    plan_edge_s: float = 0.0
    plan_build_s: float = 0.0
    execute_stage_s: float = 0.0
    execute_launch_s: float = 0.0
    execute_wait_s: float = 0.0
    execute_h2d_bytes: int = 0
    execute_d2h_bytes: int = 0
    finalize_prep_s: float = 0.0
    finalize_rounds_s: float = 0.0
    finalize_wait_s: float = 0.0
    ingress_s: float = 0.0
    admit_s: float = 0.0
    gc_s: float = 0.0
    gc_collections: int = 0
    gc_full_collections: int = 0
    # flushes drained while ``gc_hold.collector_held`` had the collector
    # off (counted always)
    gc_held_flushes: int = 0

    # Fields whose totals are invariant under group-disjoint sharding of the
    # stream: a fleet of runtimes processing a partition of the groups
    # produces the same sums as one runtime processing everything.  Wall
    # timers (meaningful only as totals) and plan-cache traffic (each
    # instance has its own cache, so hit/miss splits shift with placement)
    # are excluded — and so are the sharing/snapshot counters: the
    # share-or-split decision operates on the co-resident pane batch, so
    # which groups live together changes the sharing opportunities taken
    # (never the results).
    COUNT_FIELDS: ClassVar[tuple[str, ...]] = (
        "events", "bursts", "decisions", "panes", "windows_emitted")

    # The step clocks, read only with an Observability attached (all stay
    # 0 without one).  Plan's four lie inside ``plan_s`` (``plan_edge_s``:
    # the per-burst walk's edge masks and their packed signature bits);
    # what they leave of it is signature assembly and the plan-cache
    # lookup.  Execute's three tile ``execute_s`` (the submits' injection
    # rows and the executor's bucketing and stacking; the
    # ``ops.propagate*`` calls with their host-to-device copies; the fetch
    # and unpacking), as finalize's tile ``finalize_s`` with the fold
    # executor (flush plan and ``S``; the scan launch or host rounds; the
    # fetch and scatter), but not its sequential replay.  ``ingress_s`` / ``admit_s`` are the
    # streaming layer's ``offer`` and admission, outside the four phases;
    # ``gc_s`` / ``gc_collections`` the collector's pauses of the process,
    # ``gc_full_collections`` those of its full (generation-2) passes.
    STEP_FIELDS: ClassVar[tuple[str, ...]] = (
        "plan_prologue_s", "plan_decide_s", "plan_edge_s", "plan_build_s",
        "execute_stage_s", "execute_launch_s", "execute_wait_s",
        "execute_h2d_bytes", "execute_d2h_bytes",
        "finalize_prep_s", "finalize_rounds_s", "finalize_wait_s",
        "ingress_s", "admit_s", "gc_s", "gc_collections",
        "gc_full_collections")

    def merge(self, o: "RunStats") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(o, f))

    @classmethod
    def merged(cls, parts) -> "RunStats":
        """Fold many instances (e.g. one per shard) into a fleet total."""
        out = cls()
        for p in parts:
            out.merge(p)
        return out

    def counts(self) -> dict[str, int]:
        """The sharding-invariant count fields (see ``COUNT_FIELDS``)."""
        return {f: getattr(self, f) for f in self.COUNT_FIELDS}

    def phase_split(self) -> dict[str, float]:
        """Fractions of measured engine time per phase (sums to ~1)."""
        total = self.plan_s + self.execute_s + self.finalize_s + self.fold_s
        if total <= 0:
            return {"plan": 0.0, "execute": 0.0, "finalize": 0.0, "fold": 0.0}
        return {"plan": self.plan_s / total, "execute": self.execute_s / total,
                "finalize": self.finalize_s / total,
                "fold": self.fold_s / total}


# --------------------------------------------------------------------------
# pane processor (Algorithm 1 over one pane, producing transfer matrices)
# --------------------------------------------------------------------------


@dataclass
class _NegStep:
    """Negation rules that fired for one burst (applied during finalize)."""

    hits: list  # [(query idx, _NegRule)]


@dataclass
class _GroupPlan:
    """One graphlet's planned propagation: masks, adjacency, and job handles.

    Captured during the plan phase; coefficients arrive from the batched
    executor; the finalize phase folds them into the state functionals.
    """

    g: list
    el: int
    type_id: int
    attrs: np.ndarray
    b: int
    mvec: np.ndarray              # [len(g), b]
    epm: list
    shared: bool
    div: np.ndarray               # [b] divergence flags
    div_rows: np.ndarray
    live: np.ndarray
    dead: np.ndarray
    B_local: int
    z_ids: dict
    dense: bool
    em: np.ndarray | None         # in-burst adjacency (None when dense)
    start_q0: bool
    sum_units: list               # [(ui, injection values | None)]
    bi: int = -1                  # index of the source burst within the pane
    rows: list | None = None      # member rows within the burst's mvec stack
    base_c: np.ndarray | None = None  # count-round injection rows (cacheable)
    trivial: bool = False         # non-Kleene: zero adjacency, result == base

    # NOTE: job handles live on the _PendingPane (parallel ``jobs`` list),
    # never on the plan — group plans are immutable after construction so a
    # cached pane shape can be reused zero-copy across panes and micro-batch
    # members.


class _Prologue:
    """Order-independent phase-1 products of one pane: filtered events,
    burst runs, stacked match vectors with their signature byte images, and
    negation hits — everything :meth:`PaneProcessor._plan_finish` consumes
    that does not read mutable planner state.  Built per pane by
    :meth:`PaneProcessor._plan_prologue` or, for a whole micro-batch, in one
    stacked pass by :meth:`PaneProcessor.plan_prologues`."""

    __slots__ = ("ev", "runs", "mv_type", "mv_bytes", "neg_type", "present",
                 "has_edge", "codes", "runs_shape", "sig_mv")

    def __init__(self, ev, runs, mv_type, mv_bytes, neg_type, present,
                 has_edge, codes=None, runs_shape=None, sig_mv=None):
        self.ev = ev
        self.runs = runs
        self.mv_type = mv_type
        self.mv_bytes = mv_bytes
        self.neg_type = neg_type
        self.present = present
        self.has_edge = has_edge
        # per-type packed divergence images (pattern-based policies only):
        # tid -> [n_events] int64 coverage codes, sliced per burst by the
        # dyn-fast walk
        self.codes = codes or {}
        # precomputed ((tid, burst len), ...) signature prefix, shared by
        # every plan-cache key form; None on the unbatched path
        self.runs_shape = runs_shape
        # the match-bit bytes of every live type in ``present`` order —
        # the plan-cache key consumes this tuple as is
        self.sig_mv = sig_mv


class PaneProcessor:
    def __init__(self, ctx: ComponentContext, policy, backend: str = "cuda",
                 max_local_basis: int = 512, executor=None, plan_cache=None,
                 fold_exec=None, obs=None, comp: int = 0, device=None):
        self.ctx = ctx
        self.policy = policy
        self.backend = backend
        self.max_local_basis = max_local_basis
        self.obs = obs
        self.comp = comp
        self.executor = (executor if executor is not None
                         else PaneBatchExecutor(backend=backend,
                                                device=device))
        self.plan_cache: PanePlanCache | None = plan_cache
        self.fold_exec = fold_exec
        # policy traits probed once (the plan hot path reads them per pane)
        self._policy_static = getattr(policy, "decision_static", False)
        self._policy_pattern = getattr(policy, "pattern_based", False)
        # the PanePlan the most recent plan() hit or created (the fold
        # schedule is cached on it); None when planning uncached
        self._last_host: PanePlan | None = None
        # static sharing policies decide per (type, candidate set) only:
        # their group layout is memoized per local type
        self._static_groups: dict[int, tuple] = {}
        # divergence-image layout per local type (candidate rows, reference
        # row, start-flag diff) and burst-slice -> pattern-multiset memo for
        # the dyn-fast walk; parked on the (long-lived) context so warm
        # sweeps with fresh processors keep their memoized extraction
        if not hasattr(ctx, "kle_layout_memo"):
            ctx.kle_layout_memo = {}
            ctx.pats_memo = {}
            ctx.dyn_pane_memo = {}
            ctx.seg_memo = {}
        self._kle_layout: dict[int, tuple] = ctx.kle_layout_memo
        self._pats_cache: dict[bytes, tuple] = ctx.pats_memo
        # micro-batch segmentation memo: (ktype bytes, pane bounds) ->
        # (per-pane runs, per-type (tid, idx, off) layout)
        self._seg_memo: dict[tuple, tuple] = ctx.seg_memo
        # whole-pane decision-walk memo for the dyn-fast path: (runs shape,
        # per-type divergence-code bytes) -> [(n_lo, n_hi, groups_all, sig_t,
        # decisions, splits)] — valid while the running event count stays in
        # the intersection of the bursts' decision-replay intervals
        self._dyn_pane_memo: dict[tuple, list] = ctx.dyn_pane_memo

    # -- burst segmentation (Def. 10) --

    @staticmethod
    def _segment(type_ids: np.ndarray) -> list[tuple[int, slice]]:
        if len(type_ids) == 0:
            return []
        cut = np.nonzero(np.diff(type_ids))[0] + 1
        bounds = np.concatenate([[0], cut, [len(type_ids)]])
        return [(int(type_ids[bounds[i]]), slice(int(bounds[i]), int(bounds[i + 1])))
                for i in range(len(bounds) - 1)]

    # -- main entry --

    def process(self, pane: EventBatch, stats: RunStats) -> np.ndarray:
        """Process one pane; returns per-query transfer matrices M [k, C, C].

        Single-pane convenience over the deferred phase API: plan the pane,
        run both execute rounds through the shared executor, finalize.
        Micro-batching callers drive the phases via :class:`PaneMicroBatcher`
        instead.
        """
        mb = PaneMicroBatcher(self.executor, k=1, fold_exec=self.fold_exec,
                              obs=self.obs)
        pend = mb.submit(self, pane, stats)
        mb.drain()
        return pend.finalize()

    # -- phase 1: plan --

    def plan(self, pane: EventBatch, stats: RunStats) -> list:
        """Phase 1: produce the pane's ordered step list (timed)."""
        t0 = perf_counter()
        # counts saturate to inf past float64 range (documented overflow
        # semantics) — keep the whole pipeline quiet about it
        with np.errstate(over="ignore", invalid="ignore"):
            steps = self._plan_pane(pane, stats)
        dt = perf_counter() - t0
        stats.plan_s += dt
        obs = self.obs
        if obs is not None:
            obs.pane_phase("plan", t0, dt,
                           key=obs.pane_key(pane) if obs.tracing else None)
        return steps

    def _plan_pane(self, pane: EventBatch, stats: RunStats) -> list:
        return self._plan_finish(pane, self._plan_prologue(pane), stats)

    def _wants_codes(self, el: int) -> bool:
        """Whether the prologue should pack a divergence image for this
        local type (pattern-based policy with a real sharing choice)."""
        return (self._policy_pattern
                and len(self.ctx.kle_pos[el]) >= 2
                and len(self.ctx.kle_pos[el]) < 60)

    def _div_codes(self, el: int, mv: np.ndarray) -> np.ndarray:
        """Packed per-event divergence image: bit ``j`` of an event's code
        marks candidate ``j`` diverging from the reference there (the
        stacked, edge-free twin of :meth:`_divergence_rows`).  Elementwise
        per event, so slices of a concatenated pass equal per-pane calls."""
        ctx = self.ctx
        lay = self._kle_layout.get(el)
        if lay is None:
            q_pos, kle = ctx.q_pos[el], ctx.kle_pos[el]
            ri = q_pos.index(kle[0])
            idx = np.array([q_pos.index(qi) for qi in kle])
            sdiff = ctx.start_flag[kle, el] != ctx.start_flag[kle[0], el]
            lay = self._kle_layout[el] = (
                ri, idx, sdiff if sdiff.any() else None,
                1 << np.arange(len(kle), dtype=np.int64))
        ri, idx, sdiff, bits = lay
        D = mv[idx] != mv[ri]
        if sdiff is not None:
            D[sdiff] |= mv[idx[sdiff]] | mv[ri]
        return bits @ D

    def _plan_prologue(self, pane: EventBatch) -> "_Prologue":
        """The order-independent half of phase 1: event filtering, burst
        segmentation, and the stacked per-(query, type) predicate pass.

        Touches no mutable planner state (``stats``, the benefit model, the
        plan cache), so the micro-batcher may run it for all K panes of a
        flush in one batched pass (:meth:`plan_prologues`) before the
        order-sensitive :meth:`_plan_finish` walks replay in submission
        order.
        """
        ctx = self.ctx
        keep = ctx.relevant_lut[pane.type_id]
        ev = pane.select(np.nonzero(keep)[0])
        runs = self._segment(ev.type_id)
        if not runs:
            return _Prologue(ev, runs, {}, {}, {}, [], False)

        # stacked per-type predicate evaluation: one vectorized pass per
        # (query, type) over *all* of the pane's events of that type, across
        # every burst at once, instead of a Python predicate walk per burst.
        # The transposed byte image of each stack doubles as the signature
        # source: a burst's exact match bits are a contiguous slice of it.
        mv_type: dict[int, np.ndarray] = {}
        mv_bytes: dict[int, bytes] = {}
        neg_type: dict[int, list] = {}
        codes: dict[int, np.ndarray] = {}
        cache = self.plan_cache
        present: list[int] = []
        has_edge = False
        for tid_arr in np.unique(ev.type_id):
            tid = int(tid_arr)
            present.append(tid)
            idx = np.nonzero(ev.type_id == tid)[0]
            attrs_t = ev.attrs[idx]
            if tid in ctx.neg_rules:
                neg_type[tid] = [(qi, rule, ctx.match_vec(qi, tid, attrs_t))
                                 for qi, rule in ctx.neg_rules[tid]]
            el = ctx.local.get(tid)
            if el is not None and ctx.q_pos[el]:
                if ctx.edge_pred_els[el]:
                    has_edge = True
                mv_type[tid] = ctx.match_stack(ctx.q_pos[el], tid, attrs_t)
                if cache is not None:
                    mv_bytes[tid] = np.ascontiguousarray(
                        mv_type[tid].T).tobytes()
                if self._wants_codes(el):
                    codes[tid] = self._div_codes(el, mv_type[tid])
        return _Prologue(ev, runs, mv_type, mv_bytes, neg_type, present,
                         has_edge, codes,
                         sig_mv=(tuple(mv_bytes[t] for t in present
                                       if t in mv_bytes)
                                 if cache is not None else None))

    def _seg_build(self, panes: list[EventBatch]) -> tuple:
        """Cold half of :meth:`plan_prologues`: the full index plan for one
        flush type-shape.  Returns ``(kidx, kb, ktype, perm, runs_per,
        layout, shapes_per)`` where ``kidx`` gathers the kept rows out of
        the pane-major attrs concatenation, ``perm`` gathers them in
        type-major order for the stacked predicate pass, and each layout
        entry carries every ctx-static per-type datum the warm loop reads
        (element id, q_pos, negation rules, edge/code flags, per-pane
        split offsets, type-major slice bounds)."""
        ctx = self.ctx
        type_cat = np.concatenate([p.type_id for p in panes])
        pb = np.cumsum([0] + [len(p) for p in panes])
        keep = ctx.relevant_lut[type_cat]
        kidx = np.nonzero(keep)[0]
        ktype = type_cat[kidx]
        kb = np.concatenate([[0], np.cumsum(keep)])[pb].tolist()
        # one RLE pass with forced cuts at pane boundaries: each pane's
        # runs are the consecutive cut pairs inside its slice
        cut = (np.nonzero(np.diff(ktype))[0] + 1) if len(ktype) else \
            np.zeros(0, dtype=int)
        cuts = np.unique(np.concatenate([cut, kb]))
        pos = np.searchsorted(cuts, kb)  # pane bounds are all in cuts
        cuts_l = cuts.tolist()
        tids_l = (ktype[cuts[:-1]].tolist() if len(ktype) else [])
        runs_per = []
        for i in range(len(panes)):
            base = cuts_l[pos[i]]
            runs_per.append([
                (tids_l[j], slice(cuts_l[j] - base, cuts_l[j + 1] - base))
                for j in range(pos[i], pos[i + 1])])
        layout, perm_parts, lo = [], [], 0
        all_static = True
        for tid in sorted(set(tids_l)):
            idx = np.nonzero(ktype == tid)[0]
            el = ctx.local.get(tid)
            live = el is not None and bool(ctx.q_pos[el])
            qp = ctx.q_pos[el] if live else None
            neg = ctx.neg_rules.get(tid)
            wants = live and self._wants_codes(el)
            stat = None
            if live and not any(ctx._preds.get((qi, tid)) for qi in qp):
                # predicate-free type: the stacked match pass is all-ones —
                # a pure function of the type sequence — so the stack, its
                # signature byte image, and the divergence codes are
                # seg-static (consumers only ever read/slice them)
                mv_cat = np.ones((len(qp), len(idx)), dtype=bool)
                stat = (mv_cat, mv_cat.T.tobytes(), len(qp),
                        self._div_codes(el, mv_cat) if wants else None)
            elif live:
                all_static = False
            if neg is not None:
                all_static = False
            layout.append((tid, np.searchsorted(idx, kb).tolist(), el, live,
                           el is not None and ctx.edge_pred_els[el],
                           neg, qp, wants, lo, lo + len(idx), stat))
            perm_parts.append(kidx[idx])
            lo += len(idx)
        perm = (np.concatenate(perm_parts) if perm_parts
                else np.zeros(0, dtype=np.intp))
        shapes_per = [tuple((tid, sl.stop - sl.start) for tid, sl in rs)
                      for rs in runs_per]
        static_pros = None
        if all_static:
            # every live type is predicate-free and no type carries
            # negation rules: the whole per-pane prologue product except
            # the filtered events themselves is seg-static
            static_pros = []
            for i in range(len(panes)):
                mv_d, mvb_d, codes_d, pres = {}, {}, {}, []
                edge = False
                for (tid, off, el, live, edge_t, neg, qp, wants,
                     lo_t, hi_t, stat) in layout:
                    lo2, hi2 = off[i], off[i + 1]
                    if lo2 == hi2:
                        continue
                    pres.append(tid)
                    if stat is not None:
                        mv_cat, img_b, nq, codes_cat = stat
                        if edge_t:
                            edge = True
                        mv_d[tid] = mv_cat[:, lo2:hi2]
                        mvb_d[tid] = img_b[lo2 * nq:hi2 * nq]
                        if codes_cat is not None:
                            codes_d[tid] = codes_cat[lo2:hi2]
                sig = tuple(mvb_d[t] for t in pres if t in mvb_d)
                static_pros.append((mv_d, mvb_d, codes_d, pres, edge, sig))
        return (kidx, kb, ktype, perm, runs_per, layout, shapes_per,
                static_pros)

    def plan_prologues(self, panes: list[EventBatch]) -> list["_Prologue"]:
        """Batched phase-1 prologue for K panes of one micro-batch flush.

        One ``np.isin`` filter, one run-length segmentation (with forced
        cuts at pane boundaries), and one predicate-stack pass per (query,
        type) run over the *concatenation* of all K panes; per-pane results
        are slices of the stacked arrays.  Predicates evaluate elementwise
        and the byte images are row-major, so every slice — match vectors,
        runs, signature bytes — is bitwise identical to the per-pane
        :meth:`_plan_prologue` output.
        """
        if len(panes) == 1:
            return [self._plan_prologue(panes[0])]
        ctx = self.ctx
        cache = self.plan_cache
        # The whole index plan — keep indices, pane bounds, RLE runs, the
        # per-type layout, and the type-major gather permutation — is a
        # pure function of the pane type *sequences*, the recurrence the
        # plan cache already banks on, so it is memoized on their raw
        # bytes.  A warm flush then does one attrs concatenation plus two
        # gathers before the predicate pass.
        seg_key = tuple(p.type_id.tobytes() for p in panes)
        seg = self._seg_memo.get(seg_key)
        if seg is None:
            if len(self._seg_memo) >= 2048:
                self._seg_memo.clear()
            seg = self._seg_memo[seg_key] = self._seg_build(panes)
        (kidx, kb, ktype, perm, runs_per, layout, shapes_per,
         static_pros) = seg
        raw = np.concatenate([p.attrs for p in panes])
        # each pane's filtered view is a zero-copy row slice of the
        # pane-major gather (panes were validated at construction, so the
        # dataclass re-validation in select() is skipped).  These views
        # are plan-internal: the finish walk reads only ``len`` and
        # ``attrs``, so the time/group columns are never materialized.
        attrs_sel = raw[kidx]
        schema = panes[0].schema
        evs = []
        for i in range(len(panes)):
            ev = object.__new__(EventBatch)
            ev.schema = schema
            ev.type_id = ktype[kb[i]:kb[i + 1]]
            ev.attrs = attrs_sel[kb[i]:kb[i + 1]]
            ev.time = ev.group = ev.seq = None
            evs.append(ev)
        pros = [None] * len(panes)
        if static_pros is not None:
            # fully static flush shape: the attrs gather above is the only
            # content-dependent work left in phase 1's prologue
            for i, ev in enumerate(evs):
                mv_d, mvb_d, codes_d, pres, edge, sig = static_pros[i]
                pros[i] = _Prologue(ev, runs_per[i], mv_d,
                                    mvb_d if cache is not None else {},
                                    {}, pres, edge, codes_d, shapes_per[i],
                                    sig if cache is not None else None)
            return pros
        # stacked predicate pass over each type's concatenated events; the
        # per-pane split points were precomputed into the layout
        attrs_ts = raw[perm]       # type-major rows for the predicate pass
        mv_per: list[dict] = [{} for _ in panes]
        mvb_per: list[dict] = [{} for _ in panes]
        neg_per: list[dict] = [{} for _ in panes]
        codes_per: list[dict] = [{} for _ in panes]
        pres_per: list[list] = [[] for _ in panes]
        sig_per: list[list] = [[] for _ in panes]
        edge_per = [False] * len(panes)
        for tid, off, el, live, edge_t, neg_rules, qp, wants_codes, \
                lo_t, hi_t, stat in layout:
            attrs_t = attrs_ts[lo_t:hi_t]
            neg_cat = ([(qi, rule, ctx.match_vec(qi, tid, attrs_t))
                        for qi, rule in neg_rules]
                       if neg_rules is not None else None)
            codes_cat = None
            if live:
                if stat is not None:
                    mv_cat, img_b, row_b, codes_cat = stat
                    if cache is None:
                        img_b = None
                else:
                    mv_cat = ctx.match_stack(qp, tid, attrs_t)
                    # one byte image for the whole type; per-pane signature
                    # bytes are plain byte-string slices of it (row stride
                    # = query count, C order of the transposed image)
                    img_b = mv_cat.T.tobytes() if cache is not None else None
                    row_b = mv_cat.shape[0] * mv_cat.itemsize
                    if wants_codes:
                        codes_cat = self._div_codes(el, mv_cat)
            for i in range(len(panes)):
                lo, hi = off[i], off[i + 1]
                if lo == hi:
                    continue
                pres_per[i].append(tid)
                if neg_cat is not None:
                    neg_per[i][tid] = [(qi, rule, m[lo:hi])
                                      for qi, rule, m in neg_cat]
                if live:
                    if edge_t:
                        edge_per[i] = True
                    mv_per[i][tid] = mv_cat[:, lo:hi]
                    if img_b is not None:
                        mvb = img_b[lo * row_b:hi * row_b]
                        mvb_per[i][tid] = mvb
                        sig_per[i].append(mvb)
                    if codes_cat is not None:
                        codes_per[i][tid] = codes_cat[lo:hi]
        for i, ev in enumerate(evs):
            pros[i] = _Prologue(ev, runs_per[i], mv_per[i], mvb_per[i],
                                neg_per[i], pres_per[i], edge_per[i],
                                codes_per[i], shapes_per[i],
                                tuple(sig_per[i]) if cache is not None
                                else None)
        return pros

    def _plan_finish(self, pane: EventBatch, pro: "_Prologue",
                     stats: RunStats) -> list:
        """The order-sensitive half of phase 1: stats evolution, sharing
        decisions (the benefit model reads the running event count), plan
        cache traffic, and step construction.  Must run in pane submission
        order."""
        ctx = self.ctx
        self._last_host = None
        obs = self.obs
        audit = obs.audit if obs is not None else None
        pkey = (obs.pane_key(pane)
                if obs is not None and (audit is not None or obs.tracing)
                else None)

        ev = pro.ev
        stats.events += len(ev)
        stats.panes += 1
        runs = pro.runs
        stats.bursts += len(runs)
        if not runs:
            return []
        mv_type = pro.mv_type
        mv_bytes = pro.mv_bytes
        neg_type = pro.neg_type
        present = pro.present
        has_edge = pro.has_edge
        cache = self.plan_cache

        # sharing decisions that never read the divergence structure
        # (AlwaysShare / NeverShare) skip the per-burst divergence pass
        static_policy = self._policy_static

        # whole-pane fast signature: with a static policy, no negation types
        # and no edge predicates in the pane, the structural plan is fully
        # determined by the run-length encoding plus the stacked match bits
        # — the per-burst signature walk is skipped entirely
        fast = (cache is not None and static_policy and not neg_type
                and not has_edge)
        # dynamic-policy fast signature: pattern-based policies (the benefit
        # model reads d_rows only through coverage-pattern counts) get the
        # same whole-pane key, extended with the recomputed sharing decision
        # — the fingerprint pass below reruns the benefit model per pane on
        # the *exact* compressed decision inputs, so a benefit flip lands in
        # a different cache entry instead of freezing the stale decision
        dyn_fast = (cache is not None and not static_policy
                    and self._policy_pattern
                    and not neg_type and not has_edge
                    and ctx.kle_big.isdisjoint(mv_type))
        key: tuple | None = None
        dyn_groups: list | None = None
        rs = pro.runs_shape
        if rs is None and cache is not None:
            rs = tuple((tid, sl.stop - sl.start) for tid, sl in runs)
        sig_mv = pro.sig_mv
        if sig_mv is None and cache is not None:
            sig_mv = tuple(mv_bytes[t] for t in present if t in mv_bytes)
        if fast:
            key = ("F", self.max_local_basis, rs, sig_mv)
            plan = cache.get(key)
            if plan is not None:
                return self._hit(plan, stats, pkey, self._instantiate_fast,
                                 runs, ev, mv_type)
            stats.plan_cache_misses += 1
            if obs is not None:
                obs.cache_event(False, pkey)
        elif dyn_fast:
            t_d = perf_counter() if obs is not None else 0.0
            dyn_groups, key = self._dyn_fast_groups(runs, ev, mv_type,
                                                    mv_bytes, present, stats,
                                                    codes=pro.codes,
                                                    pkey=pkey, audit=audit,
                                                    runs_shape=rs,
                                                    sig_mv=sig_mv)
            if obs is not None:
                obs.step("plan.decide", "plan_decide_s", t_d, perf_counter(),
                         stats)
            plan = cache.get(key)
            if plan is not None:
                return self._hit(plan, stats, pkey, self._instantiate_fast,
                                 runs, ev, mv_type)
            stats.plan_cache_misses += 1
            if obs is not None:
                obs.cache_event(False, pkey)
        dec0 = stats.decisions

        # per-burst planning inputs + the exact pane signature.  The
        # signature stores full discriminating bytes (mask-bit slices, the
        # decided groups) — see core/plan_cache.py for why nothing is hashed
        # lossily.
        cursor: dict[int, int] = {}
        plan_bursts: list = []
        key_groups: list = []
        sig: list = [(self.max_local_basis, rs)]
        for ri_, (tid, sl) in enumerate(runs):
            b = sl.stop - sl.start
            c = cursor.get(tid, 0)
            cursor[tid] = c + b

            # negative-type handling (Sec. 5): applies per query with a rule
            hits = None
            if tid in neg_type:
                hits = [(qi, rule) for qi, rule, m in neg_type[tid]
                        if m[c:c + b].any()]
                if not hits:
                    hits = None

            burst = None
            sig_part: tuple | None = None
            el = ctx.local.get(tid)
            if el is not None and ctx.q_pos[el]:
                q_pos = ctx.q_pos[el]
                nq = len(q_pos)
                attrs = ev.attrs[sl]
                mvec = mv_type[tid][:, c:c + b]
                if ctx.edge_pred_els[el]:
                    t_e = perf_counter() if obs is not None else 0.0
                    epm = [ctx.edge_mask(qi, tid, attrs) for qi in q_pos]
                    epm_sig = tuple(
                        None if m is None else np.packbits(m).tobytes()
                        for m in epm)
                    stats.edge_mask_cells += b * b * sum(m is not None
                                                         for m in epm)
                    if obs is not None:
                        obs.step("plan.edge", "plan_edge_s", t_e,
                                 perf_counter(), stats)
                else:
                    epm = [None] * nq
                    epm_sig = None

                # sharing decision (Sec. 4): candidates have E+ (Def. 4).
                # Decided fresh on every pane — the benefit model tracks the
                # running event count — and folded into the cache key below.
                # Static policies (decision independent of the burst) reuse
                # their memoized per-type group layout; a dyn-fast miss
                # injects the fingerprint pass's decisions (already counted).
                kle = ctx.kle_pos[el]
                memo = (self._static_groups.get(el) if static_policy
                        else None)
                if dyn_groups is not None:
                    groups = dyn_groups[ri_]
                    groups_sig = None
                elif memo is not None:
                    groups, groups_sig = memo
                    if len(kle) >= 2:
                        stats.decisions += 1
                        if audit is not None:
                            audit.record(pane=pkey, comp=self.comp, el=el,
                                         candidates=kle, decided=groups_sig,
                                         b=b, n=stats.events)
                else:
                    groups = []
                    if len(kle) >= 2:
                        # a clock a burst, and no span
                        t_d = perf_counter() if obs is not None else 0.0
                        d_rows = (None if static_policy else
                                  self._divergence_rows(q_pos, kle, el,
                                                        mvec, epm))
                        shared_sets = self.policy.decide(
                            ctx=ctx, el=el, candidates=kle, d_rows=d_rows,
                            b=b, n=stats.events, stats=stats)
                        if obs is not None:
                            stats.plan_decide_s += perf_counter() - t_d
                        in_shared = set(qq for s in shared_sets for qq in s)
                        groups.extend([s for s in shared_sets
                                       if len(s) >= 2])
                        groups.extend([[qi] for s in shared_sets
                                       if len(s) == 1 for qi in s])
                        groups.extend([[qi] for qi in kle
                                       if qi not in in_shared])
                    else:
                        groups.extend([[qi] for qi in kle])
                    groups.extend([[qi] for qi in q_pos if qi not in kle])
                    groups_sig = tuple(map(tuple, groups))
                    if static_policy:
                        self._static_groups[el] = (groups, groups_sig)
                    if audit is not None and len(kle) >= 2:
                        audit.record(
                            pane=pkey, comp=self.comp, el=el, candidates=kle,
                            decided=groups_sig, b=b, n=stats.events,
                            benefit=getattr(self.policy, "last_benefit",
                                            None),
                            patterns=getattr(self.policy, "last_patterns",
                                             None))
                burst = (tid, el, attrs, b, q_pos, mvec, epm, groups)
                if cache is not None and not fast and not dyn_fast:
                    sig_part = (mv_bytes[tid][c * nq:(c + b) * nq], epm_sig,
                                groups_sig)

            plan_bursts.append((hits, burst))
            if cache is not None and not fast and not dyn_fast:
                sig.append((
                    tid,
                    None if hits is None else tuple(qi for qi, _ in hits),
                    sig_part))
                if audit is not None:
                    key_groups.append(None if burst is None else groups_sig)

        if cache is not None and not fast and not dyn_fast:
            key = tuple(sig)
            if audit is not None:
                audit.note_pane(pkey, tuple(key_groups), comp=self.comp)
            plan = cache.get(key)
            if plan is not None:
                return self._hit(plan, stats, pkey, self._instantiate,
                                 plan_bursts)
            stats.plan_cache_misses += 1
            if obs is not None:
                obs.cache_event(False, pkey)
        t_b = perf_counter() if obs is not None else 0.0
        before = cache.snapshot_stats(stats) if cache is not None else None

        steps = self._build_steps(plan_bursts, stats)

        if cache is not None:
            delta = cache.stat_delta(before, stats)
            if fast:
                # the fast hit skips the per-burst walk, so its sharing
                # decisions replay via the stat delta too (a dyn-fast hit
                # instead reruns the benefit model live, so its decision
                # counters must *not* be replayed)
                delta["decisions"] = stats.decisions - dec0
            zero_copy = (not ctx.sum_unit_cols and all(
                isinstance(s, _NegStep) or len(s.div_rows) == 0
                for s in steps))
            plan = PanePlan(steps=[self._strip(s) for s in steps],
                            stat_delta=delta, zero_copy=zero_copy)
            cache.put(key, plan)
            self._last_host = plan
        if obs is not None:
            obs.step("plan.build", "plan_build_s", t_b, perf_counter(), stats)
        return steps

    def _hit(self, plan: PanePlan, stats: RunStats, pkey, instantiate,
             *args) -> list:
        """A plan-cache hit: count it, replay the plan's stat delta, and
        rehydrate its steps with ``instantiate`` (the build step)."""
        stats.plan_cache_hits += 1
        obs = self.obs
        if obs is not None:
            obs.cache_event(True, pkey)
        plan.apply_stats(stats)
        self._last_host = plan
        if obs is None:
            return instantiate(plan, *args)
        t0 = perf_counter()
        steps = instantiate(plan, *args)
        obs.step("plan.build", "plan_build_s", t0, perf_counter(), stats)
        return steps

    def _build_steps(self, plan_bursts: list, stats: RunStats) -> list:
        """Construct the structural step list (the cacheable part of phase 1:
        group plans with divergence layout, adjacency, z columns, and
        count-round injection rows)."""
        steps: list = []
        for bi, (hits, burst) in enumerate(plan_bursts):
            if hits:
                steps.append(_NegStep(hits))
            if burst is None:
                continue
            tid, el, attrs, b, q_pos, mvec, epm, groups = burst
            qpos_index = {qi: i for i, qi in enumerate(q_pos)}
            for g in groups:
                if len(g) >= 2:
                    stats.shared_bursts += 1
                    stats.shared_graphlets += 1
                stats.graphlets += 1
                rows = [qpos_index[qi] for qi in g]
                self._plan_group(g, el, tid, attrs, b, mvec[rows],
                                 [epm[i] for i in rows], steps, stats, bi,
                                 rows)
        return steps

    @staticmethod
    def _strip(step):
        """Template form of a step for caching: drop per-pane data (attrs,
        match vectors, edge masks, sum values, job handles); keep the
        structural arrays, the count-round injection rows, and the member
        row indices within the burst's stacked match matrix."""
        if isinstance(step, _NegStep):
            return step
        return replace(step, attrs=None, mvec=None, epm=None, sum_units=())

    def _instantiate(self, plan: PanePlan, plan_bursts: list) -> list:
        """Rehydrate a cached plan against this pane's fresh data: swap in
        the new attribute arrays, match vectors, edge masks and sum-unit
        values; everything structural is reused as-is.  Copies bypass the
        dataclass constructor — this runs per group per pane on the hit
        path."""
        if plan.zero_copy:
            return plan.steps
        steps: list = []
        sum_units_cache: dict[int, list] = {}
        for st in plan.steps:
            if isinstance(st, _NegStep):
                steps.append(st)
                continue
            _, burst = plan_bursts[st.bi]
            tid, el, attrs, b, q_pos, mvec, epm, groups = burst
            gp = object.__new__(_GroupPlan)
            gp.__dict__.update(st.__dict__)
            if len(st.div_rows):
                # per-event snapshot fills read the fresh data; groups
                # without divergence never touch attrs/mvec/epm in finalize
                rows = st.rows
                gp.attrs = attrs
                gp.mvec = mvec[rows]
                gp.epm = [epm[i] for i in rows]
            su = sum_units_cache.get(st.bi)
            if su is None:
                su = sum_units_cache[st.bi] = self._sum_units_for(
                    tid, attrs, b)
            gp.sum_units = su
            steps.append(gp)
        return steps

    def _instantiate_fast(self, plan: PanePlan, runs: list, ev: EventBatch,
                          mv_type: dict) -> list:
        """Rehydrate a fast-keyed plan (static policy, no negation, no edge
        predicates in the pane).  Zero-copy when no step carries per-pane
        data; otherwise only the data-bearing fields are rebuilt."""
        if plan.zero_copy:
            return plan.steps
        cursor: dict[int, int] = {}
        info: list[tuple] = []
        for tid, sl in runs:
            b = sl.stop - sl.start
            c = cursor.get(tid, 0)
            cursor[tid] = c + b
            info.append((tid, sl, c, b))
        steps: list = []
        sum_units_cache: dict[int, list] = {}
        for st in plan.steps:
            tid, sl, c, b = info[st.bi]
            gp = object.__new__(_GroupPlan)
            gp.__dict__.update(st.__dict__)
            if len(st.div_rows):
                gp.attrs = ev.attrs[sl]
                gp.mvec = mv_type[tid][:, c:c + b][st.rows]
                gp.epm = [None] * len(st.rows)
            su = sum_units_cache.get(st.bi)
            if su is None:
                su = sum_units_cache[st.bi] = self._sum_units_for(
                    tid, ev.attrs[sl], b)
            gp.sum_units = su
            steps.append(gp)
        return steps

    def _sum_units_for(self, type_id: int, attrs: np.ndarray, b: int) -> list:
        """Per-burst sum-unit injection values (fresh attribute data)."""
        return [(ui, None if tid != type_id
                 else (np.ones(b) if col is None else attrs[:, col]))
                for ui, tid, col in self.ctx.sum_unit_cols]

    # -- dynamic-policy fast-key fingerprint pass --

    def _dyn_fast_groups(self, runs: list, ev: EventBatch, mv_type: dict,
                         mv_bytes: dict, present: list, stats: RunStats,
                         codes: dict | None = None, pkey=None,
                         audit=None, runs_shape=None,
                         sig_mv: tuple | None = None) -> tuple[list, tuple]:
        """Whole-pane fast key for pattern-based dynamic policies.

        Requires an edge-free, negation-free pane.  One vectorized
        divergence image per type (the stacked twin of
        :meth:`_divergence_rows` without the edge term) is sliced per burst
        into coverage-pattern multisets — the benefit model's decision
        inputs, compressed exactly (see ``optimizer.divergence_patterns``)
        — and the sharing decision is recomputed from them via
        ``policy.decide_patterns``.  The decided groups join the fast
        signature, so zero-copy reuse extends to :class:`~repro_torch.core
        .optimizer.DynamicPolicy` panes while a benefit flip (the running
        event count crossing a cost threshold) misses into a fresh entry.
        Returns (per-run groups for injection into the plan walk, key).

        The whole walk is memoized per (runs shape, per-type divergence-code
        bytes): the sharing decisions are pure functions of the coverage
        patterns, ``b`` and the running event count ``n``, and the policy
        reports the exact ``n`` interval on which each decision replays
        (:attr:`~repro_torch.core.optimizer._PolicyBase.last_interval`).  A warm
        pane whose ``n`` lands inside the recorded intersection skips the
        per-burst loop entirely — one dict probe replaces the decision walk.
        Audit-enabled runs bypass the memo (the audit log wants per-burst
        benefit values, which vary with ``n`` inside an interval).
        """
        ctx = self.ctx
        codes_type = codes
        n_pane = stats.events
        if runs_shape is None:
            runs_shape = tuple((tid, sl.stop - sl.start) for tid, sl in runs)
        if sig_mv is None:
            sig_mv = tuple(mv_bytes[t] for t in present if t in mv_bytes)
        pm_key: tuple | None = None
        if audit is None:
            pm_key = (runs_shape,
                      tuple(a.tobytes() for a in codes_type.values()))
            ent = self._dyn_pane_memo.get(pm_key)
            if ent is not None:
                for lo, hi, groups_all, sig_t, n_dec, n_split in ent:
                    if lo <= n_pane <= hi:
                        stats.decisions += n_dec
                        stats.split_bursts += n_split
                        key = ("FD", self.max_local_basis, runs_shape,
                               sig_mv, sig_t)
                        return groups_all, key
        dec0 = stats.decisions
        split0 = stats.split_bursts
        iv_lo, iv_hi = None, None
        memoable = pm_key is not None
        pats_cache = self._pats_cache
        groups_all: list = []
        sig: list = []
        cursor: dict[int, int] = {}
        t_layout = max(1, ctx.layout.t)
        for tid, sl in runs:
            b = sl.stop - sl.start
            c = cursor.get(tid, 0)
            cursor[tid] = c + b
            el = ctx.local.get(tid)
            if el is None or not ctx.q_pos[el]:
                groups_all.append(None)
                sig.append(None)
                continue
            kle = ctx.kle_pos[el]
            groups: list = []
            pats = None
            if len(kle) >= 2:
                csl = codes_type[tid][c:c + b]
                cb = csl.tobytes()
                pats = pats_cache.get(cb)
                if pats is None:
                    nz = csl[csl != 0]
                    vals, counts = np.unique(nz, return_counts=True)
                    pats = tuple(zip(vals.tolist(), counts.tolist()))
                    if len(pats_cache) >= 8192:
                        pats_cache.clear()
                    pats_cache[cb] = pats
                shared_sets = self.policy.decide_patterns(
                    patterns=pats, candidates=kle, b=b, n=stats.events,
                    t=t_layout, stats=stats)
                iv = self.policy.last_interval
                if iv is None:
                    memoable = False
                else:
                    iv_lo = iv[0] if iv_lo is None else max(iv_lo, iv[0])
                    iv_hi = iv[1] if iv_hi is None else min(iv_hi, iv[1])
                in_shared = set(qq for s in shared_sets for qq in s)
                groups.extend([s for s in shared_sets if len(s) >= 2])
                groups.extend([[qi] for s in shared_sets
                               if len(s) == 1 for qi in s])
                groups.extend([[qi] for qi in kle if qi not in in_shared])
            else:
                groups.extend([[qi] for qi in kle])
            groups.extend([[qi] for qi in ctx.q_pos[el] if qi not in kle])
            groups_all.append(groups)
            sig.append(tuple(map(tuple, groups)))
            if audit is not None and len(kle) >= 2:
                audit.record(
                    pane=pkey, comp=self.comp, el=el, candidates=kle,
                    decided=sig[-1], b=b, n=stats.events,
                    benefit=getattr(self.policy, "last_benefit", None),
                    patterns=pats)
        sig_t = tuple(sig)
        if audit is not None:
            audit.note_pane(pkey, sig_t, comp=self.comp)
        if memoable:
            lo, hi = ((iv_lo, iv_hi) if iv_lo is not None
                      else (0, float("inf")))
            if lo <= hi:
                if len(self._dyn_pane_memo) >= 4096:
                    self._dyn_pane_memo.clear()
                self._dyn_pane_memo.setdefault(pm_key, []).append(
                    (lo, hi, groups_all, sig_t,
                     stats.decisions - dec0, stats.split_bursts - split0))
        key = ("FD", self.max_local_basis, runs_shape, sig_mv, sig_t)
        return groups_all, key

    # -- divergence detection (per-event signature differences) --

    def _divergence_rows(self, q_pos, kle, el, mvec, epm) -> dict[int, np.ndarray]:
        """Per-candidate boolean rows: events where q's signature differs
        from the reference (first candidate).  Drives Thms 4.1/4.2.  One
        broadcast comparison over the stacked match vectors; the (rare)
        edge-mask term falls back to a per-candidate pass."""
        ctx = self.ctx
        ref = kle[0]
        ri = q_pos.index(ref)
        b = mvec.shape[1]
        idx = np.array([q_pos.index(qi) for qi in kle])
        D = mvec[idx] != mvec[ri]                       # [n_kle, b]
        sdiff = ctx.start_flag[kle, el] != ctx.start_flag[ref, el]
        if sdiff.any():
            D[sdiff] |= mvec[idx[sdiff]] | mvec[ri]
        ref_edge = epm[ri]
        for j, qi in enumerate(kle):
            a, bq = ref_edge, epm[q_pos.index(qi)]
            if (a is None) != (bq is None) or (
                    a is not None and bq is not None and not np.array_equal(a, bq)):
                am = np.ones((b, b), dtype=bool) if a is None else a
                bm = np.ones((b, b), dtype=bool) if bq is None else bq
                D[j] |= np.any(np.tril(am != bm, k=-1), axis=1)
        return {qi: D[j] for j, qi in enumerate(kle)}

    # -- group (graphlet) planning --

    def _plan_group(self, g, el, type_id, attrs, b, mvec, epm,
                    steps: list, stats: RunStats, bi: int = -1,
                    rows: list | None = None) -> None:
        ctx = self.ctx
        nu = ctx.nu
        shared = len(g) >= 2
        kleene = all(ctx.kleene_flag[qi, el] for qi in g)
        assert shared is False or kleene, "shared groups must be Kleene (Def. 4)"

        # a non-shared graphlet none of whose events match contributes an
        # exactly-zero update (zero injection rows, zeroed adjacency): skip
        # its jobs and its finalize step entirely
        if not shared and not mvec[0].any():
            return

        # per-event divergence flags within this group: one broadcast
        # comparison against the group reference (member 0)
        if shared:
            div = (mvec != mvec[0]).any(axis=0)
            sflags = ctx.start_flag[g, el]
            sdiff = sflags != sflags[0]
            if sdiff.any():
                div |= mvec[sdiff].any(axis=0) | mvec[0]
            e0 = epm[0]
            for i in range(1, len(g)):
                a, bq = e0, epm[i]
                if (a is None) != (bq is None) or (
                        a is not None and bq is not None and not np.array_equal(a, bq)):
                    am = np.ones((b, b), dtype=bool) if a is None else a
                    bm = np.ones((b, b), dtype=bool) if bq is None else bq
                    div |= np.any(np.tril(am != bm, k=-1), axis=1)
        else:
            div = np.zeros(b, dtype=bool)

        d = int(div.sum())
        n_z = d * nu
        B_local = 1 + nu + n_z
        if B_local > self.max_local_basis and shared:
            # basis would blow up: force split (the optimizer should normally
            # have prevented this; AlwaysShare can reach it)
            for qi in g:
                j = g.index(qi)
                self._plan_group([qi], el, type_id, attrs, b,
                                 mvec[[j]], [epm[j]], steps, stats, bi,
                                 None if rows is None else [rows[j]])
            stats.split_bursts += 1
            return

        live = mvec.all(axis=0) & ~div
        dead = ~mvec.any(axis=0) & ~div

        # local basis: 0 = gate, 1..nu = x_u, nu+1.. = z snapshots
        z_ids = {}
        nxt = 1 + nu
        div_rows = np.nonzero(div)[0]
        for i in div_rows:
            for ui in range(nu):
                z_ids[(int(i), ui)] = nxt
                nxt += 1
        if shared:
            # snapshots are a *shared-execution* artifact (Defs. 8/9); the
            # non-shared path keeps plain per-query aggregates
            stats.snapshots_created += nu + n_z
            stats.snapshots_propagated += B_local
            stats.shared_rows += b
            stats.snapshot_rows += d

        # dense fast path: no edge predicates and no divergent/dead rows
        # means the in-burst adjacency is exactly strictly-lower all-ones,
        # with the O(b) closed form (beyond-paper; see kernels/ops.py)
        dense = (kleene and epm[0] is None and d == 0 and not dead.any()
                 and b <= DENSE_B_MAX)

        # common in-burst adjacency
        if dense:
            em = None
        else:
            if kleene:
                em = np.tril(np.ones((b, b)), k=-1)
                if epm[0] is not None:
                    em *= np.tril(epm[0], k=-1)
            else:
                em = np.zeros((b, b))
            em[div | dead, :] = 0.0
            if not shared:
                em[~mvec[0], :] = 0.0

        plan = _GroupPlan(
            g=list(g), el=el, type_id=type_id, attrs=attrs, b=b, mvec=mvec,
            epm=epm, shared=shared, div=div, div_rows=div_rows, live=live,
            dead=dead, B_local=B_local, z_ids=z_ids, dense=dense, em=em,
            start_q0=bool(ctx.start_flag[g[0], el]),
            sum_units=self._sum_units_for(type_id, attrs, b), bi=bi,
            rows=rows, trivial=not kleene)
        # injection-row layout is structural: build it at plan time so the
        # plan cache carries it and repeated shapes skip the construction
        plan.base_c = self._count_base(plan)
        steps.append(plan)

    # -- phase 2: execute (jobs to the bucketed batched executor) --

    def submit_execute(self, steps: list, stats: RunStats,
                       round_: int, jobs: list) -> None:
        """Submit one execute round's jobs to the shared executor.

        Round 1 submits every group's count-unit problem; round 2 submits
        the sum-unit problems, whose injection rows read the (flushed)
        count coefficients.  The caller flushes the executor between rounds
        — per pane via :meth:`process`, per micro-batch via
        :class:`PaneMicroBatcher`.  ``jobs`` is the pending pane's handle
        list, parallel to ``steps`` (plans stay immutable: see _GroupPlan).
        """
        ex = self.executor
        if round_ == 1:
            for i, p in enumerate(steps):
                if not isinstance(p, _GroupPlan):
                    continue
                base = self._count_base(p)
                if p.trivial:
                    # non-Kleene graphlet: the in-burst adjacency is all
                    # zeros, so propagation is the identity on the injection
                    # rows — no launch needed
                    cjob = PropagateJob(base, None, result=base)
                else:
                    cjob = ex.submit(base, None if p.dense else p.em)
                jobs[i] = (cjob, {})
                stats.propagate_cells += p.b * p.B_local
        else:
            for i, p in enumerate(steps):
                if not isinstance(p, _GroupPlan):
                    continue
                cjob, sjobs = jobs[i]
                for ui, vals in p.sum_units:
                    base = self._sum_base(p, ui, vals, cjob.result)
                    if p.trivial:
                        sjobs[ui] = PropagateJob(base, None, result=base)
                    else:
                        sjobs[ui] = ex.submit(base,
                                              None if p.dense else p.em)
                    stats.propagate_cells += p.b * p.B_local

    # -- phase 2 helpers: injection rows for the batched launches --

    def _count_base(self, p: _GroupPlan) -> np.ndarray:
        if p.base_c is not None:
            return p.base_c
        base_c = np.zeros((p.b, p.B_local))
        base_c[p.live, 1 + 0] = 1.0               # x_count entry
        if p.start_q0:
            base_c[p.live, 0] = 1.0               # gate entry (start contribution)
        for i in p.div_rows:
            base_c[i, p.z_ids[(int(i), 0)]] = 1.0
        return base_c

    def _sum_base(self, p: _GroupPlan, ui: int, vals,
                  ccoef: np.ndarray) -> np.ndarray:
        # injection shares the mask and includes attr*count coefficients
        base_s = np.zeros((p.b, p.B_local))
        base_s[p.live, 1 + ui] = 1.0
        if vals is not None:
            base_s[p.live] += vals[p.live, None] * ccoef[p.live]
        for i in p.div_rows:
            base_s[i, :] = 0.0
            base_s[i, p.z_ids[(int(i), ui)]] = 1.0
        return base_s

    # -- phase 3: finalize (replay the pane in stream order) --

    def finalize(self, steps: list, stats: RunStats,
                 jobs: list, pane_key=None) -> np.ndarray:
        """Phase 3, sequential reference path: fold executed coefficients
        into the state functionals and assemble the pane's per-query
        transfer matrices M [k, C, C].  ``jobs`` is the pending pane's
        handle list, parallel to ``steps``.

        With a :class:`~repro_torch.core.fold_exec.FoldExecutor` attached the
        micro-batcher folds pending panes through it instead (stacked
        per-shape launches, bitwise identical to this replay); this method
        remains the ``fold_exec=False`` oracle the differential suite pins
        the executor against."""
        t_f = perf_counter()
        ctx = self.ctx
        C = ctx.layout.size
        k = ctx.k
        nu = ctx.nu
        t = len(ctx.pos_type_ids)

        with np.errstate(over="ignore", invalid="ignore"):
            # state functionals over pane-entry channels
            arow = np.zeros((k, nu, t, C))
            if nu and t:
                arow[:, np.arange(nu)[:, None], np.arange(t)[None, :],
                     ctx.a_cols] = 1.0
            rrow = np.zeros((k, nu, C))
            if nu:
                rrow[:, np.arange(nu), ctx.rp_cols] = 1.0
            gaterow = np.zeros((k, C))
            gaterow[:, ctx.layout.GATE] = 1.0

            for i, s in enumerate(steps):
                if isinstance(s, _NegStep):
                    for qi, rule in s.hits:
                        if rule.kind == "leading":
                            gaterow[qi, :] = 0.0
                        elif rule.kind == "trailing":
                            rrow[qi, :, :] = 0.0
                        else:
                            arow[qi, :, rule.before_local, :] = 0.0
                else:
                    cjob, sjobs = jobs[i]
                    self._finalize_group(s, cjob, sjobs, arow, rrow, gaterow)

            # assemble transfer matrices (vectorized over queries)
            M = np.zeros((k, C, C))
            M[:, ctx.layout.CONST, ctx.layout.CONST] = 1.0
            M[:, ctx.layout.GATE, :] = gaterow
            if nu and t:
                M[:, ctx.a_cols.reshape(-1), :] = arow.reshape(k, nu * t, C)
            if nu:
                M[:, ctx.rp_cols, :] = rrow
        dt = perf_counter() - t_f
        stats.finalize_s += dt
        obs = self.obs
        if obs is not None:
            obs.pane_phase("finalize", t_f, dt, key=pane_key)
        return M

    # -- phase 3 helper: one graphlet's coefficients -> state functionals --

    def _finalize_group(self, p: _GroupPlan, cjob, sjobs, arow, rrow,
                        gaterow) -> None:
        ctx = self.ctx
        C = ctx.layout.size
        nu = ctx.nu
        g = p.g
        b = p.b
        el = p.el
        ccoef = cjob.result
        scoefs = {ui: sjobs[ui].result for ui in sjobs}
        z_ids = p.z_ids
        div_rows = p.div_rows

        W = np.zeros((len(g), p.B_local, C))
        W[:, 0] = gaterow[g]
        if nu:
            # one stacked matmul for every member's x_u functionals instead
            # of a matvec per (member, unit): [G,1,1,t] @ [G,nu,t,C]
            W[:, 1:1 + nu] = np.matmul(
                ctx.pt_mask[g, el][:, None, None, :].astype(np.float64),
                arow[g])[:, :, 0, :]

        # event-level snapshot value functionals (Def. 9), ascending order.
        # P[u] caches coef_u @ W[gi]; every snapshot fill is a rank-1 update
        # so *live* rows that reference earlier z columns stay current.
        if len(div_rows):
            coefs = {0: ccoef, **scoefs}
            lower = np.tril(np.ones((b, b), dtype=bool), k=-1)
            for gi, qi in enumerate(g):
                P = {u: coefs[u] @ W[gi] for u in coefs}

                def fill(zcol: int, f: np.ndarray) -> None:
                    W[gi, zcol] = f
                    for u in coefs:
                        col = coefs[u][:, zcol]
                        if col.any():
                            P[u] += np.outer(col, f)

                adj_q = lower.copy()
                if p.epm[gi] is not None:
                    adj_q &= p.epm[gi]
                adj_q &= p.mvec[gi][None, :]
                startq = 1.0 if ctx.start_flag[qi, el] else 0.0
                for i in div_rows:
                    i = int(i)
                    row = adj_q[i].astype(float)
                    if p.mvec[gi][i]:
                        f_c = startq * gaterow[qi] + W[gi, 1 + 0] + row @ P[0]
                    else:
                        f_c = np.zeros(C)
                    fill(z_ids[(i, 0)], f_c)
                    for ui, u in enumerate(ctx.units):
                        if u[0] != "sum":
                            continue
                        _, e_name, attr = u
                        if p.mvec[gi][i]:
                            f_s = W[gi, 1 + ui] + row @ P[ui]
                            if ctx.schema.type_id(e_name) == p.type_id:
                                v = (1.0 if attr is None
                                     else p.attrs[i, ctx.schema.attr_col(attr)])
                                f_s = f_s + v * f_c
                        else:
                            f_s = np.zeros(C)
                        fill(z_ids[(i, ui)], f_s)

        # fold column sums into state functionals: one stacked matmul per
        # graphlet instead of a matvec per (member, unit)
        used = [0] + sorted(scoefs)               # unit rows: count first
        if scoefs:
            S = np.stack([ccoef.sum(axis=0)] +
                         [scoefs[ui].sum(axis=0) for ui in sorted(scoefs)])
        else:
            S = ccoef.sum(axis=0)[None]
        upd = np.matmul(S, W)                     # [len(g), len(used), C]
        for gi, qi in enumerate(g):
            end = ctx.end_flag[qi, el]
            for r, ui in enumerate(used):
                arow[qi, ui, el] += upd[gi, r]
                if end:
                    rrow[qi, ui] += upd[gi, r]


# --------------------------------------------------------------------------
# cross-pane fused execution (micro-batching)
# --------------------------------------------------------------------------


@dataclass
class _PendingPane:
    """A planned pane awaiting execution/finalization in a micro-batch.

    ``jobs`` holds the executor handles parallel to ``steps`` — kept off the
    (possibly cache-shared) plan objects so the same planned shape can be in
    flight for several panes of one micro-batch at once.  ``plan_host`` is
    the :class:`~repro_torch.core.plan_cache.PanePlan` this pane hit or created
    (the fold executor caches its level schedule there)."""

    proc: PaneProcessor
    steps: list
    stats: RunStats
    jobs: list = field(default_factory=list)
    plan_host: object = None
    M: np.ndarray | None = None
    pane_key: tuple | None = None
    pane: EventBatch | None = None    # unplanned payload until drain()

    def finalize(self) -> np.ndarray:
        if self.M is None:
            self.M = self.proc.finalize(self.steps, self.stats, self.jobs,
                                        pane_key=self.pane_key)
        return self.M


class PaneMicroBatcher:
    """Accumulate submitted panes and flush the whole backlog together.

    ``submit`` only queues the pane; planning is deferred to ``drain``,
    which runs phase 1 for the whole micro-batch as one *batched prologue*
    per processor (one stacked event filter / RLE segmentation / predicate
    pass over all K panes — see :meth:`PaneProcessor.plan_prologues`)
    followed by the per-pane decision walks **in submission order** — the
    optimizer's running event count, and hence every sharing decision,
    stays bitwise identical to per-pane planning.  ``drain`` then runs both
    execute rounds for all pending panes through the shared executor — one
    launch per size bucket per K panes — and, when a
    :class:`~repro_torch.core.fold_exec.FoldExecutor` is attached, folds every
    pending pane's finalize backlog with one stacked launch set (one flush =
    one plan + one execute + one fold launch set) and returns the pending
    panes for deferred, in-order consumption.  ``k`` is the micro-batch
    size; ``k=1`` degrades to exact per-pane execution.
    """

    def __init__(self, executor: PaneBatchExecutor, k: int = 1,
                 fold_exec=None, obs=None):
        self.executor = executor
        self.fold_exec = fold_exec
        self.obs = obs
        self.k = max(1, int(k))
        self._pending: list[_PendingPane] = []

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, proc: PaneProcessor, pane: EventBatch,
               stats: RunStats) -> _PendingPane:
        obs = self.obs
        key = None
        if obs is not None and obs.tracing:
            key = obs.pane_key(pane)
            obs.lifecycle("ingest", key, args={"events": len(pane)})
        pend = _PendingPane(proc, None, stats, jobs=None, pane_key=key,
                            pane=pane)
        self._pending.append(pend)
        return pend

    def ready(self) -> bool:
        return len(self._pending) >= self.k

    def _plan_pending(self, pend: list[_PendingPane]) -> None:
        """Deferred phase 1 for the whole micro-batch: batched prologues
        per processor, then the order-sensitive finish walks in submission
        order."""
        obs = self.obs
        t0 = perf_counter()
        with np.errstate(over="ignore", invalid="ignore"):
            by_proc: dict[int, list[_PendingPane]] = {}
            for p in pend:
                by_proc.setdefault(id(p.proc), []).append(p)
            pros: dict[int, object] = {}
            for plist in by_proc.values():
                proc = plist[0].proc
                for p, pro in zip(plist, proc.plan_prologues(
                        [q.pane for q in plist])):
                    pros[id(p)] = pro
            if obs is not None:
                obs.step("plan.prologue", "plan_prologue_s", t0,
                         perf_counter())
            for p in pend:
                p.steps = p.proc._plan_finish(p.pane, pros[id(p)], p.stats)
                p.plan_host = p.proc._last_host
                p.jobs = [None] * len(p.steps)
        self._phase(pend, "plan", t0, perf_counter())

    def _phase(self, pend: list[_PendingPane], phase: str, t0: float,
               t1: float) -> None:
        """Charge one phase of the flush, timed once from ``t0`` to ``t1``,
        to its panes: an equal share of it to each pane's ``RunStats``
        timer, and to the phase's span (one for the flush at K > 1)."""
        dt = (t1 - t0) / len(pend)
        attr = f"{phase}_s"
        for p in pend:
            setattr(p.stats, attr, getattr(p.stats, attr) + dt)
        if self.obs is not None:
            self.obs.flush_phase(phase, t0, t1, len(pend))

    def drain(self) -> list[_PendingPane]:
        """Flush the pending panes with the cyclic collector held off
        (:func:`~repro_torch.core.gc_hold.collector_held`): what the flush
        allocates dies with it, by reference counting, without being
        promoted toward a full collection."""
        pend, self._pending = self._pending, []
        if not pend:
            return pend
        with collector_held() as held:
            if held:
                for s in {id(p.stats): p.stats for p in pend}.values():
                    s.gc_held_flushes += 1
            self._flush(pend)
        return pend

    def _flush(self, pend: list[_PendingPane]) -> None:
        obs = self.obs
        args = (obs.flush_begin([p.stats for p in pend],
                                [p.pane_key for p in pend])
                if obs is not None else None)
        self._plan_pending(pend)
        ex = self.executor
        sp = obs.span("flush", args=args) if obs is not None else NULL_SPAN
        with sp:
            t0 = t_stage = perf_counter()
            with np.errstate(over="ignore", invalid="ignore"):
                for round_ in (1, 2):
                    for p in pend:
                        p.proc.submit_execute(p.steps, p.stats, round_,
                                              p.jobs)
                    # the submits' injection rows are the flush's staging
                    ex.flush(t_stage)
                    if obs is not None:
                        t_stage = perf_counter()
            self._phase(pend, "execute", t0, perf_counter())
            fe = self.fold_exec
            if fe is not None:
                fsp = (obs.span("fold_flush", args=args)
                       if obs is not None else NULL_SPAN)
                with fsp:
                    t1 = perf_counter()
                    fjobs = [fe.submit(p.proc, p.steps, p.jobs, p.stats,
                                       host=p.plan_host) for p in pend]
                    fe.flush()
                    for p, fj in zip(pend, fjobs):
                        p.M = fj.M
                    self._phase(pend, "finalize", t1, perf_counter())
        if obs is not None:
            obs.flush_end()


# --------------------------------------------------------------------------
# windowed runtime: panes -> sliding windows -> per-query results
# --------------------------------------------------------------------------


@dataclass
class _Instance:
    start: int
    u: np.ndarray
    events: list = field(default_factory=list)  # retained only for min/max


def fold_panes(Ms: list[np.ndarray], u0: np.ndarray) -> np.ndarray:
    """Replay a window's state from per-pane transfer matrices.

    Applies the panes' transfer matrices to the fresh state ``u0`` in stream
    order — the same ``u @ M.T`` fold :func:`advance_instances` performs
    incrementally, so replaying a window from stored matrices reproduces the
    incremental run.  This is the event-time revision primitive: after a late
    event dirties one pane, only that pane's ``M`` is recomputed and the
    window is re-folded from the stored matrices of the clean panes.
    """
    u = u0
    with np.errstate(over="ignore", invalid="ignore"):
        for M in Ms:
            u = u @ M.T
    return u


def advance_instances(M: np.ndarray, insts: dict[int, "_Instance"]) -> None:
    """Advance every open window instance by one pane: a single [n, C] x
    [C, C] matmul instead of one matvec per instance (the per-pane fold of
    the transfer matrix, vectorized across overlapping windows)."""
    if not insts:
        return
    members = list(insts.values())
    with np.errstate(over="ignore", invalid="ignore"):
        U = np.stack([inst.u for inst in members]) @ M.T
    for i, inst in enumerate(members):
        inst.u = U[i]


class HamletRuntime:
    """Evaluates a workload over a stream, pane by pane (Sec. 2.2 / 3.1).

    ``micro_batch`` sets the cross-pane fusion factor K: planned panes
    accumulate and their propagation backlogs flush together, one launch per
    size bucket per K panes (bitwise identical to ``micro_batch=1``).
    ``plan_cache`` attaches a per-component :class:`PanePlanCache` shared by
    every processor the runtime spawns (see ``core/plan_cache.py``).
    ``shard_slices`` splits each bucket's launch into sub-batch launches
    (the pane-batch sharding hook of ``core/batch_exec.py``).
    ``obs`` attaches a :class:`repro_torch.obs.Observability` facade: phase spans,
    step clocks and spans (``RunStats.STEP_FIELDS``), the collector's
    pauses, lifecycle instants, executor metrics and the sharing-decision
    audit log all record through it (None — the default — costs nothing;
    ``obs.detach()`` removes its collector hook).
    """

    def __init__(self, workload: Workload, policy=None, backend: str = "cuda",
                 batch_exec: bool = True, shard_slices=None,
                 micro_batch: int = 1, plan_cache: bool = True,
                 plan_cache_size: int = 128, fold_exec: bool = True,
                 obs=None, device=None):
        from .optimizer import DynamicPolicy

        # raises when a GPU is asked for (the default) and none is present
        self.device = resolve_device(backend, device)
        self.workload = workload
        self.policy = policy if policy is not None else DynamicPolicy()
        self.backend = backend
        self.pane = pane_size_for(workload.windows)
        self.micro_batch = max(1, int(micro_batch))
        self.components = workload.sharable_components()
        self.ctxs = [ComponentContext(workload.schema,
                                      [workload.atomic[i] for i in comp])
                     for comp in self.components]
        self.plan_caches = [PanePlanCache(plan_cache_size) if plan_cache
                            else None for _ in self.ctxs]
        # one executor for the whole runtime: every pane — shed or admitted,
        # any component — funnels its jobs through the same bucketed batches
        self.executor = PaneBatchExecutor(backend=backend, batched=batch_exec,
                                          shard_slices=shard_slices,
                                          device=self.device)
        # one fold executor likewise: finalize backlogs of every pending
        # pane fold as stacked per-shape launches (None = sequential replay)
        self.fold_exec = (FoldExecutor(backend=backend, device=self.device)
                          if fold_exec else None)
        self.obs = obs
        if obs is not None:
            obs.pane_ticks = self.pane
            self.executor.obs = obs
            if self.fold_exec is not None:
                self.fold_exec.obs = obs
            obs.attach(self)
        self.stats = RunStats()
        self._empty_M: list[np.ndarray] | None = None

    def make_processor(self, ci: int) -> PaneProcessor:
        """A processor for component ``ci`` wired to the runtime's shared
        executor, plan cache and observability facade (used by the
        overload / event-time layers)."""
        return PaneProcessor(self.ctxs[ci], self.policy, backend=self.backend,
                             executor=self.executor,
                             plan_cache=self.plan_caches[ci],
                             fold_exec=self.fold_exec, obs=self.obs, comp=ci)

    def plan_cache_stats(self) -> dict:
        """Aggregate plan-cache counters across components."""
        hits = sum(c.hits for c in self.plan_caches if c is not None)
        misses = sum(c.misses for c in self.plan_caches if c is not None)
        return {"hits": hits, "misses": misses,
                "entries": sum(len(c) for c in self.plan_caches
                               if c is not None),
                "hit_rate": hits / (hits + misses) if hits + misses else 0.0}

    def empty_pane_matrices(self) -> list[np.ndarray]:
        """Per-component transfer matrix of an event-free pane (cached).

        Every empty pane folds identically, so the event-time layer stores
        matrices only for panes that saw events and substitutes this one for
        the gaps when replaying a window (see :func:`fold_panes`).
        """
        if self._empty_M is None:
            empty = EventBatch(self.workload.schema, np.array([], np.int32),
                               np.array([], np.int64), None)
            scratch = RunStats()
            # no obs on these processors: the scratch stats never merge into
            # the runtime's, so spans here would break the span/stat match
            self._empty_M = [
                PaneProcessor(self.ctxs[ci], self.policy,
                              backend=self.backend, executor=self.executor,
                              plan_cache=self.plan_caches[ci],
                              fold_exec=self.fold_exec).process(empty,
                                                                scratch)
                for ci in range(len(self.ctxs))]
        return self._empty_M

    def run(self, batch: EventBatch, t_end: int | None = None) -> dict:
        """Process a stream; returns {(query, group, window_start): {agg: val}}.

        Results for user queries with top-level Or/And are combined per
        Sec. 5.  Windows are aligned to multiples of each query's slide,
        starting at 0; only windows fully contained in [0, t_end) emit.
        """
        if t_end is None:
            t_end = int(batch.time.max()) + 1 if len(batch) else 0
        t_end = ((t_end + self.pane - 1) // self.pane) * self.pane

        atomic_results: dict[tuple[int, int, int], dict] = {}
        for group_key, gbatch in batch.partition_by_group().items():
            self._run_partition(gbatch, t_end, group_key, atomic_results)

        return self._combine(atomic_results)

    # -- per group partition --

    def _run_partition(self, batch: EventBatch, t_end: int, group_key: int,
                       out: dict) -> None:
        for ic, (comp, ctx) in enumerate(zip(self.components, self.ctxs)):
            proc = self.make_processor(ic)
            insts: list[dict[int, _Instance]] = [dict() for _ in comp]
            mb = PaneMicroBatcher(self.executor, k=self.micro_batch,
                                  fold_exec=self.fold_exec, obs=self.obs)
            backlog: list[tuple[int, EventBatch, _PendingPane]] = []

            def flush_backlog():
                mb.drain()
                for t0, pane_ev, pend in backlog:
                    self._advance_pane(comp, ctx, insts, t0, pane_ev,
                                       pend.finalize(), t_end, group_key, out)
                backlog.clear()

            for t0, pane_ev in split_panes(batch, self.pane, 0, t_end):
                backlog.append((t0, pane_ev,
                                mb.submit(proc, pane_ev, self.stats)))
                if mb.ready():
                    flush_backlog()
            flush_backlog()

    def _advance_pane(self, comp, ctx, insts, t0: int, pane_ev: EventBatch,
                      M: np.ndarray, t_end: int, group_key: int,
                      out: dict) -> None:
        """Phase 4 (fold): advance window instances by one pane and emit
        closing windows."""
        obs = self.obs
        key = (obs.pane_key(pane_ev)
               if obs is not None and obs.tracing else None)
        fold_t0 = None
        fold_dt = 0.0
        for ci, aqi in enumerate(comp):
            q = self.workload.atomic[aqi]
            # open new instances whose window starts at this pane
            if t0 % q.slide == 0 and t0 + q.within <= t_end:
                insts[ci][t0] = _Instance(t0, ctx.layout.fresh_state())
            needs_minmax = ci in ctx.minmax_queries
            t_fold = perf_counter()
            advance_instances(M[ci], insts[ci])
            d = perf_counter() - t_fold
            self.stats.fold_s += d
            if fold_t0 is None:
                fold_t0 = t_fold
            fold_dt += d
            for w0, inst in list(insts[ci].items()):
                if needs_minmax and len(pane_ev):
                    inst.events.append(pane_ev)
                if w0 + q.within == t0 + self.pane:
                    out[(aqi, group_key, w0)] = self._emit(
                        ctx, ci, q, inst, group_key)
                    del insts[ci][w0]
                    self.stats.windows_emitted += 1
                    if key is not None:
                        obs.lifecycle("emit", key,
                                      args={"w0": w0, "q": aqi})
        if obs is not None and fold_t0 is not None:
            obs.pane_phase("fold", fold_t0, fold_dt, key=key)

    def _emit(self, ctx: ComponentContext, ci: int, q: AtomicQuery,
              inst: _Instance, group_key: int) -> dict:
        from .query import AggKind

        u = inst.u
        vals: dict[str, float] = {}
        for agg in q.aggs:
            if agg.kind == AggKind.COUNT_STAR:
                vals[repr(agg)] = float(u[ctx.layout.rp_idx(("count",))])
            elif agg.kind == AggKind.COUNT_TYPE:
                vals[repr(agg)] = float(u[ctx.layout.rp_idx(("sum", agg.type_name, None))])
            elif agg.kind == AggKind.SUM:
                vals[repr(agg)] = float(
                    u[ctx.layout.rp_idx(("sum", agg.type_name, agg.attr))])
            elif agg.kind == AggKind.AVG:
                s = u[ctx.layout.rp_idx(("sum", agg.type_name, agg.attr))]
                c = u[ctx.layout.rp_idx(("sum", agg.type_name, None))]
                vals[repr(agg)] = float(s / c) if c else float("nan")
            elif agg.kind in (AggKind.MIN, AggKind.MAX):
                from .minmax import window_minmax

                evs = (EventBatch.concat(inst.events) if inst.events
                       else None)
                vals[repr(agg)] = window_minmax(
                    self.workload.schema, q, evs, agg,
                    run_type_ids=ctx.relevant_type_ids, pane=self.pane,
                    backend=self.backend, device=self.device)
        return vals

    # -- Or/And combination (Sec. 5) --

    def _combine(self, atomic_results: dict) -> dict:
        return combine_results(self.workload, atomic_results)


def vals_equal(a: dict, b: dict) -> bool:
    """Exact equality of window aggregate dicts, treating NaN == NaN (an
    AVG over zero matches is NaN in both runs and must not read as a
    difference)."""
    import math

    if a.keys() != b.keys():
        return False
    for k, va in a.items():
        vb = b[k]
        if va != vb and not (isinstance(va, float) and isinstance(vb, float)
                             and math.isnan(va) and math.isnan(vb)):
            return False
    return True


def combine_results(workload: Workload, atomic_results: dict) -> dict:
    """Combine atomic sub-query results into user-query results (Sec. 5)."""
    out: dict = {}
    for qname, idxs, comb in workload.combines:
        if comb is None:
            aqi = idxs[0]
            for (ai, gk, w0), vals in atomic_results.items():
                if ai == aqi:
                    out[(qname, gk, w0)] = vals
            continue
        left, right = idxs
        keys = set((gk, w0) for (ai, gk, w0) in atomic_results if ai == left)
        keys |= set((gk, w0) for (ai, gk, w0) in atomic_results if ai == right)
        for gk, w0 in keys:
            lv = atomic_results.get((left, gk, w0), {})
            rv = atomic_results.get((right, gk, w0), {})
            c1 = lv.get("COUNT(*)", 0.0)
            c2 = rv.get("COUNT(*)", 0.0)
            out[(qname, gk, w0)] = {"COUNT(*)": comb.combine_counts(c1, c2)}
    return out
