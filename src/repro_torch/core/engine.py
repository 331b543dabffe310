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
   micro-batch flush (:meth:`PaneProcessor.plan_prologues`, K = 1
   included): one concatenated relevance filter, one run-length
   segmentation, and one stacked per-(query, type) predicate pass over
   every event of each type across the whole flush, sliced back per pane.
   The order-sensitive *finish* then walks panes in submission order, one
   walk a pane: each burst's negation hits and edge masks, the sharing
   policy's decision on each burst's groups, and each group's
   masks/adjacency/injection rows captured as propagation *jobs*.  Nothing
   here depends on the running aggregates, so the whole pane plans up
   front.  Bursty streams do not repeat a pane's run lengths and predicate
   bits, so no plan is kept past its pane.
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
   across the pane **and** across every pane of a micro-batch flush.  On
   the torch/cuda backends each divergent graphlet is first collapsed, at
   flush prep, to state-free ``S`` rows and folds like a d == 0 one.  A
   *scannable* flush plan (no negation splits, one d == 0 bucket per
   round) carries a compiled execution form: on the torch/cuda backends
   the whole flush is **one** logical device launch
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
``execute_s`` / ``finalize_s`` / ``fold_s``), so benchmarks read the phase
split straight from the engine.

Observability: every layer accepts an optional ``obs=`` handle (a
:class:`repro_torch.obs.Observability` facade — span tracer, metrics registry,
sharing-decision audit log).  Phase spans are recorded from the *same*
``perf_counter`` readings that feed ``RunStats``, so phase spans sum to
the phase totals (a flush of K > 1 panes is one span a phase, timed once);
the steps inside the phases are timed the same way into the
``RunStats.STEP_FIELDS`` clocks and ``"step"`` spans; the audit log
captures each optimizer share/no-share decision verbatim, and each pane's
decided groups.  With ``obs=None`` (default) every hook is a single
guarded attribute test — zero cost.

Host/device residency of a flush: the host side is the batched prologue
(numpy vector passes), the burst walk with its step construction, the
fold executor's flush plan, and the executor submit bookkeeping.  On the
torch/cuda backends the execute phase launches every bucket before
syncing once via ``ops.device_get_all`` (bucket outputs stay
device-resident until that fetch — see ``batch_exec.py``), and the fold
phase is one scan program whose index operands and fresh state go to the
device as the flush plan is built; its single fetch of the scanned state
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

from dataclasses import dataclass, field
from time import perf_counter
from typing import ClassVar

import numpy as np

from ..kernels.ops import DENSE_B_MAX, resolve_device
from ..obs.trace import NULL_SPAN
from .batch_exec import PaneBatchExecutor, PropagateJob
from .events import EventBatch, StreamSchema, pane_size_for, split_panes
from .fold_exec import FoldExecutor
from .gc_hold import collector_held
from .query import AtomicQuery, Workload
from .template import QueryTemplate, build_template

__all__ = ["ComponentContext", "PaneProcessor", "PaneMicroBatcher",
           "HamletRuntime", "RunStats", "fold_panes", "vals_equal"]

# a Kleene burst of this many rows or more counts as long
# (``RunStats.long_kleene_rows``)
LONG_BURST = 128
# a window result holding a finite value this large counts as a large count
# (``RunStats.large_count_windows``): past it the numpy and PyTorch
# backends' Neumann doubling may leave float64
LARGE_COUNT = 2.0 ** 512
# a propagation problem of more rows than this counts as wide
# (``RunStats.wide_propagate_cells``): past it the dense kernel's lanes hold
# more than 16 runs, so their scan takes a fifth shuffle round, and the
# masked kernel's chain runs nine 32-row tiles or more, so each updater
# warp applies four panel blocks or more and its ring of three copy slots
# wraps
WIDE_ROWS = 256


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
        # types some query takes under Kleene+ (their bursts are counted
        # in ``RunStats.kleene_rows``)
        self.kleene_lut = np.any([t.kleene for t in self.templates], axis=0)

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
    # single-query graphlets, planned a burst at a time by the stacked
    # pass (``PaneProcessor._plan_singles``)
    stacked_graphlets: int = 0
    snapshots_created: int = 0
    snapshots_propagated: int = 0
    propagate_cells: int = 0      # total solved cells (rows x basis cols)
    # of those, the cells of problems launched with more than
    # ``WIDE_ROWS`` rows
    wide_propagate_cells: int = 0
    decisions: int = 0
    # decisions the policy evaluated fresh (a v1 memo miss, a v2 call);
    # the rest replayed from its memo
    decide_evals: int = 0
    # event-level snapshots (Def. 9): sum of b^2 over the per-query edge
    # masks the per-burst walk built; rows of shared Kleene graphlets, and
    # those of them that carry an event-level snapshot (divergent rows)
    edge_mask_cells: int = 0
    shared_rows: int = 0
    snapshot_rows: int = 0
    # negation (Sec. 5): gates applied to a query's state rows, one per
    # (pane, hit) by the fold executor's ``apply_neg`` or the sequential
    # finalize; and the fold rounds (levels) of each pane's schedule in
    # the flush plans, with those of them that carry a negation gate
    neg_gates: int = 0
    neg_rounds: int = 0
    fold_rounds: int = 0
    # the fold executor's divergent (d > 0) graphlets, and those it folded
    # through a state-free ``S`` block built with the flush plan; its
    # (context, flush) plans, and those that ran the scan program
    div_graphlets: int = 0
    div_collapsed: int = 0
    fold_flushes: int = 0
    scan_flushes: int = 0
    # rows of the Kleene bursts planned (a burst of a type some query
    # takes under Kleene+), once a burst, and those of bursts of
    # ``LONG_BURST`` rows or more; windows emitted with a finite value of
    # at least ``LARGE_COUNT``
    kleene_rows: int = 0
    long_kleene_rows: int = 0
    large_count_windows: int = 0
    panes: int = 0
    windows_emitted: int = 0
    # four-phase wall-clock split (seconds) — the engine times itself so
    # benchmark phase breakdowns need no external profiler
    plan_s: float = 0.0
    execute_s: float = 0.0
    finalize_s: float = 0.0
    fold_s: float = 0.0
    # step clocks (seconds) and counts inside the phases, kept only while
    # an Observability is attached (see STEP_FIELDS)
    plan_prologue_s: float = 0.0
    plan_decide_s: float = 0.0
    plan_edge_s: float = 0.0
    plan_neg_s: float = 0.0
    plan_build_s: float = 0.0
    execute_stage_s: float = 0.0
    execute_launch_s: float = 0.0
    execute_wait_s: float = 0.0
    execute_h2d_bytes: int = 0
    execute_mask_bytes: int = 0     # of the bytes to the card, b x b masks
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
    # timers (meaningful only as totals) are excluded — and so are the
    # sharing/snapshot counters: the share-or-split decision operates on
    # the co-resident pane batch, so which groups live together changes
    # the sharing opportunities taken (never the results).
    COUNT_FIELDS: ClassVar[tuple[str, ...]] = (
        "events", "bursts", "decisions", "panes", "windows_emitted")

    # The step clocks, read only with an Observability attached (all stay
    # 0 without one).  Plan's five lie inside ``plan_s`` (``plan_edge_s``:
    # the burst walk's edge masks; ``plan_neg_s``: its negation hits and
    # their ``_NegStep``); what they leave of it is the walk's match
    # slices.  Execute's three tile ``execute_s`` (the submits' injection
    # rows and the executor's bucketing and stacking; the
    # ``ops.propagate*`` calls with their host-to-device copies; the fetch
    # and unpacking), as finalize's tile ``finalize_s``
    # with the fold executor (flush plan and ``S``; the scan launch or host
    # rounds; the fetch and scatter), but not its sequential replay.
    # ``ingress_s`` / ``admit_s`` are the streaming layer's ``offer`` and
    # admission, outside the four phases; ``gc_s`` / ``gc_collections`` the
    # collector's pauses of the process, ``gc_full_collections`` those of
    # its full (generation-2) passes.
    STEP_FIELDS: ClassVar[tuple[str, ...]] = (
        "plan_prologue_s", "plan_decide_s", "plan_edge_s", "plan_neg_s",
        "plan_build_s", "execute_stage_s", "execute_launch_s",
        "execute_wait_s", "execute_h2d_bytes", "execute_mask_bytes",
        "execute_d2h_bytes",
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
    em: np.ndarray | None         # in-burst adjacency (None when dense,
                                  # and for a stacked trivial plan)
    start_q0: bool
    sum_units: list               # [(ui, injection values | None)]
    base_c: np.ndarray | None = None  # count-round injection rows
    trivial: bool = False         # non-Kleene: zero adjacency, result == base

    # NOTE: job handles live on the _PendingPane (parallel ``jobs`` list),
    # never on the plan.


class _Prologue:
    """Order-independent phase-1 products of one pane, built for a whole
    micro-batch in one stacked pass by :meth:`PaneProcessor.plan_prologues`:
    filtered events, burst runs, stacked match vectors, negation hits,
    (pattern-based policies only) per-type packed divergence codes, and
    the rows of its Kleene bursts, all and long —
    everything :meth:`PaneProcessor._plan_finish` consumes that does not
    read mutable planner state."""

    __slots__ = ("ev", "runs", "mv_type", "neg_type", "codes",
                 "kleene_rows", "long_kleene_rows")

    def __init__(self, ev, runs, kleene_rows, long_kleene_rows):
        self.ev = ev
        self.runs = runs
        self.kleene_rows = kleene_rows
        self.long_kleene_rows = long_kleene_rows
        self.mv_type: dict[int, np.ndarray] = {}
        self.neg_type: dict[int, list] = {}
        # tid -> [n_events] int64 coverage codes, sliced per burst by the
        # decision step
        self.codes: dict[int, np.ndarray] = {}


class PaneProcessor:
    def __init__(self, ctx: ComponentContext, policy, backend: str = "cuda",
                 max_local_basis: int = 512, executor=None, fold_exec=None,
                 obs=None, comp: int = 0, device=None):
        self.ctx = ctx
        self.policy = policy
        self.backend = backend
        self.max_local_basis = max_local_basis
        self.obs = obs
        self.comp = comp
        self.executor = (executor if executor is not None
                         else PaneBatchExecutor(backend=backend,
                                                device=device))
        self.fold_exec = fold_exec
        # policy traits probed once (the plan hot path reads them per pane)
        self._policy_static = getattr(policy, "decision_static", False)
        self._policy_pattern = getattr(policy, "pattern_based", False)
        # static sharing policies decide per (type, candidate set) only:
        # their shared sets are memoized per local type
        self._static_groups: dict[int, list] = {}
        # divergence-image layout per local type (candidate rows, reference
        # row, start-flag diff) and burst-slice -> pattern-multiset memo for
        # the decision step; parked on the (long-lived) context so warm
        # sweeps with fresh processors keep their memoized extraction
        if not hasattr(ctx, "kle_layout_memo"):
            ctx.kle_layout_memo = {}
            ctx.pats_memo = {}
        self._kle_layout: dict[int, tuple] = ctx.kle_layout_memo
        self._pats_cache: dict[bytes, tuple] = ctx.pats_memo

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
            steps = self._plan_finish(pane, self.plan_prologues([pane])[0],
                                      stats)
        dt = perf_counter() - t0
        stats.plan_s += dt
        obs = self.obs
        if obs is not None:
            obs.pane_phase("plan", t0, dt,
                           key=obs.pane_key(pane) if obs.tracing else None)
        return steps

    def _wants_codes(self, el: int) -> bool:
        """Whether the prologue should pack a divergence image for this
        local type: a pattern-based policy, a real sharing choice, and no
        edge predicate (edge masks add to the divergence rows)."""
        return (self._policy_pattern
                and not self.ctx.edge_pred_els[el]
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

    def plan_prologues(self, panes: list[EventBatch]) -> list["_Prologue"]:
        """The order-independent half of phase 1 for the K panes of one
        micro-batch flush (K = 1 included): event filtering, burst
        segmentation, and the stacked per-(query, type) predicate pass.

        One relevance filter, one run-length segmentation (with forced
        cuts at pane boundaries), and one predicate-stack pass per (query,
        type) over the *concatenation* of all K panes; per-pane results are
        slices of the stacked arrays.  Predicates evaluate elementwise, so
        every slice equals a pass over its pane alone.  Touches no mutable
        planner state (``stats``, the benefit model), so the
        order-sensitive :meth:`_plan_finish` walks run after it in
        submission order.
        """
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
        # the rows of each pane's Kleene bursts, all and long: prefix sums
        # over the flush's runs, read at the panes' run bounds
        krows = np.where(ctx.kleene_lut[ktype[cuts[:-1]]], np.diff(cuts), 0)
        kcum = np.cumsum(np.concatenate([[0], krows]))[pos].tolist()
        lcum = np.cumsum(np.concatenate(
            [[0], np.where(krows >= LONG_BURST, krows, 0)]))[pos].tolist()
        # each pane's filtered view is a zero-copy row slice of the
        # pane-major gather (panes were validated at construction, so the
        # dataclass re-validation in select() is skipped).  These views
        # are plan-internal: the finish walk reads only ``len`` and
        # ``attrs``, so the time/group columns are never materialized.
        attrs_sel = np.concatenate([p.attrs for p in panes])[kidx]
        schema = panes[0].schema
        pros = []
        for i in range(len(panes)):
            ev = object.__new__(EventBatch)
            ev.schema = schema
            ev.type_id = ktype[kb[i]:kb[i + 1]]
            ev.attrs = attrs_sel[kb[i]:kb[i + 1]]
            ev.time = ev.group = ev.seq = None
            base = cuts_l[pos[i]]
            pros.append(_Prologue(ev, [
                (tids_l[j], slice(cuts_l[j] - base, cuts_l[j + 1] - base))
                for j in range(pos[i], pos[i + 1])],
                kcum[i + 1] - kcum[i], lcum[i + 1] - lcum[i]))
        # stacked predicate pass over each type's concatenated events,
        # split back per pane at the type's pane bounds
        for tid in sorted(set(tids_l)):
            idx = np.nonzero(ktype == tid)[0]
            off = np.searchsorted(idx, kb).tolist()
            attrs_t = attrs_sel[idx]
            el = ctx.local.get(tid)
            neg_rules = ctx.neg_rules.get(tid)
            neg_cat = ([(qi, rule, ctx.match_vec(qi, tid, attrs_t))
                        for qi, rule in neg_rules]
                       if neg_rules is not None else None)
            mv_cat = codes_cat = None
            if el is not None and ctx.q_pos[el]:
                mv_cat = ctx.match_stack(ctx.q_pos[el], tid, attrs_t)
                if self._wants_codes(el):
                    codes_cat = self._div_codes(el, mv_cat)
            for i, pro in enumerate(pros):
                lo, hi = off[i], off[i + 1]
                if lo == hi:
                    continue
                if neg_cat is not None:
                    pro.neg_type[tid] = [(qi, rule, m[lo:hi])
                                         for qi, rule, m in neg_cat]
                if mv_cat is not None:
                    pro.mv_type[tid] = mv_cat[:, lo:hi]
                if codes_cat is not None:
                    pro.codes[tid] = codes_cat[lo:hi]
        return pros

    def _plan_finish(self, pane: EventBatch, pro: "_Prologue",
                     stats: RunStats) -> list:
        """The order-sensitive half of phase 1, one walk over the pane's
        bursts: negation hits, match slices and edge masks; then the
        sharing decisions (the benefit model reads the running event
        count); then step construction.  Must run in pane submission
        order."""
        ctx = self.ctx
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
        stats.kleene_rows += pro.kleene_rows
        stats.long_kleene_rows += pro.long_kleene_rows
        if not runs:
            return []
        neg_type = pro.neg_type

        cursor: dict[int, int] = {}
        bursts: list = []
        for tid, sl in runs:
            b = sl.stop - sl.start
            c = cursor.get(tid, 0)
            cursor[tid] = c + b

            # negative-type handling (Sec. 5): applies per query with a rule
            neg = None
            if tid in neg_type:
                t_n = perf_counter() if obs is not None else 0.0
                hits = [(qi, rule) for qi, rule, m in neg_type[tid]
                        if m[c:c + b].any()]
                if hits:
                    neg = _NegStep(hits)
                if obs is not None:
                    obs.step("plan.neg", "plan_neg_s", t_n, perf_counter(),
                             stats)

            burst = None
            el = ctx.local.get(tid)
            if el is not None and ctx.q_pos[el]:
                q_pos = ctx.q_pos[el]
                attrs = ev.attrs[sl]
                if ctx.edge_pred_els[el]:
                    t_e = perf_counter() if obs is not None else 0.0
                    epm = [ctx.edge_mask(qi, tid, attrs) for qi in q_pos]
                    stats.edge_mask_cells += b * b * sum(m is not None
                                                         for m in epm)
                    if obs is not None:
                        obs.step("plan.edge", "plan_edge_s", t_e,
                                 perf_counter(), stats)
                else:
                    epm = [None] * len(q_pos)
                codes = pro.codes.get(tid)
                burst = (tid, el, attrs, b, q_pos,
                         pro.mv_type[tid][:, c:c + b], epm,
                         None if codes is None else codes[c:c + b])
            bursts.append((neg, burst))

        # sharing decisions (Sec. 4), decided fresh on every pane: the
        # benefit model tracks the running event count
        t_d = perf_counter() if obs is not None else 0.0
        plan_bursts: list = []
        key_groups: list = []
        for neg, burst in bursts:
            if burst is None:
                plan_bursts.append((neg, None))
                key_groups.append(None)
                continue
            tid, el, attrs, b, q_pos, mvec, epm, codes = burst
            groups = self._decide(el, b, q_pos, mvec, epm, codes, stats,
                                  pkey, audit)
            plan_bursts.append((neg, (tid, el, attrs, b, q_pos, mvec, epm,
                                      groups)))
            key_groups.append(tuple(map(tuple, groups)))
        if audit is not None:
            audit.note_pane(pkey, tuple(key_groups), comp=self.comp)
        if obs is not None:
            t_b = perf_counter()
            obs.step("plan.decide", "plan_decide_s", t_d, t_b, stats)

        steps = self._build_steps(plan_bursts, stats)
        if obs is not None:
            obs.step("plan.build", "plan_build_s", t_b, perf_counter(), stats)
        return steps

    def _decide(self, el: int, b: int, q_pos: list, mvec: np.ndarray,
                epm: list, codes: np.ndarray | None, stats: RunStats, pkey,
                audit) -> list:
        """One burst's groups: the candidates (Kleene queries, Def. 4) the
        policy shares, then singletons for the rest of ``q_pos``.

        A pattern-based policy decides from the burst's slice of the
        prologue's divergence codes (``codes``, packed for edge-free
        types) through ``decide_patterns``; any other burst goes through
        ``decide`` with its divergence rows.  Both inputs compress to the
        same coverage patterns (``optimizer.divergence_patterns``), so
        they decide alike.  Static policies decide per local type once."""
        ctx = self.ctx
        kle = ctx.kle_pos[el]
        rest = [[qi] for qi in q_pos if qi not in kle]
        if len(kle) < 2:
            return [[qi] for qi in kle] + rest
        policy = self.policy
        memo = self._static_groups.get(el)
        if memo is not None:
            stats.decisions += 1
            shared_sets = memo
        elif codes is not None:
            cb = codes.tobytes()
            pats = self._pats_cache.get(cb)
            if pats is None:
                nz = codes[codes != 0]
                vals, counts = np.unique(nz, return_counts=True)
                pats = tuple(zip(vals.tolist(), counts.tolist()))
                if len(self._pats_cache) >= 8192:
                    self._pats_cache.clear()
                self._pats_cache[cb] = pats
            shared_sets = policy.decide_patterns(
                patterns=pats, candidates=kle, b=b, n=stats.events,
                t=max(1, ctx.layout.t), stats=stats)
        else:
            d_rows = (None if self._policy_static else
                      self._divergence_rows(q_pos, kle, el, mvec, epm))
            shared_sets = policy.decide(
                ctx=ctx, el=el, candidates=kle, d_rows=d_rows, b=b,
                n=stats.events, stats=stats)
            if self._policy_static:
                self._static_groups[el] = shared_sets
        in_shared = set(qq for s in shared_sets for qq in s)
        groups = ([s for s in shared_sets if len(s) >= 2]
                  + [[qi] for s in shared_sets if len(s) == 1 for qi in s]
                  + [[qi] for qi in kle if qi not in in_shared] + rest)
        if audit is not None:
            audit.record(
                pane=pkey, comp=self.comp, el=el, candidates=kle,
                decided=tuple(map(tuple, groups)), b=b, n=stats.events,
                benefit=getattr(policy, "last_benefit", None),
                patterns=getattr(policy, "last_patterns", None))
        return groups

    def _build_steps(self, plan_bursts: list, stats: RunStats) -> list:
        """Construct the step list: group plans with divergence layout,
        adjacency, z columns, and count-round injection rows.  A burst's
        single-query groups are planned together by :meth:`_plan_singles`,
        its shared groups one at a time by :meth:`_plan_group`; the steps
        keep the groups' order; a burst's ``_NegStep`` (built by the walk)
        goes first."""
        steps: list = []
        for neg, burst in plan_bursts:
            if neg is not None:
                steps.append(neg)
            if burst is None:
                continue
            tid, el, attrs, b, q_pos, mvec, epm, groups = burst
            qpos_index = {qi: i for i, qi in enumerate(q_pos)}
            qs = [g[0] for g in groups if len(g) == 1]
            singles = iter(self._plan_singles(
                qs, [qpos_index[qi] for qi in qs], el, tid, attrs, b, mvec,
                epm))
            for g in groups:
                if len(g) >= 2:
                    stats.shared_bursts += 1
                    stats.shared_graphlets += 1
                stats.graphlets += 1
                if len(g) == 1:
                    stats.stacked_graphlets += 1
                    plan = next(singles)
                    if plan is not None:
                        steps.append(plan)
                    continue
                rows = [qpos_index[qi] for qi in g]
                self._plan_group(g, el, tid, attrs, b, mvec[rows],
                                 [epm[i] for i in rows], steps, stats)
        return steps

    def _plan_singles(self, qs: list, rows: list, el: int, type_id: int,
                      attrs: np.ndarray, b: int, mvec: np.ndarray,
                      epm: list) -> list:
        """The plans of one burst's single-query groups (queries ``qs``,
        rows ``rows`` of ``mvec`` and ``epm``) in one stacked pass, each
        field equal to :meth:`_plan_group`'s on the group alone; ``None``
        where the query matches no event of the burst.

        A lone query has no divergent row, so its plan follows from its
        match row: live where it matches, dead elsewhere, no z column.
        The count injection rows are slices of one ``[s, b, 1 + nu]``
        array, and the sum units and the strictly-lower template are built
        once a burst.  A non-Kleene (trivial) plan gets no adjacency:
        submit passes its injection rows through as its result."""
        if not qs:
            return []
        ctx = self.ctx
        nu = ctx.nu
        M = mvec[rows]                                   # [s, b]
        start = ctx.start_flag[qs, el]
        kle = ctx.kleene_flag[qs, el].tolist()
        hit = M.any(axis=1).tolist()
        full = M.all(axis=1).tolist()
        base = np.zeros((len(qs), b, 1 + nu))
        base[:, :, 1] = M                                # x_count entry
        base[:, :, 0] = M & start[:, None]               # gate entry
        dead = ~M
        div = np.zeros(b, dtype=bool)
        div_rows = np.nonzero(div)[0]
        sum_units = self._sum_units_for(type_id, attrs, b)
        fits = b <= DENSE_B_MAX
        lower = None
        plans: list = []
        for k, qi in enumerate(qs):
            if not hit[k]:
                plans.append(None)
                continue
            e = epm[rows[k]]
            kleene = kle[k]
            dense = kleene and e is None and full[k] and fits
            em = None
            if kleene and not dense:
                if lower is None:
                    lower = np.tril(np.ones((b, b)), k=-1)
                em = lower * M[k][:, None]
                if e is not None:
                    em *= np.tril(e, k=-1)
            plans.append(_GroupPlan(
                g=[qi], el=el, type_id=type_id, attrs=attrs, b=b,
                mvec=M[k:k + 1], epm=[e], shared=False, div=div,
                div_rows=div_rows, live=M[k], dead=dead[k], B_local=1 + nu,
                z_ids={}, dense=dense, em=em, start_q0=bool(start[k]),
                sum_units=sum_units, base_c=base[k], trivial=not kleene))
        return plans

    def _sum_units_for(self, type_id: int, attrs: np.ndarray, b: int) -> list:
        """Per-burst sum-unit injection values (fresh attribute data)."""
        return [(ui, None if tid != type_id
                 else (np.ones(b) if col is None else attrs[:, col]))
                for ui, tid, col in self.ctx.sum_unit_cols]

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
                    steps: list, stats: RunStats) -> None:
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
                                 mvec[[j]], [epm[j]], steps, stats)
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
            sum_units=self._sum_units_for(type_id, attrs, b),
            trivial=not kleene)
        # count-round injection rows, built once: the execute submit and the
        # fold executor's pre-summed trivial rows both read them
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
                    if p.b > WIDE_ROWS:
                        stats.wide_propagate_cells += p.b * p.B_local
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
                        if p.b > WIDE_ROWS:
                            stats.wide_propagate_cells += p.b * p.B_local
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
        per-shape launches, bitwise identical to this replay on the np
        backend; the device backends reassociate divergent graphlets' sums
        through their collapsed ``S`` rows); this method
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
                    stats.neg_gates += len(s.hits)
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

    ``jobs`` holds the executor handles parallel to ``steps``, kept off the
    plan objects."""

    proc: PaneProcessor
    steps: list
    stats: RunStats
    jobs: list = field(default_factory=list)
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
                    fjobs = [fe.submit(p.proc, p.steps, p.jobs, p.stats)
                             for p in pend]
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
    ``plan_cache`` is accepted and ignored: planning keeps no memo of
    whole panes, and the benchmark's drivers still pass the keyword.
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
                 fold_exec: bool = True,
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
        executor and observability facade (used by the
        overload / event-time layers)."""
        return PaneProcessor(self.ctxs[ci], self.policy, backend=self.backend,
                             executor=self.executor,
                             fold_exec=self.fold_exec, obs=self.obs, comp=ci)

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
        if any(LARGE_COUNT <= v < np.inf for v in vals.values()):
            self.stats.large_count_windows += 1
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
