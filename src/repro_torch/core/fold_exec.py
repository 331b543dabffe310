"""Stacked finalize/fold executor (phases 3-4 of the pipeline).

``PaneProcessor.finalize`` replays a pane group by group: per graphlet a
Python-level coefficient fold (``W`` build, event-snapshot fills, ``S @ W``)
against the running state functionals.  With execute launches fused, that
per-graphlet Python would dominate a pane's cost.  This module lifts the
replay out of the engine into a :class:`FoldExecutor` that mirrors
``batch_exec.PaneBatchExecutor``: it buckets same-shape graphlets — across
a pane *and* across every pane of a micro-batch flush — and folds each
bucket with one stacked matmul set.

Correctness model (what may and may not be reordered)
-----------------------------------------------------
A group's fold reads the state rows of its member queries (``gaterow[g]``,
``arow[g]`` — the x_u functionals are built from the *current* running
aggregates) and accumulates into the same rows; negation steps zero rows of
the same arrays.  Steps touching **disjoint** query sets therefore commute
bitwise, while two steps sharing a query never do (successive graphlets of
one query form a genuine linear recurrence through ``arow``).  The executor
makes that precise with a *level schedule*: walking the pane's step list in
stream order, each step's level is ``1 + max(level of any earlier step
sharing a query)``.  Every per-query chain (negation gates included) stays
strictly ordered across levels; within a level all steps are query-disjoint
by construction, so stacking them is a pure batching of independent slices.
Panes are independent (each folds from a fresh state), so level ``L`` of
every pending pane lands in the same round — a flush of K panes folds its
whole backlog in ``max_levels`` rounds, one stacked launch per shape bucket
``(B_local, d, b)`` per round; without divergent rows the coefficients are
read only through their column sums, so ``d == 0`` graphlets of *different*
burst lengths share one launch.

Bitwise identity with the sequential replay is preserved the same way the
execute phase preserves it (``kernels/ref.py``): every stacked operation is
the *stacked twin* of the per-group numpy call — batched ``np.matmul`` whose
slices run the identical per-slice GEMM, stacked axis-1 column sums whose
slices run the identical axis-0 reduction, boolean masks, and ``np.where``
selects of exactly-zero lanes.  The event-snapshot fill loop (rank-1 ``P``
updates per divergent row) advances all bucket members one divergent row at
a time; members are independent, so interleaving them is a no-op, and the
per-row arithmetic keeps the sequential operand order.  That loop is the
np backend's; the device backends collapse each divergent graphlet at
flush prep instead (:meth:`FoldExecutor._collapse`: the same sums,
reassociated through one triangular solve a member), and it folds on the
d == 0 path.

Flush plan
----------
Each pane's **level schedule** (step levels, negation split points,
per-level shape buckets with member index arrays) is built from its step
list, and the flush's schedules merge into one **flush plan**: the
per-round buckets of the whole flush, with flat gather/scatter indices into
the stacked state, pre-summed ``S`` rows for trivial graphlets (their count
coefficients *are* the injection rows built at plan time), and a
flush-global batched-by-burst-length layout for the dynamic ``S`` fills.
A flush then pays, per round: one ``take`` of the state rows, two batched
matmuls, one fancy-indexed scatter — plus a handful of flush-wide stacked
column sums.

Window folds (phase 4) ride the same executor: :meth:`FoldExecutor
.fold_windows` is the batched twin of :func:`repro_torch.core.engine.fold_panes`,
bucketing window chains by length and folding each bucket through
``kernels.ops.fold_stacked`` with one host sync for the whole batch — the
event-time revision path uses it to re-fold a revision storm's dirty windows
as one stacked launch set.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from time import perf_counter

import numpy as np
import torch

from ..kernels import ops
from ..obs.metrics import OCCUPANCY_BUCKETS

__all__ = ["FoldExecutor", "FoldJob", "FoldSchedule", "build_fold_schedule"]

def _is_group(step) -> bool:
    # duck-typed to avoid an import cycle with engine.py: group plans carry
    # ``g``; negation steps carry ``hits``
    return hasattr(step, "g")


# --------------------------------------------------------------------------
# fold schedule: levels + per-level shape buckets
# --------------------------------------------------------------------------


@dataclass
class _BucketTpl:
    """Same-shape graphlets of one plan at one level, with the member-level
    structural arrays the stacked fold needs."""

    b: int                 # exact burst length (0 for d == 0: ragged bucket)
    B_local: int
    d: int
    steps: list            # step indices into the pane's step list
    ng: int                # number of groups
    q: np.ndarray          # [Nm] member query ids
    gof: np.ndarray        # [Nm] member -> group ordinal within this bucket
    el: np.ndarray         # [Nm] member local-type indices
    ptm: np.ndarray        # [Nm, t] float64 pt_mask rows
    start: np.ndarray      # [Nm] float64 start-flag (the f_c gate term)
    end: np.ndarray        # [Nm] bool end-flag (rrow rows)
    div: np.ndarray | None  # [ng, d] divergent row indices (None when d==0)
    # [Nm, n_used, 1 + nu]: a collapsed divergent template's own ``S`` rows,
    # one block a member (each member is its own group, d == 0)
    s_eff: np.ndarray | None = None


@dataclass
class FoldSchedule:
    """Fold plan of one pane: levels, negation split points, and the
    per-level shape buckets."""

    n_levels: int
    used: tuple            # unit indices folded per group: (0, *sum units)
    neg: list              # per level: [(step idx, hits)]
    buckets: list          # per level: [ _BucketTpl ]


def _levelize(steps: list) -> list[int]:
    """Per-step fold level: ``1 + max(level of any earlier step sharing a
    query)`` — every per-query chain is serialized across levels, and steps
    within a level are query-disjoint (their folds commute bitwise)."""
    cur: dict[int, int] = {}
    levels: list[int] = []
    for s in steps:
        qs = s.g if _is_group(s) else [qi for qi, _ in s.hits]
        lv = 0
        for q in qs:
            c = cur.get(q, 0)
            if c > lv:
                lv = c
        levels.append(lv)
        for q in qs:
            cur[q] = lv + 1
    return levels


def build_fold_schedule(ctx, steps: list) -> FoldSchedule:
    """Derive the structural fold schedule for one pane's step list."""
    levels = _levelize(steps)
    n_levels = (max(levels) + 1) if levels else 0
    used = tuple([0] + [ui for ui, _, _ in ctx.sum_unit_cols])
    neg: list[list] = [[] for _ in range(n_levels)]
    raw: list[dict] = [{} for _ in range(n_levels)]
    for i, (s, lv) in enumerate(zip(steps, levels)):
        if not _is_group(s):
            neg[lv].append((i, s.hits))
            continue
        # without divergent rows the fold reads the coefficients only
        # through their per-group column sums, so graphlets of *different*
        # burst lengths stack into one launch; the snapshot-fill path
        # (d > 0) carries per-event arrays and needs the exact length
        raw[lv].setdefault(
            (s.B_local, s.b if len(s.div_rows) else 0), []).append(i)
    buckets: list[list[_BucketTpl]] = []
    for lv in range(n_levels):
        out = []
        for (B_local, b), idxs in raw[lv].items():
            q_parts, gof_parts, el_parts, ptm_parts = [], [], [], []
            start_parts, end_parts, div_parts = [], [], []
            d = None
            for go, i in enumerate(idxs):
                s = steps[i]
                g = np.asarray(s.g, dtype=int)
                q_parts.append(g)
                gof_parts.append(np.full(len(g), go, dtype=int))
                el_parts.append(np.full(len(g), s.el, dtype=int))
                ptm_parts.append(ctx.pt_mask[g, s.el].astype(np.float64))
                start_parts.append(
                    ctx.start_flag[g, s.el].astype(np.float64))
                end_parts.append(ctx.end_flag[g, s.el])
                dr = np.asarray(s.div_rows, dtype=int)
                if d is None:
                    d = len(dr)
                div_parts.append(dr)
            out.append(_BucketTpl(
                b=b, B_local=B_local, d=int(d), steps=idxs, ng=len(idxs),
                q=np.concatenate(q_parts),
                gof=np.concatenate(gof_parts),
                el=np.concatenate(el_parts),
                ptm=np.ascontiguousarray(np.concatenate(ptm_parts)),
                start=np.concatenate(start_parts),
                end=np.concatenate(end_parts),
                div=(np.stack(div_parts) if d else None)))
        buckets.append(out)
    return FoldSchedule(n_levels=n_levels, used=used, neg=neg,
                        buckets=buckets)


def _split_collapsed(tpl: _BucketTpl, okg: np.ndarray, s_eff: np.ndarray,
                     nu: int) -> list[_BucketTpl]:
    """The divergent template ``tpl`` as its collapsed graphlets (``okg``:
    d == 0, each member its own group with its ``S_eff`` block) and the rest,
    which keep the row loop."""
    okm = okg[tpl.gof]
    out = []
    if okm.any():
        nm = int(okm.sum())
        out.append(replace(
            tpl, b=0, d=0, B_local=1 + nu, steps=[], ng=nm,
            gof=np.arange(nm), div=None, s_eff=s_eff[okm], q=tpl.q[okm],
            el=tpl.el[okm], ptm=tpl.ptm[okm], start=tpl.start[okm],
            end=tpl.end[okm]))
    if not okm.all():
        bad = np.flatnonzero(~okg)
        out.append(replace(
            tpl, steps=[tpl.steps[g] for g in bad], ng=len(bad),
            gof=np.searchsorted(bad, tpl.gof[~okm]), div=tpl.div[bad],
            q=tpl.q[~okm], el=tpl.el[~okm], ptm=tpl.ptm[~okm],
            start=tpl.start[~okm], end=tpl.end[~okm]))
    return out


@functools.lru_cache(maxsize=256)
def _collapse_index(nu: int, used: tuple, d: int) -> tuple:
    """Index arrays of a collapsed system with ``d`` divergent rows, its
    unknowns ordered ``(r, pos)``: each unknown's ``W`` column, the base row
    its own term reads (``1 + used[pos]``), and the row of its count
    (``(r, 0)``)."""
    n_used = len(used)
    ar = np.arange(d * n_used)
    u = np.asarray(used)[ar % n_used]
    out = (1 + nu + nu * (ar // n_used) + u, 1 + u, ar - ar % n_used)
    for a in out:
        a.setflags(write=False)
    return out


# --------------------------------------------------------------------------
# executor
# --------------------------------------------------------------------------


@dataclass
class FoldJob:
    """One pending (pane, component) finalize; ``M`` is set by ``flush``."""

    proc: object           # PaneProcessor (supplies ctx + legacy fallback)
    steps: list
    jobs: list             # executor handles parallel to ``steps``
    stats: object
    M: np.ndarray | None = None


def _state0(ctx, J: int) -> np.ndarray:
    """Fresh fused pane-entry state ``Z [J, k, R, C]`` (row layout: ``0 =
    gate``, ``1 + u*t + ty = arow[u, ty]``, ``1 + nu*t + u = rrow[u]``)."""
    k, nu = ctx.k, ctx.nu
    t, C = len(ctx.pos_type_ids), ctx.layout.size
    R = 1 + nu * t + nu
    Z = np.zeros((J, k, R, C))
    Z[:, :, 0, ctx.layout.GATE] = 1.0
    if nu and t:
        Z[:, :, 1 + np.arange(nu * t), ctx.a_cols.reshape(-1)] = 1.0
    if nu:
        Z[:, :, 1 + nu * t + np.arange(nu), ctx.rp_cols] = 1.0
    return Z


class _CtxState:
    """Stacked running state of every pending job sharing one component
    context, fused into one array ``Z [J, k, R, C]`` — one gather serves a
    whole bucket's ``W`` build (see :func:`_state0` for the row layout)."""

    def __init__(self, ctx, jobs: list[FoldJob], Z: np.ndarray | None = None):
        self.ctx = ctx
        self.jobs = jobs
        nu = ctx.nu
        t, C = len(ctx.pos_type_ids), ctx.layout.size
        self.nu, self.t, self.C = nu, t, C
        self.R = 1 + nu * t + nu
        if Z is None:
            Z = _state0(ctx, len(jobs))
        self.Z = Z
        self.Z2 = Z.reshape(len(jobs) * ctx.k, self.R, C)
        self.Zf = Z.reshape(len(jobs) * ctx.k * self.R, C)

    def apply_neg(self, row: int, hits) -> None:
        """Gate job ``row``'s state rows of each hit's query; every gate
        counts in that job's ``RunStats.neg_gates``."""
        nu, t = self.nu, self.t
        self.jobs[row].stats.neg_gates += len(hits)
        for qi, rule in hits:
            if rule.kind == "leading":
                self.Z[row, qi, 0, :] = 0.0
            elif rule.kind == "trailing":
                self.Z[row, qi, 1 + nu * t:, :] = 0.0
            else:
                rows = (1 + np.arange(nu)[:, None] * t
                        + rule.before_local[None, :]).ravel()
                self.Z[row, qi, rows, :] = 0.0

    def assemble(self) -> np.ndarray:
        ctx = self.ctx
        J, k, nu = len(self.jobs), ctx.k, self.nu
        t, C = self.t, self.C
        M = np.zeros((J, k, C, C))
        M[:, :, ctx.layout.CONST, ctx.layout.CONST] = 1.0
        M[:, :, ctx.layout.GATE, :] = self.Z[:, :, 0]
        if nu and t:
            M[:, :, ctx.a_cols.reshape(-1), :] = self.Z[:, :, 1:1 + nu * t]
        if nu:
            M[:, :, ctx.rp_cols, :] = self.Z[:, :, 1 + nu * t:]
        return M


@dataclass
class _MergedBucket:
    """One flush-round stacked launch: same-shape graphlets of one level,
    concatenated across every pending pane of the flush."""

    B_local: int
    b: int                 # exact burst length (0 for d == 0: ragged)
    d: int
    used: tuple
    # d > 0: [Nm] member -> group ordinal (bucket-local); d == 0:
    # [Nm * n_used] member-by-unit rows of the flush's ``s_flat``
    gof: np.ndarray
    ptm: np.ndarray        # [Nm, t] pt_mask rows (float64)
    start: np.ndarray      # [Nm] start flags (float64; d > 0 only)
    flat_gq: np.ndarray    # [Nm] state-row gather (into Z2)
    flat_sc: np.ndarray    # [Nm * n_used] arow scatter (into Zf)
    flat_er: tuple | None  # (rrow scatter rows, upd row mask) or None
    group_refs: list       # [(state row, step idx)] per group, in order
    div_g: np.ndarray | None      # [Ng, d] (d > 0 only)


@dataclass
class _Round:
    negs: list             # [(state row, hits)]
    buckets: list          # [_MergedBucket]


@dataclass
class _ScanProgram:
    """Device-resident operand set executing a whole *scannable* flush plan
    as one logical launch (see :func:`repro_torch.kernels.ops
    .fold_rounds_scan` for the operand semantics), built with its flush
    plan; only the ``S`` block is passed at launch."""

    Z0: object             # [J*k*R + 1, C] fresh state + scratch row
    PTM: object            # [rounds, NMAX, t]
    GQ: object             # [rounds, NMAX, R]
    SIDX: object           # [rounds, NMAX, n_used]
    SC: object             # [rounds, NMAX * n_used]
    ER: object             # [rounds, NMAX * n_used]
    nu: int
    t: int
    n_used: int
    J: int
    k: int
    R: int
    C: int


@dataclass
class _SRows:
    """The flush's d == 0 ``S`` rows as ``_merge_bucket`` registers them:
    ``n`` groups so far, static blocks ``(first group, [n, n_used, 1 + nu])``
    and dynamic fills by burst length ``{b: [(group, (row, step idx))]}``."""

    n: int = 0
    static: list = field(default_factory=list)
    dyn: dict = field(default_factory=dict)


@dataclass
class _FlushPlan:
    """Merged fold plan of one (ctx, flush): the K panes' schedules.

    ``s_flat`` holds one ``[n_used, 1 + nu]`` row block per d == 0 graphlet
    of the whole flush, and one per member of a collapsed divergent
    graphlet; rows of trivial graphlets are pre-summed at build time (their
    count coefficients are the injection rows), collapsed ones are built
    with the plan, the rest are filled by ``s_fill`` — one stacked column
    sum per distinct burst length across *all* rounds.

    A *scannable* plan (every round: no negation steps, exactly one d == 0
    bucket) additionally carries a compiled execution form: ``scan`` (device
    backends — the whole flush as one device program) or ``fast``
    (numpy — the fused host round loop with one flush-wide ``S`` gather)."""

    rounds: list           # [_Round]
    s_flat: np.ndarray | None
    s_fill: list           # [(global ordinals, [(state row, step idx)])]
    scan: _ScanProgram | None = None
    fast: list | None = None      # [(merged bucket, S_all row offset)]
    fast_cat: np.ndarray | None = None   # concatenated gof of all rounds
    # fused form of ``s_fill``: (segment refs [(row, step, unit)], segment
    # start offsets, flat ordinals) — one concatenate + one reduceat per
    # flush instead of one stack + sum per distinct burst length
    s_fill_cat: tuple | None = None


class FoldExecutor:
    """Bucketed stacked finalize/fold for the pane pipeline.

    ``submit`` queues one (pane, component) finalize; ``flush`` folds the
    whole backlog level by level, one stacked launch set per shape bucket
    per round, and deposits each job's transfer matrices on ``job.M``.
    On the np backend results are bitwise identical to the sequential
    :meth:`PaneProcessor.finalize` replay (pinned by
    ``tests/test_fold_exec.py``); the device backends collapse divergent
    graphlets (``tests/test_torch_fold_collapse.py``).
    """

    def __init__(self, backend: str = "cuda", obs=None, device=None):
        self.backend = backend
        # None on the np backend; raises when a missing GPU is asked for
        self.device = ops.resolve_device(backend, device)
        self.obs = obs
        self._pending: list[FoldJob] = []
        self.flushes = 0
        self.launches = 0         # stacked group-fold launches (buckets)
        self.window_folds = 0     # stacked window-chain launches (buckets)

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, proc, steps: list, jobs: list, stats) -> FoldJob:
        job = FoldJob(proc=proc, steps=steps, jobs=jobs, stats=stats)
        self._pending.append(job)
        return job

    # -- phase 3: the stacked finalize --

    def flush(self) -> None:
        jobs, self._pending = self._pending, []
        if not jobs:
            return
        self.flushes += 1
        l0 = self.launches
        with np.errstate(over="ignore", invalid="ignore"):
            self._flush(jobs)
        if self.obs is not None:
            self.obs.observe("fold_exec.launches_per_flush",
                             self.launches - l0, OCCUPANCY_BUCKETS)

    def _flush(self, jobs: list[FoldJob]) -> None:
        # group pending jobs by component context; each ctx group holds a
        # stacked state and its own merged flush plan.  With an obs attached
        # each group is three steps, each timed once: ``finalize.prep`` (the
        # flush plan and ``S``), ``finalize.rounds`` (the scan launch or the
        # host rounds) and ``finalize.wait`` (the fetch, the scatter and
        # the flush plan's release).
        obs = self.obs
        by_ctx: dict[int, list[FoldJob]] = {}
        ctx_of: dict[int, object] = {}
        for j in jobs:
            cid = id(j.proc.ctx)
            by_ctx.setdefault(cid, []).append(j)
            ctx_of[cid] = j.proc.ctx

        for cid, cjobs in by_ctx.items():
            t_prep = perf_counter() if obs is not None else 0.0
            ctx = ctx_of[cid]
            scheds = [build_fold_schedule(ctx, j.steps) for j in cjobs]
            # each pane's rounds of the flush plan (its fold levels), those
            # that carry a negation gate, and its divergent graphlets:
            # counts of the panes alone, so any K gives the same totals
            for j, sc in zip(cjobs, scheds):
                j.stats.fold_rounds += sc.n_levels
                j.stats.neg_rounds += sum(1 for negs in sc.neg if negs)
                j.stats.div_graphlets += sum(
                    tpl.ng for tpls in sc.buckets for tpl in tpls if tpl.d)
            fp = self._build_plan(cjobs, scheds)
            for s in {id(j.stats): j.stats for j in cjobs}.values():
                s.fold_flushes += 1
                s.scan_flushes += fp.scan is not None
            # flush-global dynamic S fills: one stacked column sum per
            # distinct burst length across every round of the flush —
            # bitwise equal per slice to the per-group ``coef.sum(axis=0)``
            S_flat = fp.s_flat
            if fp.s_fill_cat is not None:
                # one gather + one segmented column sum for every dynamic
                # fill of the flush; each reduceat segment adds the same
                # rows in the same order as the per-group ``sum(axis=1)``
                refs, starts, ords = fp.s_fill_cat
                jb = cjobs
                cat = np.concatenate(
                    [jb[row].jobs[si][0].result if u == 0
                     else jb[row].jobs[si][1][u].result
                     for row, si, u in refs])
                S_flat[ords] = np.add.reduceat(cat, starts, axis=0)
            sp = fp.scan
            if sp is None:
                st = _CtxState(ctx, cjobs)
            if obs is not None:
                t_rounds = perf_counter()
                obs.step("finalize.prep", "finalize_prep_s", t_prep, t_rounds)
            if sp is not None:
                # the whole fold chain is one device program and one host
                # sync, independent of depth
                Zf = self._run_scan(fp, S_flat)
            elif fp.fast is not None:
                self._run_fast(st, fp, S_flat)
            else:
                for rd in fp.rounds:
                    for row, hits in rd.negs:
                        st.apply_neg(row, hits)
                    for mb in rd.buckets:
                        if mb.d:
                            self._fold_bucket_div(st, mb, cjobs)
                        else:
                            self._fold_bucket_fast(st, mb, S_flat)
            if obs is not None:
                t_wait = perf_counter()
                obs.step("finalize.rounds", "finalize_rounds_s", t_rounds,
                         t_wait)
            if sp is not None:
                Z = ops.device_get_all([Zf])[0][:-1].reshape(sp.J, sp.k,
                                                              sp.R, sp.C)
                st = _CtxState(ctx, cjobs, Z=Z)
            MJ = st.assemble()
            for row, j in enumerate(cjobs):
                j.M = MJ[row].copy()
            del fp, sp, S_flat, st, scheds
            if obs is not None:
                obs.step("finalize.wait", "finalize_wait_s", t_wait,
                         perf_counter())

    # -- flush-plan construction --

    def _build_plan(self, cjobs: list[FoldJob],
                    scheds: list[FoldSchedule]) -> _FlushPlan:
        ctx = cjobs[0].proc.ctx
        if self.backend != "np":
            self._collapse(ctx, cjobs, scheds)
        n_levels = max((sc.n_levels for sc in scheds), default=0)
        rounds: list[_Round] = []
        s_rows = _SRows()
        for lv in range(n_levels):
            negs: list = []
            merged: dict[tuple, list] = {}
            for row, sc in enumerate(scheds):
                if lv >= sc.n_levels:
                    continue
                negs.extend((row, hits) for _i, hits in sc.neg[lv])
                for tpl in sc.buckets[lv]:
                    merged.setdefault(
                        (tpl.B_local, tpl.b if tpl.d else 0),
                        []).append((row, tpl, sc.used))
            rounds.append(_Round(
                negs=negs,
                buckets=[self._merge_bucket(ctx, cjobs, parts, s_rows)
                         for parts in merged.values()]))
        used = scheds[0].used if scheds else (0,)
        n_used = len(used)
        s_flat = None
        s_fill: list = []
        if s_rows.n:
            # flat [G * n_used, 1 + nu] layout: row g*n_used + pos holds
            # group g's column sums for used[pos]
            s_flat = np.empty((s_rows.n * n_used, 1 + ctx.nu))
            for go, blk in s_rows.static:
                s_flat[go * n_used:(go + len(blk)) * n_used] = \
                    blk.reshape(-1, 1 + ctx.nu)
            # group the dynamic fills by (burst length, unit): each becomes
            # one flush-wide stacked column sum
            fill_refs: list = []
            fill_ords: list = []
            fill_lens: list = []
            for b, entries in s_rows.dyn.items():
                ords = np.asarray([o for o, _ in entries], dtype=int)
                refs = [r for _, r in entries]
                for pos, u in enumerate(used):
                    s_fill.append((ords * n_used + pos, refs, u))
                    fill_refs.extend((row, si, u) for row, si in refs)
                    fill_ords.append(ords * n_used + pos)
                    fill_lens.extend([b] * len(refs))
        fp = _FlushPlan(rounds=rounds, s_flat=s_flat, s_fill=s_fill)
        if s_fill:
            starts = np.zeros(len(fill_lens), dtype=np.intp)
            np.cumsum(fill_lens[:-1], out=starts[1:])
            fp.s_fill_cat = (fill_refs, starts, np.concatenate(fill_ords))
        if self._scannable(ctx, fp):
            if self.backend != "np":
                fp.scan = self._build_scan(ctx, len(cjobs), fp)
            else:
                self._build_fast(fp)
        return fp

    # -- divergent graphlets collapsed to state-free S blocks --

    def _collapse(self, ctx, cjobs: list[FoldJob],
                  scheds: list[FoldSchedule]) -> None:
        """Fold every divergent (d > 0) graphlet of the flush through its own
        ``S`` rows: rewrite each d > 0 template of ``scheds`` into a d == 0
        template carrying one ``[n_used, 1 + nu]`` block a member, which
        then merges into its round's d == 0 bucket.

        The snapshot fill (:meth:`_fill_snapshots`) is linear in the base
        rows ``W[:, :1 + nu]`` (gate and ptm-weighted ``arow``, the only
        rows that read the running state): its row loop is forward
        substitution on a unit lower-triangular system per member, so the
        snapshots are ``x = T @ W_base`` with ``T`` built from the plan
        alone, and the bucket's ``S_m @ W`` is ``S_eff @ W_base``.  The same
        sums, reassociated.  A graphlet whose system or ``S`` holds a
        non-finite value keeps the row loop (a ``0 * inf`` in the solve
        would write NaN where the loop's selects keep an inf), as does
        every graphlet on the np backend, the bitwise twin of the
        reference's stacked fold."""
        shapes: dict[tuple, list] = {}
        for row, sc in enumerate(scheds):
            for lv, tpls in enumerate(sc.buckets):
                for ti, tpl in enumerate(tpls):
                    if tpl.d:
                        shapes.setdefault((tpl.b, tpl.d), []).append(
                            (row, lv, ti, tpl))
        used = scheds[0].used
        new: dict[tuple, dict] = {}      # (row, level) -> {tpl idx: tpls}
        for (b, d), entries in shapes.items():
            s_eff, ok = self._collapse_shape(ctx, cjobs, used, b, d,
                                             [e[3] for e in entries],
                                             [e[0] for e in entries])
            m0 = g0 = 0
            for row, lv, ti, tpl in entries:
                okg = ok[g0:g0 + tpl.ng]
                se = s_eff[m0:m0 + len(tpl.q)]
                g0 += tpl.ng
                m0 += len(tpl.q)
                cjobs[row].stats.div_collapsed += int(okg.sum())
                new.setdefault((row, lv), {})[ti] = _split_collapsed(
                    tpl, okg, se, ctx.nu)
        for (row, lv), by_ti in new.items():
            sc = scheds[row]
            sc.buckets[lv] = [t for ti, tpl in enumerate(sc.buckets[lv])
                              for t in by_ti.get(ti, [tpl])]

    @staticmethod
    def _collapse_shape(ctx, cjobs: list[FoldJob], used: tuple, b: int,
                        d: int, tpls: list, rows: list):
        """``S_eff [Nm, n_used, 1 + nu]`` for every member of the divergent
        templates ``tpls`` of one shape ``(b, d)`` (pane rows ``rows``), and
        per graphlet whether it is finite.  One stacked pass; every member's
        products are slices of one fixed shape, so a member's ``S_eff`` is
        the same bits in any flush.

        The unknowns ``x[(r, pos)]`` (divergent row r, unit ``used[pos]``,
        the loop's fill order) solve ``(I - L) x = Cm``: row r's adjacency
        ``rowf_r`` (zero where the row has no match) against the graphlet's
        coefficients gives ``A = rowf @ coef[u]``; ``L`` is ``A`` at x's own
        ``W`` columns, strictly below the diagonal, plus the ``v * f_c``
        coupling of a sum to its row's count, and ``Cm`` is ``A`` at the
        base rows plus the loop's own terms (``start * gate + arow[0]`` for
        the count, ``arow[u]`` for a sum), all where the row matches."""
        nu, n_used = ctx.nu, len(used)
        N = d * n_used
        steps, coefs = [], []
        for row, tpl in zip(rows, tpls):
            job = cjobs[row]
            for si in tpl.steps:
                steps.append(job.steps[si])
                cjob, sjobs = job.jobs[si]
                coefs.append(cjob.result)
                coefs.extend(sjobs[u].result for u in used[1:])
        G = len(steps)
        CF = np.stack(coefs).reshape(G, n_used, b, -1)     # [G, n_used, b, B]
        B = CF.shape[-1]
        sizes = [len(s.g) for s in steps]
        nmax = max(sizes)
        gm = np.repeat(np.arange(G), sizes)         # member -> graphlet
        div_g = np.stack([s.div_rows for s in steps])       # [G, d]
        div = div_g[gm]                                     # [Nm, d]
        mv = np.concatenate([s.mvec for s in steps]).astype(bool, copy=False)
        nm = len(mv)
        mfl = mv[np.arange(nm)[:, None], div]               # [Nm, d]
        # each divergent row's in-burst adjacency: earlier, matched, and
        # (edge predicates) admitted by the member's own mask; a row
        # without a match snapshots zero (the loop's ``np.where``)
        rowf = (np.arange(b) < div[:, :, None]) & mv[:, None, :]
        rowf &= mfl[:, :, None]
        epm = [e for s in steps for e in s.epm]
        has = [i for i, e in enumerate(epm) if e is not None]
        if has:
            rowf[has] &= np.stack([epm[i] for i in has])[
                np.arange(len(has))[:, None], div[has]]
        # A = -rowf @ coef, one [d, b] x [b, n_used * B] product a member
        # against its graphlet's coefficients (members padded to the
        # largest graphlet); negated, so ``I - L`` is read from it in place
        R = rowf * -1.0
        padded = nm != G * nmax
        if padded:
            slot = np.concatenate([g * nmax + np.arange(n)
                                   for g, n in enumerate(sizes)])
            Rp = np.zeros((G * nmax, d, b))
            Rp[slot] = R
            R = Rp
        A = np.matmul(R.reshape(G, nmax, d, b),
                      CF.transpose(0, 2, 1, 3).reshape(G, 1, b, n_used * B))
        A = A.reshape(G * nmax, N, B)
        if padded:
            A = A[slot]
        fin = np.isfinite(A).all(axis=(1, 2))
        if not fin.all():
            A[~fin] = 0.0
        # x's W columns: with every unit folded in order, one slice; the
        # solve reads only the strict lower triangle of ``I - L``
        cols, own, cnt = _collapse_index(nu, used, d)
        IL = (A[:, :, 1 + nu:] if used == tuple(range(nu))
              else A[:, :, cols])
        Cm = -A[:, :, :1 + nu]                              # [Nm, N, 1 + nu]
        mr = np.repeat(mfl, n_used, axis=1)                 # [Nm, N]
        ar = np.arange(N)
        Cm[:, ar, own] += mr
        start = np.concatenate([tpl.start for tpl in tpls])
        Cm[:, 0::n_used, 0] += start[:, None] * mfl
        if n_used > 1:
            # v * f_c: each sum unit's injection values at the divergent
            # rows couple x[(r, pos)] to its row's count x[(r, 0)]
            V = np.zeros((G, n_used, b))
            for g, st in enumerate(steps):
                su = dict(st.sum_units)
                for pos, ui in enumerate(used[1:], 1):
                    if su[ui] is not None:
                        V[g, pos] = su[ui]
            vv = np.take_along_axis(V, div_g[:, None, :], axis=2)[gm]
            IL[:, ar, cnt] -= vv.transpose(0, 2, 1).reshape(nm, N) * mr
        # LAPACK solves column-major slices: hand them over as such
        T = torch.linalg.solve_triangular(
            torch.from_numpy(np.ascontiguousarray(IL.transpose(0, 2, 1))).mT,
            torch.from_numpy(np.ascontiguousarray(Cm.transpose(0, 2, 1))).mT,
            upper=False, unitriangular=True).numpy()        # [Nm, N, 1 + nu]
        S_m = CF.sum(axis=2)[gm]                            # [Nm, n_used, B]
        S_eff = S_m[:, :, :1 + nu] + np.matmul(S_m[:, :, cols], T)
        okm = fin & np.isfinite(S_eff).all(axis=(1, 2))
        return S_eff, np.logical_and.reduceat(
            okm, np.cumsum([0] + sizes[:-1]))

    @staticmethod
    def _scannable(ctx, fp: _FlushPlan) -> bool:
        """True when every round is exactly one d == 0 bucket and no
        negation steps — the shape :func:`ops.fold_rounds_scan` (and the
        fused numpy round loop) compiles to a single uniform program."""
        nu, t = ctx.nu, len(ctx.pos_type_ids)
        if not fp.rounds or fp.s_flat is None or not nu or not t:
            return False
        for rd in fp.rounds:
            if rd.negs or len(rd.buckets) != 1:
                return False
            mb = rd.buckets[0]
            if mb.d or mb.B_local != 1 + nu:
                return False
        return True

    def _build_scan(self, ctx, J: int, fp: _FlushPlan) -> _ScanProgram:
        """Pad every round's gather/scatter operands to a common lane count
        and park them on the executor's device.  Padded lanes read the
        scratch state row and the zero ``S`` row and scatter back to the
        scratch row, so any NaN/inf they produce (0 * inf from
        overflow-regime garbage) never reaches a real state row.  The real
        scatter targets of a round must be distinct — the scan's
        ``index_add_`` is atomic on CUDA, and only distinct targets keep it
        exact and order-free — which is checked here, once per plan."""
        nu, t, C = ctx.nu, len(ctx.pos_type_ids), ctx.layout.size
        k = ctx.k
        R = 1 + nu * t + nu
        n_used = len(fp.rounds[0].buckets[0].used)
        scratch = J * k * R
        n_s = fp.s_flat.shape[0]       # the appended zero S row's index
        nr = len(fp.rounds)
        nmax = max(len(rd.buckets[0].flat_gq) for rd in fp.rounds)
        GQ = np.full((nr, nmax, R), scratch, dtype=np.int64)
        PTM = np.zeros((nr, nmax, t))
        SIDX = np.full((nr, nmax, n_used), n_s, dtype=np.int64)
        SC = np.full((nr, nmax * n_used), scratch, dtype=np.int64)
        ER = np.full((nr, nmax * n_used), scratch, dtype=np.int64)
        ar = np.arange(R, dtype=np.int64)
        for r, rd in enumerate(fp.rounds):
            mb = rd.buckets[0]
            nm = len(mb.flat_gq)
            GQ[r, :nm] = mb.flat_gq[:, None].astype(np.int64) * R + ar
            PTM[r, :nm] = mb.ptm
            SIDX[r, :nm] = mb.gof.reshape(nm, n_used)
            SC[r, :nm * n_used] = mb.flat_sc
            if mb.flat_er is not None:
                rows, em = mb.flat_er
                if em is None:
                    ER[r, :nm * n_used] = rows
                else:
                    ER[r, :nm * n_used][em] = rows
        for r in range(nr):
            for rows in (SC[r], ER[r]):
                real = rows[rows != scratch]
                if len(np.unique(real)) != len(real):
                    raise RuntimeError(
                        f"fold round {r}: scatter targets repeat; the scan "
                        "program needs query-disjoint levels")
        Z0 = np.concatenate([_state0(ctx, J).reshape(-1, C),
                             np.zeros((1, C))])
        dev = self.device

        def dp(x):
            return torch.as_tensor(x, device=dev)

        return _ScanProgram(Z0=dp(Z0), PTM=dp(PTM), GQ=dp(GQ),
                            SIDX=dp(SIDX), SC=dp(SC), ER=dp(ER),
                            nu=nu, t=t, n_used=n_used, J=J, k=k, R=R, C=C)

    @staticmethod
    def _build_fast(fp: _FlushPlan) -> None:
        """Numpy twin of the scan program: precompute each round's offset
        into one flush-wide ``S`` gather so the hot loop runs without
        per-round ``take`` calls or bucket dispatch."""
        rounds, off = [], 0
        for rd in fp.rounds:
            mb = rd.buckets[0]
            rounds.append((mb, off))
            off += len(mb.gof)
        fp.fast = rounds
        fp.fast_cat = np.concatenate([mb.gof for mb, _ in rounds])

    def _merge_bucket(self, ctx, cjobs: list[FoldJob], parts: list,
                      s_rows: "_SRows") -> _MergedBucket:
        _row0, tpl0, used = parts[0]
        n_used = len(used)
        k, nu, t = ctx.k, ctx.nu, len(ctx.pos_type_ids)
        R = 1 + nu * t + nu
        u_arr = np.asarray(used, dtype=int)
        jm_p, q_p, gof_p, el_p, ptm_p, start_p, end_p, div_p = \
            [], [], [], [], [], [], [], []
        group_refs: list = []
        g_off = 0
        for row, tpl, _ in parts:
            nm = len(tpl.q)
            jm_p.append(np.full(nm, row, dtype=int))
            q_p.append(tpl.q)
            el_p.append(tpl.el)
            ptm_p.append(tpl.ptm)
            start_p.append(tpl.start)
            end_p.append(tpl.end)
            if tpl.d:
                gof_p.append(tpl.gof + g_off)
                div_p.append(tpl.div)
                group_refs.extend((row, si) for si in tpl.steps)
                g_off += tpl.ng
                continue
            # global S rows for the d == 0 fast path: a collapsed template
            # brings its members' own blocks; trivial graphlets' count
            # coefficients are their injection rows, so their column sums
            # are pre-summed at build time; the rest register a dynamic
            # fill.  ``gof`` holds the member-by-unit rows of ``s_flat``
            base = s_rows.n
            gof_p.append(((tpl.gof + base)[:, None] * n_used
                          + np.arange(n_used)).ravel())
            if tpl.s_eff is not None:
                s_rows.static.append((base, tpl.s_eff))
            else:
                for go, si in enumerate(tpl.steps):
                    step = cjobs[row].steps[si]
                    if step.trivial and n_used == 1:
                        s_rows.static.append(
                            (base + go, step.base_c.sum(axis=0)[None, None]))
                    else:
                        s_rows.dyn.setdefault(step.b, []).append(
                            (base + go, (row, si)))
            s_rows.n += tpl.ng
        jm = np.concatenate(jm_p)
        q = np.concatenate(q_p)
        el = np.concatenate(el_p)
        end = np.concatenate(end_p)
        gof = np.concatenate(gof_p)
        nm = len(q)
        # flat scatter indices into the fused state (member-major,
        # used-unit-minor — the accumulation order of the sequential replay)
        sqr = np.repeat(jm * k + q, n_used) * R
        su = np.tile(u_arr, nm)
        flat_sc = sqr + 1 + su * t + np.repeat(el, n_used)
        em = np.repeat(end, n_used)
        # em=None marks the common all-ends bucket (e.g. every member of a
        # Kleene end-type graphlet): the scatter reuses ``upd`` unsliced
        flat_er = None
        if em.any():
            flat_er = (sqr[em] + 1 + nu * t + su[em],
                       None if em.all() else em)
        return _MergedBucket(
            B_local=tpl0.B_local, b=tpl0.b, d=tpl0.d, used=used, gof=gof,
            ptm=np.ascontiguousarray(np.concatenate(ptm_p)),
            start=np.concatenate(start_p),
            flat_gq=jm * k + q, flat_sc=flat_sc, flat_er=flat_er,
            group_refs=group_refs,
            div_g=(np.concatenate(div_p, axis=0) if div_p else None))

    # -- compiled execution forms for scannable plans --

    def _run_scan(self, fp: _FlushPlan, S_flat: np.ndarray):
        """Launch the whole flush as one device program; returns the
        device-resident scanned state (one host sync fetches it).

        The index operands and the fresh state went to the device with the
        flush plan; the ``S`` block crosses with the launch.  Counts as a
        single stacked launch however deep the fold chain is."""
        sp = fp.scan
        self.launches += 1
        if self.obs is not None:
            self.obs.count("fold_exec.scan_launches")
            self.obs.observe("fold_exec.bucket_occupancy",
                             max(len(rd.buckets[0].flat_gq)
                                 for rd in fp.rounds), OCCUPANCY_BUCKETS)
        S_pad = np.concatenate([S_flat, np.zeros((1, S_flat.shape[1]))])
        return ops.fold_rounds_scan(sp.Z0, S_pad, sp.PTM, sp.GQ, sp.SIDX,
                                    sp.SC, sp.ER, nu=sp.nu, t=sp.t,
                                    n_used=sp.n_used)

    def _run_fast(self, st: _CtxState, fp: _FlushPlan,
                  S_flat: np.ndarray) -> None:
        """Fused host round loop for scannable plans: one flush-wide ``S``
        gather, then per round the same three stacked ops as
        :meth:`_fold_bucket_fast` (bitwise identical — each round's ``S``
        slice holds the very rows the per-round ``take`` would copy)."""
        nu, t, C = st.nu, st.t, st.C
        Z2, Zf = st.Z2, st.Zf
        obs = self.obs
        nut = 1 + nu * t
        S_all = S_flat.take(fp.fast_cat, axis=0)
        for mb, off in fp.fast:
            self.launches += 1
            flat_gq = mb.flat_gq
            nm = len(flat_gq)
            if obs is not None:
                obs.observe("fold_exec.bucket_occupancy", nm,
                            OCCUPANCY_BUCKETS)
            n_used = len(mb.used)
            zm = Z2.take(flat_gq, axis=0)
            W = np.empty((nm, mb.B_local, C))
            W[:, 0] = zm[:, 0]
            W[:, 1:1 + nu] = np.matmul(
                mb.ptm[:, None, None, :],
                zm[:, 1:nut].reshape(nm, nu, t, C))[:, :, 0, :]
            S_m = S_all[off:off + nm * n_used].reshape(nm, n_used,
                                                       mb.B_local)
            upd = np.matmul(S_m, W).reshape(nm * n_used, C)
            Zf[mb.flat_sc] += upd
            if mb.flat_er is not None:
                rows, em = mb.flat_er
                Zf[rows] += upd if em is None else upd[em]

    # -- the two bucket kernels --

    def _fold_bucket_fast(self, st: _CtxState, mb: _MergedBucket,
                          S_flat: np.ndarray) -> None:
        """d == 0: no event-level snapshots — the fold reads coefficients
        only through their column sums (already seeded in ``S_flat``), so
        one gather, two batched matmuls and one scatter fold the bucket."""
        self.launches += 1
        if self.obs is not None:
            self.obs.observe("fold_exec.bucket_occupancy", len(mb.flat_gq),
                             OCCUPANCY_BUCKETS)
        nu, t, C = st.nu, st.t, st.C
        n_used = len(mb.used)
        zm = st.Z2.take(mb.flat_gq, axis=0)        # [Nm, R, C]
        nm = len(mb.flat_gq)
        # d == 0 means B_local == 1 + nu: every row is overwritten below,
        # so the buffer needs no zeroing
        W = np.empty((nm, mb.B_local, C))
        W[:, 0] = zm[:, 0]
        if nu:
            W[:, 1:1 + nu] = np.matmul(
                mb.ptm[:, None, None, :],
                zm[:, 1:1 + nu * t].reshape(nm, nu, t, C))[:, :, 0, :]
        S_m = S_flat.take(mb.gof, axis=0).reshape(nm, n_used, mb.B_local)
        upd = np.matmul(S_m, W).reshape(nm * n_used, C)
        # level construction guarantees the scatter targets are distinct:
        # plain fancy-indexed accumulation, no np.add.at needed
        st.Zf[mb.flat_sc] += upd
        if mb.flat_er is not None:
            rows, em = mb.flat_er
            st.Zf[rows] += upd if em is None else upd[em]

    def _fold_bucket_div(self, st: _CtxState, mb: _MergedBucket,
                         cjobs: list[FoldJob]) -> None:
        """d > 0: event-level snapshot fills — exact burst length per
        bucket, per-event arrays stacked across members."""
        self.launches += 1
        if self.obs is not None:
            self.obs.observe("fold_exec.bucket_occupancy", len(mb.flat_gq),
                             OCCUPANCY_BUCKETS)
        nu, t, C = st.nu, st.t, st.C
        used, n_used = mb.used, len(mb.used)

        # fetch per-group coefficients and seed S with the per-group column
        # sums, in group order
        coef_stacks: dict[int, list] = {u: [] for u in used}
        S_rows: list[np.ndarray] = []
        steps_g = []
        for row, si in mb.group_refs:
            cjob, sjobs = cjobs[row].jobs[si]
            steps_g.append(cjobs[row].steps[si])
            coefs = {0: cjob.result}
            for ui in used[1:]:
                coefs[ui] = sjobs[ui].result
            for u in used:
                coef_stacks[u].append(coefs[u])
            if n_used > 1:
                S_rows.append(np.stack(
                    [coefs[0].sum(axis=0)]
                    + [coefs[ui].sum(axis=0) for ui in used[1:]]))
            else:
                S_rows.append(coefs[0].sum(axis=0)[None])

        zm = st.Z2.take(mb.flat_gq, axis=0)
        nm = len(mb.flat_gq)
        gate_m = zm[:, 0]
        W = np.zeros((nm, mb.B_local, C))
        W[:, 0] = gate_m
        if nu:
            W[:, 1:1 + nu] = np.matmul(
                mb.ptm[:, None, None, :],
                zm[:, 1:1 + nu * t].reshape(nm, nu, t, C))[:, :, 0, :]

        self._fill_snapshots(st.ctx, W, gate_m, used, mb.b, mb.d,
                             div_g=mb.div_g, gof=mb.gof, steps_g=steps_g,
                             coef_stacks=coef_stacks, start_m=mb.start)

        S_m = np.stack(S_rows)[mb.gof]
        upd = np.matmul(S_m, W).reshape(nm * n_used, C)
        st.Zf[mb.flat_sc] += upd
        if mb.flat_er is not None:
            rows, em = mb.flat_er
            st.Zf[rows] += upd if em is None else upd[em]

    def _fill_snapshots(self, ctx, W, gate_m, used, b, d, *, div_g, gof,
                        steps_g, coef_stacks, start_m) -> None:
        """Stacked twin of the event-snapshot fill loop: all bucket members
        advance one divergent row per iteration; ``P[u]`` carries the rank-1
        updates exactly as the sequential replay does."""
        nu, C = ctx.nu, ctx.layout.size
        nm = len(gof)
        mv_m = np.stack([s.mvec[i] for s, i in self._members(steps_g, gof)])
        adj = np.repeat(np.tril(np.ones((b, b), dtype=bool), k=-1)[None],
                        nm, axis=0)
        for m, (s, i) in enumerate(self._members(steps_g, gof)):
            e = s.epm[i]
            if e is not None:
                adj[m] &= e
        adj &= mv_m[:, None, :]

        coef_m = {u: np.stack(coef_stacks[u])[gof] for u in used}
        P = {u: np.matmul(coef_m[u], W) for u in used}

        # per-(group, div row, sum unit) injection values from the fresh
        # attribute data (v term; None when the unit's type differs)
        n_sum = len(used) - 1
        ng = len(steps_g)
        if n_sum:
            vhas = np.zeros((ng, n_sum), dtype=bool)
            vv = np.zeros((ng, d, n_sum))
            for g, s in enumerate(steps_g):
                su = dict(s.sum_units)
                for pos, ui in enumerate(used[1:]):
                    vals = su[ui]
                    if vals is not None:
                        vhas[g, pos] = True
                        vv[g, :, pos] = vals[div_g[g]]
            vh_m = vhas[gof]
            vv_m = vv[gof]

        ar = np.arange(nm)
        for r in range(d):
            i_m = div_g[gof, r]
            rowf = adj[ar, i_m].astype(float)
            mfl = mv_m[ar, i_m]
            zc = 1 + nu + r * nu
            f_c = (start_m[:, None] * gate_m + W[:, 1]
                   + np.matmul(rowf[:, None, :], P[0])[:, 0])
            f_c = np.where(mfl[:, None], f_c, 0.0)
            self._fill(W, P, coef_m, used, zc, f_c)
            for pos, ui in enumerate(used[1:]):
                f_s = (W[:, 1 + ui]
                       + np.matmul(rowf[:, None, :], P[ui])[:, 0])
                hasv = vh_m[:, pos]
                if hasv.any():
                    f_s[hasv] = (f_s[hasv]
                                 + vv_m[hasv, r, pos, None] * f_c[hasv])
                f_s = np.where(mfl[:, None], f_s, 0.0)
                self._fill(W, P, coef_m, used, zc + ui, f_s)

    @staticmethod
    def _members(steps_g, gof):
        """Iterate (group step, member row within the step) in member order."""
        seen: dict[int, int] = {}
        for g in gof:
            g = int(g)
            i = seen.get(g, 0)
            seen[g] = i + 1
            yield steps_g[g], i

    @staticmethod
    def _fill(W, P, coef_m, used, zcol: int, f: np.ndarray) -> None:
        W[:, zcol] = f
        for u in used:
            col = coef_m[u][:, :, zcol]
            sel = col.any(axis=1)
            if sel.any():
                P[u][sel] += col[sel][:, :, None] * f[sel][:, None, :]

    # -- phase 4: stacked window folds (fold_panes moved behind the executor)

    def fold_windows(self, folds: list) -> list[np.ndarray]:
        """Batched twin of :func:`repro_torch.core.engine.fold_panes`.

        ``folds`` is a list of ``(u0, [M, ...])`` window chains; returns the
        folded state per chain, each bitwise equal to the per-window fold.
        Chains bucket by (length, width) and fold through
        ``ops.fold_stacked`` — one launch set per bucket, one host sync for
        the whole batch on device backends.
        """
        out: list = [None] * len(folds)
        buckets: dict[tuple, list[int]] = {}
        for i, (u0, Ms) in enumerate(folds):
            if not len(Ms):
                out[i] = u0
                continue
            buckets.setdefault((len(Ms), len(u0)), []).append(i)
        raw: list[tuple[list[int], object]] = []
        for idxs in buckets.values():
            self.window_folds += 1
            U0 = np.stack([folds[i][0] for i in idxs])
            Mstack = np.stack([np.stack(folds[i][1]) for i in idxs])
            raw.append((idxs, ops.fold_stacked(U0, Mstack,
                                               backend=self.backend,
                                               device=self.device)))
        for (idxs, _u), host in zip(raw,
                                    ops.device_get_all([u for _, u in raw])):
            for r, i in enumerate(idxs):
                out[i] = host[r]
        return out
