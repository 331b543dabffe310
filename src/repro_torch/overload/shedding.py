"""Load-shedding policies: which events to drop when a pane is over budget.

``drop_tail`` and ``random`` are the classic baselines.  ``benefit_weighted``
is pattern-aware: it classifies event types against the workload (negation
types, pattern-completing non-Kleene types, Kleene types, irrelevant types)
and sheds in an order that protects result quality:

1. events no query matches (free sheds);
2. Kleene-burst *suffixes*, lowest sharing benefit first — trimming a suffix
   keeps the remaining burst contiguous so graphlet snapshots and the
   prefix-propagation stay valid, and the per-burst shed order is ranked by
   the Def. 11 benefit model (``core/benefit.py``): types whose bursts profit
   most from shared execution are kept longest.  At least
   ``min_burst_keep`` of each burst survives this phase so ``E+`` still has a
   witness per burst;
3. pattern-completing (non-Kleene positive) events, newest first, interleaved
   proportionally with the protected remainder of Kleene bursts — a trend
   needs a head *and* a Kleene witness, so under extreme pressure both
   classes must degrade together rather than one being wiped out first;
4. negation-type events, last of all — dropping one can create *false*
   matches for ``NOT`` queries, which destroys the subset guarantee the error
   accountant certifies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core import benefit as B
from ..core.events import EventBatch
from ..core.query import Workload

__all__ = ["ShedPlan", "TypeProfile", "DropTail", "RandomShed",
           "BenefitWeighted", "make_shedder"]


@dataclass(frozen=True)
class ShedPlan:
    """Sorted index partitions of one pane: ``keep`` survives, ``shed`` drops.

    ``witnessed`` certifies that every Kleene burst that lost events (a) lost
    only a *suffix* and (b) retains at least one kept event — the structural
    precondition of the error accountant's multiplicative count bound.
    """

    keep: np.ndarray
    shed: np.ndarray
    witnessed: bool = False

    @property
    def n_keep(self) -> int:
        return len(self.keep)

    @property
    def n_shed(self) -> int:
        return len(self.shed)


def _keep_all(n: int) -> ShedPlan:
    return ShedPlan(np.arange(n), np.array([], dtype=np.int64), witnessed=True)


def _plan_from_shed(n: int, shed_idx, witnessed: bool = False) -> ShedPlan:
    shed = np.sort(np.asarray(shed_idx, dtype=np.int64))
    keep = np.setdiff1d(np.arange(n), shed, assume_unique=True)
    return ShedPlan(keep, shed, witnessed=witnessed)


def _merge_proportional(a: list[int], b: list[int]) -> list[int]:
    """Interleave so every prefix holds ~|a|:|b| of each list (both classes
    deplete at the same relative rate)."""
    out: list[int] = []
    ia = ib = 0
    while ia < len(a) or ib < len(b):
        if ib >= len(b) or (ia < len(a) and ia * len(b) <= ib * len(a)):
            out.append(a[ia])
            ia += 1
        else:
            out.append(b[ib])
            ib += 1
    return out


class TypeProfile:
    """Pattern-aware classification of a workload's event types.

    Each type id lands in exactly one class, by maximum protection need:
    ``negative`` > ``critical`` (positive non-Kleene for some query) >
    ``kleene`` (Kleene-only) > ``irrelevant`` (matched by no query).
    """

    def __init__(self, workload: Workload):
        schema = workload.schema
        kleene_q: dict[int, int] = {}    # type id -> #queries sharing E+
        types_of: dict[int, int] = {}    # type id -> max |types| over its queries
        critical: set[int] = set()
        negative: set[int] = set()
        for q in workload.atomic:
            for t in q.info.types:
                tid = schema.type_id(t)
                if t in q.info.kleene_types:
                    kleene_q[tid] = kleene_q.get(tid, 0) + 1
                    types_of[tid] = max(types_of.get(tid, 1), len(q.info.types))
                else:
                    critical.add(tid)
            for nc in q.info.negatives:
                negative.add(schema.type_id(nc.neg_type))
        self.negative = frozenset(negative)
        self.critical = frozenset(critical - negative)
        self.kleene = frozenset(set(kleene_q) - critical - negative)
        self.irrelevant = frozenset(
            set(range(schema.n_types)) - self.negative - self.critical
            - self.kleene)
        self.kleene_sharers = {tid: kleene_q.get(tid, 1) for tid in self.kleene}
        self.kleene_types_per_q = {tid: types_of.get(tid, 1)
                                   for tid in self.kleene}


class _Policy:
    def plan(self, pane: EventBatch, keep_n: int) -> ShedPlan:
        raise NotImplementedError


class DropTail(_Policy):
    """Keep the oldest ``keep_n`` events; shed the pane's tail."""

    def plan(self, pane, keep_n):
        n = len(pane)
        if keep_n >= n:
            return _keep_all(n)
        return ShedPlan(np.arange(keep_n), np.arange(keep_n, n))


class RandomShed(_Policy):
    """Uniform random sample of ``keep_n`` events, arrival order preserved."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def plan(self, pane, keep_n):
        n = len(pane)
        if keep_n >= n:
            return _keep_all(n)
        keep = np.sort(self._rng.choice(n, size=keep_n, replace=False))
        shed = np.setdiff1d(np.arange(n), keep, assume_unique=True)
        return ShedPlan(keep, shed)


class BenefitWeighted(_Policy):
    """Pattern- and benefit-aware shedding (module docstring)."""

    def __init__(self, workload: Workload, min_burst_keep: float = 0.25,
                 model: str = "v1"):
        self.profile = TypeProfile(workload)
        self.min_burst_keep = float(min_burst_keep)
        self.model = model

    # per-event sharing benefit of a burst of length b (Def. 11/12 per burst,
    # normalised by b): bursts that profit least from shared execution shed
    # first, so high-benefit types stay resident
    def _burst_score(self, tid: int, b: int, n_pane: int) -> float:
        k = self.profile.kleene_sharers.get(tid, 1)
        t = self.profile.kleene_types_per_q.get(tid, 1)
        if self.model == "v2":
            bc = B.benefit_v2(b=b, n=n_pane, s_p=1, s_c=1, k=k, g=b,
                              p=max(1, t // 2))
        else:
            bc = B.benefit_v1(b=b, n=n_pane, s_p=1, s_c=1, k=k, g=b, t=t)
        return bc.benefit / max(1, b)

    @staticmethod
    def _bursts(type_id: np.ndarray) -> list[tuple[int, int, int]]:
        """Maximal same-type runs as ``(type, start, stop)`` (Def. 10)."""
        if len(type_id) == 0:
            return []
        cut = np.nonzero(np.diff(type_id))[0] + 1
        bounds = np.concatenate([[0], cut, [len(type_id)]])
        return [(int(type_id[bounds[i]]), int(bounds[i]), int(bounds[i + 1]))
                for i in range(len(bounds) - 1)]

    def plan(self, pane, keep_n):
        n = len(pane)
        if keep_n >= n:
            return _keep_all(n)
        shed_n = n - keep_n
        prof = self.profile
        tids = pane.type_id

        order: list[int] = []
        # phase 1: irrelevant events, newest first
        irrelevant = np.nonzero(np.isin(tids, list(prof.irrelevant)))[0]
        order.extend(irrelevant[::-1].tolist())

        # phases 2+3: Kleene bursts — suffix-first within a burst, bursts
        # ranked by ascending per-event sharing benefit.  Bursts are segmented
        # *per group partition*, mirroring the engine (which partitions by
        # group before burst segmentation): a kept witness must live in the
        # same group as the trimmed suffix or it witnesses nothing.
        primary: list[tuple[float, list[int]]] = []
        secondary: list[tuple[float, list[int]]] = []
        for gk in np.unique(pane.group):
            gidx = np.nonzero(pane.group == gk)[0]
            for tid, start, stop in self._bursts(tids[gidx]):
                if tid not in prof.kleene:
                    continue
                b = stop - start
                floor_keep = max(1, math.ceil(self.min_burst_keep * b))
                score = self._burst_score(tid, b, n)
                idx = gidx[start:stop]
                suffix = idx[:floor_keep - 1:-1].tolist()
                protected = idx[floor_keep - 1::-1].tolist()
                if suffix:
                    primary.append((score, suffix))
                secondary.append((score, protected))
        for _, idxs in sorted(primary, key=lambda p: p[0]):
            order.extend(idxs)
        n_witnessed = len(order)   # through here every burst keeps a witness

        # phase 3: surplus heads and burst witnesses, degrading together
        crit = np.nonzero(np.isin(tids, list(prof.critical)))[0]
        witnesses: list[int] = []
        for _, idxs in sorted(secondary, key=lambda p: p[0]):
            witnesses.extend(idxs)
        order.extend(_merge_proportional(crit[::-1].tolist(), witnesses))
        # phase 4: negation types, only when nothing else is left
        neg = np.nonzero(np.isin(tids, list(prof.negative)))[0]
        order.extend(neg[::-1].tolist())

        return _plan_from_shed(n, order[:shed_n],
                               witnessed=shed_n <= n_witnessed)


def make_shedder(policy: str, workload: Workload, *, seed: int = 0,
                 min_burst_keep: float = 0.25,
                 benefit_model: str = "v1") -> _Policy | None:
    """Instantiate a shedding policy by name; ``"none"`` returns None."""
    if policy == "none":
        return None
    if policy == "drop_tail":
        return DropTail()
    if policy == "random":
        return RandomShed(seed=seed)
    if policy == "benefit_weighted":
        return BenefitWeighted(workload, min_burst_keep=min_burst_keep,
                               model=benefit_model)
    raise ValueError(f"unknown shed policy {policy!r}")
