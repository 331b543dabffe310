"""Event trend aggregation queries (paper Def. 2) and workloads.

A query has: RETURN aggregates, PATTERN (Kleene pattern), WHERE predicates,
GROUP-BY attributes, WITHIN/SLIDE window.  Predicates come in two flavours:

* per-event predicates (``Pred``) keyed by event type — e.g. ``R.type = Pool``
  becomes ``{"Request": [Pred("rtype", "==", POOL)]}``;
* same-type *edge* predicates (``EdgePred``) between an event and its
  predecessor inside a Kleene run — the mechanism behind the paper's
  event-level snapshots (Def. 9 / Fig. 5(c)).

Cross-event equality constraints such as ``[rider, vehicle]`` are realised by
stream partitioning (Sec. 3.1): the executor partitions by the group-by and
equality attributes, so trends never span partitions.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field

import numpy as np

from .events import StreamSchema
from .pattern import And, Or, Pattern, PatternInfo, analyze

__all__ = [
    "Pred", "EdgePred", "Agg", "AggKind",
    "count_star", "count_type", "agg_sum", "agg_avg", "agg_min", "agg_max",
    "Query", "AtomicQuery", "Workload",
]

_OPS = {
    "<": operator.lt, "<=": operator.le, ">": operator.gt,
    ">=": operator.ge, "==": operator.eq, "!=": operator.ne,
}


@dataclass(frozen=True)
class Pred:
    """Per-event predicate ``attr OP value``."""

    attr: str
    op: str
    value: float

    def eval(self, attrs: np.ndarray, schema: StreamSchema) -> np.ndarray:
        col = attrs[:, schema.attr_col(self.attr)]
        return _OPS[self.op](col, self.value)


@dataclass(frozen=True)
class EdgePred:
    """Edge predicate between a predecessor j and successor i of one type:
    ``pred.attr OP succ.attr`` must hold for the edge (j, i) to exist."""

    attr: str
    op: str

    def eval_pairs(self, pred_vals: np.ndarray, succ_vals: np.ndarray) -> np.ndarray:
        """[n_pred, n_succ] boolean mask."""
        return _OPS[self.op](pred_vals[:, None], succ_vals[None, :])


class AggKind:
    COUNT_STAR = "COUNT(*)"
    COUNT_TYPE = "COUNT(E)"
    SUM = "SUM"
    MIN = "MIN"
    MAX = "MAX"
    AVG = "AVG"


@dataclass(frozen=True)
class Agg:
    kind: str
    type_name: str | None = None
    attr: str | None = None

    def __repr__(self) -> str:
        if self.kind == AggKind.COUNT_STAR:
            return "COUNT(*)"
        if self.kind == AggKind.COUNT_TYPE:
            return f"COUNT({self.type_name})"
        return f"{self.kind}({self.type_name}.{self.attr})"

    def units(self) -> frozenset[tuple]:
        """Linear propagation units this aggregate needs.

        ``("count",)`` is the trend-count unit (Eq. 1); ``("sum", E, attr)``
        accumulates attr over type-E events in trends; MIN/MAX use a separate
        idempotent path."""
        if self.kind == AggKind.COUNT_STAR:
            return frozenset({("count",)})
        if self.kind == AggKind.COUNT_TYPE:
            return frozenset({("count",), ("sum", self.type_name, None)})
        if self.kind == AggKind.SUM:
            return frozenset({("count",), ("sum", self.type_name, self.attr)})
        if self.kind == AggKind.AVG:
            return frozenset({("count",), ("sum", self.type_name, self.attr),
                              ("sum", self.type_name, None)})
        if self.kind in (AggKind.MIN, AggKind.MAX):
            return frozenset({("count",), ("minmax", self.kind, self.type_name, self.attr)})
        raise ValueError(self.kind)


def count_star() -> Agg:
    return Agg(AggKind.COUNT_STAR)


def count_type(type_name: str) -> Agg:
    return Agg(AggKind.COUNT_TYPE, type_name)


def agg_sum(type_name: str, attr: str) -> Agg:
    return Agg(AggKind.SUM, type_name, attr)


def agg_avg(type_name: str, attr: str) -> Agg:
    return Agg(AggKind.AVG, type_name, attr)


def agg_min(type_name: str, attr: str) -> Agg:
    return Agg(AggKind.MIN, type_name, attr)


def agg_max(type_name: str, attr: str) -> Agg:
    return Agg(AggKind.MAX, type_name, attr)


@dataclass(frozen=True)
class AtomicQuery:
    """A query whose pattern is Or/And-free: directly executable."""

    name: str
    pattern: Pattern
    info: PatternInfo
    aggs: tuple[Agg, ...]
    preds: tuple[tuple[str, tuple[Pred, ...]], ...]  # (type_name -> preds), hashable
    edge_preds: tuple[tuple[str, tuple[EdgePred, ...]], ...]
    within: int
    slide: int
    group_by: tuple[str, ...]

    def preds_for(self, type_name: str) -> tuple[Pred, ...]:
        for t, ps in self.preds:
            if t == type_name:
                return ps
        return ()

    def edge_preds_for(self, type_name: str) -> tuple[EdgePred, ...]:
        for t, ps in self.edge_preds:
            if t == type_name:
                return ps
        return ()

    @property
    def units(self) -> tuple[tuple, ...]:
        out: set[tuple] = set()
        for a in self.aggs:
            out |= a.units()
        # deterministic order: count first, then sums, then minmax
        return tuple(sorted(out, key=lambda u: (u[0] != "count",
                                                tuple(str(x) for x in u))))


@dataclass(frozen=True)
class Query:
    """User-facing query; ``expand()`` resolves top-level Or/And (Sec. 5)."""

    name: str
    pattern: Pattern
    aggs: tuple[Agg, ...] = (Agg(AggKind.COUNT_STAR),)
    preds: dict | None = None            # type_name -> list[Pred]
    edge_preds: dict | None = None       # type_name -> list[EdgePred]
    within: int = 10
    slide: int = 10
    group_by: tuple[str, ...] = ()

    def _freeze_preds(self) -> tuple:
        d = self.preds or {}
        return tuple(sorted((t, tuple(ps)) for t, ps in d.items()))

    def _freeze_edge_preds(self) -> tuple:
        d = self.edge_preds or {}
        return tuple(sorted((t, tuple(ps)) for t, ps in d.items()))

    def _atomic(self, name: str, pattern: Pattern) -> AtomicQuery:
        return AtomicQuery(
            name=name,
            pattern=pattern,
            info=analyze(pattern),
            aggs=tuple(self.aggs),
            preds=self._freeze_preds(),
            edge_preds=self._freeze_edge_preds(),
            within=self.within,
            slide=self.slide,
            group_by=tuple(self.group_by),
        )

    def expand(self) -> tuple[list[AtomicQuery], "_Combine | None"]:
        """Atomic sub-queries plus the result-combination rule (Sec. 5).

        Disjunction:  COUNT(P1 v P2) = C1' + C2' + C12 where Ci' excludes
        doubly-matched trends.  Conjunction: pairs formula.  ``C12`` (trends
        matched by both) is supported when the sub-patterns' positive type
        sets are disjoint (then C12 = 0) or the patterns are identical
        (C12 = C1); the general intersection pattern is out of scope, as in
        the paper which defines it only abstractly.
        """
        p = self.pattern
        if isinstance(p, (Or, And)):
            left, right = p.left, p.right
            li, ri = analyze(left), analyze(right)
            if left == right:
                mode = "identical"
            elif not (li.types & ri.types):
                mode = "disjoint"
            else:
                raise NotImplementedError(
                    "Or/And over overlapping, non-identical patterns needs the "
                    "intersection pattern P_{1,2}, which the paper defines only "
                    "abstractly; use disjoint or identical sub-patterns"
                )
            q1 = self._atomic(self.name + "/L", left)
            q2 = self._atomic(self.name + "/R", right)
            return [q1, q2], _Combine("or" if isinstance(p, Or) else "and", mode)
        return [self._atomic(self.name, p)], None


@dataclass(frozen=True)
class _Combine:
    op: str       # "or" | "and"
    mode: str     # "disjoint" | "identical"

    def combine_counts(self, c1: float, c2: float) -> float:
        if self.mode == "identical":
            c12, c1x, c2x = c1, 0.0, 0.0
        else:
            c12, c1x, c2x = 0.0, c1, c2
        if self.op == "or":
            return c1x + c2x + c12
        # conjunction (Sec. 5): pairs of distinct trends
        return c1x * c2x + c1x * c12 + c2x * c12 + c12 * (c12 - 1) / 2


def _units_compatible(q1: AtomicQuery, q2: AtomicQuery) -> bool:
    """Permissive Def. 5 aggregate rule: queries share the units they have in
    common; the trend-count unit is common to every aggregate, so aggregation
    functions never block sharing under ``mode='units'``."""
    return True


def _paper_aggs_compatible(q1: AtomicQuery, q2: AtomicQuery) -> bool:
    """Strict Def. 5: COUNT(*)/MIN/MAX only share with the same aggregate;
    AVG shares with SUM / COUNT(E) over the same type+attr."""

    def norm(aggs: tuple[Agg, ...]) -> set:
        out = set()
        for a in aggs:
            if a.kind == AggKind.AVG:
                out.add((AggKind.SUM, a.type_name, a.attr))
                out.add((AggKind.COUNT_TYPE, a.type_name, None))
            else:
                out.add((a.kind, a.type_name, a.attr))
        return out

    return bool(norm(q1.aggs) & norm(q2.aggs))


class Workload:
    """A static workload of trend aggregation queries over one stream schema."""

    def __init__(self, schema: StreamSchema, queries: list[Query],
                 sharable_mode: str = "units"):
        self.schema = schema
        self.queries = list(queries)
        self.sharable_mode = sharable_mode
        self.atomic: list[AtomicQuery] = []
        self.combines: list[tuple[str, list[int], _Combine | None]] = []
        for q in self.queries:
            subs, comb = q.expand()
            idxs = []
            for sq in subs:
                idxs.append(len(self.atomic))
                self.atomic.append(sq)
            self.combines.append((q.name, idxs, comb))
        self._validate()

    def _validate(self) -> None:
        for q in self.atomic:
            for t in q.info.types | {n.neg_type for n in q.info.negatives}:
                self.schema.type_id(t)  # raises on unknown
            for _, ps in q.preds + q.edge_preds:
                for p in ps:
                    self.schema.attr_col(p.attr)

    # ---- sharing structure (Defs. 4 & 5) ----

    def sharable_kleene(self, e_type: str) -> list[int]:
        """Indices of atomic queries for which ``e_type+`` is shareable."""
        return [i for i, q in enumerate(self.atomic) if e_type in q.info.kleene_types]

    def queries_sharable(self, i: int, j: int) -> bool:
        q1, q2 = self.atomic[i], self.atomic[j]
        if not (q1.info.kleene_types & q2.info.kleene_types):
            return False
        if tuple(q1.group_by) != tuple(q2.group_by):
            return False
        if self.sharable_mode == "paper" and not _paper_aggs_compatible(q1, q2):
            return False
        return True  # sliding windows over one stream always overlap

    def sharable_components(self) -> list[list[int]]:
        """Connected components of the sharable relation: each component is
        processed by one executor context."""
        n = len(self.atomic)
        parent = list(range(n))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i in range(n):
            for j in range(i + 1, n):
                if self.queries_sharable(i, j):
                    parent[find(i)] = find(j)
        comps: dict[int, list[int]] = {}
        for i in range(n):
            comps.setdefault(find(i), []).append(i)
        return sorted(comps.values())

    @property
    def windows(self) -> list[tuple[int, int]]:
        return [(q.within, q.slide) for q in self.atomic]
