"""Merged HAMLET query template (paper Sec. 3.1, Figs. 3 & 8).

Each atomic query's FSA view is materialised as boolean matrices over the
schema's type universe, and the whole workload is merged into one template
whose transitions are labelled by the set of queries they hold for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .events import StreamSchema
from .query import AtomicQuery

__all__ = ["QueryTemplate", "MergedTemplate", "build_templates"]


@dataclass
class QueryTemplate:
    """Matrix view of one atomic query over the type universe (T types).

    pred_type[e2, e1]  True iff e1 in pt(e2, q)   (paper Example 2)
    start[e] / end[e]  start / end types
    match[e]           type appears positively in the pattern
    negative[e]        type appears as a NOT component
    kleene[e]          E+ sub-pattern present (self-loop)
    """

    q: AtomicQuery
    pred_type: np.ndarray
    start: np.ndarray
    end: np.ndarray
    match: np.ndarray
    negative: np.ndarray
    kleene: np.ndarray


@dataclass
class MergedTemplate:
    """The HAMLET query template for a workload component.

    edge_q[k, e2, e1]  transition e1 -> e2 holds for query k
    shared_kleene[e]   list of query indices (into the component) for which
                       ``e+`` is shareable (Def. 4): len > 1 means shareable.
    """

    schema: StreamSchema
    queries: list[AtomicQuery]
    per_query: list[QueryTemplate]
    edge_q: np.ndarray
    shared_kleene: dict[int, list[int]]

    @property
    def n_types(self) -> int:
        return self.schema.n_types

    def type_ids_used(self) -> np.ndarray:
        used = np.zeros(self.schema.n_types, dtype=bool)
        for t in self.per_query:
            used |= t.match | t.negative
        return np.nonzero(used)[0]


def build_template(schema: StreamSchema, q: AtomicQuery) -> QueryTemplate:
    T = schema.n_types
    pred_type = np.zeros((T, T), dtype=bool)
    start = np.zeros(T, dtype=bool)
    end = np.zeros(T, dtype=bool)
    match = np.zeros(T, dtype=bool)
    negative = np.zeros(T, dtype=bool)
    kleene = np.zeros(T, dtype=bool)
    info = q.info
    for a, b in info.edges:
        pred_type[schema.type_id(b), schema.type_id(a)] = True
    for s in info.start:
        start[schema.type_id(s)] = True
    for e in info.end:
        end[schema.type_id(e)] = True
    for t in info.types:
        match[schema.type_id(t)] = True
    for n in info.negatives:
        negative[schema.type_id(n.neg_type)] = True
    for klt in info.kleene_types:
        kleene[schema.type_id(klt)] = True
    return QueryTemplate(q, pred_type, start, end, match, negative, kleene)


def build_templates(schema: StreamSchema, queries: list[AtomicQuery]) -> MergedTemplate:
    per_query = [build_template(schema, q) for q in queries]
    T = schema.n_types
    k = len(queries)
    edge_q = np.zeros((k, T, T), dtype=bool)
    for i, t in enumerate(per_query):
        edge_q[i] = t.pred_type
    shared: dict[int, list[int]] = {}
    for e in range(T):
        qs = [i for i, t in enumerate(per_query) if t.kleene[e]]
        if qs:
            shared[e] = qs
    return MergedTemplate(schema, list(queries), per_query, edge_q, shared)
