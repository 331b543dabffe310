"""SHARON-style baseline [35]: online aggregation of *fixed-length* sequences.

SHARON does not support Kleene closure.  Following the paper's methodology
(Sec. 6.1), each Kleene sub-pattern ``E+`` is flattened into a set of
fixed-length sequence queries covering every length up to the longest
possible match ``l`` in the window; each fixed-length query is aggregated
online (A-Seq style dynamic program, no sequence construction).  The ``l``-fold
flattening overhead is what dominates its latency in Figs. 9-10.

COUNT(*) only (the paper's Fig. 9-10 metric); other aggregates fall back to
GRETA's quadratic online path.

SHARON is a host baseline: its per-length products ``adj @ cur`` run in
numpy, and its fallback runs GRETA on the numpy backend, so it never touches
a device (as in the JAX package, where it has no backend either).
"""

from __future__ import annotations

import numpy as np

from ..events import EventBatch, StreamSchema, pane_size_for
from ..query import AtomicQuery, AggKind, Workload
from .greta import window_adjacency

__all__ = ["sharon_window_eval", "sharon_run"]


def sharon_window_eval(schema: StreamSchema, q: AtomicQuery, ev: EventBatch,
                       run_type_ids: list[int] | None = None,
                       pane: int | None = None,
                       max_len: int | None = None) -> dict:
    """Evaluate one window by summing per-exact-Kleene-length DP counts.

    Reuses the window adjacency semantics; the DP computes, per event, the
    number of trends of exactly ``m`` events ending there, for m = 1..l —
    the flattened workload SHARON would run.
    """
    adj, start_vec, end_valid, matched, sub = window_adjacency(
        schema, q, ev, run_type_ids, pane=pane)
    n = len(sub)
    out: dict[str, float] = {}
    if n == 0:
        for agg in q.aggs:
            out[repr(agg)] = 0.0 if agg.kind in (
                AggKind.COUNT_STAR, AggKind.COUNT_TYPE, AggKind.SUM) else float("nan")
        return out

    l = int(matched.sum()) if max_len is None else max_len
    l = max(1, l)
    # counts[m][i]: trends with exactly m events ending at i
    cur = start_vec.copy()
    total = np.zeros(n)
    total += cur * end_valid
    for _m in range(2, l + 1):
        cur = adj @ cur          # one flattened fixed-length query per length
        if not cur.any():
            break
        total += cur * end_valid

    for agg in q.aggs:
        if agg.kind == AggKind.COUNT_STAR:
            out[repr(agg)] = float(total.sum())
        else:
            # non-count aggregates: defer to the quadratic online path
            from .greta import window_eval_greta

            out.update(window_eval_greta(schema, q, ev, run_type_ids,
                                         backend="np", pane=pane))
            break
    return out


def sharon_run(workload: Workload, batch: EventBatch,
               t_end: int | None = None) -> dict:
    from ..engine import ComponentContext, combine_results

    pane = pane_size_for(workload.windows)
    if t_end is None:
        t_end = int(batch.time.max()) + 1 if len(batch) else 0
    t_end = ((t_end + pane - 1) // pane) * pane

    run_ids_for: dict[int, list[int]] = {}
    for comp in workload.sharable_components():
        ctx = ComponentContext(workload.schema, [workload.atomic[i] for i in comp])
        for aqi in comp:
            run_ids_for[aqi] = ctx.relevant_type_ids

    atomic: dict = {}
    for gk, gbatch in batch.partition_by_group().items():
        for aqi, q in enumerate(workload.atomic):
            w0 = 0
            while w0 + q.within <= t_end:
                ev = gbatch.time_slice(w0, w0 + q.within)
                atomic[(aqi, gk, w0)] = sharon_window_eval(
                    workload.schema, q, ev, run_ids_for[aqi], pane=pane)
                w0 += q.slide
    return combine_results(workload, atomic)
