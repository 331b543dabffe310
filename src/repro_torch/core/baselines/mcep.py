"""MCEP-style baseline [22]: shared two-step trend processing.

MCEP shares event *trend construction* across the workload, then computes
aggregates per query as a post-processing step over the constructed trends.
Construction is shared by enumerating trends over the union of the queries'
template edges once per window; each trend is then validated/aggregated per
query.  The exponential construction cost the paper highlights (Figs. 9-10)
is inherent: the number of trends is exponential in matched events.
"""

from __future__ import annotations

import numpy as np

from ..events import EventBatch, StreamSchema, pane_size_for
from ..query import AtomicQuery, AggKind, Workload
from .brute import window_eval_brute

__all__ = ["mcep_window_eval", "mcep_run"]

MAX_TRENDS = 2_000_000


def mcep_window_eval(schema: StreamSchema, queries: list[AtomicQuery],
                     ev: EventBatch, run_type_ids: list[int],
                     pane: int | None = None) -> list[dict]:
    """Shared construction over the union template; per-query aggregation."""
    union_edges: set[tuple[str, str]] = set()
    union_start: set[str] = set()
    union_end: set[str] = set()
    pos_names: set[str] = set()
    for q in queries:
        union_edges |= set(q.info.edges)
        union_start |= set(q.info.start)
        union_end |= set(q.info.end)
        pos_names |= set(q.info.types)

    keep = [i for i in range(len(ev))
            if int(ev.type_id[i]) in set(run_type_ids)]
    n = len(keep)
    tname = [schema.types[int(ev.type_id[i])] for i in keep]
    times = [int(ev.time[i]) for i in keep]
    attrs = [ev.attrs[i] for i in keep]
    run = [0] * n
    for i in range(1, n):
        new_run = tname[i] != tname[i - 1]
        if pane is not None and times[i] // pane != times[i - 1] // pane:
            new_run = True
        run[i] = run[i - 1] + (1 if new_run else 0)

    # shared construction: any event of a positive type may participate; the
    # union adjacency over-approximates each query's adjacency
    trends: list[tuple[int, ...]] = []

    def dfs(path: list[int]) -> None:
        if len(trends) > MAX_TRENDS:
            raise RuntimeError("MCEP trend explosion; shrink the stream")
        i = path[-1]
        if tname[i] in union_end:
            trends.append(tuple(path))
        for j in range(i + 1, n):
            if (tname[i], tname[j]) in union_edges and tname[j] in pos_names:
                path.append(j)
                dfs(path)
                path.pop()

    for i in range(n):
        if tname[i] in union_start:
            dfs([i])

    # per-query validation + aggregation (post-processing step)
    out = []
    for q in queries:
        neg_idx: dict = {}
        for nc in q.info.negatives:
            nid = schema.type_id(nc.neg_type)
            ks = []
            for i in range(n):
                if schema.type_id(tname[i]) != nid:
                    continue
                ok = True
                for p in q.preds_for(tname[i]):
                    if not p.eval(attrs[i][None, :], schema)[0]:
                        ok = False
                if ok:
                    ks.append(i)
            neg_idx[nc] = ks

        def matched(i: int) -> bool:
            if tname[i] not in q.info.types:
                return False
            for p in q.preds_for(tname[i]):
                if not p.eval(attrs[i][None, :], schema)[0]:
                    return False
            return True

        def valid(tr: tuple[int, ...]) -> bool:
            if tname[tr[0]] not in q.info.start or tname[tr[-1]] not in q.info.end:
                return False
            if not all(matched(i) for i in tr):
                return False
            for a, b in zip(tr, tr[1:]):
                if (tname[a], tname[b]) not in q.info.edges:
                    return False
                if tname[a] == tname[b] and run[a] == run[b]:
                    for ep in q.edge_preds_for(tname[a]):
                        col = schema.attr_col(ep.attr)
                        if not ep.eval_pairs(np.array([attrs[a][col]]),
                                             np.array([attrs[b][col]]))[0, 0]:
                            return False
                for nc in q.info.negatives:
                    if nc.before is None or nc.after is None:
                        continue
                    if tname[a] in nc.before and tname[b] in nc.after:
                        if any(a < k < b for k in neg_idx[nc]):
                            return False
            for nc in q.info.negatives:
                if nc.before is None and any(k < tr[0] for k in neg_idx[nc]):
                    return False
                if nc.after is None and any(k > tr[-1] for k in neg_idx[nc]):
                    return False
            return True

        q_trends = [tr for tr in trends if valid(tr)]
        vals: dict[str, float] = {}
        for agg in q.aggs:
            if agg.kind == AggKind.COUNT_STAR:
                vals[repr(agg)] = float(len(q_trends))
                continue
            e_id = agg.type_name
            col = schema.attr_col(agg.attr) if agg.attr else None
            members = [(i, attrs[i][col] if col is not None else 1.0)
                       for tr in q_trends for i in tr if tname[i] == e_id]
            if agg.kind == AggKind.COUNT_TYPE:
                vals[repr(agg)] = float(len(members))
            elif agg.kind == AggKind.SUM:
                vals[repr(agg)] = float(sum(v for _, v in members))
            elif agg.kind == AggKind.AVG:
                vals[repr(agg)] = (float(sum(v for _, v in members) / len(members))
                                   if members else float("nan"))
            elif agg.kind == AggKind.MIN:
                vals[repr(agg)] = (float(min(v for _, v in members))
                                   if members else float("nan"))
            elif agg.kind == AggKind.MAX:
                vals[repr(agg)] = (float(max(v for _, v in members))
                                   if members else float("nan"))
        out.append(vals)
    return out


def mcep_run(workload: Workload, batch: EventBatch,
             t_end: int | None = None) -> dict:
    from ..engine import ComponentContext, combine_results

    pane = pane_size_for(workload.windows)
    if t_end is None:
        t_end = int(batch.time.max()) + 1 if len(batch) else 0
    t_end = ((t_end + pane - 1) // pane) * pane

    comps = workload.sharable_components()
    atomic: dict = {}
    for gk, gbatch in batch.partition_by_group().items():
        for comp in comps:
            ctx = ComponentContext(workload.schema,
                                   [workload.atomic[i] for i in comp])
            # group queries with identical windows to share construction
            by_window: dict[tuple[int, int], list[int]] = {}
            for aqi in comp:
                q = workload.atomic[aqi]
                by_window.setdefault((q.within, q.slide), []).append(aqi)
            for (within, slide), aqis in by_window.items():
                w0 = 0
                while w0 + within <= t_end:
                    ev = gbatch.time_slice(w0, w0 + within)
                    vals = mcep_window_eval(
                        workload.schema,
                        [workload.atomic[i] for i in aqis],
                        ev, ctx.relevant_type_ids, pane=pane)
                    for aqi, v in zip(aqis, vals):
                        atomic[(aqi, gk, w0)] = v
                    w0 += slide
    return combine_results(workload, atomic)
