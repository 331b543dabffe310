"""Brute-force trend enumeration oracle.

Enumerates every event trend (Def. 3) explicitly — the exponential two-step
semantics that HAMLET/GRETA avoid — and aggregates over the constructed
trends.  Deliberately written with slow, independent Python loops so it
validates the engine's propagation algebra rather than sharing code with it.

Semantics (shared by the engine, GRETA and this oracle):
* a trend is a time-increasing subsequence of matched events whose adjacent
  pairs follow the template edges;
* same-type edge predicates apply between adjacent same-type events within
  one *run* (maximal same-type stretch of the component-relevant event
  sequence); across runs Kleene adjacency is unconstrained (the graphlet
  snapshot abstraction, Def. 8);
* NOT semantics per Sec. 5: a matched negative event cuts connections from
  ``before``-type matches earlier than it to ``after``-type matches later
  than it; leading/trailing NOT constrain the first/last trend event.
"""

from __future__ import annotations

import numpy as np

from ..events import EventBatch, StreamSchema, pane_size_for
from ..query import AtomicQuery, AggKind, Workload

__all__ = ["window_eval_brute", "brute_run"]

MAX_TRENDS = 2_000_000


def window_eval_brute(schema: StreamSchema, q: AtomicQuery, ev: EventBatch,
                      run_type_ids: list[int] | None = None,
                      pane: int | None = None) -> dict:
    info = q.info
    pos_ids = {schema.type_id(t) for t in info.types}
    neg_ids = {schema.type_id(n.neg_type) for n in info.negatives}
    if run_type_ids is None:
        run_type_ids = sorted(pos_ids | neg_ids)

    keep = [i for i in range(len(ev)) if int(ev.type_id[i]) in set(run_type_ids)]
    n = len(keep)
    tid = [int(ev.type_id[i]) for i in keep]
    tname = [schema.types[t] for t in tid]
    times = [int(ev.time[i]) for i in keep]
    attrs = [ev.attrs[i] for i in keep]

    # run ids: maximal same-type stretches of the relevant sequence, scoped to
    # panes (graphlets never span panes — Sec. 3.1)
    run = [0] * n
    for i in range(1, n):
        new_run = tid[i] != tid[i - 1]
        if pane is not None and times[i] // pane != times[i - 1] // pane:
            new_run = True
        run[i] = run[i - 1] + (1 if new_run else 0)

    def type_preds_ok(i: int) -> bool:
        for p in q.preds_for(tname[i]):
            col = schema.attr_col(p.attr)
            if not p.eval(attrs[i][None, :], schema)[0]:
                return False
        return True

    matched = [tid[i] in pos_ids and type_preds_ok(i) for i in range(n)]
    neg_matched = [tid[i] in neg_ids and type_preds_ok(i) for i in range(n)]
    # negation uses arrival (index) order — ties in timestamps resolve by
    # arrival, matching the engine's burst-sequential semantics
    neg_idx = {}
    for nc in info.negatives:
        nid = schema.type_id(nc.neg_type)
        neg_idx[nc] = [i for i in range(n) if neg_matched[i] and tid[i] == nid]

    def edge_ok(j: int, i: int) -> bool:
        if not (matched[j] and matched[i]):
            return False
        if (tname[j], tname[i]) not in info.edges:
            return False
        if tname[j] == tname[i] and run[j] == run[i]:
            for ep in q.edge_preds_for(tname[i]):
                col = schema.attr_col(ep.attr)
                if not ep.eval_pairs(np.array([attrs[j][col]]),
                                     np.array([attrs[i][col]]))[0, 0]:
                    return False
        for nc in info.negatives:
            if nc.before is None or nc.after is None:
                continue
            if tname[j] in nc.before and tname[i] in nc.after:
                if any(j < k < i for k in neg_idx[nc]):
                    return False
        return True

    def start_ok(i: int) -> bool:
        if not (matched[i] and tname[i] in info.start):
            return False
        for nc in info.negatives:
            if nc.before is None:  # leading NOT
                if any(k < i for k in neg_idx[nc]):
                    return False
        return True

    def end_ok(i: int) -> bool:
        if not (matched[i] and tname[i] in info.end):
            return False
        for nc in info.negatives:
            if nc.after is None:  # trailing NOT
                if any(k > i for k in neg_idx[nc]):
                    return False
        return True

    trends: list[tuple[int, ...]] = []

    def dfs(path: list[int]) -> None:
        if len(trends) > MAX_TRENDS:
            raise RuntimeError("brute-force trend explosion; shrink the stream")
        i = path[-1]
        if end_ok(i):
            trends.append(tuple(path))
        for j in range(i + 1, n):
            if edge_ok(i, j):
                path.append(j)
                dfs(path)
                path.pop()

    for i in range(n):
        if start_ok(i):
            dfs([i])

    out: dict[str, float] = {}
    for agg in q.aggs:
        if agg.kind == AggKind.COUNT_STAR:
            out[repr(agg)] = float(len(trends))
            continue
        e_id = schema.type_id(agg.type_name)
        col = schema.attr_col(agg.attr) if agg.attr else None
        if agg.kind == AggKind.COUNT_TYPE:
            out[repr(agg)] = float(sum(sum(1 for i in tr if tid[i] == e_id)
                                       for tr in trends))
        elif agg.kind == AggKind.SUM:
            out[repr(agg)] = float(sum(sum(attrs[i][col] for i in tr if tid[i] == e_id)
                                       for tr in trends))
        elif agg.kind == AggKind.AVG:
            s = sum(sum(attrs[i][col] for i in tr if tid[i] == e_id) for tr in trends)
            c = sum(sum(1 for i in tr if tid[i] == e_id) for tr in trends)
            out[repr(agg)] = float(s / c) if c else float("nan")
        elif agg.kind in (AggKind.MIN, AggKind.MAX):
            vals = [attrs[i][col] for tr in trends for i in tr if tid[i] == e_id]
            if not vals:
                out[repr(agg)] = float("nan")
            else:
                out[repr(agg)] = float(min(vals) if agg.kind == AggKind.MIN
                                       else max(vals))
    return out


def brute_run(workload: Workload, batch: EventBatch,
              t_end: int | None = None) -> dict:
    """Full-workload brute-force run mirroring HamletRuntime.run()."""
    from ..engine import ComponentContext, combine_results

    pane = pane_size_for(workload.windows)
    if t_end is None:
        t_end = int(batch.time.max()) + 1 if len(batch) else 0
    t_end = ((t_end + pane - 1) // pane) * pane

    comps = workload.sharable_components()
    run_ids_for: dict[int, list[int]] = {}
    for comp in comps:
        ctx = ComponentContext(workload.schema, [workload.atomic[i] for i in comp])
        for aqi in comp:
            run_ids_for[aqi] = ctx.relevant_type_ids

    atomic: dict = {}
    for gk, gbatch in batch.partition_by_group().items():
        for aqi, q in enumerate(workload.atomic):
            w0 = 0
            while w0 + q.within <= t_end:
                ev = gbatch.time_slice(w0, w0 + q.within)
                atomic[(aqi, gk, w0)] = window_eval_brute(
                    workload.schema, q, ev, run_ids_for[aqi], pane=pane)
                w0 += q.slide
    return combine_results(workload, atomic)
