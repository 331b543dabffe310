"""GRETA baseline: non-shared online trend aggregation (paper Sec. 3.2, [33]).

Each query is processed independently: per window, the full event adjacency
is materialised and the trend-count recurrence (Eq. 1) is solved once per
query — the ``k x n^2`` cost of Eq. 3.  No graphlets, no snapshots.  This is
both the paper's principal comparison point (Figs. 9-11) and an independent
quadratic oracle for the HAMLET engine tests.

The adjacency is built on the host in numpy.  The recurrence runs on the
backend the caller picks, as in :class:`~repro_torch.core.engine
.HamletRuntime`: ``"cuda"`` (the default, on ``cuda:0``) solves it with the
hand-written masked propagation kernel, ``"torch"`` with its plain PyTorch
version on any ``device``, ``"np"`` with the numpy host oracle.  On a device
backend each window's mask crosses to the device once, each propagation (the
trend counts, then one per SUM unit) is one launch, and its result comes back
with one explicit fetch.
"""

from __future__ import annotations

from dataclasses import dataclass
from time import perf_counter

import numpy as np
import torch

from ...kernels import ops
from ..events import EventBatch, StreamSchema, pane_size_for
from ..query import AtomicQuery, AggKind, Workload
from ..template import build_template

__all__ = ["window_adjacency", "window_eval_greta", "greta_run",
           "GretaTimers"]


@dataclass
class GretaTimers:
    """Where a GRETA run's wall goes, summed over its windows.

    Passing one to :func:`greta_run` or :func:`window_eval_greta` makes a
    device backend synchronize after the mask's copy and after each
    propagation, so that each part is charged where it is spent:

    * ``adjacency_s`` — the host build of the window's adjacency, start and
      end vectors (:func:`window_adjacency`);
    * ``h2d_s`` — the copy of the ``n x n`` mask to the device;
    * ``kernel_s`` — the propagation calls: the base's upload, the launch
      and the kernel, synchronized;
    * ``fetch_s`` — the results' copies back to the host.

    ``windows`` counts the windows evaluated, ``propagations`` the
    propagation calls and ``max_n`` the largest window (events kept).
    """

    adjacency_s: float = 0.0
    h2d_s: float = 0.0
    kernel_s: float = 0.0
    fetch_s: float = 0.0
    windows: int = 0
    propagations: int = 0
    max_n: int = 0

    def split(self) -> dict:
        return {"adjacency_s": self.adjacency_s, "h2d_s": self.h2d_s,
                "kernel_s": self.kernel_s, "fetch_s": self.fetch_s}


def window_adjacency(schema: StreamSchema, q: AtomicQuery, ev: EventBatch,
                     run_type_ids: list[int] | None = None,
                     pane: int | None = None):
    """Build (adj, start_vec, end_valid, matched, sub) for one window.

    ``adj[i, j] = 1`` iff event j is a predecessor event of i (pe(e_i, q)).
    ``sub`` is the EventBatch restricted to the relevant types.
    """
    info = q.info
    tmpl = build_template(schema, q)
    pos_ids = {schema.type_id(t) for t in info.types}
    neg_ids = {schema.type_id(n.neg_type) for n in info.negatives}
    if run_type_ids is None:
        run_type_ids = sorted(pos_ids | neg_ids)

    keep = np.isin(ev.type_id, np.array(sorted(set(run_type_ids)), dtype=np.int32))
    sub = ev.select(np.nonzero(keep)[0])
    n = len(sub)
    tid = sub.type_id
    times = sub.time

    run = np.zeros(n, dtype=np.int64)
    if n > 1:
        cut = tid[1:] != tid[:-1]
        if pane is not None:
            cut = cut | (times[1:] // pane != times[:-1] // pane)
        run[1:] = np.cumsum(cut)

    matched = np.zeros(n, dtype=bool)
    for t in info.types:
        t_id = schema.type_id(t)
        sel = tid == t_id
        if not sel.any():
            continue
        m = sel.copy()
        for p in q.preds_for(t):
            m &= p.eval(sub.attrs, schema)
        matched |= m

    # negation uses arrival (index) order (ties resolve by arrival)
    neg_matched: dict = {}
    for nc in info.negatives:
        nid = schema.type_id(nc.neg_type)
        m = tid == nid
        for p in q.preds_for(nc.neg_type):
            m = m & p.eval(sub.attrs, schema)
        neg_matched[nc] = np.nonzero(m)[0]

    # adjacency
    adj = np.zeros((n, n))
    lower = np.tril(np.ones((n, n), dtype=bool), k=-1)
    for i_t in np.unique(tid):
        for j_t in np.unique(tid):
            if not tmpl.pred_type[i_t, j_t]:
                continue
            rows = tid == i_t
            cols = tid == j_t
            blk = lower & rows[:, None] & cols[None, :]
            blk &= matched[:, None] & matched[None, :]
            if i_t == j_t:
                eps = q.edge_preds_for(schema.types[int(i_t)])
                if eps:
                    same_run = run[:, None] == run[None, :]
                    ep_ok = np.ones((n, n), dtype=bool)
                    for ep in eps:
                        col = sub.attrs[:, schema.attr_col(ep.attr)]
                        ep_ok &= ep.eval_pairs(col, col).T  # [succ, pred]
                    blk &= ~same_run | ep_ok
            adj[blk] = 1.0

    # mid-pattern NOT cuts
    for nc in info.negatives:
        if nc.before is None or nc.after is None:
            continue
        kn = neg_matched[nc]
        if len(kn) == 0:
            continue
        before = np.isin(tid, [schema.type_id(t) for t in nc.before])
        after = np.isin(tid, [schema.type_id(t) for t in nc.after])
        idx = np.arange(n)
        between = np.zeros((n, n), dtype=bool)
        for k in kn:
            between |= (idx[None, :] < k) & (idx[:, None] > k)
        adj[after[:, None] & before[None, :] & between] = 0.0

    # start / end validity
    start_vec = np.zeros(n)
    for t in info.start:
        start_vec[(tid == schema.type_id(t)) & matched] = 1.0
    for nc in info.negatives:
        if nc.before is None and len(neg_matched[nc]):
            start_vec[np.arange(n) > neg_matched[nc].min()] = 0.0
    end_valid = np.zeros(n, dtype=bool)
    for t in info.end:
        end_valid |= (tid == schema.type_id(t)) & matched
    for nc in info.negatives:
        if nc.after is None and len(neg_matched[nc]):
            end_valid &= np.arange(n) > neg_matched[nc].max()

    return adj, start_vec, end_valid, matched, sub


def window_eval_greta(schema: StreamSchema, q: AtomicQuery, ev: EventBatch,
                      run_type_ids: list[int] | None = None,
                      backend: str = "cuda", pane: int | None = None,
                      device=None, timers: GretaTimers | None = None) -> dict:
    """One window of one query.  ``backend``/``device`` as for
    :class:`~repro_torch.core.engine.HamletRuntime`: the default is the
    masked kernel on ``cuda:0``, which raises without a GPU."""
    dev = ops.resolve_device(backend, device)
    sync = timers is not None and dev is not None and dev.type == "cuda"
    timers = timers if timers is not None else GretaTimers()
    t0 = perf_counter()
    adj, start_vec, end_valid, matched, sub = window_adjacency(
        schema, q, ev, run_type_ids, pane=pane)
    n = len(sub)
    timers.adjacency_s += perf_counter() - t0
    timers.windows += 1
    timers.max_n = max(timers.max_n, n)
    out: dict[str, float] = {}
    if n == 0:
        for agg in q.aggs:
            out[repr(agg)] = 0.0 if agg.kind in (
                AggKind.COUNT_STAR, AggKind.COUNT_TYPE, AggKind.SUM) else float("nan")
        return out

    propagate = _propagator(adj, backend, dev, timers, sync)
    counts = propagate(start_vec)
    fin = counts * end_valid

    sums: dict[tuple, np.ndarray] = {}
    for u in q.units:
        if u[0] != "sum":
            continue
        _, e_name, attr = u
        e_id = schema.type_id(e_name)
        vals = np.ones(n) if attr is None else sub.attrs[:, schema.attr_col(attr)]
        base = np.where((sub.type_id == e_id) & matched, vals * counts, 0.0)
        sums[u] = propagate(base)

    for agg in q.aggs:
        if agg.kind == AggKind.COUNT_STAR:
            out[repr(agg)] = float(fin.sum())
        elif agg.kind == AggKind.COUNT_TYPE:
            out[repr(agg)] = float((sums[("sum", agg.type_name, None)] * end_valid).sum())
        elif agg.kind == AggKind.SUM:
            out[repr(agg)] = float(
                (sums[("sum", agg.type_name, agg.attr)] * end_valid).sum())
        elif agg.kind == AggKind.AVG:
            s = (sums[("sum", agg.type_name, agg.attr)] * end_valid).sum()
            c = (sums[("sum", agg.type_name, None)] * end_valid).sum()
            out[repr(agg)] = float(s / c) if c else float("nan")
        elif agg.kind in (AggKind.MIN, AggKind.MAX):
            out[repr(agg)] = _minmax_propagate(schema, agg, sub, adj, counts,
                                               start_vec, end_valid)
    return out


def _propagator(adj: np.ndarray, backend: str, dev, timers: GretaTimers,
                sync: bool):
    """``base [n] -> c [n]`` (a host array) over one window's adjacency.

    On a device backend the mask is copied to ``dev`` once here and reused
    by every propagation of the window; each call launches once and fetches
    its result with one host sync (:func:`ops.device_get_all`).  ``sync``
    waits for the card after the copy and after each launch, so that
    ``timers`` charges each part where it is spent."""
    def wait():
        if sync:
            torch.cuda.synchronize(dev)

    t0 = perf_counter()
    mask = adj if dev is None else torch.as_tensor(adj, device=dev)
    wait()
    timers.h2d_s += perf_counter() - t0

    def propagate(base):
        t0 = perf_counter()
        base = base[:, None]
        if dev is not None:
            base = torch.as_tensor(base, device=dev)
        c = ops.propagate(base, mask, backend=backend, device=dev)
        wait()
        t1 = perf_counter()
        (host,) = ops.device_get_all([c])
        timers.kernel_s += t1 - t0
        timers.fetch_s += perf_counter() - t1
        timers.propagations += 1
        return host[:, 0]
    return propagate


def _minmax_propagate(schema, agg, sub, adj, counts, start_vec, end_valid) -> float:
    """GRETA-style idempotent propagation of MIN/MAX over trend events."""
    n = len(sub)
    sign = 1.0 if agg.kind == AggKind.MIN else -1.0
    e_id = schema.type_id(agg.type_name)
    col = schema.attr_col(agg.attr)
    own = np.where(sub.type_id == e_id, sign * sub.attrs[:, col], np.inf)
    m = np.full(n, np.inf)
    for i in range(n):
        best = np.inf
        if start_vec[i] > 0:
            best = own[i]
        preds = np.nonzero((adj[i, :i] > 0) & (counts[:i] > 0))[0]
        if len(preds):
            best = min(best, min(np.minimum(m[preds], own[i])))
        m[i] = best
    cand = m[(end_valid) & (counts > 0)]
    cand = cand[np.isfinite(cand)]
    if len(cand) == 0:
        return float("nan")
    return float(sign * cand.min())


def greta_run(workload: Workload, batch: EventBatch, t_end: int | None = None,
              backend: str = "cuda", device=None,
              timers: GretaTimers | None = None) -> dict:
    """Full-workload GRETA run mirroring HamletRuntime.run().

    ``backend``/``device`` as for :class:`~repro_torch.core.engine
    .HamletRuntime` (default: the masked kernel on ``cuda:0``; raises
    without a GPU); ``timers`` splits the wall (:class:`GretaTimers`)."""
    from ..engine import ComponentContext, combine_results

    dev = ops.resolve_device(backend, device)

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
                atomic[(aqi, gk, w0)] = window_eval_greta(
                    workload.schema, q, ev, run_ids_for[aqi], backend=backend,
                    pane=pane, device=dev, timers=timers)
                w0 += q.slide
    return combine_results(workload, atomic)
