"""Plain NumPy reference for queries ``SEQ(H, K+)`` whose Kleene type
carries same-type edge predicates (the ``seq_kleene_edge`` pattern of a
configuration), independent of the system under test.

Semantics (HAMLET, arXiv:2101.00361, Defs. 2-3 and 8-9, skip-till-any-
match), in one group's events of one window, taken in stream order, over
the events of the types the configuration's patterns name: a *graphlet* is a maximal run of
consecutive ``K`` events inside one pane (``gcd(within, slide)`` ticks).
A trend is a matched head ``H`` followed by a non-empty sequence of later
matched ``K`` events; two consecutive ``K`` events ``j`` then ``i`` of a
trend that lie in one graphlet must satisfy every edge predicate,
``j.attr OP i.attr``; across graphlets they are unconstrained (Def. 8).

With ``f_i`` the trends ending at ``K`` event ``i`` (``H_i`` matched heads
before it):

    f_i = H_i + sum f_j  over matched j in earlier graphlets
              + sum f_j  over matched j before i in its graphlet with
                         edge(j, i)

and the same walk carries the ``K`` events counted over those trends and
their attribute sum.  COUNT(*) = sum f_i, COUNT(K) and SUM(K.x) likewise,
AVG = SUM / COUNT(K) (NaN where that count is 0).

:func:`window_direct` walks one window event by event (the definition, for
the tests).  :func:`evaluate` computes every window at once: inside a
graphlet the recurrence is linear in ``t = H + F`` (the heads so far plus
the trends ending in earlier graphlets), so each graphlet reduces to three
numbers (``alpha``: trends it adds per unit of ``t``; ``beta``, ``gamma``:
the ``K`` events and the attribute sum they carry), found by one forward
substitution over all graphlets of a size class at once; a window then
walks its panes' runs, heads adding to ``H`` and graphlets updating the
running totals.  Every term is non-negative (attributes are), so the
result rounds like any careful sum in ``dtype``; ``dtype`` float32 is the
lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np

from hbench.references.seq_kleene import (_OPS, _matches, _value_attr,
                                          parse_agg)


def _edge_preds(cfg: dict, q: dict) -> list:
    """``[(attribute column, op)]`` of the query's edge predicates on its
    Kleene type."""
    attrs = cfg["schema"]["attrs"]
    return [(attrs.index(p["attr"]), _OPS[p["op"]])
            for p in q.get("edge_preds", []) if p["type"] == q["kleene"]]


def _pattern_types(cfg: dict) -> list:
    """Type ids the configuration's patterns name: the events graphlets
    are cut from."""
    types = cfg["schema"]["types"]
    return sorted({types.index(q[r]) for q in cfg["queries"]
                   for r in ("head", "kleene")})


def _out(q: dict, count, count_k, total) -> dict:
    out = {}
    for agg in q["aggs"]:
        kind, _ = parse_agg(agg)
        if kind == "COUNT(*)":
            out[agg] = count
        elif kind == "COUNT_K":
            out[agg] = count_k
        elif kind == "SUM":
            out[agg] = total
        else:
            out[agg] = total / count_k if count_k else float("nan")
    return out


def window_direct(cfg: dict, q: dict, type_id, time, attrs) -> dict:
    """One window of one group (events in stream order), by the
    definition: each matched ``K`` event's trends from the heads before
    it, every matched ``K`` event of earlier graphlets and the edge-
    satisfying ones earlier in its own."""
    pane = math.gcd(int(cfg["within"]), int(cfg["slide"]))
    kt = cfg["schema"]["types"].index(q["kleene"])
    rel = np.isin(type_id, _pattern_types(cfg))
    type_id, time, attrs = type_id[rel], time[rel], attrs[rel]
    h = _matches(cfg, q, "head", type_id, attrs)
    k = _matches(cfg, q, "kleene", type_id, attrs)
    col = _value_attr(q)
    x = (attrs[:, cfg["schema"]["attrs"].index(col)] if col is not None
         else np.zeros(len(type_id)))
    edges = _edge_preds(cfg, q)
    heads = 0
    done = [0, 0, 0.0]     # trends, K events, x over earlier graphlets
    cur: list = []         # (event, f, c, s) of the open graphlet
    for i in range(len(type_id)):
        if type_id[i] != kt or (i and (type_id[i - 1] != kt or
                                       time[i] // pane != time[i - 1] // pane)):
            for _, f, c, s in cur:
                done[0] += f
                done[1] += c
                done[2] += s
            cur = []
        if h[i]:
            heads += 1
        elif k[i]:
            f, c, s = heads + done[0], done[1], done[2]
            for j, fj, cj, sj in cur:
                if all(op(attrs[j, a], attrs[i, a]) for a, op in edges):
                    f, c, s = f + fj, c + cj, s + sj
            cur.append((i, f, c + f, s + float(x[i]) * f))
    for _, f, c, s in cur:
        done[0] += f
        done[1] += c
        done[2] += s
    return _out(q, float(done[0]), float(done[1]), done[2])


def _graphlet_sums(edges, vals, matched, x, dtype) -> tuple:
    """``(alpha, beta, gamma)`` of each graphlet: ``vals`` ``[n, B, e]``
    edge-attribute values, ``matched`` ``[n, B]`` (False past a graphlet's
    end), ``x`` ``[n, B]`` the value attribute.  With ``a_i = 1 + sum a_j``
    over matched ``j < i`` with edge(j, i), ``u_i = a_i + sum u_j`` and
    ``w_i = x_i a_i + sum w_j``: ``alpha = sum a``, ``beta = sum u``,
    ``gamma = sum w`` over matched ``i``."""
    n, B = matched.shape
    a = np.zeros((n, B), dtype=dtype)
    u = np.zeros((n, B), dtype=dtype)
    w = np.zeros((n, B), dtype=dtype)
    for i in range(B):
        e = matched[:, :i] & matched[:, i:i + 1]
        for c, (_, op) in enumerate(edges):
            e &= op(vals[:, :i, c], vals[:, i:i + 1, c])
        e = e.astype(dtype)
        on = matched[:, i]
        a[:, i] = np.where(on, 1 + (e * a[:, :i]).sum(1), 0)
        u[:, i] = np.where(on, a[:, i] + (e * u[:, :i]).sum(1), 0)
        w[:, i] = np.where(on, x[:, i] * a[:, i] + (e * w[:, :i]).sum(1), 0)
    return a.sum(1), u.sum(1), w.sum(1)


def evaluate(cfg: dict, type_id, time, attrs, group, window_starts, groups,
             dtype=np.float64) -> dict:
    """Every aggregate of every query for each window start in
    ``window_starts`` and each group in ``groups``:
    ``{(query, group, w0): {agg: value}}``.  The events are one stream's,
    sorted by time, in stream order."""
    within, slide = int(cfg["within"]), int(cfg["slide"])
    pane = math.gcd(within, slide)
    ws = np.asarray(sorted(int(w) for w in window_starts), dtype=np.int64)
    groups = [int(g) for g in groups]
    if not len(ws) or not groups:
        return {}
    acol = {a: i for i, a in enumerate(cfg["schema"]["attrs"])}
    lo, hi = int(ws[0]), int(ws[-1]) + within
    n_panes = (hi - lo) // pane
    lut = np.full(max(max(groups), int(group.max(initial=0))) + 1, -1)
    lut[groups] = np.arange(len(groups))
    keep = (time >= lo) & (time < hi) & np.isin(type_id, _pattern_types(cfg))
    keep &= lut[np.where(keep, group, 0)] >= 0
    idx = np.nonzero(keep)[0]
    gi = lut[group[idx]]
    order = np.argsort(gi, kind="stable")          # group, stream order
    idx, gi = idx[order], gi[order]
    tid, at = type_id[idx], attrs[idx]
    cell = gi * n_panes + (time[idx] - lo) // pane   # (group, pane)
    # runs: maximal same-type stretches inside one (group, pane)
    cut = np.ones(len(idx), dtype=bool)
    cut[1:] = (tid[1:] != tid[:-1]) | (cell[1:] != cell[:-1])
    run_start = np.nonzero(cut)[0]
    run_of = np.cumsum(cut) - 1
    n_runs = len(run_start)
    run_len = np.diff(np.append(run_start, len(idx)))
    run_cell = cell[run_start]
    run_tid = tid[run_start]
    pos = np.arange(len(idx)) - run_start[run_of]    # place inside its run
    # run slot inside its (group, pane), for the [cell, slot] grid
    first = np.ones(n_runs, dtype=bool)
    first[1:] = run_cell[1:] != run_cell[:-1]
    slot = np.arange(n_runs) - np.maximum.accumulate(
        np.where(first, np.arange(n_runs), 0))
    n_cells = len(groups) * n_panes
    n_slots = int(slot.max(initial=0)) + 1
    m = within // pane
    p0 = (ws - lo) // pane                            # window's first pane
    out: dict = {}
    memo: dict = {}
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for q in cfg["queries"]:
            heads = _matches(cfg, q, "head", tid, at)
            hrun = np.bincount(run_of, weights=heads,
                               minlength=n_runs).astype(dtype)
            key = (q["kleene"], repr([p for p in q.get("preds", [])
                                      if p["type"] == q["kleene"]]),
                   repr(q.get("edge_preds", [])), _value_attr(q))
            if key not in memo:
                memo[key] = _kleene_runs(cfg, q, tid, at, acol, run_of,
                                         pos, run_len, run_tid, dtype)
            alpha, beta, gamma = memo[key]
            grid = np.zeros((4, n_cells, n_slots), dtype=dtype)
            for r, v in enumerate((hrun, alpha, beta, gamma)):
                grid[r, run_cell, slot] = v
            grid = grid.reshape(4, len(groups), n_panes, n_slots)
            # walk every (group, window) at once: its panes, their runs
            H = np.zeros((len(groups), len(ws)), dtype=dtype)
            F, C, S = H.copy(), H.copy(), H.copy()
            for off in range(m):
                panes = grid[:, :, p0 + off]          # [4, G, W, slots]
                for r in range(n_slots):
                    h, al, be, ga = panes[..., r]
                    H += h
                    live = al != 0
                    t = H + F
                    C = np.where(live, C + al * C + be * t, C)
                    S = np.where(live, S + al * S + ga * t, S)
                    F = np.where(live, F + al * t, F)
            avg = np.where(C != 0, S / C, np.nan)
            by_kind = {"COUNT(*)": F, "COUNT_K": C, "SUM": S, "AVG": avg}
            cols = [(agg, by_kind[parse_agg(agg)[0]].astype(dtype).tolist())
                    for agg in q["aggs"]]
            for i, g in enumerate(groups):
                for wi, w0 in enumerate(ws.tolist()):
                    out[(q["name"], g, w0)] = {agg: v[i][wi]
                                               for agg, v in cols}
    return out


def _kleene_runs(cfg, q, tid, at, acol, run_of, pos, run_len, run_tid,
                 dtype) -> tuple:
    """``(alpha, beta, gamma)`` of every run (0 for head runs and for
    graphlets with no matched ``K`` event), graphlets taken in size
    classes of powers of two."""
    n_runs = len(run_len)
    kt = cfg["schema"]["types"].index(q["kleene"])
    k = _matches(cfg, q, "kleene", tid, at)
    edges = _edge_preds(cfg, q)
    ecols = [c for c, _ in edges]
    col = _value_attr(q)
    x = at[:, acol[col]] if col is not None else np.zeros(len(tid))
    sums = np.zeros((3, n_runs), dtype=dtype)
    kr = np.nonzero(run_tid == kt)[0]
    size = 1 << np.ceil(np.log2(run_len[kr])).astype(np.int64)
    for B in np.unique(size).tolist():
        runs = kr[size == B]
        row = np.full(n_runs, -1)
        row[runs] = np.arange(len(runs))
        sel = np.nonzero(row[run_of] >= 0)[0]
        r, p = row[run_of[sel]], pos[sel]
        vals = np.zeros((len(runs), B, len(ecols)))
        vals[r, p] = at[sel][:, ecols]
        matched = np.zeros((len(runs), B), dtype=bool)
        matched[r, p] = k[sel]
        xs = np.zeros((len(runs), B), dtype=dtype)
        xs[r, p] = x[sel]
        sums[:, runs] = _graphlet_sums(edges, vals, matched, xs, dtype)
    return sums[0], sums[1], sums[2]
