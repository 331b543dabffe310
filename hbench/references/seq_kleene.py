"""Plain NumPy reference for queries ``SEQ(H, K+)`` (the ``seq_kleene``
pattern of a configuration), independent of the system under test.

Semantics (HAMLET, arXiv:2101.00361, Defs. 2-3, skip-till-any-match): in
one district's events of one window, taken in stream order, a trend is a
head event ``a`` (type ``H``, its predicates held) followed by any
non-empty subsequence of the later ``K`` events whose predicates hold.
With ``m_a`` such ``K`` events after ``a``:

    COUNT(*)   = sum_a (2^m_a - 1)
    COUNT(K)   = sum_a m_a 2^(m_a - 1)
    SUM(K.x)   = sum_a 2^(m_a - 1) * (sum of x over the K events after a)
    AVG(K.x)   = SUM(K.x) / COUNT(K)     (NaN where COUNT(K) is 0)

:func:`window_direct` walks one window event by event (the definition, for
the tests).  :func:`evaluate` computes every window at once: events are
laid out as one row per (district, pane), each pane's heads are summed
with their powers of two inside the pane, and a window adds its panes'
sums, each scaled by the power of two of the ``K`` events in the window's
later panes.  Scaling by a power of two is exact, and every sum adds
terms of one sign, so the result rounds like any careful sum in ``dtype``.
``dtype`` float32 is the lower-precision control.
"""

from __future__ import annotations

import math
import operator

import numpy as np

_OPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge, "==": operator.eq, "!=": operator.ne}


def parse_agg(agg: str) -> tuple[str, str | None]:
    """``"COUNT(*)"`` -> ("COUNT(*)", None); ``"SUM(K.x)"`` -> ("SUM", "x");
    ``"AVG(K.x)"`` -> ("AVG", "x"); ``"COUNT(K)"`` -> ("COUNT_K", None)."""
    if agg == "COUNT(*)":
        return "COUNT(*)", None
    kind, arg = agg[:-1].split("(", 1)
    if kind == "COUNT":
        return "COUNT_K", None
    if kind in ("SUM", "AVG"):
        return kind, arg.split(".", 1)[1]
    raise ValueError(f"aggregate {agg!r} is not in the seq_kleene reference")


def _matches(cfg: dict, q: dict, which: str, type_id, attrs) -> np.ndarray:
    types = cfg["schema"]["types"]
    attr_names = cfg["schema"]["attrs"]
    name = q[which]
    m = type_id == types.index(name)
    for p in q.get("preds", []):
        if p["type"] == name:
            m &= _OPS[p["op"]](attrs[:, attr_names.index(p["attr"])],
                               p["value"])
    return m


def _value_attr(q: dict) -> str | None:
    attrs = {parse_agg(a)[1] for a in q["aggs"]} - {None}
    if len(attrs) > 1:
        raise ValueError(f"query {q['name']}: one SUM/AVG attribute at most")
    return attrs.pop() if attrs else None


def window_direct(cfg: dict, q: dict, type_id, attrs) -> dict:
    """One window of one district (events in stream order), by the
    definition: a running count of trends ending at each ``K`` event."""
    h = _matches(cfg, q, "head", type_id, attrs)
    k = _matches(cfg, q, "kleene", type_id, attrs)
    col = _value_attr(q)
    x = (attrs[:, cfg["schema"]["attrs"].index(col)] if col is not None
         else np.zeros(len(type_id)))
    heads = 0          # trends that may still take a first K event
    count = 0          # trends ending at a K event so far
    count_k = 0        # K events summed over those trends
    total = 0.0        # x summed over those trends
    for i in range(len(type_id)):
        if h[i]:
            heads += 1
        elif k[i]:
            e = heads + count              # trends that end at this event
            ck = count_k + e
            s = total + float(x[i]) * e
            count, count_k, total = count + e, count_k + ck, total + s
    out = {}
    for agg in q["aggs"]:
        kind, _ = parse_agg(agg)
        if kind == "COUNT(*)":
            out[agg] = float(count)
        elif kind == "COUNT_K":
            out[agg] = float(count_k)
        elif kind == "SUM":
            out[agg] = total
        else:
            out[agg] = total / count_k if count_k else float("nan")
    return out


def _suffix(a: np.ndarray, axis: int) -> np.ndarray:
    """Exclusive suffix sums along ``axis``: element i holds the sum of
    the elements after i."""
    r = np.flip(np.cumsum(np.flip(a, axis), axis=axis), axis)
    return r - a


def evaluate(cfg: dict, type_id, time, attrs, group, window_starts, groups,
             dtype=np.float64) -> dict:
    """Every aggregate of every query for each window start in
    ``window_starts`` and each district in ``groups``:
    ``{(query, district, w0): {agg: value}}``.  The events are one
    stream's, sorted by time, in stream order."""
    within, slide = int(cfg["within"]), int(cfg["slide"])
    pane = math.gcd(within, slide)
    ws = np.asarray(sorted(int(w) for w in window_starts), dtype=np.int64)
    groups = [int(g) for g in groups]
    if not len(ws) or not groups:
        return {}
    lo, hi = int(ws[0]), int(ws[-1]) + within
    n_panes = (hi - lo) // pane
    lut = np.full(max(max(groups), int(group.max(initial=0))) + 1, -1)
    lut[groups] = np.arange(len(groups))
    keep = (time >= lo) & (time < hi)
    keep &= lut[np.where(keep, group, 0)] >= 0
    idx = np.nonzero(keep)[0]
    gi = lut[group[idx]]
    order = np.argsort(gi, kind="stable")          # district, stream order
    idx, gi = idx[order], gi[order]
    # one row per (district, pane), the row's events in stream order
    block = gi * n_panes + (time[idx] - lo) // pane
    n_blocks = len(groups) * n_panes
    sizes = np.bincount(block, minlength=n_blocks)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    layout = (block, np.arange(len(idx)) - starts[block],
              (n_blocks, int(sizes.max(initial=0)) or 1))
    # a window's panes, as columns of the (district, pane) grid
    win = ((ws - lo) // pane)[:, None] \
        + np.arange(within // pane)[None, :]                  # [W, m]
    out: dict = {}
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for q in cfg["queries"]:
            cols = _query(cfg, q, type_id[idx], attrs[idx], layout,
                          len(groups), win, dtype)
            for i, g in enumerate(groups):
                vals = [(agg, a[i].tolist()) for agg, a in cols]
                for wi, w0 in enumerate(ws.tolist()):
                    out[(q["name"], g, w0)] = {agg: v[wi] for agg, v in vals}
    return out


def _query(cfg, q, tid, at, layout, n_groups, win, dtype) -> list:
    """``[(agg, values [n_groups, W])]`` of one query."""
    block, col, shape = layout
    H = np.zeros(shape, dtype=bool)
    K = np.zeros(shape, dtype=np.int64)
    X = np.zeros(shape, dtype=dtype)
    k = _matches(cfg, q, "kleene", tid, at)
    H[block, col] = _matches(cfg, q, "head", tid, at)
    K[block, col] = k
    vcol = _value_attr(q)
    if vcol is not None:
        X[block, col] = np.where(k, at[:, cfg["schema"]["attrs"].index(vcol)],
                                 0.0)
    one = np.ones((), dtype=dtype)
    # inside a pane: head a with r_a K events after it in the pane
    r = _suffix(K, 1)
    pw = np.where(H, np.ldexp(one, np.where(H, r, 0)), 0).astype(dtype)
    A = pw.sum(1)                                     # sum 2^r
    D = (pw * r.astype(dtype)).sum(1)                 # sum r 2^r
    B = (pw * _suffix(X, 1)).sum(1)                   # sum 2^r (x after a)
    Kb, Xb, Hb = K.sum(1), X.sum(1), H.sum(1)
    A, D, B, Kb, Xb, Hb = (a.reshape(n_groups, -1)[:, win]
                           for a in (A, D, B, Kb, Xb, Hb))   # [G, W, m]
    # across a window's panes: m_a = r_a + delta, the K events of the
    # window's later panes
    delta = _suffix(Kb, 2)
    xout = _suffix(Xb, 2)
    live = A != 0                      # a pane with no head adds nothing
    scale = np.ldexp(one, np.where(live, delta, 0))
    half = np.ldexp(one, np.where(live, delta - 1, 0))
    count = np.where(live, scale * A, 0).sum(2) - Hb.sum(2).astype(dtype)
    count_k = np.where(live, half * (D + delta.astype(dtype) * A), 0).sum(2)
    total = np.where(live, half * (B + xout * A), 0).sum(2)
    avg = np.where(count_k != 0, total / count_k, np.nan)
    by_kind = {"COUNT(*)": count, "COUNT_K": count_k, "SUM": total,
               "AVG": avg}
    return [(agg, by_kind[parse_agg(agg)[0]].astype(dtype))
            for agg in q["aggs"]]
