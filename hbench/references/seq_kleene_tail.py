"""Plain NumPy reference for queries ``SEQ(H, K+, T)`` and
``SEQ(H, K+, NOT N)`` (the ``seq_kleene_tail`` pattern of a
configuration), independent of the system under test.

Semantics (HAMLET, arXiv:2101.00361, Defs. 2-3 and Sec. 5, skip-till-any-
match), in one district's events of one window, taken in stream order:

* a query with a ``tail`` ``T``: a trend is a matched head ``a``, then a
  non-empty subsequence of the matched ``K`` events after ``a``, then one
  matched ``T`` event ``d`` after the last of them.  With ``m`` the matched
  ``K`` events between ``a`` and ``d``, the pair ``(a, d)`` adds
  ``2^m - 1`` trends to COUNT(*), ``m 2^(m-1)`` to COUNT(K) and
  ``2^(m-1)`` times the sum of ``x`` over those ``K`` events to SUM(K.x);
* a query with ``not_after`` ``N`` (a trailing NOT): a trend is a matched
  head followed by a non-empty subsequence of later matched ``K`` events;
  it ends at its last ``K`` event ``t`` and is valid only if no matched
  ``N`` event comes after ``t`` in the window.

AVG(K.x) = SUM(K.x) / COUNT(K), NaN where COUNT(K) is 0.  Each query has
its own window length and slide: its windows are the starts that are
multiples of its slide in ``[min(window_starts), max(window_starts) +
within - q.within]``, where ``within`` is the configuration's (the window
starts a driver passes are the configuration's).

:func:`window_direct` sums those terms pair by pair (the definition, for
the tests).  :func:`evaluate` computes every window at once by the
equivalent walk: events are laid out as one row of slots per (district,
pane), and each window walks its panes' slots in stream order, for every
query of one window length and every district and window at once, keeping
the running counts of heads, of trends ending at a ``K`` event (with the
``K`` events and the sum of ``x`` they carry), those of them that end at a
``T`` event, and those that end after the last ``N`` event.  Every term
is non-negative, so the result rounds like any careful sum in ``dtype``;
``dtype`` float32 is the lower-precision control.
"""

from __future__ import annotations

import math
from functools import reduce

import numpy as np

from hbench.references.seq_kleene import _matches, _value_attr, parse_agg
from hbench.references.seq_kleene_edge import _out

# the roles a query's types play, in the order of the walk's masks
ROLES = ("head", "kleene", "tail", "not_after")


def _role(cfg: dict, q: dict, role: str, type_id, attrs) -> np.ndarray:
    """Matched events of the query's ``role`` type; none where the query
    has no such role."""
    if role not in q:
        return np.zeros(len(type_id), dtype=bool)
    return _matches(cfg, q, role, type_id, attrs)


def window_direct(cfg: dict, q: dict, type_id, attrs) -> dict:
    """One window of one district (events in stream order), by the
    definition: the terms of every (head, tail) pair, or of every (head,
    last ``K`` event) pair after the last ``N`` event."""
    h = _role(cfg, q, "head", type_id, attrs)
    k = _role(cfg, q, "kleene", type_id, attrs)
    col = _value_attr(q)
    x = (attrs[:, cfg["schema"]["attrs"].index(col)] if col is not None
         else np.zeros(len(type_id)))
    heads = np.nonzero(h)[0].tolist()
    ks = np.nonzero(k)[0]
    count = count_k = 0          # exact integers
    total = 0.0
    if "tail" in q:
        for d in np.nonzero(_role(cfg, q, "tail", type_id, attrs))[0]:
            for a in heads:
                if a >= d:
                    break
                between = ks[(ks > a) & (ks < d)]
                m = len(between)
                if not m:
                    continue
                count += 2 ** m - 1
                count_k += m * 2 ** (m - 1)
                total += math.ldexp(float(x[between].sum()), m - 1)
    else:
        neg = np.nonzero(_role(cfg, q, "not_after", type_id, attrs))[0]
        last = int(neg[-1]) if len(neg) else -1
        for t in ks[ks > last]:
            for a in heads:
                if a >= t:
                    break
                between = ks[(ks > a) & (ks < t)]
                j = len(between)
                # the trends {between subset} + t: 2^j of them, each with t
                count += 2 ** j
                count_k += 2 ** j + j * 2 ** j // 2
                total += math.ldexp(float(x[t]), j)
                if j:
                    total += math.ldexp(float(x[between].sum()), j - 1)
    return _out(q, float(count), float(count_k), total)


def query_starts(cfg: dict, q: dict, window_starts) -> list:
    """The query's own window starts for the configuration-level
    ``window_starts``."""
    ws = [int(w) for w in window_starts]
    if not ws:
        return []
    slide = int(q["slide"])
    lo = -(-min(ws) // slide) * slide
    hi = max(ws) + int(cfg["within"]) - int(q["within"])
    return list(range(lo, hi + 1, slide))


def _pane(cfg: dict) -> int:
    return reduce(math.gcd, [int(cfg["within"]), int(cfg["slide"])]
                  + [int(q[f]) for q in cfg["queries"]
                     for f in ("within", "slide")])


def _pattern_types(cfg: dict) -> list:
    """Type ids the configuration's patterns name."""
    types = cfg["schema"]["types"]
    return sorted({types.index(q[r]) for q in cfg["queries"] for r in ROLES
                   if r in q})


def evaluate(cfg: dict, type_id, time, attrs, group, window_starts, groups,
             dtype=np.float64) -> dict:
    """Every aggregate of every query for each of its window starts (see
    :func:`query_starts`) and each district in ``groups``:
    ``{(query, district, w0): {agg: value}}``.  The events are one
    stream's, sorted by time, in stream order."""
    ws = sorted(int(w) for w in window_starts)
    groups = [int(g) for g in groups]
    if not ws or not groups:
        return {}
    pane = _pane(cfg)
    lo, hi = ws[0] - ws[0] % pane, ws[-1] + int(cfg["within"])
    n_panes = -(-(hi - lo) // pane)
    lut = np.full(max(max(groups), int(group.max(initial=0))) + 1, -1)
    lut[groups] = np.arange(len(groups))
    keep = (time >= lo) & (time < hi) & np.isin(type_id,
                                                _pattern_types(cfg))
    keep &= lut[np.where(keep, group, 0)] >= 0
    idx = np.nonzero(keep)[0]
    gi = lut[group[idx]]
    order = np.argsort(gi, kind="stable")          # district, stream order
    idx, gi = idx[order], gi[order]
    # one row of slots per (district, pane), the row's events in stream
    # order
    block = gi * n_panes + (time[idx] - lo) // pane
    n_blocks = len(groups) * n_panes
    sizes = np.bincount(block, minlength=n_blocks)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    slot = np.arange(len(idx)) - starts[block]
    n_slots = int(sizes.max(initial=0)) or 1
    tid, at = type_id[idx], attrs[idx]
    families: dict = {}
    for q in cfg["queries"]:
        families.setdefault((int(q["within"]), int(q["slide"])),
                            []).append(q)
    out: dict = {}
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for qs in families.values():
            qstarts = query_starts(cfg, qs[0], ws)
            if not qstarts:
                continue
            p0 = (np.asarray(qstarts) - lo) // pane
            cols = _walk(cfg, qs, tid, at, (block, slot, n_blocks, n_slots),
                         len(groups), n_panes, p0,
                         int(qs[0]["within"]) // pane, dtype)
            for qi, q in enumerate(qs):
                vals = [(agg, v[qi].tolist()) for agg, v in cols
                        if agg in q["aggs"]]
                for i, g in enumerate(groups):
                    for wi, w0 in enumerate(qstarts):
                        out[(q["name"], g, w0)] = {agg: v[i][wi]
                                                   for agg, v in vals}
    return out


def _walk(cfg, qs, tid, at, layout, n_groups, n_panes, p0, m, dtype) -> list:
    """``[(agg, values [Q, n_groups, W])]`` of the queries ``qs`` (one
    window length): each window walks the slots of its ``m`` panes."""
    block, slot, n_blocks, n_slots = layout
    nq = len(qs)
    masks = np.zeros((len(ROLES), nq, n_blocks, n_slots), dtype=bool)
    X = np.zeros((nq, n_blocks, n_slots), dtype=dtype)
    acol = cfg["schema"]["attrs"]
    for qi, q in enumerate(qs):
        for r, role in enumerate(ROLES):
            masks[r, qi, block, slot] = _role(cfg, q, role, tid, at)
        col = _value_attr(q)
        if col is not None:
            X[qi, block, slot] = at[:, acol.index(col)]
    masks = masks.reshape(len(ROLES), nq, n_groups, n_panes, n_slots)
    X = X.reshape(nq, n_groups, n_panes, n_slots)
    zero = np.zeros((), dtype=dtype)
    shape = (nq, n_groups, len(p0))
    H = np.zeros(shape, dtype=dtype)     # matched heads so far
    F, C, S = H.copy(), H.copy(), H.copy()      # trends ending at a K event
    TF, TC, TS = H.copy(), H.copy(), H.copy()   # ... then at a T event
    RF, RC, RS = H.copy(), H.copy(), H.copy()   # ... after the last N event
    for off in range(m):
        hm, km, tm, nm = masks[:, :, :, p0 + off]      # [Q, G, W, slots]
        xs = X[:, :, p0 + off]
        for s in range(n_slots):
            k = km[..., s]
            H += hm[..., s]
            e = np.where(k, H + F, zero)          # trends ending at it
            ck = np.where(k, C + e, zero)
            sx = np.where(k, S + xs[..., s] * e, zero)
            F += e
            C += ck
            S += sx
            t = tm[..., s]
            TF += np.where(t, F, zero)
            TC += np.where(t, C, zero)
            TS += np.where(t, S, zero)
            n = nm[..., s]
            RF = np.where(n, zero, RF + e)
            RC = np.where(n, zero, RC + ck)
            RS = np.where(n, zero, RS + sx)
    tail = np.array(["tail" in q for q in qs])[:, None, None]
    count = np.where(tail, TF, RF)
    count_k = np.where(tail, TC, RC)
    total = np.where(tail, TS, RS)
    avg = np.where(count_k != 0, total / count_k, np.nan)
    by_kind = {"COUNT(*)": count, "COUNT_K": count_k, "SUM": total,
               "AVG": avg}
    aggs = list(dict.fromkeys(a for q in qs for a in q["aggs"]))
    return [(agg, by_kind[parse_agg(agg)[0]].astype(dtype)) for agg in aggs]
