"""Dynamic sharing optimizer (paper Sec. 4).

Per burst, the policy picks which subset of the candidate queries (those with
a shareable ``E+``, Def. 4) share the new graphlet:

* **Snapshot-driven pruning** (Thm. 4.1): queries that introduce no event-level
  snapshots for this burst always share.
* **Benefit-driven pruning** (Thm. 4.2): each snapshot-introducing query q is
  classified by comparing ``Shared(Q)`` with ``Shared(Q\\{q}) + NonShared(q)``
  — O(m) plan evaluations instead of the exponential plan space (Fig. 7).
* The surviving set is shared only if its benefit (Def. 11/12) is positive.

``AlwaysShare`` / ``NeverShare`` realise the paper's static baselines
(Figs. 12-13); ``FlopPolicy`` is the beyond-paper variant whose cost model
counts the actual dense-algebra FLOPs of this implementation.

``d_rows`` maps each candidate query to a boolean per-event vector marking
the burst events whose signature (match status / start status / edge-predicate
row) differs from the reference query's — i.e. the events that would become
event-level snapshots (Def. 9) if that query shares.

``DynamicPolicy`` takes each v1 decision in bulk: one boolean pattern matrix
gives every union count, and the classification, the cheapest-pair seed and
each local-search sweep evaluate all their moves in one NumPy pass, taking
the scalar algorithm's comparisons and recording the exact interval of the
running event count on which the decision replays.  The v2 model stays on
the scalar path: its ``log2`` terms are not integer arithmetic, so its
decisions are neither taken in affine form nor memoized.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict

import numpy as np

from . import benefit as B

__all__ = ["DynamicPolicy", "AlwaysShare", "NeverShare", "FlopPolicy",
           "divergence_patterns"]


# --------------------------------------------------------------------------
# v1 decisions in bulk, with their exact replay interval over n
# --------------------------------------------------------------------------
#
# Every quantity the v1 benefit model computes is *affine* in ``n`` (the
# running event count): ``shared = b*n*s_p + s_c*k*g*t`` and ``nonshared =
# k*b*n`` never multiply ``n`` by itself.  Each cost is a pair of integers
# (the coefficient of ``n``, the constant), and the sharing decision is a
# deterministic function of the signs of finitely many comparisons ``da*n +
# dc < 0`` (or ``<= 0``), i.e. piecewise-constant in ``n`` with exactly
# computable flip thresholds.  The intersection of each comparison's
# stability interval is the integer interval of ``n`` on which the decision
# replays bit for bit, so the warm-pane fast path is one dict hit plus an
# interval check instead of the full classification + local search.
#
# ``_decide_v1`` takes one decision in bulk: every union count comes from a
# boolean pattern matrix (coverage patterns x candidates) and its weights,
# and the classification, the cheapest-pair seed and each local-search sweep
# evaluate all their candidate moves in one NumPy pass.  It takes the
# comparisons the scalar algorithm (``_decide_impl`` and ``_refine``, as the
# reference package evaluates them over affine costs) takes: the same
# float expression for the local search's ``best - 1e-12``,
# ``<`` minima in first-occurrence order, ``<=`` in the classification and
# the benefit sign, and only the comparisons the scalar loops evaluate
# constrain the interval.

# exact int64 room for ``da*n`` and float64 room for the constants ``dc``
_INT64_ROOM = 1 << 62
_FLOAT_ROOM = 1 << 52


def _stable_interval(lo, hi, parts: list) -> tuple:
    """Intersect ``[lo, hi]`` with the integer interval of ``n`` on which
    every comparison ``da*n + dc < 0`` of ``parts`` (batches of ``(da, dc,
    outcome at n0)``) keeps its outcome, each at its exact rational
    threshold ``r = -dc/da`` (``dc`` may be a float: the local search
    compares against ``best - 1e-12``).  One with ``da == 0`` bounds
    nothing."""
    if not parts:
        return lo, hi
    da, dc, out = (np.concatenate(x) for x in zip(*parts))
    keep = da != 0
    da, dc, out = da[keep].astype(np.int64), dc[keep], out[keep]
    pos = da > 0
    # T, the first integer above r: ceil(r) when da > 0 (the comparison
    # is false from there on), floor(r) + 1 when da < 0 (true from there
    # on).  With F = floor(dc / |da|) = floor(dc) // |da|, exact for a
    # float dc, they are -F and F + 1
    F = np.floor(dc).astype(np.int64) // np.abs(da)
    T = np.where(pos, -F, F + 1)
    # an outcome of the side below r (true when da > 0, false when da < 0)
    # holds up to T - 1, one of the side above from T on
    hiside = pos == out
    his, los = T[hiside], T[~hiside]
    if his.size:
        hi = min(hi, int(his.min()) - 1)
    if los.size:
        lo = max(lo, int(los.max()))
    return lo, hi


@functools.lru_cache(maxsize=64)
def _lower_mask(m: int) -> np.ndarray:
    """Added to an m x m int64 matrix, hides all but the pairs (i, j > i)
    from ``argmin``."""
    out = np.tril(np.full((m, m), np.iinfo(np.int64).max // 2))
    out.setflags(write=False)
    return out


def _decide_v1(patterns, candidates, b: int, n0: int, t: int,
               local_search: bool):
    """The v1 sharing decision for one burst at ``n = n0``, in bulk.

    Returns ``(groups, (lo, hi), benefit, benefit_value, split)``:
    ``benefit`` is the final shared set's ``(a, c)`` (``None`` when fewer
    than two queries share) and ``benefit_value`` its value at ``n0``, of
    the type the scalar path gives (an int below ``b``, else a float).
    Comparisons ``da*n + dc <= 0`` between integers are recorded as
    ``da*n + dc - 1 < 0``: the same integers ``n`` satisfy both."""
    m = len(candidates)
    # n = max(n, b): below b every cost is a constant (n is b), so only
    # this comparison bounds the decision
    record = n0 >= b
    lo, hi = (b, math.inf) if record else (-math.inf, b - 1)
    n = n0 if record else b
    rec: list | None = [] if record else None
    if patterns:
        codes, counts = zip(*patterns)
        nb = (m + 7) // 8
        raw = np.frombuffer(b"".join(c.to_bytes(nb, "little") for c in codes),
                            np.uint8).reshape(len(codes), nb)
        P = np.unpackbits(raw, axis=1, count=m, bitorder="little") != 0
        w = np.array(counts, np.int64)
    else:
        P = np.zeros((0, m), bool)
        w = np.zeros(0, np.int64)
    U = int(w.sum())
    bt = b * t
    if (2 * b * (m + 2 + U) * abs(n) >= _INT64_ROOM
            or 2 * (1 + U) * max(m, 1) * bt >= _FLOAT_ROOM):
        raise OverflowError(
            f"v1 costs at n={n0}, b={b}, {m} candidates pass int64")
    cover = P.sum(1)                  # candidates each pattern covers
    u1 = w @ P                        # u({q})

    # Thm 4.1: queries that introduce no snapshot share for free; Thm 4.2:
    # q shares iff Shared(Q) <= Shared(Q \ {q}) + NonShared(q), where
    # u(Q \ {q}) = uQ - x, x the weight of the patterns only q covers
    snap = u1 > 0
    uQ = int(w @ (cover > 0))
    x = w @ (P & (cover == 1)[:, None])
    da = b * (x - 1)
    dc = bt * (m - 1) * x + bt * (1 + uQ)
    keep = da * n + dc <= 0
    if record:
        rec.append((np.where(snap, da, 0), dc - 1, keep))
    shared = keep | ~snap

    if local_search:
        S = _refine_bulk(P, w, u1, shared, m, b, bt, n, rec)
        members = sorted(candidates[i] for i in np.flatnonzero(S))
    else:
        S = shared
        members = [candidates[i] for i in np.concatenate(
            [np.flatnonzero(~snap), np.flatnonzero(snap & keep)])]
    k = len(members)
    if k < 2:
        return ([[q] for q in candidates], _stable_interval(lo, hi, rec),
                None, None, False)
    u = int(w[(P & S).any(1)].sum())
    ben = (k * b - b * (1 + u), -((1 + u) * k * bt))
    value = ben[0] * n + ben[1]
    split = value <= 0
    if record:
        rec.append(([ben[0]], [ben[1] - 1], [split]))
        benefit, value = ben, float(value)
    else:
        benefit = (0, value)
    if split:
        groups = [[q] for q in candidates]
    else:
        groups = [members] + [[q] for q in candidates if q not in members]
    return groups, _stable_interval(lo, hi, rec), benefit, value, split


def _cost(k: int, u: int, m: int, b: int, bt: int) -> tuple:
    """``(a, c)`` of the plan that shares k of the m queries, whose union
    count is u, on one graphlet and runs the others (and a lone one)
    alone: ``shared_cost_v1`` with s_p = s_c = 1 + u and g = b, plus
    ``nonshared_cost_v1``."""
    if k < 2:
        return m * b, 0
    return (m - k) * b + b * (1 + u), (1 + u) * k * bt


def _refine_bulk(P, w, u1, shared, m, b, bt, n, rec):
    """Multi-start single-move local search over shared-set membership
    (``DynamicPolicy._refine`` in bulk); returns the chosen set as a mask.
    ``rec`` collects the comparisons the scalar loops take (``None``: n is
    a constant)."""
    starts = [shared.copy(), np.ones(m, bool)]
    empty = ~P.any(0)                     # queries that cover no pattern
    if m >= 2:
        # cheapest pair as a growth seed (single moves cannot leave |S| < 2):
        # the first minimum in (i, j > i) order, as ``min`` takes it.  A
        # pair's cost rises with its union count u alone, (b*n + 2*bt)*u
        # plus a constant, so the minimum is the union's, and the
        # comparisons ``min`` takes flip only at n = -2t: they bound no
        # n >= b, the only n whose comparisons are recorded
        U2 = u1[:, None] + u1 - (P.T * w) @ P
        j = int(np.argmin(U2 + _lower_mask(m)))
        pair = np.zeros(m, bool)
        pair[[j // m, j % m]] = True
        starts.append(pair)
    best = None
    seen = set()
    for s0 in starts:
        # a start equal to an earlier one descends the same way to the
        # same cost, which is not below it: its comparisons are recorded
        if s0.tobytes() in seen:
            continue
        seen.add(s0.tobytes())
        S, c = _descend_bulk(P, w, empty, s0, m, b, bt, n, rec)
        if best is not None:
            # c < best_c, the scalar path's comparison of the descents
            da, dc = c[0] - best[1][0], c[1] - best[1][1]
            took = da * n + dc < 0
            if rec is not None:
                rec.append(([da], [dc], [took]))
        if best is None or took:
            best = (S, c)
    return best[0]


def _descend_bulk(P, w, empty, S, m, b, bt, n, rec):
    """Single-flip descent from ``S``, as ``DynamicPolicy._refine``'s
    ``descend``: a sweep visits every ``q`` in order and takes the flip
    ``S ^ {q}`` when its cost is below ``best - 1e-12``; a sweep that took
    a flip is followed by another.

    Each step evaluates the flips from the sweep position on at once.  A
    flip of a query that covers no pattern moves k alone, and its gain
    ``s*(bt*(1 + u) - b*n)`` does not depend on k, so a step assumes those
    outcomes, places every later query at the k the flips before it leave,
    and runs up to the first query whose outcome is not the assumed one (a
    taken flip that moves the union, or an edge of ``cost``)."""
    cnt = (P & S).sum(1)                  # members of S covering each pattern
    k, u = int(S.sum()), int(w[cnt > 0].sum())
    sgn = 1 - 2 * S.astype(np.int64)      # +1: q joins S, -1: q leaves
    improved = True
    while improved:
        improved = False
        p = 0
        while p < m:
            Sp, sg = S[p:], sgn[p:]
            # a pattern no member covers counts once q joins; one that only
            # q covers stops counting once q leaves
            du = sg * (w @ (P[:, p:] & (cnt[:, None] == Sp)))
            gain = bt * (1 + u) - b * n           # a pattern-free join's
            assumed = empty[p:] & (~Sp if gain < 0 else Sp if gain > 0
                                   else False)
            runs = bool(assumed.any())
            if runs:
                steps = np.where(assumed, sg, 0)
                kq = k + np.cumsum(steps) - steps     # k when q is visited
                kmin = min(k, int(kq[-1]))       # kq is monotone
            else:
                kq = kmin = k
            k2 = kq + sg
            if kmin >= 2:
                da = b * (du - sg)
                c = kq * float((1 + u) * bt)
                c2 = (du + (1 + u)) * k2 * bt
            else:
                many, many2 = kq >= 2, k2 >= 2
                u2 = u + du
                da = (np.where(many2, (m - k2) * b + b * (1 + u2), m * b)
                      - np.where(many, (m - kq) * b + b * (1 + u), m * b))
                c = np.where(many, (1 + u) * kq * bt, 0).astype(np.float64)
                c2 = np.where(many2, (1 + u2) * k2 * bt, 0)
            # c2 < best - 1e-12 as the scalar path takes it: ``da*n + dc``
            # with the float ``dc = c2 - (best_c - 1e-12)``; a flip to
            # |S| = 1 is not compared
            dc = c2 - (c - 1e-12)
            took = da * n + dc < 0
            if kmin <= 2:
                seen = k2 != 1
                da = np.where(seen, da, 0)
                took &= seen
            off = took != assumed if runs else took
            j = int(off.argmax())
            end = j + 1 if off[j] else len(off)
            if rec is not None:
                rec.append((da[:end], dc[:end], took[:end]))
            flips = took[:end]
            if flips.any() if runs else off[j]:
                improved = True
                S[p:p + end] ^= flips
                sgn[p:p + end] = np.where(flips, -sg[:end], sg[:end])
                last = p + end - 1
                kj = kq[end - 1] if runs else kq
                k = int(kj - sgn[last] if flips[-1] else kj)
                if flips[-1] and not empty[last]:
                    cnt = (P & S).sum(1)
                    u += int(du[end - 1])
            p += end
    return S, _cost(k, u, m, b, bt)


_MEMO_CAP = 4096


def _union_count(d_rows: dict[int, np.ndarray], S) -> int:
    rows = [d_rows[q] for q in S if q in d_rows]
    if not rows:
        return 0
    return int(np.any(np.stack(rows), axis=0).sum())


def divergence_patterns(d_rows: dict[int, np.ndarray],
                        candidates) -> tuple:
    """Exact compression of ``d_rows`` into everything the benefit model can
    read: the multiset of per-event *coverage patterns* — for each burst
    event, the subset of candidates whose signature diverges there (a
    bitmask over ``candidates``), with multiplicity.  Any subset's snapshot
    union count is recoverable exactly (sum the counts of intersecting
    patterns), so decisions taken from patterns are bit-for-bit the
    decisions taken from the raw rows: two bursts with equal patterns (and
    equal ``b``/``n``) provably take the same sharing decision."""
    if not candidates:
        return ()
    D = np.stack([np.asarray(d_rows[q], dtype=bool) for q in candidates])
    if len(candidates) < 60:
        codes = (1 << np.arange(len(candidates), dtype=np.int64)) @ D
        codes = codes[codes != 0]
        if not len(codes):
            return ()
        vals, counts = np.unique(codes, return_counts=True)
        return tuple(zip(vals.tolist(), counts.tolist()))
    # wide candidate sets overflow a fixed-width bitmask: pack each event's
    # coverage column into bytes and rebuild arbitrary-width Python ints
    packed = np.packbits(D, axis=0, bitorder="little")
    cols, counts = np.unique(packed, axis=1, return_counts=True)
    out = []
    for ci in range(cols.shape[1]):
        mask = int.from_bytes(cols[:, ci].tobytes(), "little")
        if mask:
            out.append((mask, int(counts[ci])))
    return tuple(sorted(out))


class _PolicyBase:
    # True when ``decide`` never reads ``d_rows`` (nor any other per-burst
    # structure): the engine then skips the divergence pass entirely and the
    # policy is handed ``d_rows=None``
    decision_static = False
    # True when the decision reads ``d_rows`` only through coverage-pattern
    # counts (``divergence_patterns``): the engine then decides edge-free
    # bursts from the prologue's packed divergence codes via
    # ``decide_patterns``, without building their divergence rows
    pattern_based = False
    # inputs/outputs of the most recent decision, read by the engine's
    # sharing-decision audit log (``repro_torch.obs.audit``); None for policies
    # whose decision never evaluates the benefit model
    last_benefit = None
    last_patterns = None
    # closed interval of the running event count ``n`` on which the most
    # recent decision is replay-stable (``None`` when unknown — non-memoized
    # models); the v1 memo replays a decision on it.
    last_interval: tuple | None = None

    def decide(self, *, ctx, el, candidates, d_rows, b, n, stats) -> list[list[int]]:
        raise NotImplementedError


class AlwaysShare(_PolicyBase):
    """Static plan: share every shareable burst (paper's static optimizer)."""

    decision_static = True

    def decide(self, *, ctx, el, candidates, d_rows, b, n, stats):
        stats.decisions += 1
        return [list(candidates)]


class NeverShare(_PolicyBase):
    """Non-shared execution for every burst (GRETA-equivalent plan)."""

    decision_static = True

    def decide(self, *, ctx, el, candidates, d_rows, b, n, stats):
        stats.decisions += 1
        return [[q] for q in candidates]


class DynamicPolicy(_PolicyBase):
    """The HAMLET optimizer (Sec. 4.2/4.3) with the Def. 11 benefit model.

    The Thm 4.1/4.2 classification is exactly optimal under the paper's
    assumption that removing a query leaves the snapshot counts unchanged.
    With *partially overlapping* per-query divergence sets that assumption
    breaks (choosing the shared subset becomes set-cover-like), so we refine
    the classification with a single-move local search (beyond-paper; still
    O(m^2) plan evaluations per burst, m = snapshot-introducing queries).
    ``model="v2"`` takes the Def. 12 costs on the scalar path."""

    pattern_based = True

    def __init__(self, model: str = "v1", local_search: bool = True):
        self.model = model
        self.local_search = local_search
        # (patterns, candidates, b, t) -> [(n_lo, n_hi, groups, benefit,
        # split)]: exact decision replay intervals over the running event
        # count (see ``_decide_v1``)
        self._memo: "OrderedDict[tuple, list]" = OrderedDict()

    def decide(self, *, ctx, el, candidates, d_rows, b, n, stats):
        return self.decide_patterns(
            patterns=divergence_patterns(d_rows, candidates),
            candidates=candidates, b=b, n=n, t=max(1, ctx.layout.t),
            stats=stats)

    def decide_patterns(self, *, patterns, candidates, b, n, t, stats):
        """Decide from the compressed decision inputs: every snapshot union
        count the classification / refinement reads is recovered from the
        coverage-pattern multiset, so this is bit-for-bit :meth:`decide` —
        the engine calls it straight off a burst's slice of the prologue's
        packed divergence codes (see ``PaneProcessor._decide``).

        The v1 model evaluates each decision in bulk (``_decide_v1``: one
        pattern matrix, every candidate move of the classification, the
        pair seed and each local-search sweep in one NumPy pass) and
        memoizes it per (patterns, candidates, b, t) with the exact
        interval of the running event count ``n`` on which it is stable
        (every cost comparison keeps its sign), so a warm stream replays
        each decision from one dict hit while benefit flips at the recorded
        thresholds still recompute and land in fresh intervals.  The
        decisions, intervals and benefits are those of the scalar algorithm
        over affine costs.

        Only the v1 model takes that path: its costs are pure integer
        arithmetic, so the affine replay is bit-for-bit.  v2's ``log2``
        terms would round differently in affine form near decision
        boundaries — it takes the plain scalar path, unmemoized.  Every
        fresh evaluation (a v1 memo miss, any v2 call) counts in
        ``stats.decide_evals``."""
        if self.model != "v1":
            stats.decide_evals += 1
            self.last_interval = None
            return self._decide_impl(patterns=patterns,
                                     candidates=candidates, b=b, n=n, t=t,
                                     stats=stats)
        n = int(n)
        key = (patterns, tuple(candidates), b, t)
        ent = self._memo.get(key)
        if ent is not None:
            self._memo.move_to_end(key)
            for lo, hi, groups, benefit, split in ent:
                if lo <= n <= hi:
                    stats.decisions += 1
                    if split:
                        stats.split_bursts += 1
                    self.last_interval = (lo, hi)
                    self.last_patterns = patterns
                    # the benefit value is itself affine in n: evaluate the
                    # recorded coefficients at this pane's event count
                    self.last_benefit = (None if benefit is None
                                         else float(benefit[0] * n
                                                    + benefit[1]))
                    return [list(g) for g in groups]
        stats.decide_evals += 1
        stats.decisions += 1
        out, (lo, hi), benefit, self.last_benefit, split = _decide_v1(
            patterns, candidates, b, n, t, self.local_search)
        if split:
            stats.split_bursts += 1
        self.last_patterns = patterns
        if ent is None:
            ent = self._memo[key] = []
            while len(self._memo) > _MEMO_CAP:
                self._memo.popitem(last=False)
        ent.append((lo, hi, tuple(map(tuple, out)), benefit, split))
        self.last_interval = (lo, hi)
        return out

    # -- the v2 model's scalar path (v1 decides in ``_decide_v1``) --

    def _costs(self, *, s_new: int, b: int, n: int, k: int, g: int, t: int):
        s_c = 1 + s_new          # graphlet snapshot x + event-level snapshots
        s_p = 1 + s_new
        return B.benefit_v2(b=b, n=n, s_p=s_p, s_c=s_c, k=k, g=g, p=max(1, t // 2))

    def _decide_impl(self, *, patterns, candidates, b, n, t, stats):
        stats.decisions += 1
        self.last_patterns = patterns
        self.last_benefit = None
        n = max(n, b)
        g = b
        bit = {q: 1 << i for i, q in enumerate(candidates)}

        def union(S) -> int:
            m = 0
            for q in S:
                m |= bit[q]
            return sum(c for code, c in patterns if code & m)

        d_q = {q: union((q,)) for q in candidates}
        free = [q for q in candidates if d_q[q] == 0]   # Thm 4.1: share for free
        snap = [q for q in candidates if d_q[q] > 0]

        shared = list(free)
        Q = list(candidates)
        full = self._costs(s_new=union(Q), b=b, n=n, k=len(Q), g=g, t=t)
        for q in snap:                                   # Thm 4.2 classification
            without_q = [x for x in Q if x != q]
            alt = (self._costs(s_new=union(without_q), b=b, n=n,
                               k=len(without_q), g=g, t=t).shared
                   + B.nonshared_cost_v1(b, n, 1))
            if full.shared <= alt:
                shared.append(q)

        if self.local_search:
            shared = self._refine(shared, candidates, union, b, n, g, t)

        if len(shared) < 2:
            return [[q] for q in candidates]
        final = self._costs(s_new=union(shared), b=b, n=n,
                            k=len(shared), g=g, t=t)
        self.last_benefit = final.benefit
        if final.benefit <= 0:
            stats.split_bursts += 1
            return [[q] for q in candidates]
        return [shared] + [[q] for q in candidates if q not in shared]

    def _plan_cost(self, S, candidates, union, b, n, g, t) -> float:
        rest = len(candidates) - len(S)
        cost = B.nonshared_cost_v1(b, n, rest) if rest else 0.0
        if len(S) >= 2:
            cost += self._costs(s_new=union(S), b=b, n=n,
                                k=len(S), g=g, t=t).shared
        elif len(S) == 1:
            cost += B.nonshared_cost_v1(b, n, 1)
        return cost

    def _refine(self, shared, candidates, union, b, n, g, t) -> list[int]:
        """Multi-start single-move local search over shared-set membership."""

        def descend(S: set) -> tuple[set, float]:
            best = self._plan_cost(S, candidates, union, b, n, g, t)
            improved = True
            while improved:
                improved = False
                for q in list(candidates):
                    S2 = S ^ {q}
                    if len(S2) == 1:
                        continue
                    c2 = self._plan_cost(S2, candidates, union, b, n, g, t)
                    if c2 < best - 1e-12:
                        S, best, improved = S2, c2, True
            return S, best

        starts = [set(shared), set(candidates)]
        # cheapest pair as a growth seed (single moves cannot leave |S| < 2)
        if len(candidates) >= 2:
            pair = min(
                ((a, c) for i, a in enumerate(candidates)
                 for c in candidates[i + 1:]),
                key=lambda p: self._plan_cost(set(p), candidates, union,
                                              b, n, g, t))
            starts.append(set(pair))
        best_S, best_c = None, float("inf")
        for s0 in starts:
            S, c = descend(s0)
            if c < best_c:
                best_S, best_c = S, c
        return sorted(best_S)


class FlopPolicy(_PolicyBase):
    """Beyond-paper cost model: counts the dense-algebra FLOPs this engine
    actually executes.  Shared: one [b x B_local] solve plus per-query
    snapshot resolution; non-shared: k solves of width ~nu."""

    def decide(self, *, ctx, el, candidates, d_rows, b, n, stats):
        stats.decisions += 1
        k = len(candidates)
        nu = ctx.nu
        C = ctx.layout.size
        u = _union_count(d_rows, candidates)
        B_local = 1 + nu + u * nu
        shared = b * b * B_local + u * k * (b * B_local + B_local * C) + k * B_local * C
        nonshared = k * (b * b * (1 + nu) + (1 + nu) * C)
        self.last_benefit = float(nonshared - shared)
        self.last_patterns = None
        if k >= 2 and shared < nonshared:
            return [list(candidates)]
        stats.split_bursts += 1 if k >= 2 else 0
        return [[q] for q in candidates]
