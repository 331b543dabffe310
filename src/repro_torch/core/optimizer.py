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
"""

from __future__ import annotations

import math
from collections import OrderedDict
from fractions import Fraction

import numpy as np

from . import benefit as B

__all__ = ["DynamicPolicy", "AlwaysShare", "NeverShare", "FlopPolicy",
           "divergence_patterns"]


# --------------------------------------------------------------------------
# exact decision memoization over the running event count
# --------------------------------------------------------------------------
#
# Every quantity the v1/v2 benefit models compute is *affine* in ``n`` (the
# running event count): ``shared = b*n*s_p + s_c*k*g*t`` and ``nonshared =
# k*b*n`` never multiply ``n`` by itself.  The sharing decision is therefore
# a deterministic function of the signs of finitely many affine comparisons,
# i.e. piecewise-constant in ``n`` with exactly computable flip thresholds.
# ``_Aff`` threads an affine number through the untouched cost code; every
# comparison it takes records the exact integer interval of ``n`` on which
# its outcome is stable, so one recorded decision replays bit-for-bit for
# every ``n`` inside the interval — the warm-pane fast path is one dict hit
# plus an interval check instead of the full classification + local search.


class _IntervalRecorder:
    """Integer interval of ``n`` on which every recorded comparison keeps
    the outcome it had at ``n0`` (inclusive bounds; ±inf = unbounded)."""

    __slots__ = ("n0", "lo", "hi")

    def __init__(self, n0: int):
        self.n0 = n0
        self.lo = -math.inf
        self.hi = math.inf

    def constrain(self, da, dc, strict: bool, outcome: bool) -> None:
        # predicate: da*n + dc < 0 (strict) / <= 0; held `outcome` at n0
        r = (Fraction(-dc, da) if isinstance(da, int) and isinstance(dc, int)
             else Fraction(-dc) / Fraction(da))
        if outcome == strict:
            # n strictly below/above the threshold
            if (da > 0) == outcome:
                self.hi = min(self.hi, math.ceil(r) - 1)
            else:
                self.lo = max(self.lo, math.floor(r) + 1)
        else:
            if (da > 0) == outcome:
                self.hi = min(self.hi, math.floor(r))
            else:
                self.lo = max(self.lo, math.ceil(r))


class _Aff:
    """``a*n + c`` evaluated at the recorder's ``n0``; comparisons record
    their exact stability interval.  Products of two n-dependent values are
    rejected — the cost models are affine by construction."""

    __slots__ = ("rec", "a", "c")

    def __init__(self, rec, a, c):
        self.rec = rec
        self.a = a
        self.c = c

    def _coerce(self, o):
        if isinstance(o, _Aff):
            return o
        if isinstance(o, (int, float)):
            return _Aff(self.rec, 0, o)
        return None

    def __float__(self):
        return float(self.a * self.rec.n0 + self.c)

    def __add__(self, o):
        o = self._coerce(o)
        if o is None:
            return NotImplemented
        return _Aff(self.rec, self.a + o.a, self.c + o.c)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        if o is None:
            return NotImplemented
        return _Aff(self.rec, self.a - o.a, self.c - o.c)

    def __rsub__(self, o):
        o = self._coerce(o)
        if o is None:
            return NotImplemented
        return _Aff(self.rec, o.a - self.a, o.c - self.c)

    def __neg__(self):
        return _Aff(self.rec, -self.a, -self.c)

    def __mul__(self, o):
        if isinstance(o, _Aff):
            if o.a == 0:
                o = o.c
            elif self.a == 0:
                return _Aff(self.rec, o.a * self.c, o.c * self.c)
            else:
                raise TypeError("product of two n-dependent costs")
        if not isinstance(o, (int, float)):
            return NotImplemented
        return _Aff(self.rec, self.a * o, self.c * o)

    __rmul__ = __mul__

    def _cmp(self, other, strict: bool, flip: bool):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        da, dc = self.a - o.a, self.c - o.c
        if flip:
            da, dc = -da, -dc
        out = ((da * self.rec.n0 + dc < 0) if strict
               else (da * self.rec.n0 + dc <= 0))
        if da != 0 and math.isfinite(dc):
            self.rec.constrain(da, dc, strict, out)
        return out

    def __lt__(self, o):
        return self._cmp(o, True, False)

    def __le__(self, o):
        return self._cmp(o, False, False)

    def __gt__(self, o):
        return self._cmp(o, True, True)

    def __ge__(self, o):
        return self._cmp(o, False, True)


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
    decisions taken from the raw rows.  This is the plan cache's quantized
    benefit-model fingerprint: two panes with equal patterns (and equal
    ``b``/``n``) provably take the same sharing decision."""
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
    # counts (``divergence_patterns``): the engine's dynamic-policy plan-key
    # fast path then recomputes the decision from a vectorized fingerprint
    # via ``decide_patterns`` instead of the per-burst plan walk
    pattern_based = False
    # inputs/outputs of the most recent decision, read by the engine's
    # sharing-decision audit log (``repro_torch.obs.audit``); None for policies
    # whose decision never evaluates the benefit model
    last_benefit = None
    last_patterns = None
    # closed interval of the running event count ``n`` on which the most
    # recent decision is replay-stable (``None`` when unknown — non-memoized
    # models).  Lets the engine memoize whole-pane decision walks: a pane's
    # decisions replay verbatim while ``n`` stays inside the intersection of
    # its bursts' intervals (see ``engine._dyn_fast_groups``).
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
    O(m^2) plan evaluations per burst, m = snapshot-introducing queries)."""

    pattern_based = True

    def __init__(self, model: str = "v1", local_search: bool = True):
        self.model = model
        self.local_search = local_search
        # (patterns, candidates, b, t) -> [(n_lo, n_hi, groups, benefit,
        # split)]: exact decision replay intervals over the running event
        # count (see the _Aff instrumentation above)
        self._memo: "OrderedDict[tuple, list]" = OrderedDict()

    def _costs(self, *, s_new: int, b: int, n: int, k: int, g: int, t: int):
        s_c = 1 + s_new          # graphlet snapshot x + event-level snapshots
        s_p = 1 + s_new
        if self.model == "v1":
            return B.benefit_v1(b=b, n=n, s_p=s_p, s_c=s_c, k=k, g=g, t=t)
        return B.benefit_v2(b=b, n=n, s_p=s_p, s_c=s_c, k=k, g=g, p=max(1, t // 2))

    def decide(self, *, ctx, el, candidates, d_rows, b, n, stats):
        return self.decide_patterns(
            patterns=divergence_patterns(d_rows, candidates),
            candidates=candidates, b=b, n=n, t=max(1, ctx.layout.t),
            stats=stats)

    def decide_patterns(self, *, patterns, candidates, b, n, t, stats):
        """Decide from the compressed decision inputs: every snapshot union
        count the classification / refinement reads is recovered from the
        coverage-pattern multiset, so this is bit-for-bit :meth:`decide` —
        the engine's plan-key fast path calls it straight off a vectorized
        per-burst fingerprint (see ``engine._dyn_fast_groups``).

        Decisions are memoized per (patterns, candidates, b, t) with the
        exact interval of the running event count ``n`` on which the
        recorded decision trajectory is stable (all cost comparisons keep
        their sign — see ``_Aff``), so a warm stream replays each decision
        from one dict hit while benefit flips at the recorded thresholds
        still recompute and land in fresh intervals.

        Only the v1 model memoizes: its costs are pure integer arithmetic,
        so the affine replay is bit-for-bit.  v2's ``log2`` terms make the
        instrumented arithmetic round differently near decision boundaries
        — it takes the plain path."""
        if self.model != "v1":
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
        rec = _IntervalRecorder(n)
        split0 = stats.split_bursts
        out = self._decide_impl(patterns=patterns, candidates=candidates,
                                b=b, n=_Aff(rec, 1, 0), t=t, stats=stats)
        lb = self.last_benefit
        if isinstance(lb, _Aff):
            benefit = (lb.a, lb.c)
            self.last_benefit = float(lb)
        else:
            benefit = None if lb is None else (0, lb)
        if ent is None:
            ent = self._memo[key] = []
            while len(self._memo) > _MEMO_CAP:
                self._memo.popitem(last=False)
        ent.append((rec.lo, rec.hi, tuple(map(tuple, out)),
                    benefit, stats.split_bursts > split0))
        self.last_interval = (rec.lo, rec.hi)
        return out

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
