"""Error accountant: per-query aggregate error bounds under shedding.

Shedding changes results; this module tracks *which* guarantees survive.
Every shed event is bucketed per (atomic query, group key, pane) into three
classes relative to that query — Kleene-type, pattern-completing
(non-Kleene positive), negation-type — from which two bounds follow for the
trend-count aggregates of a window:

* **Subset guarantee** (lower bound): if no negation-type event of query q was
  shed, every trend counted by the shedded run exists in the unshedded run, so
  ``emitted <= true`` for COUNT/SUM of non-negative attributes.  (Dropping a
  positive event only removes trends; dropping a NOT event can fabricate
  them.)
* **Multiplicative upper bound** (factor-3 lemma): when a shed Kleene event e
  was a burst *suffix* with a kept same-burst witness e' (``witnessed`` shed
  plans certify this), every trend containing e maps to a trend without it —
  ``T -> T \\ {e}`` when that is still a match, else ``T -> T \\ {e} + {e'}``
  (e' precedes e, so e' inherits every backward adjacency of e).  The map is
  at most 2-to-1 onto trends without e, hence ``N <= 3 * N_without`` per
  removal, and over a window where ``s`` Kleene-type events of q were shed:

      true <= 3**s * emitted        (and true = 0 whenever emitted = 0)

  The lemma needs removal/substitution to preserve trend-hood, so ``tight``
  additionally requires: no pattern-completing or negation event of q shed in
  the window, no edge predicates (they make within-burst adjacency
  non-transitive), and no per-event predicates on q's Kleene types (the
  witness might fail them).  A 2**s bound without the witness condition is
  *unsound*: a shed event can be the sole Kleene witness of arbitrarily many
  trends.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..core.events import EventBatch, pane_size_for
from ..core.query import Workload

__all__ = ["WindowBound", "QueryErrorReport", "ErrorAccountant",
           "merge_error_reports"]

_KLE, _CRIT, _NEG, _WIT = 0, 1, 2, 3


@dataclass(frozen=True)
class WindowBound:
    """Shed exposure of one (query, group, window)."""

    shed_kleene: int
    shed_critical: int
    shed_negative: int
    tight: bool      # the 3**s multiplicative bound applies

    def count_upper_bound(self, emitted: float) -> float:
        """Upper bound on the true trend count given the emitted one."""
        if not self.tight:
            return float("inf")
        if emitted <= 0:
            return 0.0
        return 3.0 ** self.shed_kleene * emitted


@dataclass(frozen=True)
class QueryErrorReport:
    query: str
    shed_kleene: int
    shed_critical: int
    shed_negative: int
    cells_affected: int      # (group, pane) buckets with any relevant shed
    subset_guarantee: bool   # emitted results are lower bounds on the truth


def merge_error_reports(reports) -> dict[str, "QueryErrorReport"]:
    """Fleet-level certificate from per-instance ``report()`` dicts.

    Shed-class counts sum; the subset guarantee is the conjunction (one
    instance shedding a negation event of q withdraws the global lower
    bound).  ``cells_affected`` also sums — exact when the instances
    partition the group space (the sharded service: groups are disjoint per
    shard, router cells cover events no shard ever saw), an upper bound on
    distinct cells otherwise.  For exact per-window ``3^s`` bounds merge the
    accountants themselves (:meth:`ErrorAccountant.merged`)."""
    out: dict[str, QueryErrorReport] = {}
    for rep in reports:
        for name, r in rep.items():
            prev = out.get(name)
            if prev is None:
                out[name] = r
            else:
                out[name] = QueryErrorReport(
                    query=name,
                    shed_kleene=prev.shed_kleene + r.shed_kleene,
                    shed_critical=prev.shed_critical + r.shed_critical,
                    shed_negative=prev.shed_negative + r.shed_negative,
                    cells_affected=prev.cells_affected + r.cells_affected,
                    subset_guarantee=prev.subset_guarantee
                    and r.subset_guarantee)
    return out


class ErrorAccountant:
    def __init__(self, workload: Workload, pane: int | None = None):
        self.pane = int(pane) if pane else pane_size_for(workload.windows)
        # (aqi, group, pane_t0) -> [kleene, critical, negative, witnessed]
        self._shed: dict[tuple[int, int, int], list[int]] = {}
        self._tainted: set[int] = set()
        self.total_shed = 0
        self.late_events = 0
        self._bind(workload)

    def _bind(self, workload: Workload) -> None:
        self.workload = workload
        schema = workload.schema
        self._cls: list[tuple[frozenset, frozenset, frozenset]] = []
        self._boundable: list[bool] = []
        self._by_name: dict[str, int] = {}
        for aqi, q in enumerate(workload.atomic):
            kle = frozenset(schema.type_id(t) for t in q.info.kleene_types)
            crit = frozenset(schema.type_id(t) for t in q.info.types) - kle
            neg = frozenset(schema.type_id(nc.neg_type)
                            for nc in q.info.negatives)
            self._cls.append((kle, crit, neg))
            self._boundable.append(
                not q.edge_preds
                and all(not q.preds_for(t) for t in q.info.kleene_types))
            self._by_name[q.name] = aqi

    def migrate(self, workload: Workload) -> None:
        """Rebind to a changed workload (query add/remove at a plan
        migration).  History of surviving queries is remapped by name.
        Queries *new* to this workload are permanently tainted: events shed
        before the query existed were never classified for it, so neither
        the subset guarantee nor the multiplicative bound can be certified
        for any of its windows.  The pane bucketing is fixed at construction
        (changing it would orphan recorded cells); it stays sound for new
        window geometries because window coverage only ever over-counts."""
        old_names = {aqi: name for name, aqi in self._by_name.items()}
        tainted_names = {old_names[aqi] for aqi in self._tainted}
        self._bind(workload)
        remap = {old_aqi: self._by_name[name]
                 for old_aqi, name in old_names.items()
                 if name in self._by_name}
        self._shed = {(remap[aqi], gk, t0): cell
                      for (aqi, gk, t0), cell in self._shed.items()
                      if aqi in remap}
        self._tainted = {self._by_name[n] for n in tainted_names
                         if n in self._by_name}
        if self.total_shed:
            survivors = set(remap.values())
            self._tainted |= set(range(len(workload.atomic))) - survivors

    def record(self, shed: EventBatch, witnessed: bool = False,
               late: bool = False) -> None:
        """Account a batch of shed events (any time span; bucketed per pane).

        ``witnessed``: the shed plan certified suffix-only Kleene shedding
        with a kept witness per trimmed burst (see module docstring).

        ``late``: the events were not chosen by a shed plan but arrived past
        the lateness horizon of the event-time layer (or behind an
        order-assuming pane loop) and were dropped for it.  They are charged
        exactly like unwitnessed shed events — an un-folded event corrupts
        results the same way however it was lost — which keeps the subset /
        ``3^s`` bookkeeping sound under disorder: any window a late Kleene
        event would have landed in loses its ``tight`` certificate, and late
        negation events withdraw the subset guarantee."""
        if not len(shed):
            return
        self.total_shed += len(shed)
        if late:
            self.late_events += len(shed)
        pane_t0 = (shed.time // self.pane) * self.pane
        for aqi, (kle, crit, neg) in enumerate(self._cls):
            for ci, tset in ((_KLE, kle), (_CRIT, crit), (_NEG, neg)):
                if not tset:
                    continue
                mask = np.isin(shed.type_id, list(tset))
                if not mask.any():
                    continue
                counts = Counter(zip(shed.group[mask].tolist(),
                                     pane_t0[mask].tolist()))
                for (gk, t0), c in counts.items():
                    cell = self._shed.setdefault((aqi, int(gk), int(t0)),
                                                 [0, 0, 0, 1])
                    cell[ci] += c
                    cell[_WIT] &= int(witnessed)

    @classmethod
    def merged(cls, accountants) -> "ErrorAccountant":
        """Cell-exact union of several accountants over the same workload.

        The sharded service runs one accountant per shard plus one at the
        router (admission-time shedding); the global certificate is their
        union: per-cell counts sum, the witness bit ANDs, taints union.
        ``window_bound`` / ``report`` on the result are then exactly what a
        single accountant observing every shed event would have produced —
        one global subset guarantee and one ``3^s`` bound per window."""
        accountants = list(accountants)
        if not accountants:
            raise ValueError("need at least one accountant")
        first = accountants[0]
        out = cls(first.workload, pane=first.pane)
        for acc in accountants:
            if acc.pane != out.pane:
                raise ValueError("accountants disagree on pane bucketing")
            out.total_shed += acc.total_shed
            out.late_events += acc.late_events
            out._tainted |= acc._tainted
            for key, cell in acc._shed.items():
                dst = out._shed.setdefault(key, [0, 0, 0, 1])
                for ci in (_KLE, _CRIT, _NEG):
                    dst[ci] += cell[ci]
                dst[_WIT] &= cell[_WIT]
        return out

    # -- queries --

    def window_bound(self, query: str, group: int, w0: int) -> WindowBound:
        """Bound for the window of ``query`` (atomic name) starting at w0."""
        aqi = self._by_name[query]
        within = self.workload.atomic[aqi].within
        kle = crit = neg = 0
        witnessed = True
        for t0 in range(w0 - w0 % self.pane, w0 + within, self.pane):
            cell = self._shed.get((aqi, int(group), t0))
            if cell:
                kle += cell[_KLE]
                crit += cell[_CRIT]
                neg += cell[_NEG]
                witnessed &= bool(cell[_WIT])
        tight = (crit == 0 and neg == 0 and witnessed
                 and self._boundable[aqi] and aqi not in self._tainted)
        return WindowBound(kle, crit, neg, tight)

    def report(self) -> dict[str, QueryErrorReport]:
        out: dict[str, QueryErrorReport] = {}
        for name, aqi in self._by_name.items():
            kle = crit = neg = cells = 0
            for (qa, _gk, _t0), cell in self._shed.items():
                if qa != aqi or not any(cell[:_WIT]):
                    continue
                cells += 1
                kle += cell[_KLE]
                crit += cell[_CRIT]
                neg += cell[_NEG]
            out[name] = QueryErrorReport(
                query=name, shed_kleene=kle, shed_critical=crit,
                shed_negative=neg, cells_affected=cells,
                subset_guarantee=neg == 0 and aqi not in self._tainted)
        return out
