"""Pane-plan memoization: bursty streams repeat pane *shapes*.

Under bursty arrival the expensive part of planning a pane — burst
segmentation, divergence layout, in-burst adjacency construction, the
event-level snapshot (z) column layout, and the count-round injection rows —
depends only on the pane's *shape*: the type run-length structure, the
per-burst per-query predicate/edge-mask bits, the negation hits, and the
sharing decision the optimizer took.  None of it reads attribute values
beyond the predicate outcomes.  Bursty workloads therefore re-plan the same
shape over and over; this module caches the structural plan so a repeated
shape skips phase-1 group construction entirely and only swaps in the fresh
attribute/value data.

Key design (exactness over speed):

* The signature stores the *full* discriminating bytes — packed predicate
  match bits, packed edge-mask bits, negation-hit query ids, and the
  optimizer's decided groups — never a lossy hash, so a cache hit is
  *provably* the identical plan and the engine's bitwise differential
  guarantee survives memoization.
* The sharing decision is part of the key, not the cached value: the
  optimizer runs fresh on every pane (its benefit model depends on the
  running event count), and a flipped share/no-share choice simply misses
  into a new entry.  Plan reuse can therefore never freeze the sharing
  decision.
* Entries are LRU-evicted beyond ``max_entries``; cached group plans are
  stripped of per-pane data (attributes, match vectors, job handles) so an
  entry holds only the structural arrays.

The cache is shared per (component, runtime): every :class:`PaneProcessor`
the runtime spawns — service epochs, overload group loops, event-time
group processors — consults the same cache, so a shape learned on one group
partition is reused on all of them.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

__all__ = ["PanePlan", "PanePlanCache", "PLAN_STAT_FIELDS"]

# RunStats counters whose increments happen inside the cached (phase-1 group
# construction) region; replayed on every hit so the stats stream — and
# everything keyed off it, like the optimizer's running event count — evolves
# identically whether or not the cache is enabled.
PLAN_STAT_FIELDS = ("graphlets", "shared_bursts", "shared_graphlets",
                    "split_bursts", "snapshots_created",
                    "snapshots_propagated", "shared_rows", "snapshot_rows")


@dataclass
class PanePlan:
    """One cached structural plan: the step templates plus the stat delta
    the skipped planning code would have produced.

    ``zero_copy`` marks a plan none of whose steps carry per-pane data (no
    divergent rows, no sum-unit injection values, no negation steps): the
    cached step list is then reused *as is* on a hit — job handles live on
    the pending pane, so the shared plan objects are never written.

    ``fold_schedule`` memoizes the fold executor's level/bucket schedule
    (``core/fold_exec.py``) for this plan's step list — structural like the
    steps themselves, filled in lazily on the first fold, so warm panes skip
    fold planning entirely."""

    steps: list
    stat_delta: dict = field(default_factory=dict)
    zero_copy: bool = False
    fold_schedule: object = None

    def apply_stats(self, stats) -> None:
        for f, v in self.stat_delta.items():
            setattr(stats, f, getattr(stats, f) + v)


class PanePlanCache:
    """Bounded LRU of :class:`PanePlan` keyed by exact pane signatures."""

    def __init__(self, max_entries: int = 128):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[tuple, PanePlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple) -> PanePlan | None:
        plan = self._entries.get(key)
        if plan is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return plan

    def put(self, key: tuple, plan: PanePlan) -> None:
        self._entries[key] = plan
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._entries.clear()

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def snapshot_stats(self, stats) -> dict:
        return {f: getattr(stats, f) for f in PLAN_STAT_FIELDS}

    @staticmethod
    def stat_delta(before: dict, stats) -> dict:
        # zero deltas are dropped: apply_stats replays the dict on every
        # cache hit, and most fields don't move on a typical pane
        return {f: d for f, v in before.items()
                if (d := getattr(stats, f) - v) != 0}
