"""Sharing-decision audit log.

Records every optimizer share / no-share decision the engine makes while
planning a pane: the candidate queries, the decided group partition
(*verbatim* the groups the pane's steps are built from), the benefit
delta the cost model computed, the coverage pattern the decision was
based on, and whether the decision *flipped* relative to the previous
pane at the same (component, Kleene-type) site — the paper's Fig. 12
adaptivity story, inspectable on any run.

Alongside the per-decision entries, :meth:`SharingAuditLog.note_pane`
captures each pane's decided groups, burst by burst, so a run's audit log
can be compared pane for pane (see ``tests/test_obs.py``).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SharingDecision:
    """One optimizer share/no-share decision at a Kleene-type site."""

    seq: int                 # global decision ordinal
    pane: tuple              # (group, pane_t0) of the pane being planned
    comp: int                # component ordinal within the runtime
    el: int                  # local Kleene event-type index
    candidates: tuple        # query positions eligible to share
    decided: tuple           # decided groups, as the steps are built
    shared: bool             # any group of >= 2 queries?
    flipped: bool            # differs from previous decision at this site?
    benefit: float | None = None   # cost-model benefit delta (None: static)
    patterns: tuple | None = None  # coverage pattern histogram (value, count)
    b: int = 0               # burst size the decision was made on
    n: int = 0               # running event count at decision time

    def to_dict(self) -> dict:
        return {"seq": self.seq, "pane": list(self.pane), "comp": self.comp,
                "el": self.el, "candidates": list(self.candidates),
                "decided": [list(g) for g in self.decided],
                "shared": self.shared, "flipped": self.flipped,
                "benefit": self.benefit,
                "patterns": ([list(p) for p in self.patterns]
                             if self.patterns is not None else None),
                "b": self.b, "n": self.n}


@dataclass
class SharingAuditLog:
    """Bounded ring of :class:`SharingDecision` entries plus per-pane keys."""

    capacity: int = 1 << 16
    recorded: int = 0
    dropped: int = 0
    flips: int = 0
    shared_decisions: int = 0
    split_decisions: int = 0
    _entries: deque = field(init=False, repr=False)
    _last: dict = field(default_factory=dict, repr=False)
    _pane_groups: OrderedDict = field(default_factory=OrderedDict,
                                      repr=False)

    def __post_init__(self):
        self._entries = deque(maxlen=max(1, int(self.capacity)))

    def record(self, *, pane, comp, el, candidates, decided,
               benefit=None, patterns=None, b=0, n=0) -> None:
        decided = tuple(tuple(g) for g in decided)
        site = (comp, el)
        prev = self._last.get(site)
        flipped = prev is not None and prev != decided
        self._last[site] = decided
        shared = any(len(g) >= 2 for g in decided)
        self.recorded += 1
        self.flips += flipped
        if shared:
            self.shared_decisions += 1
        else:
            self.split_decisions += 1
        if len(self._entries) == self._entries.maxlen:
            self.dropped += 1
        self._entries.append(SharingDecision(
            seq=self.recorded, pane=tuple(pane) if pane else (-1, -1),
            comp=comp, el=el, candidates=tuple(candidates), decided=decided,
            shared=shared, flipped=flipped, benefit=benefit,
            patterns=(tuple(tuple(p) for p in patterns)
                      if patterns is not None else None),
            b=int(b), n=int(n)))

    def note_pane(self, pane, groups: tuple, comp: int = 0) -> None:
        """Record a pane's decided groups (one entry a burst, None for a
        burst no query reads), keyed ``(comp, group, pane_t0)``
        (components plan independently)."""
        if pane is None:
            return
        key = (comp,) + tuple(pane)
        if key in self._pane_groups:
            self._pane_groups.move_to_end(key)
        elif len(self._pane_groups) >= self._entries.maxlen:
            self._pane_groups.popitem(last=False)
        self._pane_groups[key] = groups

    # --------------------------------------------------------------- access

    def entries(self) -> list:
        return list(self._entries)

    def by_pane(self) -> dict:
        out: dict = {}
        for e in self._entries:
            out.setdefault(e.pane, []).append(e)
        return out

    def pane_key_groups(self) -> dict:
        """(comp, group, pane_t0) -> the pane's decided-groups tuple."""
        return dict(self._pane_groups)

    def summary(self) -> dict:
        return {"decisions": self.recorded, "dropped": self.dropped,
                "shared": self.shared_decisions,
                "split": self.split_decisions, "flips": self.flips,
                "sites": len(self._last)}

    def export_jsonl(self, path) -> int:
        import json

        with open(path, "w") as f:
            for e in self._entries:
                f.write(json.dumps(e.to_dict(), sort_keys=True))
                f.write("\n")
        return len(self._entries)
