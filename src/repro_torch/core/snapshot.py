"""Snapshot-basis bookkeeping for shared trend aggregation (paper Sec. 3.3).

Intermediate trend aggregates inside a pane are maintained as *linear
expressions* over a basis of snapshots.  Each basis entry carries, per query,
a *value functional*: a row vector over the pane-entry state channels that
yields the snapshot's value for that query when applied to the query's state
vector ``u`` (see DESIGN.md §2 and engine.py).

Channels of the per-(query, window-instance) state vector ``u``:

    0: const      always 1
    1: gate       1 until a leading-NOT negative match (then 0)
    A(u, E)       running sum, per linear unit u and positive type E, of the
                  unit's intermediate aggregates over matched type-E events
                  (the paper's ``sum(G_E', q)`` inputs to Eq. 4)
    Rp(u)         pending final aggregates (Eq. 2), reset by trailing NOT

Basis entries are the paper's snapshots: graphlet-level ``x`` entries
(Def. 8), event-level ``z`` entries (Def. 9), and a gate entry used for start
contributions.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ChannelLayout", "PaneBasis"]


class ChannelLayout:
    """Index layout of the state vector for one sharable component."""

    CONST = 0
    GATE = 1

    def __init__(self, units: list[tuple], type_ids: list[int]):
        self.units = list(units)          # linear units: ("count",) first, then sums
        self.type_ids = list(type_ids)    # component positive type ids (schema ids)
        self.n_units = len(self.units)
        self.t = len(self.type_ids)
        self._type_pos = {e: i for i, e in enumerate(self.type_ids)}
        self._unit_pos = {u: i for i, u in enumerate(self.units)}
        self.size = 2 + self.n_units * self.t + self.n_units

    def a_idx(self, unit: tuple, type_id: int) -> int:
        return 2 + self._unit_pos[unit] * self.t + self._type_pos[type_id]

    def rp_idx(self, unit: tuple) -> int:
        return 2 + self.n_units * self.t + self._unit_pos[unit]

    def unit_index(self, unit: tuple) -> int:
        return self._unit_pos[unit]

    def fresh_state(self) -> np.ndarray:
        u = np.zeros(self.size)
        u[self.CONST] = 1.0
        u[self.GATE] = 1.0
        return u


class PaneBasis:
    """Per-pane snapshot basis with per-query value functionals.

    ``W[q]`` is a [max_basis, C] matrix; row ``j`` is snapshot ``j``'s value
    functional for query ``q``.  ``coef_row @ W[q] @ u[q]`` resolves a
    coefficient row to the query's scalar value.
    """

    def __init__(self, n_queries: int, n_channels: int, max_basis: int = 192):
        self.k = n_queries
        self.C = n_channels
        self.max_basis = max_basis
        self.W = np.zeros((n_queries, max_basis, n_channels))
        self.B = 0
        self.n_graphlet_snapshots = 0
        self.n_event_snapshots = 0

    def room_for(self, n: int) -> bool:
        return self.B + n <= self.max_basis

    def alloc(self, kind: str) -> int:
        if self.B >= self.max_basis:
            raise RuntimeError("snapshot basis overflow; optimizer should have split")
        idx = self.B
        self.B += 1
        if kind == "graphlet":
            self.n_graphlet_snapshots += 1
        elif kind == "event":
            self.n_event_snapshots += 1
        return idx

    def set_value(self, q: int, idx: int, functional: np.ndarray) -> None:
        self.W[q, idx, :] = functional

    def w(self, q: int) -> np.ndarray:
        """Active [B, C] functional matrix for query q."""
        return self.W[q, : self.B, :]
