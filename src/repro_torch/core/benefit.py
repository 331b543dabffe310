"""Dynamic sharing benefit model (paper Sec. 4.1, Defs. 11 & 12).

The technical report prints two variants of the model; its worked examples
(Eq. 8-10, Fig. 6) follow the Def. 11 form with the type count ``t``, so that
is the default (``benefit_v1``).  ``benefit_v2`` adds the ``log2(g)`` graphlet
index-probe terms of Def. 12.

All quantities are per burst of ``b`` events of type E (Def. 10):
    b    events in the burst
    n    events against which new intermediate aggregates propagate
    s_c  snapshots created from this burst
    s_p  snapshots propagated through the graphlet
    k    queries in Q_E
    g    events in the (shared) graphlet
    t    event types per query (v1) / p predecessor types per type (v2)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["BurstCost", "shared_cost_v1", "nonshared_cost_v1", "benefit_v1",
           "shared_cost_v2", "nonshared_cost_v2", "benefit_v2"]


@dataclass(frozen=True)
class BurstCost:
    shared: float
    nonshared: float

    @property
    def benefit(self) -> float:
        return self.nonshared - self.shared


# ---- Def. 11 (Eq. 6): the variant behind the paper's worked examples ----

def shared_cost_v1(b: int, n: int, s_p: int, s_c: int, k: int, g: int, t: int) -> float:
    return b * n * s_p + s_c * k * g * t


def nonshared_cost_v1(b: int, n: int, k: int) -> float:
    return k * b * n


def benefit_v1(b: int, n: int, s_p: int, s_c: int, k: int, g: int, t: int) -> BurstCost:
    return BurstCost(shared_cost_v1(b, n, s_p, s_c, k, g, t),
                     nonshared_cost_v1(b, n, k))


# ---- Def. 12 (Eq. 7): adds log2(g) graphlet index probes ----

def shared_cost_v2(b: int, n: int, s_p: int, s_c: int, k: int, g: int, p: int) -> float:
    lg = math.log2(g) if g > 1 else 0.0
    return s_c * k * g * p + b * (lg + n * s_p)


def nonshared_cost_v2(b: int, n: int, k: int, g: int) -> float:
    lg = math.log2(g) if g > 1 else 0.0
    return k * b * (lg + n)


def benefit_v2(b: int, n: int, s_p: int, s_c: int, k: int, g: int, p: int) -> BurstCost:
    return BurstCost(shared_cost_v2(b, n, s_p, s_c, k, g, p),
                     nonshared_cost_v2(b, n, k, g))
