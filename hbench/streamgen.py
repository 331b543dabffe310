"""The benchmark's own stream generator: per-district Markov-bursty streams.

A frozen, vectorised copy of the port's ``streams.generator.tenant_stream``
with one group a tenant (``overload_stream`` inside it): every district
draws Poisson event counts per tick at its share of the stream's density,
a Markov-switching type sequence of its own (with probability
``burstiness`` the next event repeats the district's current type, else it
redraws from the type weights), and attributes uniform in the
configuration's range.  Districts are merged by time; events of one tick
keep district order, and a district's events keep the order they were
drawn in.  The arrays come out of NumPy alone, from ``seed`` and the
segment's index, so one seed always gives one stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TICKS_PER_MINUTE = 60


@dataclass
class Stream:
    """Struct-of-arrays events, sorted by time (ties by district, then
    draw order).  ``attrs`` has one column per schema attribute."""

    type_id: np.ndarray   # int32[n]
    time: np.ndarray      # int64[n], ticks
    attrs: np.ndarray     # float64[n, a]
    group: np.ndarray     # int64[n], district

    def __len__(self) -> int:
        return len(self.type_id)

    def ticks(self, t0: int, t1: int) -> slice:
        """Positions of the events with ``t0 <= time < t1``."""
        lo, hi = np.searchsorted(self.time, [t0, t1], side="left")
        return slice(int(lo), int(hi))


def markov_types(rng: np.random.Generator, starts: np.ndarray, n: int,
                 weights, burstiness: float) -> np.ndarray:
    """Markov-switching types for ``n`` events cut into chains at
    ``starts`` (each chain's first event always draws).  An event redraws
    from ``weights`` with probability ``1 - burstiness``, else repeats its
    chain's previous type."""
    w = np.asarray(weights, dtype=float)
    draws = rng.choice(len(w), size=n, p=w / w.sum()).astype(np.int32)
    redraw = rng.random(n) >= burstiness
    redraw[starts] = True
    last = np.where(redraw, np.arange(n), 0)
    np.maximum.accumulate(last, out=last)
    return draws[last]


def district_stream(*, seed: int, segment: int, minutes: float,
                    events_per_minute: float, districts: int,
                    n_types: int, type_weights, burstiness: float,
                    n_attrs: int, attr_range=(0.0, 10.0)) -> Stream:
    """``minutes`` of stream over ``[0, minutes * 60)`` ticks, drawn from
    ``(seed, segment)``: each of ``districts`` districts at
    ``events_per_minute / districts`` events a minute."""
    rng = np.random.default_rng([int(seed), int(segment)])
    ticks = int(round(minutes * TICKS_PER_MINUTE))
    lam = events_per_minute / TICKS_PER_MINUTE / districts
    counts = rng.poisson(lam, size=(districts, ticks))       # [D, T]
    per_district = counts.sum(axis=1)
    n = int(per_district.sum())
    # district-major order: district d's events, tick by tick
    group = np.repeat(np.arange(districts, dtype=np.int64), per_district)
    time = np.repeat(np.tile(np.arange(ticks, dtype=np.int64), districts),
                     counts.ravel())
    starts = np.concatenate([[0], np.cumsum(per_district)[:-1]])
    starts = starts[per_district > 0]
    types = markov_types(rng, starts, n, type_weights, burstiness)
    lo, hi = attr_range
    attrs = rng.uniform(lo, hi, size=(n, max(1, n_attrs)))
    # merge by time; a stable sort keeps district order within a tick
    order = np.argsort(time, kind="stable")
    return Stream(types[order], time[order], attrs[order], group[order])
