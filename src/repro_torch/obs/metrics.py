"""Metrics registry: counters, gauges, histograms with fixed bucket layouts.

Every series lives in a :class:`MetricsRegistry` keyed by name.  Histogram
bucket edges are *fixed at creation* and must match on every subsequent
lookup and on :meth:`MetricsRegistry.merge` — merging two histograms with
different edge layouts raises instead of silently resampling, so bucket
edges are stable across merges by construction.

The module ships the canonical edge layouts the engine uses:

* ``LATENCY_MS_BUCKETS`` — phase / pane latency in milliseconds.
* ``SERVE_LATENCY_MS_BUCKETS`` — serving delivery / blocked-time latency
  (finer sub-100ms edges so paced-session quantiles do not snap to the
  coarse engine-phase edges).
* ``OCCUPANCY_BUCKETS``  — bucket occupancy and launches-per-flush.
* ``LAG_BUCKETS``        — watermark lag in stream ticks.
* ``DEPTH_BUCKETS``      — revision-storm depth (panes per storm).
"""

from __future__ import annotations

from bisect import bisect_right
from math import inf, isfinite

LATENCY_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0)

# Serving delivery latency needs finer resolution than the engine-phase
# layout: a paced session study operates in the 10–500 ms regime, and with
# the coarse edges above every quantile snaps to 25.0/50.0/500.0 ms exactly
# (the committed BENCH_serving.json artifact showed p50 == 25.0 because the
# histogram had no edge between 25 and 50).  These edges keep sub-100 ms
# resolution at ~±15% per bucket.  Every serving-latency series must use
# this layout — histogram merges raise on a layout mismatch, so mixing the
# coarse layout in is caught loudly instead of silently resampled.
SERVE_LATENCY_MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.5, 8.0, 10.0,
    12.5, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0, 50.0, 60.0, 70.0, 85.0,
    100.0, 125.0, 150.0, 200.0, 250.0, 300.0, 400.0, 500.0, 700.0,
    1000.0, 1500.0, 2000.0)


def serve_latency_series(kind: str, key) -> str:
    """Canonical name of a keyed serving-latency histogram series.

    ``kind`` is ``"session"`` or ``"tenant"``; the serving front-end keeps
    one ``SERVE_LATENCY_MS_BUCKETS`` histogram per key under this name
    (delivery latency: pane sealed by the scheduler watermark -> record in
    inbox).
    """
    if kind not in ("session", "tenant"):
        raise ValueError(f"unknown serving latency kind {kind!r}")
    return f"serve.latency_ms.{kind}.{key}"


def serve_blocked_series(sid) -> str:
    """Canonical name of the per-session credit-blocked-time histogram.

    The transport's credit gate observes, per session, how long the
    session sat at zero credits before the next grant (the producer-side
    backpressure stall); layout is ``SERVE_LATENCY_MS_BUCKETS``."""
    return f"serve.blocked_ms.session.{sid}"


OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                     512.0, 1024.0)
LAG_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
DEPTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class Counter:
    """Monotonic counter."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> None:
        self.value += other.value

    def collect(self):
        return self.value


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def merge(self, other: "Gauge") -> None:
        self.value = other.value

    def collect(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram: ``len(edges) + 1`` counts, last is overflow.

    Non-finite observations (NaN, ±inf) never enter the buckets or ``sum``
    — they land in the ``invalid`` counter, so one poisoned sample cannot
    turn ``mean`` (and every latency report downstream) into NaN forever.
    ``max`` tracks the largest *finite* observation, which lets
    :meth:`quantile` report a real value even when the quantile lands in
    the open overflow bucket instead of silently capping at the last
    finite edge (the classic under-reported-SLO-breach bug).
    """

    kind = "histogram"
    __slots__ = ("name", "edges", "counts", "count", "sum", "invalid", "max")

    def __init__(self, name: str, edges=LATENCY_MS_BUCKETS):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name!r}: edges must be a "
                             f"non-empty strictly increasing sequence")
        self.name = name
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.invalid = 0          # NaN / ±inf observations, kept out of sum
        self.max = None           # largest finite observation, or None

    def observe(self, v) -> None:
        if not isfinite(v):
            self.invalid += 1
            return
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if self.max is None or v > self.max:
            self.max = v

    def observe_n(self, v, n: int) -> None:
        """Record ``n`` observations of the same value in one call."""
        if not isfinite(v):
            self.invalid += n
            return
        self.counts[bisect_right(self.edges, v)] += n
        self.count += n
        self.sum += v * n
        if self.max is None or v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        if other.edges != self.edges:
            raise ValueError(
                f"histogram {self.name!r}: bucket layouts differ "
                f"({self.edges} vs {other.edges}); edges are fixed at "
                f"creation and must be stable across merges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.invalid += other.invalid
        if other.max is not None and (self.max is None
                                      or other.max > self.max):
            self.max = other.max

    def quantile(self, q: float) -> float:
        """Upper bucket edge containing quantile ``q`` (0..1).

        ``q == 0`` reports the first *populated* bucket's edge (not a
        populated-looking edge from empty leading buckets); a quantile in
        the overflow bucket reports the tracked finite ``max`` rather
        than capping at the last edge.
        """
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target and (c > 0 or target > 0):
                if i >= len(self.edges):
                    return self.max if self.max is not None else inf
                return self.edges[i]
        return self.max if self.max is not None else self.edges[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def collect(self):
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "invalid": self.invalid, "max": self.max,
                "edges": list(self.edges), "counts": list(self.counts)}


class MetricsRegistry:
    """Name-keyed registry of counters, gauges and histograms."""

    def __init__(self):
        self._m: dict = {}

    def _get(self, name, cls, *args):
        m = self._m.get(name)
        if m is None:
            m = self._m[name] = cls(name, *args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, edges=LATENCY_MS_BUCKETS) -> Histogram:
        h = self._get(name, Histogram, edges)
        if h.edges != tuple(float(e) for e in edges):
            raise ValueError(f"histogram {name!r} already registered with "
                             f"edges {h.edges}")
        return h

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry (types and edges must agree)."""
        for name, m in other._m.items():
            if isinstance(m, Histogram):
                self.histogram(name, m.edges).merge(m)
            else:
                self._get(name, type(m)).merge(m)

    def names(self):
        return sorted(self._m)

    def __len__(self) -> int:
        return len(self._m)

    def __contains__(self, name) -> bool:
        return name in self._m

    def get(self, name):
        return self._m.get(name)

    def collect(self) -> dict:
        return {name: self._m[name].collect() for name in sorted(self._m)}
