"""Bursty stream generators (paper Sec. 6.1).

The paper evaluates on four datasets: NYC taxi/Uber, smart home, stock, and a
synthetic ridesharing stream whose event rate and type distribution are
controlled by the generator.  We reproduce their *shapes*: per-minute event
rates, a controllable burstiness factor (events of one type arriving in
clumps — the regime where graphlet sharing pays), group-key cardinality, and
per-type attribute distributions.  (The multi-tenant and disorder
generators of the JAX package are not ported yet.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.events import EventBatch, StreamSchema

__all__ = [
    "StreamConfig", "bursty_stream", "ridesharing_stream", "stock_stream",
    "smarthome_stream", "nyc_taxi_stream",
    "OverloadStreamConfig", "overload_stream", "NAMED_STREAMS",
    "RIDESHARING_SCHEMA", "STOCK_SCHEMA", "SMARTHOME_SCHEMA", "TAXI_SCHEMA",
]

RIDESHARING_SCHEMA = StreamSchema(
    types=("Request", "Accept", "Travel", "Pickup", "Dropoff", "Cancel"),
    attrs=("duration", "speed", "price", "rtype"),
)
STOCK_SCHEMA = StreamSchema(
    types=("Buy", "Sell", "Quote", "Trade"),
    attrs=("price", "volume"),
)
SMARTHOME_SCHEMA = StreamSchema(
    types=("Load", "Work", "Measure", "Idle"),
    attrs=("value", "voltage"),
)
TAXI_SCHEMA = StreamSchema(
    types=("Request", "Travel", "Pickup", "Dropoff"),
    attrs=("duration", "speed", "passengers", "price"),
)


@dataclass
class StreamConfig:
    schema: StreamSchema
    events_per_minute: int = 200
    minutes: int = 10
    n_groups: int = 4
    burstiness: float = 0.8        # 0: iid types; 1: long same-type runs
    type_weights: tuple[float, ...] | None = None
    attr_low: float = 0.0
    attr_high: float = 10.0
    seed: int = 0
    ticks_per_minute: int = 60


def _markov_types(rng, n: int, n_types: int, weights, burstiness: float
                  ) -> np.ndarray:
    """Markov-switching type sequence: with prob ``burstiness`` the next
    event repeats the current type (a burst); otherwise it redraws from the
    type distribution."""
    w = np.asarray(np.ones(n_types) if weights is None else weights,
                   dtype=float)
    w = w / w.sum()
    types = np.empty(n, dtype=np.int32)
    types[0] = rng.choice(n_types, p=w)
    redraw = rng.random(n) >= burstiness
    draws = rng.choice(n_types, size=n, p=w)
    for i in range(1, n):
        types[i] = draws[i] if redraw[i] else types[i - 1]
    return types


def bursty_stream(cfg: StreamConfig) -> EventBatch:
    """Bursty type sequence over strictly increasing integer tick times."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.events_per_minute * cfg.minutes
    types = _markov_types(rng, n, cfg.schema.n_types, cfg.type_weights,
                          cfg.burstiness)
    total_ticks = cfg.minutes * cfg.ticks_per_minute
    if n <= total_ticks:
        times = np.sort(rng.choice(total_ticks, size=n, replace=False))
    else:
        times = np.sort(rng.integers(0, total_ticks, size=n))
    attrs = rng.uniform(cfg.attr_low, cfg.attr_high,
                        size=(n, max(1, len(cfg.schema.attrs))))
    groups = rng.integers(0, cfg.n_groups, size=n)
    return EventBatch(cfg.schema, types, np.asarray(times, dtype=np.int64),
                      attrs, groups)


@dataclass
class OverloadStreamConfig:
    """Overload scenario: a rate ramp with flash crowds on top.

    The per-tick arrival rate starts at ``base_events_per_minute``, ramps
    linearly to ``ramp_to`` times that by the end of the stream, and each
    ``(start_tick, duration_ticks, multiplier)`` entry in ``flash_crowds``
    multiplies the rate over its span.  Per-tick counts are Poisson, so
    instantaneous load is itself bursty; event *types* keep the Markov
    burst structure of :func:`bursty_stream` (the regime graphlet sharing —
    and pattern-aware shedding — care about).
    """

    schema: StreamSchema
    base_events_per_minute: int = 300
    minutes: int = 10
    ramp_to: float = 1.0
    flash_crowds: tuple[tuple[int, int, float], ...] = ()
    n_groups: int = 4
    burstiness: float = 0.85
    type_weights: tuple[float, ...] | None = None
    attr_low: float = 0.0
    attr_high: float = 10.0
    seed: int = 0
    ticks_per_minute: int = 60


def overload_stream(cfg: OverloadStreamConfig) -> EventBatch:
    rng = np.random.default_rng(cfg.seed)
    total_ticks = cfg.minutes * cfg.ticks_per_minute
    base_per_tick = cfg.base_events_per_minute / cfg.ticks_per_minute
    mult = np.linspace(1.0, max(cfg.ramp_to, 0.0), total_ticks)
    for start, duration, m in cfg.flash_crowds:
        mult[start:start + duration] *= m
    counts = rng.poisson(base_per_tick * mult)
    n = int(counts.sum())
    if n == 0:
        return EventBatch(cfg.schema, np.array([], np.int32),
                          np.array([], np.int64), None)
    times = np.repeat(np.arange(total_ticks, dtype=np.int64), counts)
    types = _markov_types(rng, n, cfg.schema.n_types, cfg.type_weights,
                          cfg.burstiness)
    attrs = rng.uniform(cfg.attr_low, cfg.attr_high,
                        size=(n, max(1, len(cfg.schema.attrs))))
    groups = rng.integers(0, cfg.n_groups, size=n)
    return EventBatch(cfg.schema, types, times, attrs, groups)


def ridesharing_stream(events_per_minute: int = 200, minutes: int = 10,
                       n_groups: int = 4, burstiness: float = 0.85,
                       seed: int = 0) -> EventBatch:
    """Synthetic ridesharing stream (paper Sec. 6.1): Travel events dominate,
    arriving in bursts per district; default 10K events/min in the paper."""
    return bursty_stream(StreamConfig(
        schema=RIDESHARING_SCHEMA, events_per_minute=events_per_minute,
        minutes=minutes, n_groups=n_groups, burstiness=burstiness,
        type_weights=(1, 1, 6, 1, 1, 1), seed=seed))


def stock_stream(events_per_minute: int = 450, minutes: int = 8,
                 n_groups: int = 8, burstiness: float = 0.7,
                 seed: int = 1) -> EventBatch:
    return bursty_stream(StreamConfig(
        schema=STOCK_SCHEMA, events_per_minute=events_per_minute,
        minutes=minutes, n_groups=n_groups, burstiness=burstiness,
        type_weights=(2, 2, 4, 3), seed=seed))


def smarthome_stream(events_per_minute: int = 2000, minutes: int = 2,
                     n_groups: int = 16, burstiness: float = 0.9,
                     seed: int = 2) -> EventBatch:
    return bursty_stream(StreamConfig(
        schema=SMARTHOME_SCHEMA, events_per_minute=events_per_minute,
        minutes=minutes, n_groups=n_groups, burstiness=burstiness,
        type_weights=(1, 2, 6, 1), seed=seed))


def nyc_taxi_stream(events_per_minute: int = 200, minutes: int = 10,
                    n_groups: int = 6, burstiness: float = 0.8,
                    seed: int = 3) -> EventBatch:
    return bursty_stream(StreamConfig(
        schema=TAXI_SCHEMA, events_per_minute=events_per_minute,
        minutes=minutes, n_groups=n_groups, burstiness=burstiness,
        type_weights=(1, 5, 1, 1), seed=seed))


NAMED_STREAMS = {
    "ridesharing": ridesharing_stream,
    "stock": stock_stream,
    "smarthome": smarthome_stream,
    "taxi": nyc_taxi_stream,
}
