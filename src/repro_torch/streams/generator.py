"""Bursty stream generators (paper Sec. 6.1).

The paper evaluates on four datasets: NYC taxi/Uber, smart home, stock, and a
synthetic ridesharing stream whose event rate and type distribution are
controlled by the generator.  We reproduce their *shapes*: per-minute event
rates, a controllable burstiness factor (events of one type arriving in
clumps — the regime where graphlet sharing pays), group-key cardinality, and
per-type attribute distributions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.events import EventBatch, StreamSchema

__all__ = [
    "StreamConfig", "bursty_stream", "ridesharing_stream", "stock_stream",
    "smarthome_stream", "nyc_taxi_stream",
    "OverloadStreamConfig", "overload_stream",
    "TenantStreamConfig", "tenant_stream",
    "DisorderConfig", "DisorderedStream", "disorder_arrival_order",
    "apply_disorder", "disordered_stream", "NAMED_STREAMS",
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


# --------------------------------------------------------------------------
# multi-tenant composition (sharded-service workloads)
# --------------------------------------------------------------------------


@dataclass
class TenantStreamConfig:
    """Multi-tenant composition of per-tenant overload streams.

    Tenant ``t`` owns the contiguous group range
    ``[t * groups_per_tenant, (t+1) * groups_per_tenant)`` — the same
    tenant/group convention the sharded service's placement table uses —
    and emits its own :func:`overload_stream` (Poisson per-tick counts,
    linear ramp, Markov-bursty types) with an independent rng.

    base_events_per_minute   per-tenant base rate before skew
    rate_skew                Zipf-style tenant rate skew exponent: tenant t
                             gets weight ``(t+1)**-rate_skew``, normalized
                             so the *total* offered load is preserved; 0 =
                             uniform tenants
    flash_tenant / flash     a flash crowd ``(start_tick, duration_ticks,
                             multiplier)`` applied to exactly one tenant's
                             rate — the hot-tenant scenario the router's
                             rebalance and SLO-isolation paths are tested
                             against; the other tenants' streams are
                             bit-for-bit unaffected (independent rngs)
    ramp_to                  per-tenant linear rate ramp (shared shape)
    """

    schema: StreamSchema
    n_tenants: int = 4
    groups_per_tenant: int = 2
    base_events_per_minute: int = 300
    minutes: int = 10
    rate_skew: float = 0.0
    flash_tenant: int | None = None
    flash: tuple[int, int, float] = (0, 60, 4.0)
    ramp_to: float = 1.0
    burstiness: float = 0.85
    type_weights: tuple[float, ...] | None = None
    seed: int = 0
    ticks_per_minute: int = 60

    def __post_init__(self) -> None:
        if self.n_tenants < 1:
            raise ValueError("n_tenants must be >= 1")
        if self.groups_per_tenant < 1:
            raise ValueError("groups_per_tenant must be >= 1")
        if self.rate_skew < 0:
            raise ValueError("rate_skew must be >= 0")
        if self.flash_tenant is not None \
                and not (0 <= self.flash_tenant < self.n_tenants):
            raise ValueError("flash_tenant out of range")


def tenant_stream(cfg: TenantStreamConfig) -> EventBatch:
    """Compose per-tenant overload streams into one time-sorted batch.

    Group keys are tenant-offset; ties on time keep tenant order (stable
    merge), so the composed stream is deterministic given ``seed``.
    """
    w = np.array([(t + 1.0) ** -cfg.rate_skew
                  for t in range(cfg.n_tenants)])
    w *= cfg.n_tenants / w.sum()
    parts: list[EventBatch] = []
    for t in range(cfg.n_tenants):
        sub = overload_stream(OverloadStreamConfig(
            schema=cfg.schema,
            base_events_per_minute=max(
                1, int(round(cfg.base_events_per_minute * w[t]))),
            minutes=cfg.minutes,
            ramp_to=cfg.ramp_to,
            flash_crowds=(cfg.flash,) if t == cfg.flash_tenant else (),
            n_groups=cfg.groups_per_tenant,
            burstiness=cfg.burstiness,
            type_weights=cfg.type_weights,
            seed=cfg.seed + 1009 * t,
            ticks_per_minute=cfg.ticks_per_minute))
        if len(sub):
            parts.append(EventBatch(
                sub.schema, sub.type_id, sub.time, sub.attrs,
                sub.group + t * cfg.groups_per_tenant))
    if not parts:
        return EventBatch(cfg.schema, np.array([], np.int32),
                          np.array([], np.int64), None)
    return EventBatch.merge(parts)


# --------------------------------------------------------------------------
# disorder models (event-time subsystem workloads)
# --------------------------------------------------------------------------

NAMED_STREAMS = {
    "ridesharing": ridesharing_stream,
    "stock": stock_stream,
    "smarthome": smarthome_stream,
    "taxi": nyc_taxi_stream,
}


@dataclass
class DisorderConfig:
    """How arrival order diverges from event-time order.

    model             "bounded_skew"     — an affected event's *arrival* is
                                           delayed by U[1, max_skew] ticks:
                                           every event is late by at most
                                           ``max_skew`` (the regime a
                                           bounded-skew watermark covers
                                           exactly);
                      "stragglers"       — whole bursts (maximal same-type
                                           runs, the unit the engine shares
                                           on) go late *together* by
                                           U[max_skew, straggler_delay]:
                                           retried producers re-sending a
                                           clump;
                      "adversarial_tail" — affected events draw Pareto
                                           delays: most modest, a heavy tail
                                           beyond any finite horizon, so the
                                           expiry/shedding path is exercised
    fraction          fraction of events affected (bursts are chosen until
                      the event fraction is covered for "stragglers")
    max_skew          delay bound for bounded_skew; delay floor for
                      stragglers
    straggler_delay   delay ceiling for stragglers
    tail_scale        Pareto scale (ticks) for adversarial_tail
    tail_alpha        Pareto shape (smaller = heavier tail)
    seed              rng seed (disorder is independent of the base stream)
    """

    model: str = "bounded_skew"
    fraction: float = 0.1
    max_skew: int = 8
    straggler_delay: int = 30
    tail_scale: float = 8.0
    tail_alpha: float = 1.1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.model not in ("bounded_skew", "stragglers",
                              "adversarial_tail"):
            raise ValueError(f"unknown disorder model {self.model!r}")
        if not (0.0 <= self.fraction <= 1.0):
            raise ValueError("fraction must be in [0, 1]")


def _arrival_delays(batch: EventBatch, cfg: DisorderConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    n = len(batch)
    delays = np.zeros(n, dtype=np.int64)
    if n == 0 or cfg.fraction == 0.0:
        return delays
    if cfg.model == "bounded_skew":
        hit = rng.random(n) < cfg.fraction
        delays[hit] = rng.integers(1, max(cfg.max_skew, 1) + 1,
                                   size=int(hit.sum()))
    elif cfg.model == "stragglers":
        # maximal same-type runs; late bursts arrive as one clump
        cut = np.nonzero(np.diff(batch.type_id))[0] + 1
        bounds = np.concatenate([[0], cut, [n]])
        order = rng.permutation(len(bounds) - 1)
        budget = int(np.ceil(cfg.fraction * n))
        lo = max(cfg.max_skew, 1)
        hi = max(cfg.straggler_delay, lo + 1)
        for bi in order:
            if budget <= 0:
                break
            s, e = int(bounds[bi]), int(bounds[bi + 1])
            delays[s:e] = rng.integers(lo, hi + 1)
            budget -= e - s
    else:  # adversarial_tail
        hit = rng.random(n) < cfg.fraction
        raw = cfg.tail_scale * (1.0 + rng.pareto(cfg.tail_alpha,
                                                 size=int(hit.sum())))
        delays[hit] = np.ceil(raw).astype(np.int64)
    return delays


def disorder_arrival_order(batch: EventBatch, cfg: DisorderConfig
                           ) -> np.ndarray:
    """Arrival permutation: position ``i`` arrives ``order[i]`` (an index
    into the time-sorted ``batch``).  Stable in arrival time, so undisturbed
    events keep their stream order."""
    arrival = batch.time + _arrival_delays(batch, cfg)
    return np.argsort(arrival, kind="stable")


@dataclass
class DisorderedStream:
    """A time-sorted truth batch plus the order its events hit the wire.

    ``base.seq`` is stamped with the stream position (the producer's
    sequence id), so a consumer that merges by ``(time, seq)`` reconstructs
    the exact original total order — including duplicate-timestamp ties.
    """

    base: EventBatch
    order: np.ndarray

    def __len__(self) -> int:
        return len(self.base)

    def chunks(self, size: int):
        """Yield wire chunks (time-sorted internally, provenance-stamped) in
        arrival order — ready for ``EventTimeRuntime.ingest``."""
        b = self.base
        for i in range(0, len(self.order), size):
            idx = self.order[i:i + size]
            yield EventBatch.from_unsorted(b.schema, b.type_id[idx],
                                           b.time[idx], b.attrs[idx],
                                           b.group[idx], seq=idx)

    def max_lateness(self) -> int:
        """Largest frontier lag any event arrives with (the minimal skew a
        bounded-skew watermark needs to lose nothing)."""
        times = self.base.time[self.order]
        if not len(times):
            return 0
        frontier = np.maximum.accumulate(times)
        return int((frontier - times).max())


def apply_disorder(batch: EventBatch, cfg: DisorderConfig) -> DisorderedStream:
    base = EventBatch(batch.schema, batch.type_id, batch.time, batch.attrs,
                      batch.group, seq=np.arange(len(batch), dtype=np.int64))
    return DisorderedStream(base=base, order=disorder_arrival_order(base, cfg))


def disordered_stream(dataset: str, disorder: DisorderConfig, **kwargs
                      ) -> DisorderedStream:
    """Disordered variant of a named workload stream — ``dataset`` is one of
    ``NAMED_STREAMS`` (ridesharing / stock / smarthome / taxi); ``kwargs``
    pass through to the base generator."""
    try:
        gen = NAMED_STREAMS[dataset]
    except KeyError:
        raise ValueError(f"unknown dataset {dataset!r}; "
                         f"have {sorted(NAMED_STREAMS)}") from None
    return apply_disorder(gen(**kwargs), disorder)
