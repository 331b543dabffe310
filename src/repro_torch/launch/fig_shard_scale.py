"""The configuration of the sharded-service weak-scaling study and of the
serving benchmark, as the JAX package's ``benchmarks/fig_shard_scale.py``
and ``benchmarks/bench_serving.py`` build them.

The workload is paper workload 1 with 4 queries ``SEQ(head, Travel+)`` over
heads Request, Pickup and Dropoff, within 30 and slide 5 (pane 5), COUNT
only.  One shard's worth of traffic is ``TENANTS_PER_SHARD`` = 4 tenants of
``GROUPS_PER_TENANT`` = 2 groups from ``tenant_stream`` at 3,000 events/min
for 6 minutes (full mode; 2 in quick mode) with a ramp to 1.3x, seed 42; an
N-shard run replicates that unit onto N shards with the group ids offset,
and pins each replica's groups onto its own shard through the placement
table's overrides.  The shards run the overload runtime with no shedding,
K = 8, and a 50 ms pane SLO.

    from repro_torch.launch.fig_shard_scale import (workload, base_stream,
                                                    replicated, service)
    wl = workload()
    stream = replicated(base_stream(), 4)
    svc = service(wl, 4, backend="cuda")
    res = svc.run(stream)

``workload(pred_attr="speed")`` is its predicate variant: paper workload
1's ``Travel.speed < 4 + i % 5`` on the queries ``i % 3 == 2`` (the study's
own queries have none, so only the variant reaches the masked kernel).
``session_parts`` is the serving benchmark's tenant-aligned split of a
stream into client sessions (``N_SESSIONS`` = 32 trickle sessions,
``TRANSPORT_SESSIONS`` = 8 socket sessions).
"""

from __future__ import annotations

import numpy as np

from ..core.events import EventBatch
from ..overload.config import OverloadConfig
from ..shardsvc import ShardedHamletService, ShardServiceConfig
from ..streams.generator import (RIDESHARING_SCHEMA, TenantStreamConfig,
                                 tenant_stream)
from .fig9 import kleene_workload

__all__ = ["GROUPS_PER_TENANT", "TENANTS_PER_SHARD", "SLO_MS", "MICRO_BATCH",
           "N_SESSIONS", "TRANSPORT_SESSIONS", "workload", "base_stream",
           "replicated", "service", "session_parts"]

GROUPS_PER_TENANT = 2
TENANTS_PER_SHARD = 4
SLO_MS = 50.0
MICRO_BATCH = 8            # the shards' and the serving benchmark's K
N_SESSIONS = 32            # trickle sessions of the serving benchmark
TRANSPORT_SESSIONS = 8     # socket sessions of its transport study


def workload(pred_attr: str | None = None):
    """The study's 4-query workload (slide 5 -> pane 5); ``pred_attr``
    adds paper workload 1's Kleene predicate on every third query."""
    return kleene_workload(RIDESHARING_SCHEMA, 4, kleene_type="Travel",
                           head_types=["Request", "Pickup", "Dropoff"],
                           within=30, slide=5, pred_attr=pred_attr)


def base_stream(quick: bool = False, tps: int = TENANTS_PER_SHARD,
                flash: bool = False) -> EventBatch:
    """One shard's worth of tenants (the replicated weak-scaling unit);
    ``flash`` aims a 6x flash crowd at tenant 0 for 30 ticks."""
    minutes = 2 if quick else 6
    return tenant_stream(TenantStreamConfig(
        schema=RIDESHARING_SCHEMA, n_tenants=tps,
        groups_per_tenant=GROUPS_PER_TENANT,
        base_events_per_minute=3000,
        minutes=minutes, ramp_to=1.3,
        flash_tenant=0 if flash else None, flash=(minutes * 20, 30, 6.0),
        type_weights=(1, 1, 6, 1, 1, 1), seed=42))


def replicated(base: EventBatch, n_replicas: int,
               tps: int = TENANTS_PER_SHARD, flash_base=None) -> EventBatch:
    """Clone the base tenant set onto ``n_replicas`` shards (group ids
    offset per replica), so every shard gets identical work;
    ``flash_base`` (when given) replaces replica 0 — the flash crowd lands
    on exactly one shard."""
    span = tps * GROUPS_PER_TENANT
    parts = []
    for r in range(n_replicas):
        src = flash_base if (r == 0 and flash_base is not None) else base
        parts.append(EventBatch(schema=src.schema, type_id=src.type_id,
                                time=src.time, attrs=src.attrs,
                                group=src.group + r * span))
    return EventBatch.merge(parts)


def service(wl, n_shards: int, tps: int = TENANTS_PER_SHARD, *,
            backend: str = "cuda", device=None,
            **cfg_kw) -> ShardedHamletService:
    """The study's service: no admission, alignment every pane, the shards
    unshed at K = 8 and a 50 ms SLO, each replica block pinned onto its
    shard by placement overrides; ``cfg_kw`` go to the
    :class:`ShardServiceConfig` (e.g. ``parallel``)."""
    cfg = ShardServiceConfig(
        n_shards=n_shards, groups_per_tenant=GROUPS_PER_TENANT,
        admission="none", align_every_panes=1, max_lag_epochs=1,
        overload=OverloadConfig(shed_policy="none", micro_batch=MICRO_BATCH,
                                slo_ms=SLO_MS),
        **cfg_kw)
    svc = ShardedHamletService(wl, cfg, backend=backend, device=device)
    for t in range(n_shards * tps):
        for g in range(t * GROUPS_PER_TENANT, (t + 1) * GROUPS_PER_TENANT):
            svc.placement.override(g, t // tps)
    return svc


def session_parts(stream: EventBatch, n_sessions: int) -> list:
    """Tenant-aligned session split: ``[(tenant, part), ...]``, session i
    serving tenant ``i % n_tenants``, each tenant's events stride-split
    over its sessions.  The original stream position is stamped as the
    producer ``seq``, so the serving merge orders equal timestamps as the
    merged stream does."""
    if stream.seq is None:
        stream = EventBatch(
            schema=stream.schema, type_id=stream.type_id, time=stream.time,
            attrs=stream.attrs, group=stream.group,
            seq=np.arange(len(stream), dtype=np.int64))
    n_tenants = int(stream.group.max()) // GROUPS_PER_TENANT + 1
    parts = []
    for i in range(n_sessions):
        t = i % n_tenants
        lo, hi = t * GROUPS_PER_TENANT, (t + 1) * GROUPS_PER_TENANT
        idx = np.flatnonzero((stream.group >= lo) & (stream.group < hi))
        parts.append((t, stream.select(idx[i // n_tenants::max(
            1, n_sessions // n_tenants)])))
    return parts
