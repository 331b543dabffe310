"""The port's stream substrate against the JAX package's: the multi-tenant
and disorder generators and group-key sharding, bitwise equal for the same
seeds (host numpy on both sides)."""

import numpy as np
import pytest

from repro.streams import generator as RG
from repro.streams import partition as RP
from repro_torch import interop
from repro_torch import streams as PS
from repro_torch.streams import generator as PG
from repro_torch.streams import partition as PP

COLS = ("type_id", "time", "attrs", "group", "seq")


def assert_batches_equal(a, b, tag):
    assert len(a) == len(b), tag
    assert tuple(a.schema.types) == tuple(b.schema.types), tag
    for col in COLS:
        assert np.array_equal(getattr(a, col), getattr(b, col)), (tag, col)


def test_exports_match_reference():
    import repro.streams as RS

    ref = {n for n in dir(RS) if not n.startswith("_")}
    port = {n for n in dir(PS) if not n.startswith("_")}
    assert ref <= port, ref - port
    assert set(RG.__all__) == set(PG.__all__)
    assert set(RP.__all__) == set(PP.__all__)


@pytest.mark.parametrize("kw", [
    dict(n_tenants=3, groups_per_tenant=2, base_events_per_minute=200,
         minutes=2, seed=4),
    dict(n_tenants=4, groups_per_tenant=1, base_events_per_minute=300,
         minutes=1, rate_skew=1.2, flash_tenant=2, flash=(10, 20, 4.0),
         ramp_to=1.5, seed=9),
])
def test_tenant_stream_matches_reference(kw):
    a = RG.tenant_stream(RG.TenantStreamConfig(schema=RG.RIDESHARING_SCHEMA,
                                               **kw))
    b = PG.tenant_stream(PG.TenantStreamConfig(schema=PG.RIDESHARING_SCHEMA,
                                               **kw))
    assert len(a) > 0
    assert_batches_equal(a, b, kw)


def test_tenant_config_rejects_what_the_reference_rejects():
    for bad in (dict(n_tenants=0), dict(groups_per_tenant=0),
                dict(rate_skew=-1.0), dict(flash_tenant=4)):
        with pytest.raises(ValueError):
            RG.TenantStreamConfig(schema=RG.RIDESHARING_SCHEMA, **bad)
        with pytest.raises(ValueError):
            PG.TenantStreamConfig(schema=PG.RIDESHARING_SCHEMA, **bad)


@pytest.mark.parametrize("model", ["bounded_skew", "stragglers",
                                   "adversarial_tail"])
@pytest.mark.parametrize("dataset", ["ridesharing", "stock"])
def test_disordered_stream_matches_reference(model, dataset):
    kw = dict(events_per_minute=300, minutes=1, seed=3)
    ra = RG.disordered_stream(dataset, RG.DisorderConfig(
        model=model, fraction=0.3, seed=5), **kw)
    pa = PG.disordered_stream(dataset, PG.DisorderConfig(
        model=model, fraction=0.3, seed=5), **kw)
    assert_batches_equal(ra.base, pa.base, model)
    assert np.array_equal(ra.order, pa.order)
    assert not np.array_equal(pa.order, np.arange(len(pa)))
    assert ra.max_lateness() == pa.max_lateness() > 0
    for rc, pc in zip(ra.chunks(97), pa.chunks(97)):
        assert_batches_equal(rc, pc, (model, "chunk"))
    with pytest.raises(ValueError):
        PG.disordered_stream("nope", PG.DisorderConfig())


def test_apply_disorder_on_a_carried_stream():
    """``apply_disorder`` on a stream carried across with ``interop`` gives
    the reference's arrival order."""
    base = RG.ridesharing_stream(events_per_minute=400, minutes=1, seed=8)
    c = interop.stream_columns(base)
    pb = interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                            c["type_id"], c["time"], c["attrs"], c["group"])
    cfg = dict(model="stragglers", fraction=0.2, max_skew=4,
               straggler_delay=20, seed=1)
    ra = RG.apply_disorder(base, RG.DisorderConfig(**cfg))
    pa = PG.apply_disorder(pb, PG.DisorderConfig(**cfg))
    assert np.array_equal(ra.order, pa.order)
    assert np.array_equal(
        RG.disorder_arrival_order(base, RG.DisorderConfig(**cfg)),
        PG.disorder_arrival_order(pb, PG.DisorderConfig(**cfg)))


@pytest.mark.parametrize("n_shards,capacity", [(1, None), (3, None),
                                               (4, 50)])
def test_shard_by_group_matches_reference(n_shards, capacity):
    a = RG.ridesharing_stream(events_per_minute=500, minutes=1, n_groups=7,
                              seed=2)
    b = PG.ridesharing_stream(events_per_minute=500, minutes=1, n_groups=7,
                              seed=2)
    ra = RP.shard_by_group(a, n_shards, capacity)
    pa = PS.shard_by_group(b, n_shards, capacity)
    for col in ("type_id", "time", "attrs", "group", "valid"):
        x, y = getattr(ra, col), getattr(pa, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), col
    assert (pa.n_shards, pa.capacity) == (ra.n_shards, ra.capacity)
    assert np.array_equal(pa.counts, ra.counts)
    assert pa.occupancy() == ra.occupancy()
