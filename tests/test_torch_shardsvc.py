"""The port's sharded service against the JAX package's, on the CPU.

Every scenario of ``tests/test_shardsvc.py`` runs on the same inputs, made
from numpy seeds and carried across with ``repro_torch.interop``, through
the reference (its numpy backend, as its own tests run it) and through the
port on ``backend="np"`` and on ``backend="torch", device="cpu"`` (the
kernels' plain versions):

* N-shard results (N in 1, 2, 4) against the reference's 1-shard run:
  bitwise (``vals_equal``) on np; on torch COUNT exact below 2^53, the
  same keys and non-finite pattern and every other value within rtol
  1e-12, with the number of bitwise windows reported (``hold``) — on these
  inputs every window is bitwise, and the torch runs are pinned so too;
* shard-count-invariant counts, router admission and its certificates,
  late/expired accounting, the aligner's status after every chunk and the
  placement table: equal to the reference's on both port backends (host
  numpy, independent of the kernel backend);
* the pane-batch sharding hook (``shard_slices``) and thread-safe kernel
  bookkeeping of the port's own.
"""

import dataclasses
import gc
import math
import threading
from unittest import mock

import numpy as np
import pytest

from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.engine import RunStats as RefRunStats
from repro.core.pattern import EventType, Kleene, Seq
from repro.core.query import Query, Workload
from repro.overload import OverloadConfig as RefOverloadConfig
from repro.overload.accountant import ErrorAccountant as RefAccountant
from repro.overload.accountant import \
    merge_error_reports as ref_merge_error_reports
from repro.shardsvc import PlacementTable as RefPlacement
from repro.shardsvc import ShardedHamletService as RefService
from repro.shardsvc import ShardServiceConfig as RefCfg
from repro.shardsvc import ring_hash as ref_ring_hash
from repro.streams.generator import (NAMED_STREAMS, RIDESHARING_SCHEMA,
                                     SMARTHOME_SCHEMA, STOCK_SCHEMA,
                                     TAXI_SCHEMA, DisorderConfig,
                                     apply_disorder)
from repro_torch import interop
from repro_torch.core.engine import HamletRuntime, RunStats, vals_equal
from repro_torch.distributed.sharding import pane_bucket_shards
from repro_torch.eventtime.frontier import FrontierSnapshot
from repro_torch.kernels import _build
from repro_torch.overload import OverloadConfig
from repro_torch.overload.accountant import (ErrorAccountant,
                                             merge_error_reports)
from repro_torch.shardsvc import (ADMISSION_MODES, PlacementTable,
                                  ShardedHamletService, ShardServiceConfig,
                                  WatermarkAligner, ring_hash)

DATASETS = {
    "ridesharing": (RIDESHARING_SCHEMA, "Travel", ("Request", "Accept")),
    "stock": (STOCK_SCHEMA, "Quote", ("Buy", "Sell")),
    "smarthome": (SMARTHOME_SCHEMA, "Measure", ("Load", "Work")),
    "taxi": (TAXI_SCHEMA, "Travel", ("Request", "Pickup")),
}

STREAM_KW = {"ridesharing": dict(events_per_minute=250, minutes=2,
                                 n_groups=6),
             "stock": dict(events_per_minute=300, minutes=2, n_groups=6),
             "smarthome": dict(events_per_minute=400, minutes=2,
                               n_groups=8),
             "taxi": dict(events_per_minute=250, minutes=2, n_groups=6)}

BACKENDS = [("np", None), ("torch", "cpu")]
BACKEND_IDS = [b for b, _ in BACKENDS]


def port_wl(wl):
    return interop.workload_from(interop.workload_spec(wl))


def port_stream(batch):
    c = interop.stream_columns(batch)
    return interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                              c["type_id"], c["time"], c["attrs"], c["group"],
                              c["seq"])


class Side:
    """One side of a differential run: the reference, or the port on one
    backend.  Scenarios build every object through it from the reference's
    inputs."""

    def __init__(self, backend=None, device=None):
        self.ref = backend is None
        self.backend = backend or "ref"
        self.kw = {} if self.ref else {"backend": backend, "device": device}

    def wl(self, wl):
        return wl if self.ref else port_wl(wl)

    def batch(self, b):
        return b if self.ref else port_stream(b)

    def overload(self, **kw):
        return (RefOverloadConfig if self.ref else OverloadConfig)(**kw)

    def cfg(self, n_shards, **kw):
        kw.setdefault("admission", "none")
        kw["overload"] = self.overload(
            **kw.get("overload", dict(shed_policy="none", micro_batch=4)))
        return (RefCfg if self.ref else ShardServiceConfig)(
            n_shards=n_shards, **kw)

    def service(self, wl, n_shards, **kw):
        return (RefService if self.ref else ShardedHamletService)(
            self.wl(wl), self.cfg(n_shards, **kw), **self.kw)


REF = Side()
PORTS = [Side(b, d) for b, d in BACKENDS]


@pytest.fixture(autouse=True, scope="module")
def collect_garbage_after_module():
    """Free the module's cyclic garbage (services, runtimes, threads' frames)
    when it ends, so a later module in the same worker process does not pay
    for it in a collection inside one of its timed panes."""
    yield
    gc.collect()


def _wl(schema, kleene, heads, within=20, slide=10):
    k = EventType(kleene)
    qs = [Query(f"q{i}", Seq(EventType(h), Kleene(k)),
                within=within, slide=slide)
          for i, h in enumerate(heads)]
    qs.append(Query("qk", Kleene(k), within=within, slide=slide))
    return Workload(schema, qs)


def _dataset(name, **kw):
    schema, kleene, heads = DATASETS[name]
    return (_wl(schema, kleene, heads),
            NAMED_STREAMS[name](**dict(STREAM_KW[name], **kw)))


def hold(got: dict, want: dict, tag="") -> int:
    """Hold ``got`` against the reference's ``want``: equal keys, equal
    non-finite pattern, COUNT exact below 2^53 and every other value
    within rtol 1e-12.  Returns the number of bitwise-equal windows."""
    assert got.keys() == want.keys(), tag
    for k, w in want.items():
        g = got[k]
        assert g.keys() == w.keys(), (tag, k)
        for a, wv in w.items():
            gv = g[a]
            if not math.isfinite(wv):
                assert (math.isnan(gv) and math.isnan(wv)) or gv == wv, \
                    (tag, k, a, gv, wv)
            elif a.startswith("COUNT") and abs(wv) < 2 ** 53:
                assert gv == wv, (tag, k, a, gv, wv)
            else:
                assert math.isclose(gv, wv, rel_tol=1e-12), (tag, k, a, gv,
                                                             wv)
    return sum(vals_equal(got[k], want[k]) for k in want)


def assert_same(got: dict, want: dict, tag=""):
    """Bitwise: every window ``vals_equal`` (the rule of ``hold`` is
    checked first, so a failure names the first value that differs)."""
    n = hold(got, want, tag)
    assert n == len(want), (tag, f"{n} of {len(want)} windows bitwise")


# ------------------------------------------------------------- differential


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_shard_count_invariant_results(name, side):
    """1-, 2- and 4-shard port runs against the reference's 1-shard run:
    bitwise on both backends, and the fleet RunStats count fields equal."""
    wl, stream = _dataset(name)
    ref_svc = REF.service(wl, 1)
    want = ref_svc.run(stream)
    assert want, "differential is vacuous without results"
    for n in (1, 2, 4):
        svc = side.service(wl, n)
        assert_same(svc.run(side.batch(stream)), want, (name, n))
        assert svc.stats().counts() == ref_svc.stats().counts()


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_chunk_size_invariant(side):
    """Routing in bigger arrival chunks (several panes at once) does not
    change results."""
    wl, stream = _dataset("ridesharing")
    want = REF.service(wl, 2).run(stream)
    svc = side.service(wl, 2)
    got = svc.run(side.batch(stream), chunk_ticks=3 * svc.pane)
    assert_same(got, want)


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_fixed_shed_differential_and_certificates(side):
    """global_fixed admission: the admitted set, the results and the global
    error certificate are shard-count invariant and equal the
    reference's."""
    wl, stream = _dataset("stock")
    ov = dict(shed_policy="drop_tail", fixed_shed=0.3, micro_batch=4)
    ref_svc = REF.service(wl, 1, admission="global_fixed", overload=ov)
    want = ref_svc.run(stream)
    want_rep = {k: dataclasses.astuple(r)
                for k, r in ref_svc.error_report().items()}
    for n in (1, 2, 4):
        svc = side.service(wl, n, admission="global_fixed", overload=ov)
        assert_same(svc.run(side.batch(stream)), want, n)
        assert {k: dataclasses.astuple(r)
                for k, r in svc.error_report().items()} == want_rep
        assert svc.admission.summary() == ref_svc.admission.summary()
        assert svc.admission.summary()["shed"] > 0


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
@pytest.mark.parametrize("model,fraction,lossless", [
    ("bounded_skew", 0.2, True),
    ("stragglers", 0.15, False),
])
def test_eventtime_disorder_differential(model, fraction, lossless, side):
    """Disordered arrival through per-shard reorder buffers: results and
    late/expired accounting equal the reference's at every shard count."""
    wl, stream = _dataset("taxi")
    ds = apply_disorder(stream, DisorderConfig(
        model=model, fraction=fraction, max_skew=6, straggler_delay=25,
        seed=5))
    skew = ds.max_lateness() if lossless else 6
    ref_svc = REF.service(wl, 1, eventtime=True, skew=skew)
    want = ref_svc.run_chunks(ds.chunks(64))
    want_lost = (sum(w.late_total for w in ref_svc.workers),
                 sum(w.expired_total for w in ref_svc.workers))
    for n in (1, 2, 4):
        svc = side.service(wl, n, eventtime=True, skew=skew)
        got = svc.run_chunks(side.batch(c) for c in ds.chunks(64))
        assert_same(got, want, n)
        assert (sum(w.late_total for w in svc.workers),
                sum(w.expired_total for w in svc.workers)) == want_lost
    if lossless:
        assert want_lost == (0, 0)
    else:
        assert want_lost[0] > 0


# ---------------------------------------------------------------- rebalance


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_rebalance_is_exact(side):
    """A mid-stream move of one group gives the reference's results bitwise
    (moved or not), lands in the placement overrides, and hands the open
    windows over as host numpy state."""
    wl, stream = _dataset("ridesharing")
    t_hi = int(stream.time.max()) + 1
    want = REF.service(wl, 2).run(stream)

    svc = side.service(wl, 2)
    pstream = side.batch(stream)
    group = 3
    src = svc.placement.shard_of(group)
    dst = 1 - src
    boundary = None
    moved = []
    transfer = svc._transfer

    def spy(mv):
        drv = svc.workers[mv.src].rt._drivers.get(mv.group)
        transfer(mv)
        moved.extend(i.u for per in (drv.insts if drv else [])
                     for d in per for i in d.values())
    svc._transfer = spy
    for t0 in range(0, t_hi, svc.pane):
        svc.ingest(pstream.time_slice(t0, t0 + svc.pane))
        if boundary is None and t0 >= t_hi // 2:
            boundary = svc.plan_rebalance(group, dst)
    svc.close()
    assert boundary is not None and boundary % svc.pane == 0
    assert svc.placement.overrides == {group: dst}
    assert svc.placement.shard_of(group) == dst
    assert not svc._moves, "move never committed"
    assert moved and all(type(u) is np.ndarray for u in moved)
    assert_same(svc.results(), want)


def test_rebalance_to_same_shard_is_noop():
    wl, stream = _dataset("ridesharing")
    side = PORTS[0]
    svc = side.service(wl, 2)
    group = 3
    src = svc.placement.shard_of(group)
    svc.plan_rebalance(group, src)
    assert not svc._moves and svc.placement.overrides == {}
    svc.run(side.batch(stream))


# ---------------------------------------------------- watermark alignment


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_laggard_excluded_and_alignment_advances(side):
    """A throttled shard is excluded from alignment once it trails: the
    aligner's status after every chunk, the final/pending split and the
    results equal the reference's."""
    wl, stream = _dataset("smarthome")
    t_hi = int(stream.time.max()) + 1

    def drive(s):
        svc = s.service(wl, 4, align_every_panes=1, max_lag_epochs=1)
        svc.workers[0].throttle = 1
        batch = s.batch(stream)
        trail = []
        for t0 in range(0, t_hi, 6 * svc.pane):
            svc.ingest(batch.time_slice(t0, t0 + 6 * svc.pane))
            st = svc.aligner.status()
            final, pending = svc.aligned_results()
            trail.append((st["aligned_time"], st["laggards"], st["epochs"],
                          svc.workers[0].t_now, sorted(final),
                          sorted(pending)))
            for (qname, _gk, w0) in final:
                assert w0 + svc._within[qname] <= st["aligned_time"]
        svc.close()
        return svc, trail

    ref_svc, want = drive(REF)
    svc, got = drive(side)
    assert got == want
    assert any(0 in lag for _, lag, *_ in got)
    assert max(at - t0 for at, _, _, t0, _, _ in got) > 0
    assert svc.aligner.status()["laggards"] == []
    final, pending = svc.aligned_results()
    merged = dict(final)
    merged.update(pending)
    assert_same(merged, ref_svc.results())
    assert final and any(p for *_, p in got)


def test_aligner_monotone_and_validates():
    """The aligner publishes the reference's epoch and laggard set for a
    sequence of reports, never lowering the epoch."""
    from repro.eventtime.frontier import FrontierSnapshot as RefSnapshot
    from repro.shardsvc import WatermarkAligner as RefAligner

    al = WatermarkAligner(2, align_every=10, max_lag_epochs=1)
    with pytest.raises(ValueError):
        al.update(FrontierSnapshot(shard=5, watermark=0, sealed_end=0,
                                   processed_end=0))
    assert al.aligned_epoch == 0
    ref = RefAligner(2, align_every=10, max_lag_epochs=1)
    published = []
    for shard, end in ((0, 30), (1, 20), (1, 10), (0, 40), (1, 50),
                       (0, 20), (1, 60)):
        al.update(FrontierSnapshot(shard, end - 1, end, end))
        ref.update(RefSnapshot(shard, end - 1, end, end))
        published.append(al.align())
        assert published[-1] == ref.align()
        assert al.laggards() == ref.laggards()
    assert published == sorted(published) and published[-1] > 0
    with pytest.raises(ValueError):
        WatermarkAligner(2, align_every=0)
    with pytest.raises(ValueError):
        WatermarkAligner(2, align_every=10, max_lag_epochs=-1)


# ------------------------------------------------------- global admission


def test_admission_modes_exposed():
    assert set(ADMISSION_MODES) == {"none", "global_fixed", "per_shard"}
    with pytest.raises(ValueError):
        ShardServiceConfig(admission="bogus")
    with pytest.raises(ValueError):
        ShardServiceConfig(n_shards=0)
    with pytest.raises(ValueError):
        ShardServiceConfig(skew=-1)


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_per_shard_admission_sheds_under_pressure(side):
    """per_shard mode: the router sheds each shard's sub-chunk at that
    shard's PID state (which follows the host's clock, so nothing is
    compared with the reference); shards never shed themselves, and the
    certificate still merges to one global report."""
    wl, stream = _dataset("smarthome")
    svc = side.service(wl, 2, admission="per_shard", overload=dict(
        shed_policy="drop_tail", slo_ms=0.05, micro_batch=1))
    assert svc._shard_overload_cfg().shed_policy == "none"
    for w in svc.workers:
        assert w.rt.shedder is None
    res = svc.run(side.batch(stream))
    summ = svc.admission.summary()
    assert summ["mode"] == "per_shard"
    assert summ["offered"] == len(stream)
    assert summ["shed"] == summ["offered"] - summ["admitted"] > 0
    rep = svc.error_report()
    assert rep and all(hasattr(r, "subset_guarantee") for r in rep.values())
    assert res


def test_accountant_merge_cell_exact():
    """``ErrorAccountant.merged`` is a cell-exact union, cell for cell the
    reference's, and equal to one accountant that saw every shed event."""
    wl, stream = _dataset("stock")
    merged_of = {}
    for acc_cls, w, s in ((RefAccountant, wl, stream),
                          (ErrorAccountant, port_wl(wl), port_stream(stream))):
        half = len(s) // 2
        lo, hi = s.select(np.arange(half)), s.select(np.arange(half, len(s)))
        full, a1, a2 = acc_cls(w), acc_cls(w), acc_cls(w)
        full.record(lo, witnessed=True)
        full.record(hi, witnessed=False, late=True)
        a1.record(lo, witnessed=True)
        a2.record(hi, witnessed=False, late=True)
        merged = acc_cls.merged([a1, a2])
        assert merged.total_shed == full.total_shed == len(s)
        assert merged.late_events == full.late_events == len(hi)
        assert merged._shed == full._shed
        assert merged.report() == full.report()
        q = w.atomic[0]
        g = int(s.group[0])
        assert merged.window_bound(q.name, g, 0) == \
            full.window_bound(q.name, g, 0)
        merged_of[acc_cls] = merged
    port, ref = merged_of[ErrorAccountant], merged_of[RefAccountant]
    assert port._shed == ref._shed
    assert ({k: dataclasses.astuple(r) for k, r in port.report().items()}
            == {k: dataclasses.astuple(r) for k, r in ref.report().items()})


def test_accountant_merge_rejects_pane_mismatch():
    wl, _ = _dataset("stock")
    pwl = port_wl(wl)
    with pytest.raises(ValueError):
        ErrorAccountant.merged([ErrorAccountant(pwl, pane=5),
                                ErrorAccountant(pwl, pane=10)])
    with pytest.raises(ValueError):
        ErrorAccountant.merged([])


def test_merge_error_reports_sums_and_conjoins():
    wl, stream = _dataset("stock")
    got = {}
    for acc_cls, merge, w, s in (
            (RefAccountant, ref_merge_error_reports, wl, stream),
            (ErrorAccountant, merge_error_reports, port_wl(wl),
             port_stream(stream))):
        a1, a2 = acc_cls(w), acc_cls(w)
        a1.record(s.select(np.arange(len(s) // 2)), witnessed=True)
        a2.record(s.select(np.arange(len(s) // 2, len(s))))
        r1, r2 = a1.report(), a2.report()
        fleet = merge([r1, r2])
        for name, r in fleet.items():
            assert r.shed_kleene == r1[name].shed_kleene + \
                r2[name].shed_kleene
            assert r.cells_affected == (r1[name].cells_affected
                                        + r2[name].cells_affected)
            assert r.subset_guarantee == (r1[name].subset_guarantee
                                          and r2[name].subset_guarantee)
        got[acc_cls] = {k: dataclasses.astuple(r) for k, r in fleet.items()}
    assert got[ErrorAccountant] == got[RefAccountant]


# ----------------------------------------------------------- placement


def test_placement_deterministic_and_balanced():
    """The ring is the reference's: the same hashes, the same shard for
    every group, tenants colocated."""
    for key in ("g:42", "g:43", "tenant:0", "shard:3:63"):
        assert ring_hash(key) == ref_ring_hash(key)
    assert ring_hash("g:42") != ring_hash("g:43")
    groups = np.arange(200)
    for n, gpt in ((4, 2), (3, 1), (7, 3)):
        pt, ref_pt = PlacementTable(n, gpt), RefPlacement(n, gpt)
        assert np.array_equal(pt.shard_of_groups(groups),
                              ref_pt.shard_of_groups(groups))
        assert [pt.shard_of(g) for g in groups.tolist()] == \
            pt.shard_of_groups(groups).tolist()
    pt1 = PlacementTable(4, groups_per_tenant=2)
    assert {pt1.shard_of(g) for g in range(200)} == set(range(4))
    for g in range(0, 200, 2):
        assert pt1.shard_of(g) == pt1.shard_of(g + 1)


def test_placement_partition_and_overrides():
    pt = PlacementTable(3)
    groups = list(range(30))
    on = [pt.groups_on(s, groups) for s in range(3)]
    assert sorted(g for part in on for g in part) == groups
    g = 7
    before = pt.shard_of(g)
    target = (before + 1) % 3
    v0 = pt.version
    pt.override(g, target)
    assert pt.shard_of(g) == target and pt.version == v0 + 1
    assert pt.shard_of_groups(np.array([g]))[0] == target
    pt.clear_override(g)
    assert pt.shard_of(g) == before
    with pytest.raises(ValueError):
        pt.override(g, 3)


# --------------------------------------------------- merged observability


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_runstats_merge_parity_and_counts(side):
    """Fleet RunStats: the count fields of the merged 4-shard run equal the
    reference's 1-shard run; wall timers sum rather than match."""
    wl, stream = _dataset("ridesharing")
    ref_svc = REF.service(wl, 1)
    ref_svc.run(stream)
    svc = side.service(wl, 4)
    svc.run(side.batch(stream))
    assert svc.stats().counts() == ref_svc.stats().counts()
    assert 0 < svc.stats().events <= len(stream)
    assert RunStats.COUNT_FIELDS == RefRunStats.COUNT_FIELDS


def test_runstats_merged_sums_parts():
    a, b = RunStats(), RunStats()
    a.events, b.events = 3, 4
    a.plan_s, b.plan_s = 0.5, 0.25
    m = RunStats.merged([a, b])
    assert m.events == 7 and m.plan_s == 0.75


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_observability_merge_across_shards(side):
    """collect() with per-shard observability merges the registries: every
    merged histogram count equals the sum over shards, and the series are
    the reference's (on np; the torch backend adds its fold scan's), less
    the reference's flush-plan LRU series (the port keeps no such memo)."""
    wl, stream = _dataset("ridesharing")
    ref_svc = REF.service(wl, 2, obs=True)
    ref_svc.run(stream)
    svc = side.service(wl, 2, obs=True)
    svc.run(side.batch(stream))
    out = svc.collect()
    merged, shards = out["metrics"], out["shard_metrics"]
    assert merged, "registry-only observability must collect series"
    ref_series = set(ref_svc.collect()["metrics"])
    assert "fold_exec.flush_plan.misses" in ref_series
    ref_series -= {f"fold_exec.flush_plan.{k}"
                   for k in ("hits", "misses", "evictions")}
    # the device backends' scanned fold adds its own launch series
    assert ref_series <= set(merged)
    if side.backend == "np":
        assert set(merged) == ref_series
    hists = [n for n, v in merged.items()
             if isinstance(v, dict) and "count" in v]
    assert hists, "phase histograms must be recorded"
    for name in hists:
        assert merged[name]["count"] == sum(
            s[name]["count"] for s in shards if name in s), name
    for s in shards:
        assert set(s) <= set(merged)
    assert sum(s["executor_launches"] for s in out["shards"]) > 0


# ------------------------------------------------- the port's own pieces


def test_shard_slices_hook_identical():
    """Splitting buckets with ``pane_bucket_shards`` (the distributed hook)
    is a pure partitioning of the launch: results stay bitwise identical
    to the unsplit run and to the reference's split run (the workload and
    stream of ``tests/test_differential.py``'s twin), with more
    launches."""
    from repro.core.events import EventBatch, StreamSchema
    from repro.core.query import Pred, agg_sum, count_star
    from repro.distributed.sharding import \
        pane_bucket_shards as ref_pane_bucket_shards

    for nb in range(0, 12):
        for n in (1, 3, 5):
            assert pane_bucket_shards(nb, n) == ref_pane_bucket_shards(nb, n)
    schema = StreamSchema(types=("A", "B", "C"), attrs=("v",))
    A, B, C = map(EventType, "ABC")
    wl = Workload(schema, [
        Query("q1", Seq(A, Kleene(B)), aggs=(count_star(), agg_sum("B", "v")),
              within=20, slide=10),
        Query("q2", Seq(C, Kleene(B)), preds={"B": [Pred("v", "<", 3)]},
              within=20, slide=20),
        Query("q3", Kleene(B), within=20, slide=10),
    ])
    evs = [(1, v % 5) for v in range(200)] + [(0, 1)] + \
          [(1, v % 3) for v in range(40)]
    n = len(evs)
    batch = EventBatch(schema, np.array([t for t, _ in evs], np.int32),
                       np.arange(1, n + 1),
                       np.array([[float(v)] for _, v in evs]).reshape(n, 1))
    want = RefRuntime(wl, batch_exec=True, shard_slices=lambda nb:
                      ref_pane_bucket_shards(nb, 3)).run(batch, 260)
    pwl, pb = port_wl(wl), port_stream(batch)
    for backend, device in BACKENDS:
        whole = HamletRuntime(pwl, backend=backend, device=device)
        got_whole = whole.run(pb, 260)
        cut = HamletRuntime(pwl, backend=backend, device=device,
                            shard_slices=lambda nb: pane_bucket_shards(nb, 3))
        got = cut.run(pb, 260)
        assert_same(got, got_whole, backend)
        assert_same(got, want, backend)
        assert cut.executor.launches > whole.executor.launches


def test_kernel_library_loads_once_across_threads(tmp_path, monkeypatch):
    """Eight threads asking for the kernels at once: one build, one load,
    the same library for all (the build is stubbed: no nvcc here)."""
    builds = []

    def fake_compile(nvcc, build_dir, csrc=_build.CSRC):
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)        # hold the lock a while
        return build_dir / "libhamlet_kernels_stub.so", "stub"

    monkeypatch.setattr(_build, "_LOADED", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_digest", lambda nvcc, csrc=None: "stub")
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.MagicMock())
    start = threading.Barrier(8)
    got = []

    def worker():
        start.wait(timeout=10)
        got.append(_build.load())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(builds) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert got[0].ptxas_log == "stub"


def test_launch_counters_lose_no_increment_across_threads():
    """``count_launch`` from 16 threads with a short switch interval: every
    increment lands in ``launches`` and in the shape counter."""
    import collections
    import sys

    def fn():
        pass
    fn.launches = 0
    fn.shapes = collections.Counter()
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(fn, (1, 2, 3, "float64"))
            for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == n_threads * per
    assert fn.shapes[(1, 2, 3, "float64")] == n_threads * per
