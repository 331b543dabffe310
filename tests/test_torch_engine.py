"""The port's engine against the JAX package's, end to end on the CPU.

The port runs on ``backend="torch", device="cpu"`` (the plain PyTorch
versions of the kernels) and is held against ``repro``'s
``HamletRuntime(wl, fold_exec=False, plan_cache=False)`` — the sequential
numpy oracle of ``tests/test_fold_exec.py`` — on inputs carried across with
``repro_torch.interop``:

* the four named workload streams x micro batch K in {1, 4, 16}: COUNT
  results equal (``vals_equal``);
* SUM/AVG aggregates within rtol 1e-12 (the torch backend's matmuls may add
  in another order than numpy's);
* fold-chain depths {3, 8, 24} and the 1100-event overflow chain, whose
  saturated windows must carry the same inf/NaN pattern;
* MIN/MAX aggregates (the fuzz workload of
  ``tests/test_engine_correctness.py``) bitwise on the np and torch
  backends at K in {1, 4};
* within the port, the reference's twin contracts exactly: batched equals
  per-burst, results do not change with K, and a warm flush is one logical
  launch at any depth;
* planning keeps nothing of a pane past its flush: the collector's count
  of tracked objects does not grow with the panes of a long stream.
"""

import math

import numpy as np
import pytest

from benchmarks.common import kleene_workload
from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.engine import fold_panes as ref_fold_panes
from repro.core.events import EventBatch as RefBatch
from repro.core.events import StreamSchema as RefSchema
from repro.core.pattern import EventType, Kleene, Seq
from repro.core.query import Query, Workload, agg_min, agg_sum, count_star
from repro.launch.hamlet_service import \
    ridesharing_workload as ref_ridesharing_workload
from repro.streams import generator as RG
from repro_torch import interop
from repro_torch.core.engine import (HamletRuntime, PaneMicroBatcher,
                                     PaneProcessor, RunStats, _NegStep)
from repro_torch.core.engine import vals_equal
from repro_torch.core.fold_exec import FoldExecutor, build_fold_schedule
from repro_torch.core.optimizer import DynamicPolicy, NeverShare
from repro_torch.kernels.ops import DENSE_B_MAX
from repro_torch.obs import Observability
from repro_torch.streams import generator as PG

KS = (1, 4, 16)
DEV = dict(backend="torch", device="cpu")

SHAPES = {
    "ridesharing": dict(kleene_type="Travel",
                        head_types=["Request", "Pickup", "Dropoff"]),
    "stock": dict(kleene_type="Quote", head_types=["Buy", "Sell"]),
    "smarthome": dict(kleene_type="Measure", head_types=["Load", "Work"]),
    "taxi": dict(kleene_type="Travel", head_types=["Request", "Pickup"]),
}
SCHEMAS = {"ridesharing": RG.RIDESHARING_SCHEMA, "stock": RG.STOCK_SCHEMA,
           "smarthome": RG.SMARTHOME_SCHEMA, "taxi": RG.TAXI_SCHEMA}


def port_wl(wl):
    return interop.workload_from(interop.workload_spec(wl))


def port_stream(batch):
    c = interop.stream_columns(batch)
    return interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                              c["type_id"], c["time"], c["attrs"], c["group"],
                              c["seq"])


def named_case(name):
    """``tests/test_fold_exec.py``'s named case: 4 predicated Kleene
    queries over 2 minutes of the named stream at 250 events/min."""
    schema = SCHEMAS[name]
    wl = kleene_workload(schema, 4, **SHAPES[name], within=60, slide=30,
                         pred_attr=list(schema.attrs)[0])
    stream = RG.NAMED_STREAMS[name](events_per_minute=250, minutes=2, seed=13)
    t_end = ((int(stream.time.max()) + 30) // 30) * 30
    return wl, stream, t_end


def assert_held(got, want, tag, rtol=1e-12):
    """COUNT exact (``vals_equal``); SUM/AVG within ``rtol``; the same
    non-finite pattern everywhere."""
    assert got.keys() == want.keys(), tag
    for k, w in want.items():
        g = got[k]
        assert g.keys() == w.keys(), (tag, k)
        for a, wv in w.items():
            gv = g[a]
            if a.startswith("COUNT"):
                assert vals_equal({a: gv}, {a: wv}), (tag, k, a, gv, wv)
            elif math.isfinite(wv):
                assert math.isclose(gv, wv, rel_tol=rtol), (tag, k, a, gv, wv)
            else:
                assert gv == wv or (math.isnan(gv) and math.isnan(wv)), (
                    tag, k, a, gv, wv)


def assert_bitwise(got, want, tag):
    assert got.keys() == want.keys(), tag
    for k in want:
        assert vals_equal(got[k], want[k]), (tag, k)


# ------------------------------------------------------------ named sweeps


@pytest.mark.parametrize("name", list(SHAPES))
def test_named_workloads_match_reference(name):
    wl, stream, t_end = named_case(name)
    want = RefRuntime(wl, fold_exec=False, plan_cache=False).run(stream, t_end)
    pwl, pst = port_wl(wl), port_stream(stream)
    scans = 0
    for K in KS:
        obs = Observability.disabled()
        rt = HamletRuntime(pwl, micro_batch=K, fold_exec=True, obs=obs,
                           **DEV)
        got = rt.run(pst, t_end)
        assert_bitwise(got, want, (name, K))
        scans += obs.registry.collect().get("fold_exec.scan_launches", 0)
    # the device scan program was built and exercised
    assert scans > 0, name


def test_streams_match_reference():
    for name in SHAPES:
        a = RG.NAMED_STREAMS[name](events_per_minute=300, minutes=1, seed=5)
        b = PG.NAMED_STREAMS[name](events_per_minute=300, minutes=1, seed=5)
        for col in ("type_id", "time", "attrs", "group"):
            assert np.array_equal(getattr(a, col), getattr(b, col)), name
    kw = dict(base_events_per_minute=600, minutes=2, ramp_to=1.5,
              flash_crowds=((60, 10, 4.0),), n_groups=1, burstiness=0.9,
              type_weights=(1, 1, 6, 1, 1, 1), seed=7)
    a = RG.overload_stream(RG.OverloadStreamConfig(
        schema=RG.RIDESHARING_SCHEMA, **kw))
    b = PG.overload_stream(PG.OverloadStreamConfig(
        schema=PG.RIDESHARING_SCHEMA, **kw))
    for col in ("type_id", "time", "attrs", "group"):
        assert np.array_equal(getattr(a, col), getattr(b, col))


# ------------------------------------------------- chain depths + overflow

SCHEMA = RefSchema(types=("A", "B"), attrs=("v",))
A, B = EventType("A"), EventType("B")


def chain_wl():
    return Workload(SCHEMA, [
        Query("q1", Seq(A, Kleene(B)), aggs=(count_star(), agg_sum("B", "v")),
              within=40, slide=20),
        Query("q2", Kleene(B), within=40, slide=20),
    ])


def chain_batch(n_bursts, burst_len=1, seed=0):
    evs = [0]
    for _ in range(n_bursts):
        evs.extend([1] * burst_len)
        evs.append(0)
    types = np.array(evs, dtype=np.int32)
    time = np.minimum(np.arange(1, len(types) + 1), 19)
    vals = np.random.default_rng(seed).uniform(0.5, 2.0, (len(types), 1))
    return RefBatch(SCHEMA, types, time, vals)


@pytest.mark.parametrize("depth", [3, 8, 24])
def test_chain_depths_match_reference(depth):
    wl, batch = chain_wl(), chain_batch(depth, burst_len=3, seed=depth)
    want = RefRuntime(wl, fold_exec=False, plan_cache=False).run(batch, 40)
    pwl, pb = port_wl(wl), port_stream(batch)
    for K in KS:
        got = HamletRuntime(pwl, micro_batch=K, **DEV).run(pb, 40)
        assert_held(got, want, (depth, K))


def test_overflow_chain_matches_reference():
    # a 1100-event Kleene burst holds ~2^1099 trends: counts saturate past
    # f64 on the oracle and must saturate identically in the port
    wl, batch = chain_wl(), chain_batch(1, burst_len=1100)
    want = RefRuntime(wl, fold_exec=False, plan_cache=False).run(batch, 40)
    assert any(not np.isfinite(v) for out in want.values()
               for v in out.values()), "overflow regime not reached"
    got = HamletRuntime(port_wl(wl), micro_batch=4, **DEV).run(
        port_stream(batch), 40)
    assert_bitwise(got, want, "overflow")


# ---------------------------------------------- SUM/AVG + negation (CLI)


def cli_case():
    wl = ref_ridesharing_workload(3)
    stream = RG.ridesharing_stream(events_per_minute=300, minutes=1,
                                   n_groups=2, seed=3)
    return wl, stream, 60


def test_cli_workload_matches_reference():
    """Negation, SUM and AVG (the CLI's default workload): COUNT exact and
    SUM/AVG to 1e-12 on the torch backend against the sequential oracle;
    the port's np backend bitwise equal to the reference's same path.  (The
    reference's own stacked fold differs from its sequential replay in the
    last ulp of some SUM windows here, so bitwise holds path for path.)"""
    wl, stream, t_end = cli_case()
    want = RefRuntime(wl, fold_exec=False, plan_cache=False).run(stream, t_end)
    pwl, pst = port_wl(wl), port_stream(stream)
    got = HamletRuntime(pwl, micro_batch=4, **DEV).run(pst, t_end)
    assert_held(got, want, "torch")
    for fe in (False, True):
        ref_np = RefRuntime(wl, micro_batch=4, fold_exec=fe).run(stream, t_end)
        got_np = HamletRuntime(pwl, backend="np", micro_batch=4,
                               fold_exec=fe).run(pst, t_end)
        assert_bitwise(got_np, ref_np, ("np", fe))


# -------------------------------------------------- within-port contracts


def test_batched_equals_per_burst_and_k_invariance():
    wl, stream, t_end = cli_case()
    pwl, pst = port_wl(wl), port_stream(stream)
    base = HamletRuntime(pwl, batch_exec=False, **DEV).run(pst, t_end)
    for K, be in ((1, True), (4, False), (16, True)):
        got = HamletRuntime(pwl, batch_exec=be, micro_batch=K,
                            **DEV).run(pst, t_end)
        assert_bitwise(got, base, (K, be))


def _warm_flush_launches(n_bursts):
    """The second of two equal flushes: its fold launches, its scan
    programs, and its fold rounds (the deepest pane's levels)."""
    obs = Observability.disabled()
    rt = HamletRuntime(port_wl(chain_wl()), micro_batch=4, obs=obs, **DEV)
    proc = rt.make_processor(0)
    batch = port_stream(chain_batch(n_bursts))
    stats = RunStats()

    def flush():
        mb = PaneMicroBatcher(rt.executor, k=4, fold_exec=rt.fold_exec)
        pends = [mb.submit(proc, batch, stats) for _ in range(4)]
        mb.drain()
        return pends

    def scans():
        return obs.registry.collect().get("fold_exec.scan_launches", 0)

    first = [p.finalize() for p in flush()]
    fe = rt.fold_exec
    l0, s0 = fe.launches, scans()
    pends = flush()
    for a, p in zip(first, pends):
        assert np.array_equal(a, p.finalize())
    assert scans() - s0 == 1
    rounds = max(build_fold_schedule(proc.ctx, p.steps).n_levels
                 for p in pends)
    return fe.launches - l0, rounds


def test_one_launch_per_warm_flush_any_depth():
    (l_shallow, r_shallow), (l_deep, r_deep) = (
        _warm_flush_launches(8), _warm_flush_launches(24))
    assert r_deep > r_shallow >= 3
    assert l_shallow == l_deep == 1


# fewer tracked objects than two panes' plans hold: a memo of whole panes
# or flushes adds about 146 a pane on this stream (18,660 at K = 1 and
# 19,902 at K = 16 over the 128 panes measured); without one the count
# moves by 0-1
PLAN_STATE_GROWTH_LIMIT = 256


@pytest.mark.parametrize("K", [1, 16])
def test_plan_state_does_not_grow_with_panes(K):
    """Planning keeps nothing of a pane once it is folded: after a warm
    segment of a smart-home-shaped stream (``hbench/configs/``, where the
    sharing-decision memos saturate), four segments of fresh events leave
    the count of objects the collector tracks where it was."""
    import gc
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from hbench import drivers

    cfg = json.loads((root / "hbench" / "configs" / "smarthome-w1.json")
                     .read_text())
    cfg["events_per_group_minute"] = 200
    mix = {"districts": 2, "micro_batch": 16}
    wl = drivers._workload(cfg)
    t_end = drivers.segment_ticks(cfg, mix)
    segs = [drivers._batch(wl, drivers.cell_stream(cfg, mix, 2**31 + 17, i,
                                                   t_end / 60))
            for i in range(5)]
    rt = HamletRuntime(wl, policy=DynamicPolicy(), backend="np",
                       micro_batch=K)
    rt.run(segs[0], t_end)
    gc.collect()
    n0 = len(gc.get_objects())
    for b in segs[1:]:
        rt.run(b, t_end)
    gc.collect()
    grown = len(gc.get_objects()) - n0
    assert rt.stats.panes == 5 * 32
    assert grown < PLAN_STATE_GROWTH_LIMIT, grown


def test_fold_windows_matches_fold_panes():
    rng = np.random.default_rng(9)
    C = 5
    folds = [(rng.random(C), [rng.random((C, C)) for _ in range(n)])
             for n in (0, 1, 3, 3, 6)]
    got = FoldExecutor(**DEV).fold_windows(folds)
    for (u0, Ms), g in zip(folds, got):
        np.testing.assert_allclose(g, ref_fold_panes(Ms, u0), rtol=1e-12)


# ----------------------------------------------------------- MIN / MAX


def minmax_case(seed):
    """``tests/test_engine_correctness.py::test_fuzz_against_brute_and_greta``'s
    workload (q3 takes MIN, q5 MAX, beside COUNT, SUM, AVG, negation and
    edge predicates) over its fuzz stream for ``seed``, trial 0."""
    from repro.core.events import EventBatch, StreamSchema
    from repro.core.pattern import Not
    from repro.core.query import (EdgePred, Pred, agg_avg, agg_max,
                                  count_type)

    schema = StreamSchema(types=("A", "B", "C", "X"), attrs=("v", "w"))
    a, b, c, x = map(EventType, "ABCX")
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 15))
    types = rng.integers(0, 4, n)
    times = np.sort(rng.choice(np.arange(1, 40), size=n, replace=False))
    attrs = rng.integers(0, 5, (n, 2)).astype(float)
    groups = rng.integers(0, 2, n)
    batch = EventBatch(schema, types, times, attrs, groups)
    qs = [
        Query("q1", Seq(a, Kleene(b)),
              aggs=(count_star(), agg_sum("B", "v"), agg_avg("B", "v")),
              preds={"B": [Pred("v", "<", 4)]}, within=20, slide=10),
        Query("q2", Seq(c, Kleene(b)),
              aggs=(count_star(), count_type("B")), within=40, slide=20),
        Query("q3", Kleene(b), aggs=(count_star(), agg_min("B", "w")),
              edge_preds={"B": [EdgePred("v", "<=")]}, within=20, slide=20),
        Query("q4", Seq(a, Kleene(b), c, Not(x)), aggs=(count_star(),),
              within=40, slide=40),
        Query("q5", Seq(a, Not(x), Kleene(b)),
              aggs=(count_star(), agg_max("B", "v")), within=20, slide=20),
    ]
    return Workload(schema, qs), batch


@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("K", [1, 4])
def test_minmax_matches_reference(K, backend):
    """MIN/MAX windows (the side path of ``core/minmax.py``, its trend
    counts from the runtime's own backend) bitwise equal to the
    reference's ``HamletRuntime`` in every finite window, over eight fuzz
    seeds; every window of these streams is finite."""
    dev = dict(backend=backend, device="cpu" if backend == "torch" else None)
    minmax_seen = 0
    for seed in range(8):
        wl, batch = minmax_case(seed)
        want = RefRuntime(wl, micro_batch=K).run(batch, 40)
        got = HamletRuntime(port_wl(wl), micro_batch=K, **dev).run(
            port_stream(batch), 40)
        assert got.keys() == want.keys(), seed
        for k, w in want.items():
            assert all(math.isfinite(v) for a, v in w.items()
                       if a.startswith("COUNT")), (seed, k)
            assert vals_equal(got[k], w), (seed, k, got[k], w)
            minmax_seen += sum(math.isfinite(v) for a, v in w.items()
                               if a.startswith(("MIN", "MAX")))
    assert minmax_seen > 0


# ------------------------------------------- stacked single-query plans


def _oracle_steps(proc, plan_bursts, stats):
    """The step list as ``_plan_group`` builds it, one call a group."""
    steps = []
    for neg, burst in plan_bursts:
        if neg is not None:
            steps.append(neg)
        if burst is None:
            continue
        tid, el, attrs, b, q_pos, mvec, epm, groups = burst
        for g in groups:
            if len(g) >= 2:
                stats.shared_bursts += 1
                stats.shared_graphlets += 1
            stats.graphlets += 1
            rows = [q_pos.index(qi) for qi in g]
            proc._plan_group(g, el, tid, attrs, b, mvec[rows],
                             [epm[i] for i in rows], steps, stats)
    return steps


def _same_array(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and a.shape == b.shape and a.tobytes() == b.tobytes())


PLAN_ARRAYS = ("mvec", "div", "div_rows", "live", "dead", "base_c")
PLAN_VALUES = ("g", "el", "type_id", "b", "shared", "B_local", "z_ids",
               "dense", "start_q0", "trivial")


def _assert_plan_equal(got, want, tag):
    for f in PLAN_VALUES:
        assert getattr(got, f) == getattr(want, f), (tag, f)
    for f in PLAN_ARRAYS:
        assert _same_array(getattr(got, f), getattr(want, f)), (tag, f)
    assert got.attrs is want.attrs, tag
    assert len(got.epm) == len(want.epm), tag
    assert all(_same_array(a, b) for a, b in zip(got.epm, want.epm)), tag
    assert [u for u, _ in got.sum_units] == [u for u, _ in want.sum_units]
    assert all(_same_array(a, b) for (_, a), (_, b)
               in zip(got.sum_units, want.sum_units)), tag
    if got.trivial:
        # nothing reads a trivial plan's adjacency: the oracle's is zeros
        assert got.em is None and not want.em.any(), tag
    else:
        assert _same_array(got.em, want.em), tag


def _plan_kinds(ctx, plan_bursts):
    """What the single-query groups of these bursts exercise."""
    kinds = set()
    for _, burst in plan_bursts:
        if burst is None:
            continue
        tid, el, attrs, b, q_pos, mvec, epm, groups = burst
        singles = [q_pos.index(g[0]) for g in groups if len(g) == 1]
        if singles and len(singles) < len(groups):
            kinds.add("mixed")
        if singles and not mvec[singles].any():
            kinds.add("unmatched burst")
        for j in singles:
            qi = q_pos[j]
            if not mvec[j].any():
                kinds.add("unmatched")
            elif epm[j] is not None:
                kinds.add("edge-masked")
            elif not ctx.kleene_flag[qi, el]:
                kinds.add("trivial")
            elif b > DENSE_B_MAX:
                kinds.add("kleene b > DENSE_B_MAX")
            elif mvec[j].all():
                kinds.add("dense")
            else:
                kinds.add("masked")
    return kinds


def _hbench_case(name):
    """A benchmark configuration (``hbench/configs/``) over one small
    segment of its stream, under the benchmark's policy."""
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from hbench import drivers

    cfg = json.loads((root / "hbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["events_per_group_minute"] = 200
    mix = {"districts": 2, "micro_batch": 16}
    wl = drivers._workload(cfg)
    t_end = drivers.segment_ticks(cfg, mix)
    batch = drivers._batch(wl, drivers.cell_stream(cfg, mix, 2**31 + 3, 0,
                                                   t_end / 60))
    return wl, batch, t_end, DynamicPolicy()


def _chain_case(pred):
    """``chain_wl`` never shared, over B bursts of 600 and 3 events (both
    sides of ``DENSE_B_MAX``); with ``pred`` both queries take only
    ``v > 5``, which no event meets."""
    from repro.core.query import Pred

    preds = {"B": [Pred("v", ">", 5.0)]} if pred else None
    wl = Workload(SCHEMA, [
        Query("q1", Seq(A, Kleene(B)), aggs=(count_star(), agg_sum("B", "v")),
              preds=preds, within=40, slide=20),
        Query("q2", Kleene(B), preds=preds, within=40, slide=20),
    ])
    types = np.array([0] + [1] * 600 + [0] + [1] * 3 + [0], dtype=np.int32)
    time = np.minimum(np.arange(1, len(types) + 1), 19)
    vals = np.random.default_rng(4).uniform(0.5, 2.0, (len(types), 1))
    return (port_wl(wl), port_stream(RefBatch(SCHEMA, types, time, vals)),
            40, NeverShare())


STACKED_CASES = {
    "smarthome-w1": ({"trivial", "unmatched"}, _hbench_case),
    "ridesharing-w1": ({"trivial", "masked", "mixed"}, _hbench_case),
    "stock-trends": ({"trivial", "edge-masked", "mixed"}, _hbench_case),
    "chain": ({"trivial", "dense", "kleene b > DENSE_B_MAX"},
              lambda _: _chain_case(False)),
    "chain-unmatched": ({"trivial", "unmatched burst"},
                        lambda _: _chain_case(True)),
}


@pytest.mark.parametrize("case", list(STACKED_CASES))
def test_stacked_singles_equal_plan_group(case, monkeypatch):
    """Each pane's step list, with a burst's single-query groups planned in
    one stacked pass, equals the one ``_plan_group`` builds a group at a
    time: the same steps in the same order, each plan field for field
    (a trivial plan's unread adjacency aside), and the same ``RunStats``
    increments; ``stacked_graphlets`` counts the single-query groups."""
    want_kinds, make = STACKED_CASES[case]
    wl, batch, t_end, policy = make(case)
    seen = []
    build = PaneProcessor._build_steps

    def capture(self, plan_bursts, stats):
        seen.append((self, plan_bursts))
        return build(self, plan_bursts, stats)

    monkeypatch.setattr(PaneProcessor, "_build_steps", capture)
    HamletRuntime(wl, policy=policy, backend="np", micro_batch=4).run(
        batch, t_end)
    assert seen
    kinds = set()
    for n, (proc, plan_bursts) in enumerate(seen):
        kinds |= _plan_kinds(proc.ctx, plan_bursts)
        got_stats, want_stats = RunStats(), RunStats()
        got = build(proc, plan_bursts, got_stats)
        want = _oracle_steps(proc, plan_bursts, want_stats)
        assert [type(s) for s in got] == [type(s) for s in want], (case, n)
        for i, (a, w) in enumerate(zip(got, want)):
            if isinstance(a, _NegStep):
                assert a.hits == w.hits, (case, n, i)
            else:
                _assert_plan_equal(a, w, (case, n, i))
        singles = sum(len(g) == 1 for _, burst in plan_bursts
                      if burst is not None for g in burst[-1])
        assert got_stats.stacked_graphlets == singles, (case, n)
        got_stats.stacked_graphlets = 0
        assert got_stats == want_stats, (case, n)
    assert want_kinds <= kinds, (case, kinds)


def test_stacked_graphlets_counted_without_observability(monkeypatch):
    """``RunStats.stacked_graphlets`` is counted with no ``Observability``
    attached, and equals the single-query groups the plan walk built."""
    wl, stream, t_end = named_case("ridesharing")
    singles = []
    build = PaneProcessor._build_steps

    def capture(self, plan_bursts, stats):
        singles.append(sum(len(g) == 1 for _, burst in plan_bursts
                           if burst is not None for g in burst[-1]))
        return build(self, plan_bursts, stats)

    monkeypatch.setattr(PaneProcessor, "_build_steps", capture)
    rt = HamletRuntime(port_wl(wl), micro_batch=4, **DEV)
    rt.run(port_stream(stream), t_end)
    s = rt.stats
    assert s.stacked_graphlets == sum(singles) > 0
    assert s.stacked_graphlets == s.graphlets - s.shared_graphlets
