"""The port's observability layer against the JAX package's, on the CPU:
the engine contracts of ``tests/test_obs.py``.

* attaching ``Observability()``, ``Observability.disabled()`` or nothing
  leaves the port's results bitwise equal, at K = 1 and 4;
* the item-2 gate: on the four named workloads the sharing-decision audit
  log (every entry, ``pane_key_groups()``, the summary) and the decision
  count equal the reference's on the same inputs;
* the trace exports as Chrome-trace JSONL with balanced spans, its phase
  spans sum to the ``RunStats`` timers, and ``jsonl_to_chrome`` round
  trips it;
* ``collect()`` has the reference's keys (with the port's step clocks,
  and without the reference's plan-cache views), and takes any object
  with a ``summary()`` for the layers the port does not have yet;
* the port's own step clocks and spans (``RunStats.STEP_FIELDS``): plan's
  lie inside ``plan_s``, execute's and finalize's tile their phase, the
  streaming layer's ingress and admission are phases of their own, the
  collector's pauses are counted only while attached, a flush of K > 1
  panes is one measured phase span, and ``Tracer.unix_ns`` places a span
  on ``torch.profiler``'s clock.
"""

import gc
import json
import time

import pytest

from benchmarks.common import kleene_workload
from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.optimizer import FlopPolicy as RefFlopPolicy
from repro.obs import Observability as RefObservability
from repro.streams import generator as RG
from repro_torch import interop
from repro_torch.core.engine import HamletRuntime, RunStats, vals_equal
from repro_torch.core.optimizer import DynamicPolicy, FlopPolicy
from repro_torch.obs import (PHASES, NULL_SPAN, Observability,
                             SharingAuditLog, SharingDecision, Tracer,
                             jsonl_to_chrome)

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


def named_case(name, epm=250, minutes=2, n_queries=4):
    """``tests/test_obs.py``'s named case, as reference objects."""
    wl = kleene_workload(SCHEMAS[name], n_queries, **SHAPES[name], within=60,
                         slide=30)
    stream = RG.NAMED_STREAMS[name](events_per_minute=epm, minutes=minutes,
                                    seed=13)
    t_end = ((int(stream.time.max()) + 30) // 30) * 30
    return wl, stream, t_end


def port_case(name):
    wl, stream, t_end = named_case(name)
    c = interop.stream_columns(stream)
    pst = interop.batch_from(
        interop.schema_from(c["types"], c["attr_names"]), c["type_id"],
        c["time"], c["attrs"], c["group"], c["seq"])
    return interop.workload_from(interop.workload_spec(wl)), pst, t_end


def assert_bitwise(a, b, tag):
    assert a.keys() == b.keys(), tag
    for k in a:
        assert vals_equal(a[k], b[k]), (tag, k)


# ------------------------------------------------- read-only: obs on == off


def test_obs_bitwise_engine():
    wl, stream, t_end = port_case("ridesharing")
    want = HamletRuntime(wl, **DEV).run(stream, t_end)
    for mk, K in ((Observability, 1), (Observability.disabled, 1),
                  (Observability, 4), (Observability.disabled, 4),
                  (lambda: None, 4)):
        got = HamletRuntime(wl, obs=mk(), micro_batch=K, **DEV).run(
            stream, t_end)
        assert_bitwise(got, want, (K, mk))


# ------------------------------------------------ item-2 gate: the audit log


@pytest.mark.parametrize("name", list(SHAPES))
def test_audit_matches_reference(name):
    """Every audit entry, the per-pane key groups, the audit summary and
    the decision count equal the reference's."""
    wl, stream, t_end = named_case(name)
    pwl, pst, _ = port_case(name)
    ref_obs, obs = RefObservability(), Observability()
    ref_rt = RefRuntime(wl, obs=ref_obs)
    ref_rt.run(stream, t_end)
    rt = HamletRuntime(pwl, obs=obs, **DEV)
    rt.run(pst, t_end)
    want = [e.to_dict() for e in ref_obs.audit.entries()]
    got = [e.to_dict() for e in obs.audit.entries()]
    assert want and got == want, name
    assert obs.audit.pane_key_groups() == ref_obs.audit.pane_key_groups()
    assert obs.audit.summary() == ref_obs.audit.summary()
    assert rt.stats.decisions == ref_rt.stats.decisions > 0, name


def test_audit_benefits_match_reference():
    """FlopPolicy records a cost-model benefit with each decision; the
    port's equal the reference's bit for bit."""
    wl, stream, t_end = named_case("ridesharing")
    pwl, pst, _ = port_case("ridesharing")
    ref_obs, obs = RefObservability(), Observability()
    RefRuntime(wl, policy=RefFlopPolicy(), obs=ref_obs).run(stream, t_end)
    HamletRuntime(pwl, policy=FlopPolicy(), obs=obs, **DEV).run(pst, t_end)
    got = [e.benefit for e in obs.audit.entries()]
    assert got == [e.benefit for e in ref_obs.audit.entries()]
    assert all(b is not None for b in got)


def test_audit_export_jsonl(tmp_path):
    wl, stream, t_end = port_case("ridesharing")
    obs = Observability()
    HamletRuntime(wl, policy=DynamicPolicy(), obs=obs, **DEV).run(stream,
                                                                  t_end)
    path = tmp_path / "audit.jsonl"
    n = obs.audit.export_jsonl(path)
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(rows) == n == len(obs.audit.entries()) > 0
    assert rows == [e.to_dict() for e in obs.audit.entries()]
    assert all(isinstance(e, SharingDecision) for e in obs.audit.entries())


def test_audit_flip_and_share_counting():
    log = SharingAuditLog(capacity=4)
    g1, g2 = ((0, 1),), ((0,), (1,))
    log.record(pane=(0, 0), comp=0, el=0, candidates=(0, 1), decided=g1)
    log.record(pane=(0, 5), comp=0, el=0, candidates=(0, 1), decided=g1)
    log.record(pane=(0, 10), comp=0, el=0, candidates=(0, 1), decided=g2)
    assert log.flips == 1
    assert log.shared_decisions == 2 and log.split_decisions == 1
    for i in range(10):
        log.record(pane=(0, i), comp=0, el=0, candidates=(0, 1), decided=g1)
    assert len(log.entries()) == 4
    assert log.dropped > 0 and log.summary()["decisions"] == 13


# -------------------------------------------------------- trace contracts


def test_trace_jsonl_schema_roundtrip(tmp_path):
    wl, stream, t_end = port_case("ridesharing")
    obs = Observability()
    rt = HamletRuntime(wl, obs=obs, micro_batch=4, **DEV)
    rt.run(stream, t_end)
    path = tmp_path / "trace.jsonl"
    n = obs.export_trace(path)
    evs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(evs) == n > 0
    depth = 0
    for ev in evs:
        assert {"ph", "name", "cat", "ts", "pid", "tid"} <= ev.keys()
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
        elif ev["ph"] == "B":
            depth += 1
        elif ev["ph"] == "E":
            depth -= 1
        assert depth >= 0
    assert depth == 0
    names = {e["name"] for e in evs if e["ph"] == "X" and e["cat"] == "phase"}
    assert set(PHASES) <= names
    dst = tmp_path / "trace.json"
    assert jsonl_to_chrome(path, dst) == n
    assert len(json.loads(dst.read_text())["traceEvents"]) == n
    # the phase spans are the RunStats timers' own readings
    assert obs.tracer.dropped == 0
    totals = obs.phase_totals()
    for ph in PHASES:
        stat = getattr(rt.stats, f"{ph}_s")
        assert abs(totals.get(ph, 0.0) - stat) <= 0.05 * stat + 1e-9, ph


def test_disabled_tracer_is_noop():
    obs = Observability.disabled()
    assert not obs.tracing and obs.audit is None
    with obs.span("flush"):
        obs.lifecycle("ingest", (0, 0))
        obs.lifecycle("emit", (0, 0), args={"w0": 0})
    assert len(obs.tracer) == 0
    obs.count("x")
    assert obs.registry.collect()["x"] == 1
    assert Tracer(capacity=0).span("x") is NULL_SPAN


# --------------------------------------------------------------- collect()


class _Summary:
    def __init__(self, d):
        self.d = d

    def summary(self):
        return self.d


def test_collect_keys_match_reference():
    wl, stream, t_end = named_case("ridesharing")
    pwl, pst, _ = port_case("ridesharing")
    ref_obs, obs = RefObservability(), Observability()
    ref_rt = RefRuntime(wl, obs=ref_obs, micro_batch=4)
    ref_rt.run(stream, t_end)
    # the numpy backend on both sides: the device backends add series of
    # their own (``fold_exec.scan_launches``)
    rt = HamletRuntime(pwl, obs=obs, micro_batch=4, backend="np")
    rt.run(pst, t_end)
    want = ref_obs.collect(stats=ref_rt.stats, runtime=ref_rt)
    got = obs.collect(stats=rt.stats, runtime=rt)
    # the reference's own: its plan cache's view and counters, and its
    # fold executor's flush-plan series (the port keeps no such memo)
    ref_only = {"plan_cache"}
    ref_only_engine = {"plan_cache_hits", "plan_cache_misses"}
    ref_only_metrics = {f"fold_exec.flush_plan.{k}"
                        for k in ("hits", "misses", "evictions")}
    assert got.keys() == want.keys() - ref_only
    assert ref_only <= want.keys()
    for k in ("executors", "audit", "trace"):
        assert got[k].keys() == want[k].keys(), k
    # the port's step clocks, its count of fresh sharing decisions, its
    # event-level snapshot counters, its count of flushes drained with
    # the collector held off, its count of graphlets the stacked pass
    # planned, its negation-gate and fold-round counters, its fold
    # executor's divergent-graphlet and flush counters, and its counts of
    # Kleene burst rows, of windows past 2^512 and of the cells of wide
    # propagation problems are its own RunStats fields
    assert ref_only_engine <= want["engine"].keys()
    assert got["engine"].keys() == \
        (want["engine"].keys() - ref_only_engine) | set(RunStats.STEP_FIELDS) \
        | {"decide_evals", "edge_mask_cells", "shared_rows", "snapshot_rows",
           "gc_held_flushes", "stacked_graphlets", "neg_gates",
           "neg_rounds", "fold_rounds", "div_graphlets", "div_collapsed",
           "fold_flushes", "scan_flushes", "kleene_rows",
           "long_kleene_rows", "large_count_windows",
           "wide_propagate_cells"}
    assert "fold_exec.flush_plan.misses" in want["metrics"]
    assert got["metrics"].keys() == want["metrics"].keys() - ref_only_metrics
    assert got["audit"] == want["audit"]
    assert got["engine"]["panes"] == rt.stats.panes
    # the layers the port has not got: anything with a summary()
    more = obs.collect(overload=_Summary({"shed": 1}),
                       eventtime=_Summary({"lag": 2}),
                       serving={"sessions": 3})
    assert more["overload"] == {"shed": 1}
    assert more["eventtime"] == {"lag": 2}
    assert more["serving"] == {"sessions": 3}


# ------------------------------------------------ step clocks and spans


def _step_run(K, obs=None, policy=DynamicPolicy):
    wl, stream, t_end = port_case("ridesharing")
    obs = Observability() if obs is None else obs
    rt = HamletRuntime(wl, policy=policy(), obs=obs, micro_batch=K, **DEV)
    res = rt.run(stream, t_end)
    rt.run(stream, t_end)        # a second run on the same runtime
    return rt, obs, res


@pytest.mark.parametrize("K", [1, 4])
def test_step_clocks_nest_in_their_phases(K):
    """Every step field is >= 0; plan's three steps lie inside ``plan_s``;
    execute's and finalize's three each tile their phase to within 5%."""
    rt, obs, _ = _step_run(K)
    s = rt.stats
    for f in RunStats.STEP_FIELDS:
        assert getattr(s, f) >= 0, f
    assert 0 < s.plan_prologue_s + s.plan_decide_s + s.plan_build_s \
        <= s.plan_s
    for phase, steps in (("execute", ("stage", "launch", "wait")),
                         ("finalize", ("prep", "rounds", "wait"))):
        total = getattr(s, f"{phase}_s")
        tiled = sum(getattr(s, f"{phase}_{st}_s") for st in steps)
        assert abs(tiled - total) <= 0.05 * total, (phase, tiled, total)
    # the torch backend hands the card's share to the device it was given
    assert s.execute_h2d_bytes > 0 and s.execute_d2h_bytes > 0
    assert obs.tracer.dropped == 0
    steps = {e["name"] for e in obs.tracer.events() if e["cat"] == "step"}
    assert {"plan.prologue", "plan.decide", "plan.build", "execute.stage",
            "execute.launch", "execute.wait", "finalize.prep",
            "finalize.rounds", "finalize.wait"} <= steps


@pytest.mark.parametrize("policy", [DynamicPolicy, FlopPolicy])
def test_plan_decide_clock_under_dynamic_policies(policy):
    """The share/not-share decisions are timed under either policy: the
    pattern path under ``DynamicPolicy``, the divergence rows under
    ``FlopPolicy``, each pane's decisions one ``plan.decide`` span."""
    rt, obs, _ = _step_run(1, policy=policy)
    assert rt.stats.plan_decide_s > 0
    decide = [e for e in obs.tracer.events() if e["name"] == "plan.decide"]
    assert decide


def test_step_clocks_only_when_attached():
    rt, _, _ = _step_run(4, obs=Observability.disabled())
    assert rt.stats.execute_launch_s > 0 and rt.stats.plan_build_s > 0
    wl, stream, t_end = port_case("ridesharing")
    bare = HamletRuntime(wl, micro_batch=4, **DEV)
    bare.run(stream, t_end)
    assert all(getattr(bare.stats, f) == 0 for f in RunStats.STEP_FIELDS)


def test_gc_pauses_counted_while_attached():
    """A forced full collection inside an attached run is counted (and
    spanned); the hook goes on ``detach`` and with a freed facade."""
    gc.collect()
    n0 = len(gc.callbacks)
    wl, stream, t_end = port_case("ridesharing")
    obs = Observability()
    rt = HamletRuntime(wl, obs=obs, **DEV)
    assert len(gc.callbacks) == n0 + 1
    rt.run(stream, t_end)
    g0 = rt.stats.gc_collections
    gc.collect()
    assert rt.stats.gc_s > 0 and rt.stats.gc_collections > g0
    assert any(e["name"] == "gc" and e["cat"] == "step"
               for e in obs.tracer.events())
    obs.detach()
    assert len(gc.callbacks) == n0
    n1 = rt.stats.gc_collections
    gc.collect()
    assert rt.stats.gc_collections == n1
    # a facade that is freed takes its hook with it
    HamletRuntime(wl, obs=Observability(), **DEV)
    gc.collect()
    assert len(gc.callbacks) == n0


def test_trace_read_while_a_collector_hook_records():
    """A collector hook may record a span at any allocation, also while
    the trace is being read (the ``gc`` span of a full pass): reading
    never fails for it."""
    rt, obs, _ = _step_run(1)
    n0 = len(obs.tracer)

    def hook(phase, info):
        if phase == "stop":
            obs.tracer.complete("probe", time.perf_counter(), 0.0,
                                cat="step")

    old = gc.get_threshold()
    gc.callbacks.append(hook)
    try:
        gc.set_threshold(1, 1, 1)
        evs = obs.tracer.events()
        totals = obs.phase_totals()
    finally:
        gc.set_threshold(*old)
        gc.callbacks.remove(hook)
    obs.detach()
    assert len(evs) > n0 and totals["plan"] > 0
    assert len(obs.tracer) > n0


def test_flush_phase_spans_are_measured_at_k4():
    """At K = 4 each flush has exactly one span a phase on the engine
    track, listing its panes; no per-pane phase span is made up, and the
    spans still sum to the RunStats timers."""
    rt, obs, _ = _step_run(4)
    evs = obs.tracer.events()
    flushes = [e["args"]["flush"] for e in evs
               if e["ph"] == "B" and e["name"] == "flush"]
    for ph in ("plan", "execute", "finalize"):
        spans = [e for e in evs if e["ph"] == "X" and e["cat"] == "phase"
                 and e["name"] == ph]
        assert sorted(e["args"]["flush"] for e in spans) == flushes, ph
        assert all(e["tid"] == 0 and e["args"]["panes"] == 4
                   and len(e["args"]["pane_keys"]) == 4 for e in spans)
    totals = obs.phase_totals()
    for ph in PHASES:
        stat = getattr(rt.stats, f"{ph}_s")
        assert abs(totals[ph] - stat) <= 0.05 * stat, ph
    # every step span of a flush carries its id
    assert all(e["args"]["flush"] in set(flushes) for e in evs
               if e["cat"] == "step" and e["name"] != "gc")


def _overload(K, obs):
    from repro_torch.overload import OverloadConfig, OverloadRuntime

    wl, stream, t_end = port_case("ridesharing")
    cfg = OverloadConfig(shed_policy="none", micro_batch=K)
    ort = OverloadRuntime(wl, cfg, obs=obs, **DEV)
    return ort, ort.run(stream, t_end)


@pytest.mark.parametrize("K", [1, 4])
def test_overload_bitwise_and_its_host_phases(K):
    """The streaming layer's results are bitwise the same with either
    facade or none; with one, ``offer`` is the ``ingress`` phase and the
    admission the ``admit`` phase, disjoint from the pipeline's."""
    _, want = _overload(K, None)
    _, got = _overload(K, Observability.disabled())
    assert_bitwise(got, want, K)
    obs = Observability()
    ort, got = _overload(K, obs)
    assert_bitwise(got, want, K)
    st = ort.stats
    assert st.ingress_s > 0 and st.admit_s > 0
    spans = [e for e in obs.tracer.events()
             if e["ph"] == "X" and e["cat"] == "phase"]
    totals = obs.phase_totals()
    assert abs(totals["ingress"] - st.ingress_s) <= 1e-9 + 1e-6 * st.ingress_s
    assert abs(totals["admit"] - st.admit_s) <= 1e-9 + 1e-6 * st.admit_s
    top = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                 if e["tid"] == 0)
    assert all(b0 <= a1 + 1e-3 for (_, b0), (a1, _) in zip(top, top[1:]))


def test_host_phase_from_many_threads_loses_nothing():
    """A pipelined flush admits on its worker thread while the caller
    admits the next pane: both add to ``admit_s``, and no update is lost."""
    import sys
    import threading

    obs = Observability.disabled()
    st = RunStats()
    n_threads, n_calls = 16, 2000

    def work():
        for _ in range(n_calls):
            obs.host_phase("admit", "admit_s", st, 0.0, 1.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert st.admit_s == n_threads * n_calls


def test_clock_sync_and_epoch_export(tmp_path):
    tr = Tracer()
    t0 = time.perf_counter()
    tr.complete("x", t0, 0.001)
    evs = tr.events()
    sync = evs[0]
    assert sync["ph"] == "M" and sync["name"] == "clock_sync"
    assert abs(tr.unix_ns(evs[1]["ts"]) - time.time_ns()) < 5e8
    path = tmp_path / "t.jsonl"
    assert tr.export_jsonl(path, epoch_ns=0) == 2
    ep = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert ep[1]["ts"] == pytest.approx(tr.unix_ns(evs[1]["ts"]) / 1e3,
                                        abs=1.0)
    assert ep[0]["args"] == sync["args"]


def test_unix_ns_maps_a_span_onto_the_profiler_clock():
    """A ``record_function`` range opened inside a program span lies,
    through ``Tracer.unix_ns``, inside that span on the CPU profiler's
    clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        time.sleep(0.005)
        with record_function("inside"):
            time.sleep(0.005)
        time.sleep(0.005)
        tr.complete("outer", t0, time.perf_counter() - t0)
    (ev,) = [e for e in tr.events() if e["name"] == "outer"]
    lo, hi = tr.unix_ns(ev["ts"]), tr.unix_ns(ev["ts"] + ev["dur"])
    (rf,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inside"]
    assert lo < rf.start_ns() < rf.start_ns() + rf.duration_ns() < hi
