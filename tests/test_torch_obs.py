"""The port's observability layer against the JAX package's, on the CPU:
the engine contracts of ``tests/test_obs.py``.

* attaching ``Observability()``, ``Observability.disabled()`` or nothing
  leaves the port's results bitwise equal, at K = 1 and 4;
* the item-2 gate: on the four named workloads the sharing-decision audit
  log (every entry, ``pane_key_groups()``, the summary) and the plan-cache
  hit/miss counts equal the reference's on the same inputs;
* the trace exports as Chrome-trace JSONL with balanced spans, its phase
  spans sum to the ``RunStats`` timers, and ``jsonl_to_chrome`` round
  trips it;
* ``collect()`` has the reference's keys, and takes any object with a
  ``summary()`` for the layers the port does not have yet.
"""

import json

import pytest

from benchmarks.common import kleene_workload
from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.optimizer import FlopPolicy as RefFlopPolicy
from repro.obs import Observability as RefObservability
from repro.streams import generator as RG
from repro_torch import interop
from repro_torch.core.engine import HamletRuntime, vals_equal
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
def test_audit_and_plan_cache_match_reference(name):
    """Every audit entry, the per-pane key groups, the audit summary and
    the plan-cache hit/miss counts equal the reference's."""
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
    assert rt.plan_cache_stats() == ref_rt.plan_cache_stats()
    for k in ("plan_cache_hits", "plan_cache_misses", "decisions"):
        assert getattr(rt.stats, k) == getattr(ref_rt.stats, k), (name, k)
    assert rt.stats.plan_cache_misses > 0


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
        obs.cache_event(True, (0, 0))
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
    assert got.keys() == want.keys()
    for k in ("engine", "executors", "plan_cache", "audit", "trace"):
        assert got[k].keys() == want[k].keys(), k
    assert got["metrics"].keys() == want["metrics"].keys()
    assert got["plan_cache"] == want["plan_cache"]
    assert got["audit"] == want["audit"]
    assert got["engine"]["panes"] == rt.stats.panes
    # the layers the port has not got: anything with a summary()
    more = obs.collect(overload=_Summary({"shed": 1}),
                       eventtime=_Summary({"lag": 2}),
                       serving={"sessions": 3})
    assert more["overload"] == {"shed": 1}
    assert more["eventtime"] == {"lag": 2}
    assert more["serving"] == {"sessions": 3}
