"""The port's overload subsystem against the JAX package's, on the CPU.

Every scenario of ``tests/test_overload.py`` named below runs three times
on the same inputs, made from numpy seeds and carried across with
``repro_torch.interop``: through the reference (its numpy backend, as its
own tests run it), through the port on ``backend="np"`` and through the
port on ``backend="torch", device="cpu"`` (the kernels' plain versions).

* controller trajectories, shed plans (the kept and shed index sets of
  every pane), ingress counters and batches, per-pane metrics, the error
  accountant's cells and ``QueryErrorReport``s: equal **bitwise** on both
  port backends (they are host numpy and do not depend on the backend);
* windows: np against the reference bitwise (``vals_equal``), torch against
  it with COUNT exact, SUM/AVG within rtol 1e-12 and the non-finite pattern
  equal;
* within the port: a pipelined flush and micro batches K > 1 give the
  inline K = 1 results under fixed shedding, and every timed flush reaches
  its host fetch before the clock is read again.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.events import EventBatch, StreamSchema
from repro.core.pattern import EventType, Kleene, Not, Seq
from repro.core.query import Pred, Query, Workload
from repro.core.service import HamletService as RefService
from repro.overload import BenefitWeighted as RefBenefitWeighted
from repro.overload import DropTail as RefDropTail
from repro.overload import IngressQueue as RefIngressQueue
from repro.overload import LatencyController as RefController
from repro.overload import OverloadConfig as RefOverloadConfig
from repro.overload import OverloadRuntime as RefOverloadRuntime
from repro.overload import RandomShed as RefRandomShed
from repro.overload import TypeProfile as RefTypeProfile
from repro_torch import interop
from repro_torch.core.engine import HamletRuntime, vals_equal
from repro_torch.core.service import HamletService
from repro_torch.kernels import ops
from repro_torch.overload import (BenefitWeighted, DropTail, IngressQueue,
                                  LatencyController, OverloadConfig,
                                  OverloadRuntime, RandomShed, TypeProfile)

SCHEMA = StreamSchema(types=("A", "B", "C", "D"), attrs=("v",))
A, B, C, D = map(EventType, "ABCD")
BACKENDS = [("np", None), ("torch", "cpu")]


def port_wl(wl):
    return interop.workload_from(interop.workload_spec(wl))


def port_stream(batch):
    c = interop.stream_columns(batch)
    return interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                              c["type_id"], c["time"], c["attrs"], c["group"],
                              c["seq"])


class Pkg:
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

    def config(self, **kw):
        return (RefOverloadConfig if self.ref else OverloadConfig)(**kw)

    def runtime(self, wl, **kw):
        return (RefRuntime if self.ref else HamletRuntime)(
            self.wl(wl), **self.kw, **kw)

    def overload(self, wl, cfg, cls=None, **kw):
        cls = cls or (RefOverloadRuntime if self.ref else OverloadRuntime)
        return cls(self.wl(wl), self.config(**cfg), **self.kw, **kw)

    def service(self, qs, **kw):
        wl = self.wl(Workload(SCHEMA, qs))
        if "overload" in kw:
            kw["overload"] = self.config(**kw["overload"])
        if "eventtime" in kw:
            from repro.eventtime import EventTimeConfig as RefETC
            from repro_torch.eventtime import EventTimeConfig as ETC
            kw["eventtime"] = (RefETC if self.ref else ETC)(**kw["eventtime"])
        return (RefService if self.ref else HamletService)(
            wl.schema, wl.queries, **self.kw, **kw)


REF = Pkg()
PORTS = [Pkg(b, d) for b, d in BACKENDS]
port_ids = [b for b, _ in BACKENDS]


def _wl(with_not=True):
    qs = [Query("q1", Seq(A, Kleene(B)), within=10, slide=5),
          Query("q2", Kleene(B), within=10, slide=10)]
    if with_not:
        qs.append(Query("q3", Seq(A, Kleene(B), Not(C)), within=10, slide=10))
    return Workload(SCHEMA, qs)


def _stream(n=120, t_max=40, seed=0, groups=2, p=(0.15, 0.6, 0.1, 0.15)):
    rng = np.random.default_rng(seed)
    types = rng.choice(4, n, p=list(p)).astype(np.int32)
    times = np.sort(rng.integers(0, t_max, n))
    attrs = rng.integers(0, 5, (n, 1)).astype(float)
    return EventBatch(SCHEMA, types, times, attrs,
                      rng.integers(0, groups, n))


def assert_windows(got, want, tag, exact):
    """``exact``: every window ``vals_equal``; else COUNT exact, other
    aggregates within rtol 1e-12, the non-finite pattern equal."""
    assert got.keys() == want.keys(), tag
    for k, w in want.items():
        g = got[k]
        if exact:
            assert vals_equal(g, w), (tag, k, g, w)
            continue
        assert g.keys() == w.keys(), (tag, k)
        for a, wv in w.items():
            gv = g[a]
            assert type(gv) is float, (tag, k, a)
            if not math.isfinite(wv):
                assert (math.isnan(gv) and math.isnan(wv)) or gv == wv, \
                    (tag, k, a, gv, wv)
            elif a.startswith("COUNT"):
                assert gv == wv, (tag, k, a, gv, wv)
            else:
                assert math.isclose(gv, wv, rel_tol=1e-12), (tag, k, a, gv, wv)


def record_plans(shedder) -> list:
    """Wrap ``shedder.plan`` to log every plan's kept/shed index sets."""
    log = []
    if shedder is None:
        return log
    plan = shedder.plan

    def logged(pane, keep_n):
        p = plan(pane, keep_n)
        log.append((p.keep.tolist(), p.shed.tolist(), p.witnessed))
        return p
    shedder.plan = logged
    return log


def accountant_state(acc) -> tuple:
    """The accountant cell by cell, its taints, totals and reports."""
    return ({k: list(v) for k, v in acc._shed.items()}, set(acc._tainted),
            acc.total_shed, acc.late_events,
            {n: dataclasses.astuple(r) for n, r in acc.report().items()})


def metrics_state(metrics) -> list:
    """Per-pane counts and shed ratios (the wall-clock times excluded)."""
    return [(p.t0, p.offered, p.admitted, p.shed, p.shed_ratio, p.late)
            for p in metrics.panes]


# ---------------------------------------------------------------- controller


def _plant(ctl_cls, load_x):
    slo = 20.0
    rng = np.random.default_rng(int(load_x * 10))
    ctl = ctl_cls(slo_ms=slo)
    hist, ratios = [], []
    for _ in range(200):
        proc = ((1.0 - ctl.shed_ratio) * load_x * slo
                * (1.0 + 0.1 * rng.standard_normal()))
        ratios.append(ctl.update(max(proc, 0.0)))
        hist.append(proc)
    return ctl, hist, ratios


@pytest.mark.parametrize("load_x", [1.5, 2.0, 4.0])
def test_controller_converges_on_sustained_overload(load_x):
    ctl, hist, ratios = _plant(LatencyController, load_x)
    _, _, want = _plant(RefController, load_x)
    assert ratios == want
    tail = hist[-50:]
    assert abs(np.mean(tail) - 20.0) < 0.15 * 20.0
    assert abs(ctl.shed_ratio - (1 - 1 / load_x)) < 0.1
    assert not ctl.state()["saturated"]


def _drive(ctl, trace):
    return [ctl.update(lat, revision_load=rev) for lat, rev in trace]


@pytest.mark.parametrize("case", ["idle", "fixed", "burst", "storm",
                                  "storm_off", "steer"])
def test_controller_trajectories_match_reference(case):
    """``test_controller_idle_never_sheds``, ``_fixed_ratio_bypasses_
    feedback``, ``_recovers_after_burst``, ``test_revision_storm_raises_
    shed_ratio`` and ``test_revision_load_steers_alongside_latency``: the
    same observations give the same shed ratios, bitwise."""
    kw, trace = {
        "idle": ({}, [(10.0, 0.0)] * 100),
        "fixed": ({"fixed": 0.4}, [(5.0, 0.0), (500.0, 0.0)]),
        "burst": ({}, [(100.0, 0.0)] * 30 + [(5.0, 0.0)] * 100),
        "storm": ({"kr": 0.5}, [(20.0, 2.0)] * 10 + [(10.0, 0.0)] * 60),
        "storm_off": ({"kr": 0.0}, [(20.0, 2.0)] * 10),
        "steer": ({"kr": 0.3}, [(25.0, 1.5)] * 15),
    }[case]
    got = _drive(LatencyController(slo_ms=20.0, **kw), trace)
    assert got == _drive(RefController(slo_ms=20.0, **kw), trace)
    if case == "idle":
        assert got[-1] == 0.0
    elif case == "fixed":
        assert got == [0.4, 0.4]
    elif case == "burst":
        assert got[29] > 0.3 and got[-1] < 0.05
    elif case == "storm":
        assert got[9] > 0.2 and got[-1] < 0.05
    elif case == "storm_off":
        assert got[-1] == 0.0
    else:
        calm = _drive(LatencyController(slo_ms=20.0, kr=0.3),
                      [(25.0, 0.0)] * 15)
        assert got[-1] > calm[-1]


def test_controller_from_config_and_validation():
    cfg = OverloadConfig(slo_ms=30.0, kp=0.2, ki=0.01, kr=0.4,
                         fixed_shed=0.25, max_shed=0.9)
    ctl = LatencyController.from_config(cfg)
    ref = RefController.from_config(RefOverloadConfig(
        slo_ms=30.0, kp=0.2, ki=0.01, kr=0.4, fixed_shed=0.25, max_shed=0.9))
    assert ctl.state() == ref.state()
    with pytest.raises(ValueError):
        LatencyController(slo_ms=0.0)
    for bad in ({"shed_policy": "nope"}, {"low_watermark": 0.9},
                {"fixed_shed": 1.0}, {"micro_batch": 0}, {"kr": -1.0}):
        with pytest.raises(ValueError):
            OverloadConfig(**bad)
    assert dataclasses.asdict(OverloadConfig()) == dataclasses.asdict(
        RefOverloadConfig())


# ------------------------------------------------------------------ policies


def _plan_pair(port_pol, ref_pol, batch, keep_n):
    got = port_pol.plan(port_stream(batch), keep_n)
    want = ref_pol.plan(batch, keep_n)
    assert got.keep.tolist() == want.keep.tolist()
    assert got.shed.tolist() == want.shed.tolist()
    assert got.witnessed == want.witnessed
    return got


def test_drop_tail_keeps_prefix():
    pane = _stream(n=30)
    plan = _plan_pair(DropTail(), RefDropTail(), pane, 12)
    assert (plan.keep == np.arange(12)).all()
    assert (plan.shed == np.arange(12, 30)).all()
    assert _plan_pair(DropTail(), RefDropTail(), pane, 40).n_shed == 0


def test_random_shed_is_the_reference_sample():
    """The numpy generator seeded as the reference's gives the reference's
    kept sets, pane after pane."""
    pol, ref = RandomShed(seed=3), RefRandomShed(seed=3)
    for seed, keep_n in ((0, 20), (1, 7), (2, 33)):
        plan = _plan_pair(pol, ref, _stream(n=50, seed=seed), keep_n)
        assert plan.n_keep == keep_n and plan.n_shed == 50 - keep_n
        assert (np.diff(plan.keep) > 0).all()


def test_type_profile_classification():
    prof, ref = TypeProfile(port_wl(_wl())), RefTypeProfile(_wl())
    assert prof.critical == ref.critical == {0}
    assert prof.kleene == ref.kleene == {1}
    assert prof.negative == ref.negative == {2}
    assert prof.irrelevant == ref.irrelevant == {3}
    assert prof.kleene_sharers == ref.kleene_sharers
    assert prof.kleene_types_per_q == ref.kleene_types_per_q


@pytest.mark.parametrize("model", ["v1", "v2"])
def test_benefit_weighted_plans_match_reference(model):
    """``test_benefit_weighted_sheds_irrelevant_then_kleene_suffixes``,
    ``_sheds_suffixes_and_keeps_witnesses`` and ``_protects_negation_to_the
    _end``: every shed depth of their panes gives the reference's plan."""
    pol = BenefitWeighted(port_wl(_wl()), min_burst_keep=0.25, model=model)
    ref = RefBenefitWeighted(_wl(), min_burst_keep=0.25, model=model)
    for seed, n in ((1, 80), (2, 100), (4, 60)):
        pane = _stream(n=n, seed=seed)
        for keep_n in range(0, n + 1, 3):
            _plan_pair(pol, ref, pane, keep_n)
    pane = _stream(n=80, seed=1)
    n_irr = int(np.sum(pane.type_id == 3))
    plan = _plan_pair(pol, ref, pane, len(pane) - n_irr)
    assert set(pane.type_id[plan.shed].tolist()) == {3}
    plan = _plan_pair(pol, ref, pane, len(pane) - n_irr - 10)
    assert set(pane.type_id[plan.shed].tolist()) <= {1, 3}
    assert plan.witnessed
    pane = _stream(n=60, seed=4)
    n_neg = int(np.sum(pane.type_id == 2))
    plan = _plan_pair(pol, ref, pane, n_neg)
    assert (pane.type_id[plan.keep] == 2).all()


def test_benefit_weighted_prefers_low_sharing_benefit_bursts():
    wl = Workload(SCHEMA, [
        Query("q1", Seq(A, Kleene(B)), within=10, slide=10),
        Query("q2", Kleene(B), within=10, slide=10),
        Query("q3", Seq(A, Kleene(B), Not(C)), within=10, slide=10),
        Query("q4", Seq(A, Kleene(D)), within=10, slide=10),
    ])
    types = np.array([0] + [1] * 12 + [3] * 12, dtype=np.int32)
    pane = EventBatch(SCHEMA, types, np.arange(len(types), dtype=np.int64),
                      None, np.zeros(len(types)))
    plan = _plan_pair(BenefitWeighted(port_wl(wl), min_burst_keep=0.25),
                      RefBenefitWeighted(wl, min_burst_keep=0.25), pane,
                      len(pane) - 6)
    assert set(pane.type_id[plan.shed].tolist()) == {3}


def test_make_shedder_names():
    from repro_torch.overload import make_shedder

    wl = port_wl(_wl())
    assert make_shedder("none", wl) is None
    assert isinstance(make_shedder("drop_tail", wl), DropTail)
    assert isinstance(make_shedder("random", wl, seed=4), RandomShed)
    assert isinstance(make_shedder("benefit_weighted", wl), BenefitWeighted)
    with pytest.raises(ValueError):
        make_shedder("nope", wl)


# ------------------------------------------------------------- ingress queue


def _queue_script(queue_cls, schema_batch, script):
    """Run ``script`` (a list of ("offer", batch) / ("poll", t)) against a
    fresh queue; return every result and the counters after each step."""
    out = []
    q = None
    for step in script:
        if step[0] == "new":
            q = queue_cls(schema_batch, **step[1])
            continue
        if step[0] == "offer":
            r = q.offer(step[1])
        else:
            got = q.poll_until(step[1])
            r = (got.type_id.tolist(), got.time.tolist(),
                 got.attrs.tolist() if len(got) else [], got.group.tolist())
        out.append((r, q.accepting, q.rejected, q.dropped, q.straddled_late,
                    len(q), q.headroom()))
    return out


@pytest.mark.parametrize("case", ["backpressure", "truncate", "order",
                                  "disordered", "straddle"])
def test_ingress_queue_matches_reference(case):
    """``tests/test_overload.py``'s five ingress tests, step by step against
    the reference's queue."""
    b = _stream(n=60, t_max=30,
                seed={"order": 8, "disordered": 18}.get(case, 19))
    script = {
        "backpressure": [
            ("new", dict(capacity=100, high_watermark=0.8,
                         low_watermark=0.5)),
            ("offer", _stream(n=90, t_max=10, seed=5)),
            ("offer", _stream(n=10, seed=6)), ("poll", 100),
            ("offer", _stream(n=10, seed=6))],
        "truncate": [
            ("new", dict(capacity=50, high_watermark=1.0, low_watermark=0.5)),
            ("offer", _stream(n=80, t_max=10, seed=7)), ("poll", 100)],
        "order": [("new", dict(capacity=1000)),
                  ("offer", b.time_slice(0, 15)),
                  ("offer", b.time_slice(15, 30)), ("poll", 10),
                  ("poll", 100)],
        "disordered": [("new", dict(capacity=1000)),
                       ("offer", b.time_slice(15, 30)),
                       ("offer", b.time_slice(0, 15)), ("poll", 12),
                       ("poll", 100)],
        "straddle": [("new", dict(capacity=1000)),
                     ("offer", b.time_slice(0, 20)), ("poll", 20),
                     ("offer", b), ("poll", 40)],
    }[case]
    port_script = [(s[0], port_stream(s[1])) if s[0] == "offer" else s
                   for s in script]
    got = _queue_script(IngressQueue, port_wl(_wl()).schema, port_script)
    assert got == _queue_script(RefIngressQueue, SCHEMA, script)
    if case == "backpressure":
        assert [r[0] for r in got[:2]] == [90, 0] and got[0][1] is False
        assert got[2][1] is True and got[3][0] == 10
    elif case == "truncate":
        assert got[0][0] == 50 and got[0][3] == 30
    elif case == "disordered":
        assert got[2][4] == 0 and (np.diff(got[2][0][1]) >= 0).all()
    elif case == "straddle":
        assert got[2][4] == int(np.sum(b.time < 20))
        assert len(got[3][0][1]) == len(b)


def test_ingress_queue_takes_concurrent_producers():
    import threading

    q = IngressQueue(port_wl(_wl()).schema, capacity=1 << 14)
    chunks = [port_stream(_stream(n=50, t_max=40, seed=s)) for s in range(8)]
    threads = [threading.Thread(target=q.offer, args=(c,)) for c in chunks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = q.poll_until(100)
    assert len(out) == 400 and (np.diff(out.time) >= 0).all()


# -------------------------------------------------------------------- runtime


def _overload_run(pk, wl, batch, t_end, cfg, **kw):
    ort = pk.overload(wl, cfg, **kw)
    plans = record_plans(ort.shedder)
    res = ort.run(pk.batch(batch), t_end=t_end)
    ort.shutdown()
    return res, ort, plans


def stepped_clock(step_s: float = 1e-3):
    """A deterministic clock that advances ``step_s`` on every read.  The
    live controller then sees the same pane times in every run, whatever
    the host's load; a fresh one for each run gives each the same reads."""
    reads = itertools.count()
    return lambda: next(reads) * step_s


def _held_against_reference(wl, batch, t_end, cfg, make_clock=None, **kw):
    """Run the scenario on the reference and on both port backends; hold
    shed plans, per-pane counts and the accountant bitwise, windows as the
    module docstring says.  ``make_clock`` (e.g. :func:`stepped_clock`)
    gives each run its own clock.  Returns the port runs."""
    def run(pk):
        clock = {} if make_clock is None else {"clock": make_clock()}
        return _overload_run(pk, wl, batch, t_end, cfg, **kw, **clock)

    want, ref, ref_plans = run(REF)
    runs = []
    for pk in PORTS:
        got, ort, plans = run(pk)
        tag = (pk.backend, cfg)
        assert plans == ref_plans, tag
        assert metrics_state(ort.metrics) == metrics_state(ref.metrics), tag
        assert accountant_state(ort.accountant) == \
            accountant_state(ref.accountant), tag
        assert_windows(got, want, tag, exact=pk.backend == "np")
        runs.append((got, ort))
    return want, ref, runs


def test_runtime_without_shedding_matches_batch_engine():
    wl = _wl()
    batch = _stream(n=150, t_max=40, seed=9, groups=3)
    want, _, runs = _held_against_reference(wl, batch, 40,
                                            {"shed_policy": "none"},
                                            make_clock=stepped_clock)
    assert want == RefRuntime(wl).run(batch, t_end=40)
    for pk, (got, ort) in zip(PORTS, runs):
        batch_run = pk.runtime(wl).run(pk.batch(batch), t_end=40)
        assert_windows(got, batch_run, pk.backend, exact=True)
        assert ort.metrics.summary()["shed"] == 0


@pytest.mark.parametrize("policy", ["drop_tail", "random",
                                    "benefit_weighted"])
def test_runtime_fixed_shed_drops_and_stays_subset(policy):
    wl = _wl()
    batch = _stream(n=200, t_max=40, seed=10, groups=2)
    truth = RefRuntime(wl).run(batch, t_end=40)
    _, _, runs = _held_against_reference(
        wl, batch, 40, {"shed_policy": policy, "fixed_shed": 0.5})
    for got, ort in runs:
        s = ort.metrics.summary()
        assert 0.4 <= s["shed_frac"] <= 0.6
        if policy == "benefit_weighted":
            for k, v in truth.items():
                assert got.get(k, {}).get("COUNT(*)", 0.0) <= \
                    v["COUNT(*)"] + 1e-9


def test_runtime_routes_stale_arrivals_to_accountant():
    wl = _wl()
    batch = _stream(n=120, t_max=40, seed=20)
    states = []
    for pk in [REF] + PORTS:
        ort = pk.overload(wl, {"shed_policy": "none"},
                          clock=stepped_clock())
        ort.offer(pk.batch(batch.time_slice(0, 20)))
        for _ in range(4):
            ort.step_pane()
        ort.offer(pk.batch(batch.time_slice(5, 12)))
        ort.offer(pk.batch(batch.time_slice(20, 40)))
        for _ in range(4):
            ort.step_pane()
        states.append((ort.queue.straddled_late,
                       accountant_state(ort.accountant),
                       metrics_state(ort.metrics)))
        assert ort.accountant.report()["q2"].shed_kleene > 0
    assert states[1] == states[0] and states[2] == states[0]
    assert states[0][0] == len(batch.time_slice(5, 12))


def test_runtime_admission_cap_bounds_pane_work():
    wl = _wl()
    batch = _stream(n=300, t_max=40, seed=11)
    _, _, runs = _held_against_reference(
        wl, batch, 40, {"shed_policy": "drop_tail", "pane_budget_events": 10},
        make_clock=stepped_clock)
    for _, ort in runs:
        assert all(p.admitted <= 10 for p in ort.metrics.panes)


def _sim_stream():
    rng = np.random.default_rng(12)
    n_panes, per_pane = 120, 40
    types = rng.choice([0, 1], size=n_panes * per_pane,
                       p=[0.2, 0.8]).astype(np.int32)
    times = np.repeat(np.arange(n_panes * 5, step=5), per_pane) \
        + np.tile(np.arange(per_pane) % 5, n_panes)
    times = np.sort(times).astype(np.int64)
    return EventBatch(SCHEMA, types, times, None,
                      np.zeros(len(types), np.int64)), n_panes * 5


def _sim_run(pk):
    """``test_runtime_controller_holds_slo_with_simulated_clock``'s plant:
    1 ms of simulated clock per admitted event."""
    base = RefOverloadRuntime if pk.ref else OverloadRuntime

    class _Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = _Clock()

    class _SimRuntime(base):
        def _process(self, kept, t0):
            clock.t += len(kept) * 1e-3

    batch, t_end = _sim_stream()
    cfg = {"slo_ms": 20.0, "shed_policy": "drop_tail",
           "pane_budget_events": 30}
    res, ort, plans = _overload_run(pk, _wl(with_not=False), batch, t_end,
                                    cfg, cls=_SimRuntime, clock=clock)
    return res, ort, plans


def test_runtime_controller_holds_slo_with_simulated_clock():
    """The simulated clock makes the live controller deterministic: its
    shed ratios, plans and per-pane times equal the reference's."""
    _, ref, ref_plans = _sim_run(REF)
    want = [(p.proc_ms, p.lat_ms) for p in ref.metrics.panes]
    for pk in PORTS:
        _, ort, plans = _sim_run(pk)
        assert plans == ref_plans, pk.backend
        assert metrics_state(ort.metrics) == metrics_state(ref.metrics)
        assert [(p.proc_ms, p.lat_ms) for p in ort.metrics.panes] == want
        assert accountant_state(ort.accountant) == \
            accountant_state(ref.accountant)
        tail = ort.metrics.panes[-30:]
        p99 = float(np.percentile([p.proc_ms for p in ort.metrics.panes], 99))
        assert p99 <= 2 * 20.0
        assert abs(np.mean([p.proc_ms for p in tail]) - 20.0) < 6.0
        assert 0.35 <= np.mean([p.shed_ratio for p in tail]) <= 0.65
        assert ort.metrics.summary() == ref.metrics.summary()


# --------------------------------------------------------- error accounting


def test_accountant_window_bounds_hold():
    """Per window: emitted <= true, and true <= 3^s * emitted wherever the
    accountant certifies its bound as tight; every bound equal to the
    reference's."""
    wl = Workload(SCHEMA, [Query("q1", Seq(A, Kleene(B)), within=10, slide=5),
                           Query("q2", Kleene(B), within=10, slide=10)])
    checked_tight = 0
    for seed in range(8):
        batch = _stream(n=150, t_max=30, seed=seed, p=(0.25, 0.65, 0.05, 0.05))
        want = RefRuntime(wl).run(batch, t_end=30)
        for ratio in (0.4, 0.7):
            _, ref, runs = _held_against_reference(
                wl, batch, 30, {"shed_policy": "benefit_weighted",
                                "fixed_shed": ratio})
            for got, ort in runs:
                for (qn, gk, w0), v in want.items():
                    t = v["COUNT(*)"]
                    g = got.get((qn, gk, w0), {}).get("COUNT(*)", 0.0)
                    wb = ort.accountant.window_bound(qn, gk, w0)
                    assert dataclasses.astuple(wb) == dataclasses.astuple(
                        ref.accountant.window_bound(qn, gk, w0))
                    assert g <= t + 1e-9
                    if wb.tight:
                        checked_tight += 1
                        assert t <= wb.count_upper_bound(g) + 1e-6
    assert checked_tight > 2 * 50


@pytest.mark.parametrize("case", ["subset", "kleene_preds", "negative"])
def test_accountant_flags_match_reference(case):
    """``test_accountant_subset_guarantee_flags``, ``_bound_not_tight_with_
    kleene_predicates`` and ``_flags_negative_shed``."""
    if case == "subset":
        wl, batch, t_end = _wl(), _stream(n=200, t_max=40, seed=13), 40
        cfg = {"shed_policy": "benefit_weighted", "fixed_shed": 0.5}
    elif case == "kleene_preds":
        wl = Workload(SCHEMA, [Query("q1", Seq(A, Kleene(B)),
                                     preds={"B": [Pred("v", "<", 3.0)]},
                                     within=10, slide=10)])
        batch, t_end = _stream(n=100, t_max=20, seed=14, groups=1), 20
        cfg = {"shed_policy": "benefit_weighted", "fixed_shed": 0.5}
    else:
        wl, t_end = _wl(), 40
        batch = _stream(n=200, t_max=40, seed=15, p=(0.1, 0.4, 0.4, 0.1))
        cfg = {"shed_policy": "drop_tail", "fixed_shed": 0.6}
    _, _, runs = _held_against_reference(wl, batch, t_end, cfg)
    for _, ort in runs:
        rep = ort.accountant.report()
        if case == "subset":
            assert all(r.subset_guarantee for r in rep.values())
            assert rep["q2"].shed_kleene > 0
        elif case == "kleene_preds":
            assert ort.accountant.total_shed > 0
            for w0 in (0, 10):
                wb = ort.accountant.window_bound("q1", 0, w0)
                if wb.shed_kleene:
                    assert not wb.tight
        else:
            assert rep["q3"].shed_negative > 0
            assert not rep["q3"].subset_guarantee


def test_accountant_merged_equals_single():
    """``ErrorAccountant.merged`` and ``merge_error_reports`` as the
    reference's, over two halves of one run's shed events."""
    from repro.overload.accountant import ErrorAccountant as RefAcc
    from repro.overload.accountant import merge_error_reports as ref_merge
    from repro_torch.overload.accountant import (ErrorAccountant,
                                                 merge_error_reports)

    wl = _wl()
    batch = _stream(n=200, t_max=40, seed=16)
    halves = [batch.select(np.arange(0, 100)), batch.select(np.arange(100,
                                                                      200))]
    states = []
    for acc_cls, merge, conv_wl, conv_b in (
            (RefAcc, ref_merge, lambda w: w, lambda b: b),
            (ErrorAccountant, merge_error_reports, port_wl, port_stream)):
        parts = [acc_cls(conv_wl(wl)) for _ in halves]
        for acc, h, wit in zip(parts, halves, (True, False)):
            acc.record(conv_b(h), witnessed=wit)
        m = acc_cls.merged(parts)
        states.append((accountant_state(m), {
            n: dataclasses.astuple(r)
            for n, r in merge([p.report() for p in parts]).items()}))
    assert states[0] == states[1]


# ------------------------------------------------- within the port: K, pipe


@pytest.mark.parametrize("backend,device", BACKENDS, ids=port_ids)
def test_runtime_micro_batch_and_pipeline_equal_inline(backend, device):
    """Under ``fixed_shed`` the micro-batched (K = 4) and the pipelined
    flush give the inline K = 1 run's windows, plans and accountant."""
    wl = _wl()
    batch = _stream(n=200, t_max=60, seed=21, groups=3)
    pk = Pkg(backend, device)
    cfg = {"shed_policy": "benefit_weighted", "fixed_shed": 0.5}
    want, base, base_plans = _overload_run(pk, wl, batch, 60, cfg)
    for extra in ({"micro_batch": 4}, {"pipeline_flush": True},
                  {"micro_batch": 4, "pipeline_flush": True}):
        got, ort, plans = _overload_run(pk, wl, batch, 60, {**cfg, **extra})
        assert_windows(got, want, extra, exact=True)
        assert plans == base_plans
        assert accountant_state(ort.accountant) == \
            accountant_state(base.accountant)
        assert metrics_state(ort.metrics) == metrics_state(base.metrics)
        if extra.get("pipeline_flush"):
            assert ort._flush_pool is None          # shut down


@pytest.mark.parametrize("micro_batch", [1, 3])
def test_flush_time_covers_the_device_fetch(monkeypatch, micro_batch):
    """Every timed flush that executes panes reaches the executors' host
    fetch (``ops.device_get_all``, the one sync on a device backend)
    between its two clock reads, single-pane and micro-batched alike."""
    log = []
    fetch = ops.device_get_all

    def logged_fetch(arrays):
        log.append("fetch")
        return fetch(arrays)

    monkeypatch.setattr(ops, "device_get_all", logged_fetch)

    def clock():
        log.append("clock")
        return float(len(log))

    wl = _wl()
    batch = _stream(n=150, t_max=40, seed=9, groups=2)
    ort = OverloadRuntime(port_wl(wl), OverloadConfig(
        shed_policy="none", micro_batch=micro_batch), backend="torch",
        device="cpu", clock=clock)
    ort.run(port_stream(batch), t_end=40)
    reads = [i for i, e in enumerate(log) if e == "clock"]
    assert len(reads) == 2 * math.ceil(len(ort.metrics.panes) / micro_batch)
    for a, b in zip(reads[::2], reads[1::2]):
        assert "fetch" in log[a + 1:b], (a, b)


@pytest.mark.parametrize("backend,device", BACKENDS, ids=port_ids)
def test_runtime_defaults_and_summary(backend, device):
    """The metrics summary's keys and the per-pane record, as the
    reference's; a runtime on the host reports its device."""
    wl = _wl()
    batch = _stream(n=100, t_max=40, seed=3)
    _, ort, _ = _overload_run(Pkg(backend, device), wl, batch, 40,
                              {"shed_policy": "drop_tail", "fixed_shed": 0.3})
    _, ref, _ = _overload_run(REF, wl, batch, 40,
                              {"shed_policy": "drop_tail", "fixed_shed": 0.3})
    assert ort.metrics.summary().keys() == ref.metrics.summary().keys()
    assert ort.rt.device == (None if backend == "np"
                             else torch.device(device))
    assert ort.t_now == ref.t_now == 40


# ------------------------------------------------------------ service wiring


def _service_feed(svc, pk, batch, step):
    res = {}
    for i in range(0, len(batch), step):
        res.update(svc.feed(pk.batch(batch.select(
            np.arange(i, min(i + step, len(batch)))))))
    res.update(svc.close())
    return res


def _service_state(svc):
    ov = svc.overload
    return (ov.shed_events, ov.controller.updates,
            accountant_state(ov.accountant))


def test_service_overload_opt_in():
    qs = [Query("q1", Seq(A, Kleene(B)), within=10, slide=5),
          Query("q2", Kleene(B), within=10, slide=10)]
    batch = _stream(n=200, t_max=60, seed=16)
    ov = {"shed_policy": "benefit_weighted", "fixed_shed": 0.5}
    ref = REF.service(qs, overload=dict(ov))
    ref_plans = record_plans(ref.overload.shedder)
    want = _service_feed(ref, REF, batch, 40)
    for pk in PORTS:
        svc = pk.service(qs, overload=dict(ov))
        plans = record_plans(svc.overload.shedder)
        got = _service_feed(svc, pk, batch, 40)
        assert plans == ref_plans
        assert _service_state(svc)[0] == _service_state(ref)[0] > 0
        assert _service_state(svc)[2] == _service_state(ref)[2]
        assert svc.overload.controller.updates > 0
        assert svc.overload.accountant.report()["q2"].shed_kleene > 0
        assert_windows(got, want, pk.backend, exact=pk.backend == "np")
        unshed = _service_feed(pk.service(qs), pk, batch, 40)
        for k, v in unshed.items():
            assert got.get(k, {}).get("COUNT(*)", 0.0) <= v["COUNT(*)"] + 1e-9
    assert REF.service(qs).overload is None
    assert PORTS[0].service(qs).overload is None


def test_service_overload_migration_taints_new_queries():
    qs = [Query("q1", Seq(A, Kleene(B)), within=10, slide=10)]
    batch = _stream(n=200, t_max=60, seed=17)
    q4 = Query("q4", Seq(C, Kleene(B)), within=10, slide=10)
    states = []
    for pk in [REF] + PORTS:
        svc = pk.service(qs, overload={"shed_policy": "benefit_weighted",
                                       "fixed_shed": 0.5})
        out = dict(svc.feed(pk.batch(batch.select(
            np.nonzero(batch.time < 30)[0]))))
        assert svc.overload.shed_events > 0
        svc.add_query(pk.wl(Workload(SCHEMA, [q4])).queries[0])
        out.update(svc.feed(pk.batch(batch.select(
            np.nonzero(batch.time >= 30)[0]))))
        out.update(svc.close())
        rep = svc.overload.accountant.report()
        assert not rep["q4"].subset_guarantee
        assert rep["q1"].subset_guarantee
        assert not svc.overload.accountant.window_bound("q4", 0, 40).tight
        states.append((_service_state(svc), out))
    for (state, out), pk in zip(states[1:], PORTS):
        assert state[0] == states[0][0][0] and state[2] == states[0][0][2]
        assert_windows(out, states[0][1], pk.backend,
                       exact=pk.backend == "np")


def test_service_feeds_revision_load_to_controller():
    """With event time and overload attached, each epoch's retract/amend
    records reach the controller as its revision-load axis — the same
    sequence of observations as the reference's."""
    qs = [Query("q1", Seq(A, Kleene(B)), within=10, slide=10)]
    batch = _stream(n=160, t_max=40, seed=3)
    late = batch.select(np.arange(min(30, len(batch))))
    late = EventBatch(SCHEMA, late.type_id, np.minimum(late.time, 8),
                      late.attrs + 1.0, late.group)
    nxt = _stream(n=80, t_max=40, seed=4)
    nxt = EventBatch(SCHEMA, nxt.type_id, nxt.time + 40, nxt.attrs,
                     nxt.group)
    seen = []
    for pk in [REF] + PORTS:
        calls = []
        ctl_cls = RefController if pk.ref else LatencyController

        class _Spy(ctl_cls):
            def update(self, latency_ms, revision_load=0.0):
                calls.append(revision_load)
                return super().update(latency_ms, revision_load)

        svc = pk.service(qs, overload={"slo_ms": 1e9, "shed_policy": "none",
                                       "kr": 0.5},
                         eventtime={"watermark": "bounded_skew", "skew": 2,
                                    "lateness_horizon": 40})
        svc.overload.controller = _Spy(slo_ms=1e9, kr=0.5)
        svc.feed(pk.batch(batch))
        svc.close()
        n_before = len(calls)
        assert n_before > 0
        svc.revise(pk.batch(late))
        assert len(svc.revisions) > 0
        svc.feed(pk.batch(nxt))
        svc.close()
        assert len(calls) > n_before and max(calls[n_before:]) > 0.0
        seen.append((calls, [(r.kind, r.query, r.group, r.w0, r.revision)
                             for r in svc.revisions]))
    assert seen[1] == seen[0] and seen[2] == seen[0]


def test_slo_control_case_matches_benchmarks():
    """The port's copy of ``benchmarks/fig_overload.py``'s SLO-control
    workload and stream (full and quick mode) and of its fragmented
    worst-case stream equal the JAX package's."""
    from benchmarks.fig_overload import _workload
    from repro.streams.generator import (RIDESHARING_SCHEMA,
                                         OverloadStreamConfig, StreamConfig,
                                         bursty_stream, overload_stream)
    from repro_torch.launch.fig_overload import (fragmented_stream,
                                                 slo_control_case)

    for minutes, n_queries in ((8, 8), (4, 4)):
        wl, stream, t_end = slo_control_case(minutes, n_queries)
        assert t_end == minutes * 60
        assert interop.workload_spec(wl) == interop.workload_spec(
            _workload(n_queries))
        ref = overload_stream(OverloadStreamConfig(
            schema=RIDESHARING_SCHEMA, base_events_per_minute=1500,
            minutes=minutes, ramp_to=1.5,
            flash_crowds=((t_end // 3, 10, 3.0), (2 * t_end // 3, 10, 4.0)),
            n_groups=4, burstiness=0.9, type_weights=(1, 1, 6, 1, 1, 1),
            seed=7))
        for col in ("type_id", "time", "attrs", "group"):
            assert np.array_equal(getattr(stream, col), getattr(ref, col))
    frag = bursty_stream(StreamConfig(
        schema=RIDESHARING_SCHEMA, events_per_minute=1500, minutes=1,
        n_groups=4, burstiness=0.0, type_weights=(1, 1, 6, 1, 1, 1), seed=11))
    got = fragmented_stream()
    for col in ("type_id", "time", "attrs", "group"):
        assert np.array_equal(getattr(got, col), getattr(frag, col))
