"""The trip-outcome deployment (``hbench/configs/ridesharing-trips.json``):
24 queries ``SEQ(Request, Travel+, Dropoff | Cancel | NOT Pickup)`` over
windows of 30 and 20 ticks, through the port's negation gates and tail
graphlets.

* the benchmark's plain reference (``hbench/references/seq_kleene_tail.py``,
  loaded by file path): its one-window definition against every trend
  spelled out, and against the JAX package's ``HamletRuntime`` on fuzz
  streams; its all-windows form against its one-window definition;
* the configuration's workload (``hbench/queries/seq_kleene_tail.py``)
  against ``launch/hamlet_service.py::ridesharing_workload(24)``;
* ``HamletRuntime`` against the reference, on the numpy and PyTorch
  backends on the CPU at K in {1, 16}, two districts over two replay
  segments;
* the negation counters (``neg_gates``, ``neg_rounds``, ``fold_rounds``)
  and the ``plan.neg`` step clock and span.
"""

import importlib
import importlib.util
import itertools
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.events import EventBatch as RefBatch
from repro.launch.hamlet_service import \
    ridesharing_workload as ref_ridesharing_workload
from repro.streams.generator import RIDESHARING_SCHEMA as REF_SCHEMA
from repro_torch.core.engine import HamletRuntime, vals_equal
from repro_torch.core.events import EventBatch
from repro_torch.core.optimizer import DynamicPolicy
from repro_torch.launch.hamlet_service import ridesharing_workload
from repro_torch.obs import Observability

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    """A module of the benchmark, by file path (its absolute imports of
    ``hbench`` resolve from the repository's root)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "ridesharing_trips_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("hbench/references/seq_kleene_tail.py")
queries = _load("hbench/queries/seq_kleene_tail.py")
streamgen = _load("hbench/streamgen.py")
drivers = importlib.import_module("hbench.drivers")


def _cfg(name):
    return json.loads((ROOT / "hbench" / "configs" / f"{name}.json")
                      .read_text())


CFG = _cfg("ridesharing-trips")
TYPES = CFG["schema"]["types"]
QUERY = {q["name"]: q for q in CFG["queries"]}
# q1-q3 and a derived query of each family (Travel.speed < 2 + i % 8)
FAMILY = ("q1", "q2", "q3", "q4", "q8", "q12")


def _enumerate(cfg, q, t, at):
    """COUNT(*), COUNT(Travel) and SUM(Travel.x) of every trend spelled
    out: a matched Request, then a non-empty set of later matched Travels,
    then a tail after the last of them, or, under NOT Pickup, no Pickup
    after the last of them."""
    attrs = cfg["schema"]["attrs"]
    h = ref._role(cfg, q, "head", t, at)
    k = ref._role(cfg, q, "kleene", t, at)
    tail = ref._role(cfg, q, "tail", t, at)
    neg = np.nonzero(ref._role(cfg, q, "not_after", t, at))[0]
    col = ref._value_attr(q)
    x = at[:, attrs.index(col)]
    count = count_k = 0
    total = 0.0
    for a in np.nonzero(h)[0]:
        later = [j for j in range(a + 1, len(t)) if k[j]]
        for r in range(1, len(later) + 1):
            for sub in itertools.combinations(later, r):
                if "tail" in q:
                    ends = int(tail[sub[-1] + 1:].sum())
                elif len(neg) and neg[-1] > sub[-1]:
                    ends = 0
                else:
                    ends = 1
                count += ends
                count_k += ends * r
                total += ends * float(sum(x[j] for j in sub))
    return count, count_k, total


def _window(rng, n):
    w = np.array([2, 1, 5, 1, 2, 2], dtype=float)
    t = rng.choice(len(TYPES), size=n, p=w / w.sum()).astype(np.int32)
    return t, rng.uniform(0, 10, (n, len(CFG["schema"]["attrs"])))


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_window_direct_equals_enumeration(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        t, at = _window(rng, int(rng.integers(0, 13)))
        for name in FAMILY:
            q = QUERY[name]
            got = ref.window_direct(CFG, q, t, at)
            count, count_k, total = _enumerate(CFG, q, t, at)
            assert got["COUNT(*)"] == count
            (agg,) = [a for a in q["aggs"] if a != "COUNT(*)"]
            want = total if agg.startswith("SUM") else (
                total / count_k if count_k else math.nan)
            assert got[agg] == pytest.approx(want, rel=1e-12, nan_ok=True)


def _stream(seed, districts=2, minutes=1.5, epm=625, segment=0):
    return streamgen.district_stream(
        seed=seed, segment=segment, minutes=minutes,
        events_per_minute=districts * epm, districts=districts,
        n_types=len(TYPES), type_weights=CFG["type_weights"],
        burstiness=CFG["burstiness"], n_attrs=len(CFG["schema"]["attrs"]))


@pytest.mark.parametrize("seed", [3, 2**32 + 5])
def test_evaluate_equals_window_direct(seed):
    """Every window of each query's own length, from the configuration-
    level starts: 30-tick windows from 0 to 60, 20-tick ones to 70."""
    s = _stream(seed)
    starts = list(range(0, 90 - 30 + 1, 15))
    out = ref.evaluate(CFG, s.type_id, s.time, s.attrs, s.group, starts,
                       [0, 1])
    n30 = sum(q["within"] == 30 for q in CFG["queries"])
    assert len(out) == 2 * (13 * n30 + 15 * (len(QUERY) - n30))
    nonzero = 0
    for (qn, g, w0), vals in out.items():
        q = QUERY[qn]
        sel = (s.group == g) & (s.time >= w0) & (s.time < w0 + q["within"])
        want = ref.window_direct(CFG, q, s.type_id[sel], s.attrs[sel])
        assert vals.keys() == want.keys()
        for agg, v in want.items():
            assert vals[agg] == pytest.approx(v, rel=1e-13, nan_ok=True)
        nonzero += vals["COUNT(*)"] > 0
    assert nonzero > len(out) // 4


@pytest.mark.parametrize("seed", range(4))
def test_window_direct_equals_jax_runtime(seed):
    """The paper's package on fuzz streams of two districts over 40
    ticks: every window of the 24 queries equals the reference's
    definition."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(20, 60))
    t, at = _window(rng, n)
    tm = np.sort(rng.integers(0, 40, n)).astype(np.int64)
    grp = rng.integers(0, 2, n).astype(np.int64)
    got = RefRuntime(ref_ridesharing_workload(24), micro_batch=4).run(
        RefBatch(REF_SCHEMA, t, tm, at, grp), 40)
    assert len(got) == 2 * sum(len(range(0, 40 - q["within"] + 1, 5))
                               for q in CFG["queries"])
    for (qn, g, w0), vals in got.items():
        q = QUERY[qn]
        sel = (grp == g) & (tm >= w0) & (tm < w0 + q["within"])
        want = ref.window_direct(CFG, q, t[sel], at[sel])
        assert vals.keys() == want.keys()
        assert vals["COUNT(*)"] == want["COUNT(*)"], (qn, g, w0)
        for agg, v in want.items():
            assert vals[agg] == pytest.approx(v, rel=1e-12, nan_ok=True)


def test_configuration_is_ridesharing_workload():
    wl = queries.workload(CFG)
    want = ridesharing_workload(24)
    assert wl.schema == want.schema
    assert len(wl.queries) == 24
    for got, q in zip(wl.queries, want.queries):
        assert got == q, q.name
    # q24 repeats q3: 23 distinct queries
    assert len({(q.pattern, q.aggs, q._freeze_preds(), q.within, q.slide)
                for q in wl.queries}) == 23


MIX = {"districts": 2, "micro_batch": 16}


def _segments(cfg=CFG, n=2, seed=2**31 + 7):
    t_end = drivers.segment_ticks(cfg, MIX)
    return t_end, [drivers.cell_stream(cfg, MIX, seed, i, t_end / 60)
                   for i in range(n)]


def _run(wl, backend, K, fold_exec=True, obs=None, cfg=CFG):
    rt = HamletRuntime(wl, policy=DynamicPolicy(), backend=backend,
                       device=None if backend == "np" else "cpu",
                       micro_batch=K, fold_exec=fold_exec, obs=obs)
    t_end, segs = _segments(cfg)
    got = [rt.run(EventBatch(wl.schema, s.type_id, s.time, s.attrs,
                             s.group), t_end) for s in segs]
    return rt, got, segs, t_end


@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("backend", ["np", "torch"])
def test_runtime_matches_reference(backend, K):
    _, got, segs, t_end = _run(queries.workload(CFG), backend, K)
    starts = list(range(0, t_end - CFG["within"] + 1, CFG["slide"]))
    exact = 0
    for res, s in zip(got, segs):
        want = ref.evaluate(CFG, s.type_id, s.time, s.attrs, s.group,
                            starts, [0, 1])
        assert res.keys() == want.keys()
        for key, vals in want.items():
            for agg, v in vals.items():
                g = res[key][agg]
                if agg == "COUNT(*)" and v < 2**53:
                    assert g == v, (key, g, v)
                    exact += 1
                else:
                    assert g == pytest.approx(v, rel=1e-12, nan_ok=True), \
                        (key, agg)
    assert exact > 0


NEG = ("neg_gates", "neg_rounds", "fold_rounds")


def test_negation_counters_do_not_change_with_k_or_backend():
    """Counted with no ``Observability``; the same at K 1 and 16, on both
    backends and through the sequential finalize (its gates); the results
    the same bitwise at any K."""
    wl = queries.workload(CFG)
    seen, results = {}, {}
    for backend in ("np", "torch"):
        for K in (1, 16):
            rt, got, _, _ = _run(wl, backend, K)
            seen[(backend, K)] = {f: getattr(rt.stats, f) for f in NEG}
            results[(backend, K)] = got
    first = seen[("np", 1)]
    assert all(v == first for v in seen.values()), seen
    assert 0 < first["neg_rounds"] < first["fold_rounds"]
    assert first["neg_gates"] >= first["neg_rounds"]
    for r1, r16 in zip(results[("np", 1)], results[("np", 16)]):
        assert r1.keys() == r16.keys()
        assert all(vals_equal(r1[k], r16[k]) for k in r1)
    seq, _, _, _ = _run(wl, "np", 4, fold_exec=False)
    assert seq.stats.neg_gates == first["neg_gates"]
    assert seq.stats.fold_rounds == seq.stats.neg_rounds == 0


def test_negation_counters_on_a_workload_without_negation():
    cfg = _cfg("ridesharing-w1")
    wl = _load("hbench/queries/seq_kleene.py").workload(cfg)
    rt, _, _, _ = _run(wl, "np", 16, cfg=cfg)
    assert rt.stats.neg_gates == rt.stats.neg_rounds == 0
    assert rt.stats.fold_rounds > 0


@pytest.mark.parametrize("attached", [True, False])
def test_plan_neg_clock_only_with_observability(attached):
    obs = Observability() if attached else None
    rt, _, _, _ = _run(queries.workload(CFG), "np", 16, obs=obs)
    assert rt.stats.neg_gates > 0
    if attached:
        assert 0 < rt.stats.plan_neg_s < rt.stats.plan_s
        spans = [e for e in obs.tracer.events() if e["name"] == "plan.neg"]
        assert spans and all(e["cat"] == "step" for e in spans)
    else:
        assert rt.stats.plan_neg_s == 0
