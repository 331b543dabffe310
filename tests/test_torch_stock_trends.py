"""The stock deployment (``hbench/configs/stock-trends.json``): 20 queries
``SEQ(Buy, Sell+)`` under price edge predicates, on the port's general
plan walk and its event-level snapshots.

* the benchmark's plain reference (``hbench/references/seq_kleene_edge.py``,
  loaded by file path) against every trend spelled out, for a dozen events
  at most, falling and rising runs; its all-windows form against its
  one-window walk;
* ``HamletRuntime`` on the configuration's own queries (built by
  ``hbench/queries/seq_kleene_edge.py``) against the reference, on the
  numpy and PyTorch backends on the CPU and on ``cuda`` where a card is;
* the counters of event-level snapshots (``edge_mask_cells``,
  ``shared_rows``, ``snapshot_rows``) and the ``plan.edge`` step clock and
  span;
* ``Workload`` refuses an edge predicate on an attribute the schema lacks.
"""

import importlib.util
import itertools
import json
import math
import operator
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.engine import HamletRuntime
from repro_torch.core.events import EventBatch, StreamSchema
from repro_torch.core.optimizer import DynamicPolicy
from repro_torch.core.pattern import EventType, Kleene, Seq
from repro_torch.core.query import EdgePred, Query, Workload
from repro_torch.obs import Observability

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    """A module of the benchmark, by file path (its absolute imports of
    ``hbench`` resolve from the repository's root)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "stock_trends_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("hbench/references/seq_kleene_edge.py")
queries = _load("hbench/queries/seq_kleene_edge.py")
streamgen = _load("hbench/streamgen.py")


def _cfg(name):
    return json.loads((ROOT / "hbench" / "configs" / f"{name}.json")
                      .read_text())


CFG = _cfg("stock-trends")
BUY, SELL = range(2)
PANE = 15


def _enumerate(cfg, q, t, tm, at):
    """COUNT(*), COUNT(Sell) and SUM(Sell.price) of every trend spelled
    out: a matched Buy, then any non-empty set of later matched Sells whose
    consecutive pairs inside one graphlet (a run of Sells in one pane)
    satisfy the edge predicate."""
    attrs = cfg["schema"]["attrs"]
    ops = {">": operator.gt, "<": operator.lt, ">=": operator.ge}

    def holds(p, i):
        return ops[p["op"]](at[i, attrs.index(p["attr"])], p["value"])

    head = [t[i] == BUY and all(holds(p, i) for p in q["preds"]
                                if p["type"] == "Buy") for i in range(len(t))]
    sell = [t[i] == SELL and all(holds(p, i) for p in q["preds"]
                                 if p["type"] == "Sell")
            for i in range(len(t))]
    run = [0] * len(t)
    for i in range(1, len(t)):
        run[i] = run[i - 1] + (t[i] != t[i - 1]
                               or tm[i] // PANE != tm[i - 1] // PANE)
    (ep,) = q["edge_preds"]
    col = attrs.index(ep["attr"])
    count = count_k = 0
    total = 0.0
    for a in (i for i in range(len(t)) if head[i]):
        later = [j for j in range(a + 1, len(t)) if sell[j]]
        for r in range(1, len(later) + 1):
            for sub in itertools.combinations(later, r):
                if all(run[j] != run[i] or ops[ep["op"]](at[j, col],
                                                          at[i, col])
                       for j, i in zip(sub, sub[1:])):
                    count += 1
                    count_k += r
                    total += float(sum(at[j, attrs.index("price")]
                                       for j in sub))
    return count, count_k, total


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
@pytest.mark.parametrize("op", [">", "<"])
def test_window_direct_equals_enumeration(op, seed):
    qs = [q for q in CFG["queries"] if q["edge_preds"][0]["op"] == op][:4]
    rng = np.random.default_rng(seed)
    for _ in range(30):
        n = int(rng.integers(0, 13))
        t = rng.integers(0, 2, n).astype(np.int32)
        tm = np.sort(rng.integers(0, 60, n)).astype(np.int64)
        at = rng.uniform(0, 10, (n, len(CFG["schema"]["attrs"])))
        for q in qs:
            got = ref.window_direct(CFG, q, t, tm, at)
            count, count_k, total = _enumerate(CFG, q, t, tm, at)
            assert got["COUNT(*)"] == count
            avg = got["AVG(Sell.price)"]
            if count_k:
                assert avg == pytest.approx(total / count_k, rel=1e-12)
            else:
                assert math.isnan(avg)


def _stream(seed, districts=3, minutes=2, epm=625):
    return streamgen.district_stream(
        seed=seed, segment=0, minutes=minutes,
        events_per_minute=districts * epm, districts=districts,
        n_types=len(CFG["schema"]["types"]),
        type_weights=CFG["type_weights"], burstiness=CFG["burstiness"],
        n_attrs=len(CFG["schema"]["attrs"]))


def test_evaluate_equals_window_direct():
    s = _stream(2**32 + 5)
    starts = list(range(0, 120 - 60 + 1, 15))
    out = ref.evaluate(CFG, s.type_id, s.time, s.attrs, s.group, starts,
                       [0, 1, 2])
    assert len(out) == 3 * len(starts) * len(CFG["queries"])
    for (qn, g, w0), vals in out.items():
        q = next(q for q in CFG["queries"] if q["name"] == qn)
        sel = (s.group == g) & (s.time >= w0) & (s.time < w0 + 60)
        want = ref.window_direct(CFG, q, s.type_id[sel], s.time[sel],
                                 s.attrs[sel])
        for agg, v in want.items():
            assert vals[agg] == pytest.approx(v, rel=1e-13, nan_ok=True)


def _run(wl, s, backend, device, K, **kw):
    rt = HamletRuntime(wl, policy=DynamicPolicy(), backend=backend,
                       device=device, micro_batch=K, fold_exec=True, **kw)
    got = rt.run(EventBatch(wl.schema, s.type_id, s.time, s.attrs, s.group),
                 120)
    return rt, got


def _runtime_against_reference(backend, device, K, epm):
    wl = queries.workload(CFG)
    s = _stream(41 + epm, epm=epm)
    _, got = _run(wl, s, backend, device, K)
    want = ref.evaluate(CFG, s.type_id, s.time, s.attrs, s.group,
                        range(0, 61, 15), [0, 1, 2])
    assert got.keys() == want.keys()
    exact = 0
    for key, vals in want.items():
        for agg, v in vals.items():
            g = got[key][agg]
            if agg == "COUNT(*)" and v < 2**53:
                # integer sums of integers: exact in float64 below 2^53
                assert g == v, (key, g, v)
                exact += 1
            else:
                # the port adds the same non-negative terms in another
                # order (per-pane transfer matrices folded across the
                # window) than the reference's walk: a few thousand
                # roundings of 2^-53 at most
                assert g == pytest.approx(v, rel=1e-12, nan_ok=True), key
    return exact


@pytest.mark.parametrize("epm", [150, 625])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("backend,device", [("np", None), ("torch", "cpu")])
def test_runtime_matches_reference(backend, device, K, epm):
    exact = _runtime_against_reference(backend, device, K, epm)
    if epm == 150:
        # windows of ~150 events: counts below 2^53, held exactly
        assert exact > 0


@pytest.mark.parametrize("K", [1, 4])
def test_runtime_matches_reference_on_cuda(K):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the masked kernel runs on the card")
    _runtime_against_reference("cuda", "cuda:0", K, 625)


def _ridesharing():
    cfg = _cfg("ridesharing-w1")
    s = streamgen.district_stream(
        seed=9, segment=0, minutes=2, events_per_minute=3 * 625,
        districts=3, n_types=len(cfg["schema"]["types"]),
        type_weights=cfg["type_weights"], burstiness=cfg["burstiness"],
        n_attrs=len(cfg["schema"]["attrs"]))
    seq_kleene = _load("hbench/queries/seq_kleene.py")
    return seq_kleene.workload(cfg), s


COUNTERS = ("edge_mask_cells", "shared_rows", "snapshot_rows")


def _counters(wl, s, runs):
    """The three counters over ``runs`` runs of one stream."""
    rt = HamletRuntime(wl, policy=DynamicPolicy(), backend="np",
                       micro_batch=4)
    b = EventBatch(wl.schema, s.type_id, s.time, s.attrs, s.group)
    for _ in range(runs):
        rt.run(b, 120)
    return {f: getattr(rt.stats, f) for f in COUNTERS}


@pytest.mark.parametrize("workload", ["stock-trends", "ridesharing-w1"])
def test_snapshot_counters(workload):
    """Positive on the stock workload (every Sell burst builds 20 edge
    masks of b^2 cells); on ridesharing's edge-free one no mask is built,
    while its per-event predicates still give shared rows snapshots.  A
    stream run twice counts exactly twice what it counts once."""
    wl, s = ((queries.workload(CFG), _stream(77))
             if workload == "stock-trends" else _ridesharing())
    once = _counters(wl, s, 1)
    got = _counters(wl, s, 2)
    assert got == {f: 2 * v for f, v in once.items()}
    assert 0 < got["snapshot_rows"] < got["shared_rows"]
    assert (got["edge_mask_cells"] > 0) == (workload == "stock-trends")


def test_edge_mask_cells_count_every_mask():
    """One burst of b Sells of one company, in one pane: each of the 20
    queries builds one b x b mask."""
    wl = queries.workload(CFG)
    b = 7
    t = np.array([BUY] + [SELL] * b, dtype=np.int32)
    tm = np.zeros(len(t), dtype=np.int64)
    at = np.random.default_rng(3).uniform(0, 10, (len(t), 4))
    rt = HamletRuntime(wl, policy=DynamicPolicy(), backend="np")
    rt.run(EventBatch(wl.schema, t, tm, at, np.zeros(len(t), np.int64)), 60)
    assert rt.stats.edge_mask_cells == len(CFG["queries"]) * b * b


@pytest.mark.parametrize("attached", [True, False])
def test_plan_edge_clock_only_with_observability(attached):
    wl = queries.workload(CFG)
    s = _stream(5, minutes=1)
    obs = Observability() if attached else None
    rt, _ = _run(wl, s, "np", None, 4, obs=obs)
    assert rt.stats.edge_mask_cells > 0
    if attached:
        assert 0 < rt.stats.plan_edge_s < rt.stats.plan_s
        spans = [e for e in obs.tracer.events() if e["name"] == "plan.edge"]
        assert spans and all(e["cat"] == "step" for e in spans)
    else:
        assert rt.stats.plan_edge_s == 0


def test_unknown_edge_attribute_is_refused():
    schema = StreamSchema(types=("Buy", "Sell"), attrs=("price",))
    pattern = Seq(EventType("Buy"), Kleene(EventType("Sell")))
    Workload(schema, [Query("ok", pattern,
                            edge_preds={"Sell": [EdgePred("price", ">")]})])
    with pytest.raises(KeyError, match="unknown attribute"):
        Workload(schema, [Query("q", pattern,
                                edge_preds={"Sell": [EdgePred("volume",
                                                              ">")]})])
