"""The fold executor's divergent graphlets folded through state-free ``S``
blocks (``FoldExecutor._collapse``), on the CPU.

On the device backends every divergent (d > 0) graphlet of a flush is
collapsed at flush prep into one ``[n_used, 1 + nu]`` block a member and
folds on the d == 0 path; the np backend keeps the snapshot row loop, the
bitwise twin of the reference's stacked fold.  Held here, on
``backend="torch", device="cpu"``:

* the trip-outcome workload (``ridesharing_workload(24)``: negation, tails,
  SUM and AVG), Kleene queries under edge predicates and Kleene patterns
  that start at the shared type, at micro batch K in {1, 4, 16}, against
  the JAX package's sequential oracle: COUNT exact, SUM/AVG within rtol
  1e-12, and every divergent graphlet collapsed;
* one divergent bucket: ``S_eff @ W_base`` against the row loop's update
  (``_fold_bucket_div``) on the same state, within 1e-13 relative;
* a divergent burst whose counts overflow float64 keeps the row loop, with
  the np backend's non-finite pattern;
* the np backend never collapses.
"""

import dataclasses

import numpy as np
import pytest

from benchmarks.common import kleene_workload
from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.events import EventBatch as RefBatch
from repro.core.events import StreamSchema as RefSchema
from repro.core.pattern import EventType, Kleene, Seq
from repro.core.query import (EdgePred, Pred, Query, Workload, agg_sum,
                              count_star)
from repro.launch.hamlet_service import \
    ridesharing_workload as ref_ridesharing_workload
from repro.streams import generator as RG
from repro_torch import interop
from repro_torch.core import fold_exec
from repro_torch.core.engine import HamletRuntime
from repro_torch.core.fold_exec import (FoldExecutor, _CtxState, _SRows,
                                        build_fold_schedule)
from repro_torch.core.optimizer import AlwaysShare

DEV = dict(backend="torch", device="cpu")


def port_wl(wl):
    return interop.workload_from(interop.workload_spec(wl))


def port_stream(batch):
    c = interop.stream_columns(batch)
    return interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                              c["type_id"], c["time"], c["attrs"], c["group"],
                              c["seq"])


def trip_case():
    wl = ref_ridesharing_workload(24)
    stream = RG.ridesharing_stream(events_per_minute=300, minutes=2,
                                   n_groups=2, seed=11)
    return wl, stream, 120


def edge_case():
    wl = kleene_workload(RG.STOCK_SCHEMA, 6, kleene_type="Quote",
                         head_types=["Buy", "Sell"], within=60, slide=30,
                         pred_attr="volume")
    qs = [dataclasses.replace(q, edge_preds={
        "Quote": [EdgePred("price", ">" if i % 2 == 0 else "<")]})
        for i, q in enumerate(wl.queries)]
    stream = RG.stock_stream(events_per_minute=300, minutes=2, n_groups=2,
                             seed=12)
    return Workload(wl.schema, qs), stream, 120


def start_case():
    """Kleene patterns that start at the shared type (the snapshot's
    ``start * gate`` term) beside one that does not."""
    schema = RefSchema(types=("A", "B"), attrs=("v",))
    A, B = EventType("A"), EventType("B")
    aggs = (count_star(), agg_sum("B", "v"))
    wl = Workload(schema, [
        Query("q1", Kleene(B), aggs=aggs, within=40, slide=20),
        Query("q2", Kleene(B), aggs=aggs, preds={"B": [Pred("v", "<", 1.5)]},
              within=40, slide=20),
        Query("q3", Seq(A, Kleene(B)), aggs=aggs, within=40, slide=20),
    ])
    rng = np.random.default_rng(9)
    n = 600
    types = (rng.random(n) < 0.85).astype(np.int32)
    time = np.sort(rng.integers(0, 120, n))
    vals = rng.uniform(0.5, 2.0, (n, 1))
    return wl, RefBatch(schema, types, time, vals), 120


CASES = {"trips": trip_case, "edge": edge_case, "start": start_case}


@pytest.fixture(scope="module")
def oracle():
    """The JAX package's sequential replay of each case, computed once."""
    cache: dict = {}

    def get(name):
        if name not in cache:
            wl, stream, t_end = CASES[name]()
            cache[name] = RefRuntime(wl, fold_exec=False,
                                     plan_cache=False).run(stream, t_end)
        return cache[name]

    return get


def assert_held(got, want, tag, rtol=1e-12):
    """COUNT exact; SUM/AVG within ``rtol``; the same non-finite pattern."""
    assert got.keys() == want.keys(), tag
    for k, w in want.items():
        assert got[k].keys() == w.keys(), (tag, k)
        for a, wv in w.items():
            gv = got[k][a]
            if not np.isfinite(wv) or a.startswith("COUNT"):
                assert gv == wv or (np.isnan(gv) and np.isnan(wv)), \
                    (tag, k, a, gv, wv)
            else:
                assert gv == pytest.approx(wv, rel=rtol), (tag, k, a)


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("name", list(CASES))
def test_collapsed_fold_matches_sequential_oracle(name, K, oracle):
    wl, stream, t_end = CASES[name]()
    rt = HamletRuntime(port_wl(wl), micro_batch=K, **DEV)
    got = rt.run(port_stream(stream), t_end)
    assert_held(got, oracle(name), (name, K))
    s = rt.stats
    assert s.div_collapsed == s.div_graphlets > 0, (s.div_collapsed,
                                                    s.div_graphlets)
    assert 0 < s.fold_flushes and s.scan_flushes <= s.fold_flushes


def _flush_jobs(wl, stream, t_end, K=16):
    """The fold jobs of every flush of a torch-backend run, kept with their
    coefficients: [(ctx, [FoldJob])]."""
    flushes = []
    rt = HamletRuntime(port_wl(wl), micro_batch=K, **DEV)
    orig = rt.fold_exec._flush

    def keep(jobs):
        flushes.append(list(jobs))
        orig(jobs)

    rt.fold_exec._flush = keep
    rt.run(port_stream(stream), t_end)
    out = []
    for jobs in flushes:
        by_ctx: dict = {}
        for j in jobs:
            by_ctx.setdefault(id(j.proc.ctx), (j.proc.ctx, []))[1].append(j)
        out.extend(by_ctx.values())
    return out


def test_collapsed_bucket_equals_the_row_loop():
    """The widest divergent template of a trip run: its members' ``S_eff``
    folded on the d == 0 path give the row loop's update, on a state whose
    read rows are random and whose written rows start at zero (so the
    written rows hold the update itself)."""
    wl, stream, t_end = trip_case()
    best = None
    for ctx, cjobs in _flush_jobs(wl, stream, t_end):
        for row, j in enumerate(cjobs):
            for tpls in build_fold_schedule(ctx, j.steps).buckets:
                for tpl in tpls:
                    if tpl.d and (best is None or tpl.d * len(tpl.q)
                                  > best[3].d * len(best[3].q)):
                        best = (ctx, cjobs, row, tpl)
    assert best is not None
    ctx, cjobs, row, tpl = best
    assert tpl.d >= 3 and ctx.nu > 1
    used = build_fold_schedule(ctx, cjobs[row].steps).used
    s_eff, ok = FoldExecutor._collapse_shape(ctx, cjobs, used, tpl.b, tpl.d,
                                             [tpl], [row])
    assert ok.all()
    (collapsed,) = fold_exec._split_collapsed(tpl, ok, s_eff, ctx.nu)
    assert collapsed.d == 0 and collapsed.ng == len(tpl.q)

    ex = FoldExecutor(backend="np")
    mb_div = ex._merge_bucket(ctx, cjobs, [(row, tpl, used)], _SRows())
    mb_c = ex._merge_bucket(ctx, cjobs, [(row, collapsed, used)], _SRows())
    assert mb_div.d == tpl.d and mb_c.d == 0
    assert np.array_equal(mb_div.flat_sc, mb_c.flat_sc)
    Z = np.random.default_rng(5).uniform(
        0.5, 2.0, fold_exec._state0(ctx, len(cjobs)).shape)
    st_div, st_c = (_CtxState(ctx, cjobs, Z=Z.copy()) for _ in range(2))
    for st in (st_div, st_c):
        st.Zf[mb_div.flat_sc] = 0.0
        if mb_div.flat_er is not None:
            st.Zf[mb_div.flat_er[0]] = 0.0
    ex._fold_bucket_div(st_div, mb_div, cjobs)
    ex._fold_bucket_fast(st_c, mb_c, s_eff.reshape(-1, 1 + ctx.nu))
    want = st_div.Zf[mb_div.flat_sc]
    got = st_c.Zf[mb_c.flat_sc]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def overflow_case():
    """One shared Kleene burst of 1,100 B events (~2^1099 trends: its
    coefficients overflow float64) with three events that only one query
    matches: a divergent graphlet whose system is not finite."""
    schema = RefSchema(types=("A", "B"), attrs=("v",))
    A, B = EventType("A"), EventType("B")
    wl = Workload(schema, [
        Query("q1", Seq(A, Kleene(B)),
              aggs=(count_star(), agg_sum("B", "v")), within=40, slide=20),
        Query("q2", Seq(A, Kleene(B)), aggs=(count_star(),),
              preds={"B": [Pred("v", "<", 4.0)]}, within=40, slide=20),
    ])
    n = 1100
    types = np.array([0] + [1] * n + [0], dtype=np.int32)
    time = np.minimum(np.arange(1, len(types) + 1), 19)
    v = np.random.default_rng(3).uniform(0.5, 2.0, (len(types), 1))
    v[[200, 600, 1000], 0] = 5.0
    return wl, RefBatch(schema, types, time, v), 40


def test_overflowing_divergent_burst_keeps_the_row_loop():
    wl, batch, t_end = overflow_case()
    pwl, pb = port_wl(wl), port_stream(batch)
    runs = {}
    for backend in ("np", "torch"):
        rt = HamletRuntime(pwl, micro_batch=4, policy=AlwaysShare(),
                           backend=backend,
                           device=None if backend == "np" else "cpu")
        runs[backend] = (rt.run(pb, t_end), rt.stats)
    (want, s_np), (got, s) = runs["np"], runs["torch"]
    assert s.div_graphlets == s_np.div_graphlets > 0
    assert s.div_collapsed < s.div_graphlets
    assert any(not np.isfinite(v) for out in want.values()
               for v in out.values()), "overflow regime not reached"
    assert_held(got, want, "overflow")


def test_np_backend_never_collapses(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the np backend collapsed a graphlet")

    monkeypatch.setattr(FoldExecutor, "_collapse_shape",
                        staticmethod(refuse))
    wl, stream, t_end = edge_case()
    rt = HamletRuntime(port_wl(wl), micro_batch=4, backend="np")
    rt.run(port_stream(stream), t_end)
    assert rt.stats.div_graphlets > 0 and rt.stats.div_collapsed == 0
