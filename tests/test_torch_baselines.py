"""The port's baselines (brute, GRETA, SHARON, MCEP) against the JAX
package's, on the CPU.

Inputs are made from seeds with numpy and carried across with
``repro_torch.interop``:

* brute, SHARON and MCEP (host numpy in both packages) on the seeds of
  ``tests/test_baselines.py``: every window bitwise equal (``vals_equal``);
* GRETA on ``tests/test_differential.py``'s workload and bursty streams
  with t_end 40: the port's ``backend="np"`` bitwise equal to the
  reference's ``backend="np"``, its ``backend="torch"`` on the CPU within
  rtol 1e-12;
* one window of n >= 25 events, where both packages leave the row loop
  for the doubling oracle, against the reference's ``backend="pallas"``
  (interpret mode) within rtol 1e-12;
* MCEP's trend-explosion ``RuntimeError``; GRETA's defaults (the card,
  raising without one) and its values, Python floats on every backend;
* fig9's windows whose counts are large but finite (8,000 ev/min): the
  reference's numpy doubling gives NaN there, its row loop the finite
  count; the port's ``"np"`` keeps the doubling's NaN and the masked
  kernel's plain version (the ``"cuda"`` path's) is held against the row
  loop (``repro_torch.kernels.ref.exact_oracle``), for COUNT and for
  MIN/MAX.
"""

import functools
import math

import numpy as np
import pytest
import torch

from repro.core.baselines.brute import brute_run as ref_brute_run
from repro.core.baselines.greta import greta_run as ref_greta_run
from repro.core.baselines.greta import \
    window_eval_greta as ref_window_eval_greta
from repro.core.baselines.mcep import mcep_run as ref_mcep_run
from repro.core.baselines.sharon import sharon_run as ref_sharon_run
from repro.core.events import EventBatch, StreamSchema
from repro.core.pattern import EventType, Kleene, Not, Seq
from repro.core.query import (Pred, Query, Workload, agg_avg, agg_max,
                              agg_min, agg_sum, count_star, count_type)
from repro_torch import interop
from repro_torch.core.baselines import brute, greta, mcep, sharon
from repro_torch.core.engine import vals_equal
from repro_torch.kernels.ref import exact_oracle

A, B, C, X = map(EventType, "ABCX")
SCHEMA = StreamSchema(types=("A", "B", "C", "X"), attrs=("v", "w"))
DIFF_SCHEMA = StreamSchema(types=("A", "B", "C"), attrs=("v",))


def port_wl(wl):
    return interop.workload_from(interop.workload_spec(wl))


def port_stream(batch):
    c = interop.stream_columns(batch)
    return interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                              c["type_id"], c["time"], c["attrs"], c["group"],
                              c["seq"])


def assert_bitwise(got, want, tag):
    assert got.keys() == want.keys(), tag
    for k in want:
        assert vals_equal(got[k], want[k]), (tag, k, got[k], want[k])


def assert_close(got, want, tag, rtol=1e-12):
    assert got.keys() == want.keys(), tag
    for k, w in want.items():
        assert got[k].keys() == w.keys(), (tag, k)
        for a, wv in w.items():
            gv = got[k][a]
            assert type(gv) is float, (tag, k, a, type(gv))
            if math.isnan(wv):
                assert math.isnan(gv), (tag, k, a, gv)
            else:
                assert math.isclose(gv, wv, rel_tol=rtol), (tag, k, a, gv, wv)


# ---------------------------------------- tests/test_baselines.py's seeds


def _baselines_wl():
    return Workload(SCHEMA, [
        Query("q1", Seq(A, Kleene(B)), preds={"B": [Pred("v", "<", 3)]},
              within=20, slide=10),
        Query("q2", Seq(C, Kleene(B)), within=20, slide=20),
        Query("q3", Kleene(B), within=20, slide=20),
        Query("q4", Seq(A, Kleene(B), C, Not(X)), within=20, slide=20),
    ])


def _baselines_batch(rng, n):
    types = rng.integers(0, 4, n)
    times = np.sort(rng.choice(np.arange(1, 40), size=n, replace=False))
    attrs = rng.integers(0, 5, (n, 2)).astype(float)
    return EventBatch(SCHEMA, types, times, attrs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mcep_and_brute_match_reference(seed):
    """``test_mcep_matches_brute``'s inputs: both baselines bitwise equal
    to the reference's, and to each other on COUNT(*)."""
    batch = _baselines_batch(np.random.default_rng(seed), 12)
    wl = _baselines_wl()
    pwl, pst = port_wl(wl), port_stream(batch)
    got_b = brute.brute_run(pwl, pst, 40)
    got_m = mcep.mcep_run(pwl, pst, 40)
    assert_bitwise(got_b, ref_brute_run(wl, batch, 40), ("brute", seed))
    assert_bitwise(got_m, ref_mcep_run(wl, batch, 40), ("mcep", seed))
    for k in got_b:
        assert got_m[k]["COUNT(*)"] == got_b[k]["COUNT(*)"], k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sharon_matches_reference(seed):
    """``test_sharon_matches_brute``'s inputs: SHARON bitwise equal to the
    reference's, and within 1e-6 of brute force."""
    batch = _baselines_batch(np.random.default_rng(100 + seed), 14)
    wl = _baselines_wl()
    pwl, pst = port_wl(wl), port_stream(batch)
    got = sharon.sharon_run(pwl, pst, 40)
    assert_bitwise(got, ref_sharon_run(wl, batch, 40), ("sharon", seed))
    want = brute.brute_run(pwl, pst, 40)
    for k in want:
        assert abs(got[k]["COUNT(*)"] - want[k]["COUNT(*)"]) < 1e-6, k


def test_sharon_non_count_aggregates_run_greta_on_the_host():
    """SHARON's non-COUNT branch takes GRETA's numpy path (no device is
    asked for), bitwise the reference's."""
    wl = Workload(SCHEMA, [
        Query("q", Seq(A, Kleene(B)),
              aggs=(count_star(), agg_sum("B", "v"), agg_max("B", "w")),
              within=20, slide=10)])
    batch = _baselines_batch(np.random.default_rng(7), 14)
    got = sharon.sharon_run(port_wl(wl), port_stream(batch), 40)
    assert_bitwise(got, ref_sharon_run(wl, batch, 40), "sharon-sum")


def test_mcep_trend_explosion_raises(monkeypatch):
    monkeypatch.setattr(mcep, "MAX_TRENDS", 50)
    wl = Workload(SCHEMA, [Query("q", Kleene(B), within=20, slide=20)])
    n = 12
    batch = EventBatch(SCHEMA, np.ones(n, np.int32), np.arange(1, n + 1),
                       np.zeros((n, 2)))
    with pytest.raises(RuntimeError, match="MCEP trend explosion"):
        mcep.mcep_run(port_wl(wl), port_stream(batch), 20)


# ------------------------------- GRETA on tests/test_differential.py's case


def _diff_wl(extra_aggs=False):
    q1_aggs = (count_star(), agg_sum("B", "v"))
    if extra_aggs:
        q1_aggs += (agg_avg("B", "v"), count_type("B"), agg_min("B", "v"))
    return Workload(DIFF_SCHEMA, [
        Query("q1", Seq(A, Kleene(B)), aggs=q1_aggs, within=20, slide=10),
        Query("q2", Seq(C, Kleene(B)), preds={"B": [Pred("v", "<", 3)]},
              within=20, slide=20),
        Query("q3", Kleene(B), within=20, slide=10),
    ])


def _diff_batch(rng, n_runs, max_len=8):
    """``tests/test_differential.py``'s bursty stream: runs of one type,
    one event per tick."""
    evs = []
    for _ in range(n_runs):
        t = int(rng.integers(0, 3))
        for _ in range(int(rng.integers(1, max_len + 1))):
            evs.append((t, int(rng.integers(0, 5))))
    n = len(evs)
    types = np.array([t for t, _ in evs], dtype=np.int32)
    attrs = (np.array([[float(v)] for _, v in evs]).reshape(n, 1)
             if n else None)
    return EventBatch(DIFF_SCHEMA, types, np.arange(1, n + 1), attrs)


@pytest.mark.parametrize("seed", range(6))
def test_greta_matches_reference(seed):
    """Port ``np`` bitwise, port ``torch`` (CPU) within rtol 1e-12, both
    against the reference's ``greta_run(backend="np")``."""
    rng = np.random.default_rng(100 + seed)
    batch = _diff_batch(rng, n_runs=int(rng.integers(0, 8)))
    wl = _diff_wl(extra_aggs=seed % 2 == 1)
    want = ref_greta_run(wl, batch, 40, backend="np")
    pwl, pst = port_wl(wl), port_stream(batch)
    assert_bitwise(greta.greta_run(pwl, pst, 40, backend="np"), want,
                   ("np", seed))
    assert_close(greta.greta_run(pwl, pst, 40, backend="torch",
                                 device="cpu"), want, ("torch", seed))


def _long_window():
    """One window of 38 relevant events (n >= 25: the doubling oracle on
    np and torch, the Pallas kernel on the reference's pallas backend)."""
    batch = _diff_batch(np.random.default_rng(6), n_runs=12, max_len=6)
    q = _diff_wl(extra_aggs=True).atomic[0]
    ev = batch.time_slice(0, 40)
    return q, ev


def test_greta_window_matches_pallas_interpret():
    q, ev = _long_window()
    keep = np.isin(ev.type_id, [0, 1, 2])
    assert keep.sum() >= 25
    want = ref_window_eval_greta(DIFF_SCHEMA, q, ev, [0, 1, 2],
                                 backend="pallas", pane=10)
    want_np = ref_window_eval_greta(DIFF_SCHEMA, q, ev, [0, 1, 2],
                                    backend="np", pane=10)
    pq = port_wl(Workload(DIFF_SCHEMA, [
        Query("q1", q.pattern, aggs=q.aggs, within=q.within,
              slide=q.slide)])).atomic[0]
    pev = port_stream(ev)
    timers = greta.GretaTimers()
    for backend, device in (("np", None), ("torch", "cpu")):
        got = greta.window_eval_greta(interop.schema_from(
            DIFF_SCHEMA.types, DIFF_SCHEMA.attrs), pq, pev, [0, 1, 2],
            backend=backend, pane=10, device=device, timers=timers)
        assert_close({0: got}, {0: want}, ("pallas", backend))
        if backend == "np":
            assert vals_equal(got, want_np)
    assert want["COUNT(*)"] > 0
    # two evaluations of the window: the counts, then one propagation per
    # SUM unit (SUM(B.v) and COUNT(B))
    assert timers.windows == 2 and timers.max_n == len(ev)
    assert timers.propagations == 2 * 3
    assert timers.h2d_s >= 0.0 and timers.adjacency_s > 0.0


def test_greta_values_are_python_floats():
    rng = np.random.default_rng(101)
    batch = _diff_batch(rng, n_runs=6)
    res = greta.greta_run(port_wl(_diff_wl(True)), port_stream(batch), 40,
                          backend="torch", device="cpu")
    assert res
    assert all(type(v) is float for r in res.values() for v in r.values())


def test_greta_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    batch = _diff_batch(np.random.default_rng(1), n_runs=4)
    pwl, pst = port_wl(_diff_wl()), port_stream(batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greta.greta_run(pwl, pst, 40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greta.greta_run(pwl, pst, 40, backend="torch")
    with pytest.raises(ValueError):
        greta.greta_run(pwl, pst, 40, backend="cuda", device="cpu")


# ------------------------------------------------ fig9's workload, saturated


def _ref_fig9_case(events_per_minute, minutes):
    from benchmarks.common import kleene_workload
    from benchmarks.fig9_vs_sota import HEADS
    from repro.streams.generator import RIDESHARING_SCHEMA, ridesharing_stream

    wl = kleene_workload(RIDESHARING_SCHEMA, 5, kleene_type="Travel",
                         head_types=HEADS, within=60, slide=30,
                         pred_attr="speed")
    stream = ridesharing_stream(events_per_minute=events_per_minute,
                                minutes=minutes, n_groups=4, seed=0,
                                burstiness=0.95)
    return wl, stream


def test_fig9_case_matches_benchmarks():
    """The port's copy of ``benchmarks/fig9_vs_sota.py``'s workload and
    stream equals the JAX package's."""
    from repro_torch.launch.fig9 import fig9_case

    wl, stream = _ref_fig9_case(1000, 2)
    pwl, pst, t_end = fig9_case(1000)
    assert t_end == 120
    assert interop.workload_spec(pwl) == interop.workload_spec(wl)
    for col in ("type_id", "time", "attrs", "group"):
        assert np.array_equal(getattr(pst, col), getattr(stream, col)), col


def test_saturated_greta_is_nan_where_hamlet_is_inf():
    """Pins a saturation difference between the two algorithms, in both
    packages: on fig9's workload at 8,000 events/min, the window of group
    0, query q1 (1,971 events) overflows f64.  HAMLET's COUNT is +inf;
    GRETA's is NaN, because its dense adjacency forms 0 * inf for every
    non-edge past the first overflowed row (the reference's numpy
    doubling, the port's np and torch backends, and the forward
    substitution of the masked kernel's plain version, whose rows are part
    +inf, part NaN)."""
    from repro.core.baselines.greta import window_adjacency
    from repro.core.engine import ComponentContext
    from repro.core.engine import HamletRuntime as RefRuntime
    from repro_torch.core.engine import HamletRuntime
    from repro_torch.kernels.hamlet_propagate import \
        masked_prefix_propagate_cuda

    wl, stream = _ref_fig9_case(8000, 1)
    pwl, pst = port_wl(wl), port_stream(stream)
    key = ("q1", 0, 0)
    ref_ham = RefRuntime(wl).run(stream, 60)[key]["COUNT(*)"]
    ham = HamletRuntime(pwl, backend="np").run(pst, 60)[key]["COUNT(*)"]
    ham_t = HamletRuntime(pwl, backend="torch", device="cpu").run(
        pst, 60)[key]["COUNT(*)"]
    assert ref_ham == ham == ham_t == math.inf

    run_ids = ComponentContext(wl.schema, list(wl.atomic)).relevant_type_ids
    ev = stream.partition_by_group()[0].time_slice(0, 60)
    pev = port_stream(ev)
    assert len(ev) == 1971
    q, pq = wl.atomic[1], pwl.atomic[1]
    want = ref_window_eval_greta(wl.schema, q, ev, run_ids, backend="np",
                                 pane=30)["COUNT(*)"]
    got = greta.window_eval_greta(pwl.schema, pq, pev, run_ids, backend="np",
                                  pane=30)["COUNT(*)"]
    got_t = greta.window_eval_greta(pwl.schema, pq, pev, run_ids,
                                    backend="torch", pane=30,
                                    device="cpu")["COUNT(*)"]
    assert math.isnan(want) and math.isnan(got) and math.isnan(got_t)

    adj, start, end_valid, _, _ = window_adjacency(wl.schema, q, ev, run_ids,
                                                   pane=30)
    c = masked_prefix_propagate_cuda(
        torch.as_tensor(start[None, :, None]),
        torch.as_tensor(adj[None]))[0, :, 0].numpy()
    assert np.isnan(c).any() and np.isposinf(c).any()
    assert math.isnan(float((c * end_valid).sum()))


# ------------------- fig9's large but finite counts: the exact-path rule


@functools.lru_cache(maxsize=None)
def _fig9_8000_windows(qi):
    """Window 0 of each group of fig9's case at 8,000 ev/min for query
    ``qi``: the reference's ``(ev, adj, start, end_valid, sub)`` and the
    row loop's count vector."""
    from repro.core.baselines.greta import window_adjacency
    from repro.core.engine import ComponentContext
    from repro.kernels.ref import numpy_prefix_propagate

    wl, stream = _ref_fig9_case(8000, 1)
    run_ids = ComponentContext(wl.schema, list(wl.atomic)).relevant_type_ids
    out = {}
    for g, gb in sorted(stream.partition_by_group().items()):
        ev = gb.time_slice(0, 60)
        adj, start, end_valid, _, sub = window_adjacency(
            wl.schema, wl.atomic[qi], ev, run_ids, pane=30)
        row = numpy_prefix_propagate(start[:, None], adj)[:, 0]
        out[g] = (ev, adj, start, end_valid, sub, row)
    return wl, stream, run_ids, out


def _plain_counts(adj, start):
    """The masked kernel's plain version (what the wrapper runs on a CPU
    tensor) on one window."""
    from repro_torch.kernels.hamlet_propagate import \
        masked_prefix_propagate_cuda

    return masked_prefix_propagate_cuda(
        torch.as_tensor(start[None, :, None]),
        torch.as_tensor(adj[None]))[0, :, 0].numpy()


def test_large_finite_greta_counts_follow_the_row_loop():
    """fig9 at 8,000 ev/min, window 0 of groups 0, 2 and 3, query q0: the
    true COUNT is finite (~1e285-1e301).  The reference's
    ``window_eval_greta(backend="np")`` is NaN (its doubling's matrix
    powers overflow into 0 * inf); its row loop is finite and equals the
    reference ``HamletRuntime``'s COUNT to rtol 1e-12; the port's np
    backend keeps the reference's NaN.  The masked kernel's plain version
    equals the row loop row for row: bitwise on every row below 2^53
    (integer-valued, exact in any order), within rtol 1e-12 above, where
    the two add each row's products in another order (torch's batched
    matmul against numpy's vecmat); non-finite rows at the same
    positions."""
    from repro.core.engine import HamletRuntime as RefRuntime

    wl, stream, run_ids, wins = _fig9_8000_windows(0)
    ham = RefRuntime(wl).run(stream, 60)
    pwl, q, pq = port_wl(wl), wl.atomic[0], port_wl(wl).atomic[0]
    held = []
    for g in (0, 2, 3):
        ev, adj, start, end_valid, sub, row = wins[g]
        doubling = ref_window_eval_greta(wl.schema, q, ev, run_ids,
                                         backend="np", pane=30)["COUNT(*)"]
        row_count = float((row * end_valid).sum())
        assert math.isnan(doubling) and math.isfinite(row_count), g
        assert math.isclose(row_count, ham[("q0", g, 0)]["COUNT(*)"],
                            rel_tol=1e-12), g
        want, kind = exact_oracle(doubling, row_count)
        assert kind == "row loop" and want == row_count
        got_np = greta.window_eval_greta(pwl.schema, pq, port_stream(ev),
                                         run_ids, backend="np",
                                         pane=30)["COUNT(*)"]
        assert math.isnan(got_np), g
        c = _plain_counts(adj, start)
        for f in (np.isnan, np.isposinf, np.isneginf):
            assert np.array_equal(f(c), f(row)), g
        fin = np.isfinite(row)
        small = fin & (np.abs(row) < 2.0 ** 53)
        assert small.sum() > 100 and np.array_equal(c[small], row[small])
        big = fin & ~small
        assert big.any()
        assert np.allclose(c[big], row[big], rtol=1e-12, atol=0.0), g
        got = float((c * end_valid).sum())
        assert math.isclose(got, want, rel_tol=1e-12), (g, got, want)
        held.append(g)
    assert held == [0, 2, 3]
    # the other window of q0 is saturated in the row loop too: the rule
    # keeps the reference's value there
    *_, end_valid, _, row = wins[1]
    assert exact_oracle(math.nan, float((row * end_valid).sum()))[1] == \
        "doubling"


def test_large_finite_minmax_follows_the_row_loop():
    """``chip_smoke.py::minmax_variant`` (``MIN(Travel.speed)`` on q0,
    ``MAX(Travel.duration)`` on q1) on the same stream: all 8 windows are
    NaN in the reference ``HamletRuntime`` (its MIN/MAX reads
    ``counts > 0`` off the doubling's NaN rows; the port's np and torch
    backends run the same doubling for b >= 25); the reference's
    ``_minmax_propagate`` fed with its row loop's counts gives finite
    values (group 0: MIN 0.00185, MAX 9.9936), and the port's, fed with
    the masked kernel's plain counts, the same values bitwise."""
    import dataclasses

    from repro.core.baselines.greta import \
        _minmax_propagate as ref_minmax_propagate
    from repro.core.engine import HamletRuntime as RefRuntime

    wl0, stream, run_ids, _ = _fig9_8000_windows(0)
    extra = {0: agg_min("Travel", "speed"), 1: agg_max("Travel", "duration")}
    wl = Workload(wl0.schema, [
        dataclasses.replace(q, aggs=q.aggs + (extra[i],)) if i in extra
        else q for i, q in enumerate(wl0.queries)])
    ref = RefRuntime(wl).run(stream, 60)
    pwl = port_wl(wl)
    values = {}
    for qi, agg in extra.items():
        wins = _fig9_8000_windows(qi)[3]
        for g, (ev, adj, start, end_valid, sub, row) in wins.items():
            key, a = (f"q{qi}", g, 0), repr(agg)
            assert math.isnan(ref[key][a]), (key, a)
            want = ref_minmax_propagate(wl.schema, agg, sub, adj, row, start,
                                        end_valid)
            assert math.isfinite(want), (key, a)
            assert exact_oracle(ref[key][a], want) == (want, "row loop")
            got = greta._minmax_propagate(
                pwl.schema, pwl.atomic[qi].aggs[-1], port_stream(sub), adj,
                _plain_counts(adj, start), start, end_valid)
            assert got == want, (key, a, got, want)
            values[key] = got
    assert len(values) == 8
    assert round(values[("q0", 0, 0)], 5) == 0.00185
    assert round(values[("q1", 0, 0)], 4) == 9.9936
