"""The port's event-time subsystem against the JAX package's, on the CPU.

Scenarios of ``tests/test_eventtime.py`` and ``tests/test_revision_memory.py``
run through the reference (its numpy backend, as its own tests run it),
through the port on ``backend="np"`` and through the port on
``backend="torch", device="cpu"``, on the same inputs made from numpy seeds
and carried across with ``repro_torch.interop``:

* watermarks, reorder buffers and frontiers: every watermark, sealed pane,
  late and expired batch equal to the reference's (host numpy);
* emission records (kind, query, group, window, revision number,
  speculative flag) equal to the reference's, record for record; their
  values and the final post-revision windows bitwise (``vals_equal``) on
  np, and on torch with COUNT exact, SUM/AVG within rtol 1e-12 and the
  non-finite pattern equal; the runtime's metrics, evictions and the
  error accountant's cells equal;
* the final windows also against the port's own in-order ``HamletRuntime``
  on the time-sorted stream.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.events import EventBatch, StreamSchema
from repro.core.pattern import EventType, Kleene, Not, Seq
from repro.core.query import (Query, Workload, agg_avg, agg_max, agg_sum,
                              count_star)
from repro.core.service import HamletService as RefService
from repro.eventtime import BoundedSkew as RefBoundedSkew
from repro.eventtime import EventTimeConfig as RefETC
from repro.eventtime import EventTimeRuntime as RefETR
from repro.eventtime import GroupHeartbeat as RefGroupHeartbeat
from repro.eventtime import PercentileAdaptive as RefPercentile
from repro.eventtime import ReorderBuffer as RefReorderBuffer
from repro.overload import ErrorAccountant as RefAccountant
from repro.streams.generator import DisorderConfig, apply_disorder
from repro_torch import interop
from repro_torch.core.engine import HamletRuntime, vals_equal
from repro_torch.core.service import HamletService
from repro_torch.eventtime import (BoundedSkew, EventTimeConfig,
                                   EventTimeRuntime, GroupHeartbeat,
                                   PercentileAdaptive, ReorderBuffer,
                                   make_watermark)
from repro_torch.overload import ErrorAccountant

SCHEMA = StreamSchema(types=("A", "B", "C", "D"), attrs=("v",))
A, B, C, D = map(EventType, "ABCD")
BACKENDS = [("np", None), ("torch", "cpu")]
IDS = [b for b, _ in BACKENDS]


def port_wl(wl):
    return interop.workload_from(interop.workload_spec(wl))


def port_stream(batch):
    c = interop.stream_columns(batch)
    return interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                              c["type_id"], c["time"], c["attrs"], c["group"],
                              c["seq"])


PSCHEMA = interop.schema_from(SCHEMA.types, SCHEMA.attrs)


def close_vals(g, w, exact):
    """``exact``: ``vals_equal``; else COUNT exact, other aggregates within
    rtol 1e-12, the non-finite pattern equal."""
    if exact:
        return vals_equal(g, w)
    if g.keys() != w.keys():
        return False
    for a, wv in w.items():
        gv = g[a]
        if not math.isfinite(wv):
            if not ((math.isnan(gv) and math.isnan(wv)) or gv == wv):
                return False
        elif a.startswith("COUNT"):
            if gv != wv:
                return False
        elif not math.isclose(gv, wv, rel_tol=1e-12):
            return False
    return True


def assert_windows(got, want, tag, exact):
    assert got.keys() == want.keys(), tag
    for k, w in want.items():
        assert close_vals(got[k], w, exact), (tag, k, got[k], w)


def assert_records(got, want, tag, exact):
    """Record for record: every field equal, the values as above."""
    assert len(got) == len(want), (tag, len(got), len(want))
    for g, w in zip(got, want):
        assert (g.kind, g.query, g.group, g.w0, g.revision, g.speculative) \
            == (w.kind, w.query, w.group, w.w0, w.revision, w.speculative), \
            (tag, g, w)
        assert (g.vals is None) == (w.vals is None), (tag, g, w)
        if w.vals is not None:
            assert close_vals(g.vals, w.vals, exact), (tag, g, w)


def accountant_state(acc):
    return ({k: list(v) for k, v in acc._shed.items()}, set(acc._tainted),
            acc.total_shed, acc.late_events,
            {n: dataclasses.astuple(r) for n, r in acc.report().items()})


class Side:
    """The reference, or the port on one backend."""

    def __init__(self, backend=None, device=None):
        self.ref = backend is None
        self.backend = backend or "ref"
        self.kw = {} if self.ref else {"backend": backend, "device": device}
        self.exact = backend in (None, "np")

    def wl(self, wl):
        return wl if self.ref else port_wl(wl)

    def batch(self, b):
        return b if self.ref else port_stream(b)

    def cfg(self, **kw):
        return (RefETC if self.ref else EventTimeConfig)(**kw)

    def et(self, wl, accountant=False, **kw):
        cfg = self.cfg(**kw.pop("cfg"))
        if accountant:
            kw["accountant"] = (RefAccountant if self.ref
                                else ErrorAccountant)(self.wl(wl))
        return (RefETR if self.ref else EventTimeRuntime)(
            self.wl(wl), cfg, **self.kw, **kw)

    def runtime(self, wl, **kw):
        return (RefRuntime if self.ref else HamletRuntime)(
            self.wl(wl), **self.kw, **kw)

    def service(self, qs, **kw):
        wl = self.wl(Workload(SCHEMA, qs))
        if "eventtime" in kw:
            kw["eventtime"] = self.cfg(**kw["eventtime"])
        if "overload" in kw:
            from repro.overload import OverloadConfig as RefOC
            from repro_torch.overload import OverloadConfig as OC
            kw["overload"] = (RefOC if self.ref else OC)(**kw["overload"])
        return (RefService if self.ref else HamletService)(
            wl.schema, wl.queries, **self.kw, **kw)


REF = Side()
PORTS = [Side(b, d) for b, d in BACKENDS]


def _wl(with_not=True, with_aggs=False):
    aggs1 = ((count_star(), agg_sum("B", "v")) if with_aggs
             else (count_star(),))
    qs = [Query("q1", Seq(A, Kleene(B)), aggs=aggs1, within=10, slide=5),
          Query("q2", Kleene(B), within=10, slide=10)]
    if with_not:
        qs.append(Query("q3", Seq(A, Kleene(B), Not(C)), within=10,
                        slide=10))
    if with_aggs:
        qs.append(Query("q4", Seq(C, Kleene(B)),
                        aggs=(count_star(), agg_avg("B", "v"),
                              agg_max("B", "v")),
                        within=20, slide=10))
    return Workload(SCHEMA, qs)


def _stream(n=150, t_max=40, seed=0, groups=2, p=(0.2, 0.55, 0.1, 0.15)):
    rng = np.random.default_rng(seed)
    types = rng.choice(4, n, p=list(p)).astype(np.int32)
    times = np.sort(rng.integers(0, t_max, n))
    attrs = rng.integers(0, 5, (n, 1)).astype(float)
    return EventBatch(SCHEMA, types, times, attrs,
                      rng.integers(0, groups, n))


def _batch(types, times, groups=None):
    return EventBatch(SCHEMA, np.array(types, np.int32),
                      np.array(times, np.int64), None,
                      None if groups is None else np.array(groups, np.int64))


def _columns(b):
    return None if b is None else (b.type_id.tolist(), b.time.tolist(),
                                   b.group.tolist(), b.seq.tolist()
                                   if b.seq is not None else None)


# ------------------------------------------------------------- watermarks


def _observe_script(port, ref, script):
    for step in script:
        if step[0] == "obs":
            args = [np.array(x) for x in step[1:]]
            assert port.observe(*args) == ref.observe(*args)
        else:
            assert port.heartbeat(*step[1:]) == ref.heartbeat(*step[1:])
        assert port.watermark() == ref.watermark()
    return port.watermark()


def test_bounded_skew_watermark():
    """max_seen - skew - 1: an event exactly ``skew`` late stays inside."""
    wm, ref = BoundedSkew(skew=5), RefBoundedSkew(skew=5)
    script = [("obs", [10, 12]), ("obs", [7]), ("obs", [30])]
    assert [_observe_script(wm, ref, [s]) for s in script] == [6, 6, 24]
    with pytest.raises(ValueError):
        BoundedSkew(skew=-1)


def test_percentile_watermark_adapts_to_disorder():
    calm = PercentileAdaptive(percentile=95, window=64)
    assert _observe_script(calm, RefPercentile(percentile=95, window=64),
                           [("obs", np.arange(100))]) == 98
    rng = np.random.default_rng(0)
    t = np.arange(200) + rng.integers(0, 15, 200)
    rough = PercentileAdaptive(percentile=95, window=64)
    ref = RefPercentile(percentile=95, window=64)
    chunks = [("obs", t[i:i + 23]) for i in range(0, 200, 23)]
    _observe_script(rough, ref, chunks)
    assert 2 <= int(t.max()) - rough.watermark() <= 16
    assert rough.current_skew == ref.current_skew
    cap = PercentileAdaptive(percentile=100, window=32, max_skew=4)
    assert _observe_script(cap, RefPercentile(percentile=100, window=32,
                                              max_skew=4),
                           [("obs", [100, 0, 100])]) == 95


def test_group_heartbeat_watermark():
    script = [("obs", [10, 20], [0, 1]), ("hb", 0, 20)]
    wm = GroupHeartbeat(skew=0)
    assert _observe_script(wm, RefGroupHeartbeat(skew=0), script) == 19
    wm2 = GroupHeartbeat(skew=0, idle_timeout=5)
    assert _observe_script(wm2, RefGroupHeartbeat(skew=0, idle_timeout=5),
                           [("obs", [10, 40], [0, 1])]) == 39


def test_make_watermark_and_config():
    with pytest.raises(ValueError):
        EventTimeConfig(watermark="nope")
    for bad in ({"skew": -1}, {"percentile": 0.0},
                {"lateness_horizon": -1}, {"max_retained_panes": 0}):
        with pytest.raises(ValueError):
            EventTimeConfig(**bad)
    assert dataclasses.asdict(EventTimeConfig()) == dataclasses.asdict(
        RefETC())
    for name, cls in (("bounded_skew", BoundedSkew),
                      ("percentile", PercentileAdaptive),
                      ("group_heartbeat", GroupHeartbeat)):
        assert type(make_watermark(EventTimeConfig(watermark=name))) is cls


def test_routed_frontier_matches_reference():
    from repro.eventtime import FrontierSnapshot as RefSnap
    from repro.eventtime import RoutedFrontier as RefRouted
    from repro_torch.eventtime import FrontierSnapshot, RoutedFrontier

    script = [("obs", [5, 9]), ("hb", 0, 30), ("obs", [12]), ("hb", 3, 20),
              ("obs", [60])]
    wm, ref = RoutedFrontier(skew=2), RefRouted(skew=2)
    assert _observe_script(wm, ref, script) == 57
    assert wm.promises == ref.promises == 2
    snap, rsnap = FrontierSnapshot(1, 57, 45, 30), RefSnap(1, 57, 45, 30)
    assert (snap.epoch(15), snap.backlog()) == (rsnap.epoch(15),
                                                rsnap.backlog()) == (2, 15)


# ---------------------------------------------------------- reorder buffer


def _reorder_script(make, conv, script):
    buf = make()
    out = []
    for step in script:
        if step[0] == "push":
            r = buf.push(conv(EventBatch.from_unsorted(SCHEMA, *step[1:])))
        elif step[0] == "hb":
            r = buf.heartbeat(*step[1:])
        else:
            r = buf.flush()
        out.append(([(sp.t0, _columns(sp.events)) for sp in r.sealed],
                    _columns(r.late), _columns(r.expired), r.n_late,
                    r.n_expired, buf.watermark, buf.sealed_end, len(buf)))
    return out, (buf.late_total, buf.expired_total)


@pytest.mark.parametrize("case", ["seal", "late", "ties", "heartbeat"])
def test_reorder_buffer_matches_reference(case):
    """``test_reorder_buffer_seals_contiguous_panes``, ``_routes_late_and
    _expired``, ``_merges_ties_by_seq`` and a heartbeat-driven seal, step
    by step against the reference's buffer."""
    pane, skew, horizon, wm = {
        "seal": (5, 3, None, "bs"), "late": (5, 0, 10, "bs"),
        "ties": (10, 0, None, "bs"), "heartbeat": (5, 0, None, "hb")}[case]
    script = {
        "seal": [("push", [0, 1, 1], [7, 2, 11]), ("push", [0], [18]),
                 ("flush",)],
        "late": [("push", [0], [20]), ("push", [1, 1, 1], [15, 3, 21])],
        "ties": [("push", [1], [4], None, None, [7]),
                 ("push", [2], [4], None, None, [3]), ("flush",)],
        "heartbeat": [("push", [1, 1], [3, 25], None, [0, 1]),
                      ("hb", 0, 25), ("flush",)],
    }[case]

    def make(ref):
        pol = ((RefBoundedSkew if ref else BoundedSkew)(skew=skew)
               if wm == "bs" else
               (RefGroupHeartbeat if ref else GroupHeartbeat)(skew=skew))
        return lambda: (RefReorderBuffer if ref else ReorderBuffer)(
            SCHEMA if ref else PSCHEMA, pane=pane, policy=pol,
            lateness_horizon=horizon)

    got = _reorder_script(make(False), port_stream, script)
    assert got == _reorder_script(make(True), lambda b: b, script)
    steps, totals = got
    if case == "seal":
        assert [t0 for t0, _ in steps[0][0]] == [0]
        assert [t0 for t0, _ in steps[1][0]] == [5, 10]
        assert [t0 for t0, _ in steps[2][0]] == [15]
    elif case == "late":
        assert steps[1][1][1] == [15] and steps[1][2][1] == [3]
        assert totals == (1, 1)
    elif case == "ties":
        assert steps[2][0][0][1][0] == [2, 1]
    else:
        assert steps[0][0] == [] and steps[1][0]


# ----------------------------------------------- speculative runtime: basics


def _ingest_all(et, side, chunks):
    recs = []
    for ch in chunks:
        recs += et.ingest(side.batch(ch))
    return recs


def _three(fn):
    """Run ``fn(side)`` on the reference and both port backends; returns
    the reference's output and the ports' with their sides."""
    want = fn(REF)
    return want, [(side, fn(side)) for side in PORTS]


def test_inorder_stream_matches_plain_runtime_and_never_amends():
    wl = _wl(with_aggs=True)
    batch = _stream(n=200, t_max=40, seed=1)
    chunks = [batch.select(np.arange(i, min(i + 17, len(batch))))
              for i in range(0, len(batch), 17)]

    def run(side):
        et = side.et(wl, cfg={"skew": 4})
        recs = _ingest_all(et, side, chunks) + et.flush(t_end=40)
        return recs, et.results(), et.metrics.summary()

    (want_r, want, want_m), ports = _three(run)
    for side, (recs, got, m) in ports:
        assert_records(recs, want_r, side.backend, side.exact)
        assert_windows(got, want, side.backend, side.exact)
        assert m == want_m and m["amendments"] == m["panes_revised"] == 0
        assert_windows(got, side.runtime(wl).run(side.batch(batch),
                                                 t_end=40), side.backend,
                       exact=True)


def test_speculative_emission_and_revision_records():
    """``test_speculative_emission_precedes_watermark``, ``test_revision_
    emits_retract_amend_pairs`` and ``test_noop_revision_stays_silent``."""
    wl = _wl(with_not=False)
    batch = _stream(n=100, t_max=40, seed=2, groups=1)
    chunks = [batch.select(np.arange(i, min(i + 10, len(batch))))
              for i in range(0, len(batch), 10)]

    def run(side):
        et = side.et(wl, cfg={"skew": 15})
        spec = _ingest_all(et, side, chunks)
        et2 = side.et(wl, cfg={"skew": 0})
        rev = _ingest_all(et2, side, [_batch([0, 1, 1], [0, 1, 3]),
                                      _batch([1], [12]), _batch([1], [2])])
        et3 = side.et(wl, cfg={"skew": 0})
        noop = _ingest_all(et3, side, [_batch([0, 1], [0, 3]),
                                       _batch([1], [12]), _batch([3], [2])])
        return (spec, rev, noop, et.metrics.summary(),
                et2.metrics.summary(), et3.metrics.summary())

    want, ports = _three(run)
    for side, got in ports:
        for g, w in zip(got[:3], want[:3]):
            assert_records(g, w, side.backend, side.exact)
        assert got[3:] == want[3:]
        spec, rev, noop, m1, m2, m3 = got
        assert any(r.speculative for r in spec if r.kind == "emit")
        kinds = [r.kind for r in rev]
        assert kinds[-4:] == ["retract", "amend", "retract", "amend"]
        assert m2["amendments"] == 2 and m2["retractions"] == 2
        assert not [r for r in noop if r.kind in ("retract", "amend")]
        assert m3["noop_revisions"] > 0 and m3["amendments"] == 0


def test_expired_events_routed_to_accountant():
    wl = _wl()

    def run(side):
        et = side.et(wl, accountant=True,
                     cfg={"skew": 0, "lateness_horizon": 5})
        recs = _ingest_all(et, side, [_batch([1], [30]), _batch([1], [2])])
        acc = et.accountant
        return (recs, et.metrics.expired, accountant_state(acc),
                dataclasses.astuple(acc.window_bound("q2", 0, 0)))

    want, ports = _three(run)
    for side, got in ports:
        assert_records(got[0], want[0], side.backend, side.exact)
        assert got[1:] == want[1:]
        assert got[1] == 1 and got[2][3] == 1
        assert got[3][0] == 1 and got[3][3] is False


@pytest.mark.parametrize("case", ["one_chunk", "tie_order", "truncate",
                                  "absorb", "heartbeat"])
def test_runtime_edges_match_reference(case):
    """``test_single_large_chunk_never_expires_its_own_events``, ``test_whole
    _stream_as_one_chunk_keeps_producer_tie_order``, ``test_flush_t_end_
    truncates_and_extends``, ``test_straggler_into_unemitted_window_absorbed
    _despite_horizon`` and ``test_group_heartbeat_unblocks_baseline_
    emission``: records, final windows and metrics as the reference's."""
    def run(side):
        out = []
        if case == "one_chunk":
            wl = _wl(with_aggs=True)
            batch = _stream(n=200, t_max=60, seed=11)
            for spec in (True, False):
                et = side.et(wl, cfg={"skew": 0, "lateness_horizon": 5,
                                      "speculative": spec})
                recs = et.ingest(side.batch(batch)) + et.flush(t_end=60)
                out.append((recs, et.results(), et.metrics.expired))
        elif case == "tie_order":
            wl = _wl(with_aggs=True)
            batch = _stream(n=200, t_max=40, seed=13)
            ds = apply_disorder(batch, DisorderConfig(fraction=0.4,
                                                      max_skew=9, seed=14))
            for chunk in (len(batch), 77):
                et = side.et(wl, cfg={"skew": 2})
                base = side.batch(ds.base)
                out.append(([], et.run_disordered(base, ds.order,
                                                  chunk=chunk, t_end=40),
                            et.metrics.amendments))
        elif case == "truncate":
            wl = _wl(with_not=False)
            batch = _stream(n=120, t_max=40, seed=12, groups=1)
            et = side.et(wl, cfg={"skew": 100, "speculative": False})
            recs = et.ingest(side.batch(batch)) + et.flush(t_end=20)
            out.append((recs, et.results(), 0))
            et2 = side.et(wl, cfg={"skew": 0})
            recs = et2.ingest(side.batch(batch.time_slice(0, 20)))
            out.append((recs + et2.flush(t_end=40), et2.results(), 0))
        elif case == "absorb":
            wl = Workload(SCHEMA, [Query("q", Seq(A, Kleene(B)), within=60,
                                         slide=60)])
            et = side.et(wl, cfg={"skew": 0, "lateness_horizon": 5})
            recs = _ingest_all(et, side, [_batch([0, 1], [10, 30]),
                                          _batch([1], [20])])
            out.append((recs + et.flush(t_end=60), et.results(),
                        et.metrics.expired))
        else:
            wl = _wl(with_not=False)
            et = side.et(wl, cfg={"watermark": "group_heartbeat", "skew": 0,
                                  "speculative": False})
            recs = et.ingest(side.batch(_batch([1, 1], [3, 25], [0, 1])))
            assert recs == []
            out.append((et.heartbeat(0, 25), et.results(), 0))
        return out

    want, ports = _three(run)
    for side, got in ports:
        for (recs, res, n), (wrecs, wres, wn) in zip(got, want):
            assert_records(recs, wrecs, (case, side.backend), side.exact)
            assert_windows(res, wres, (case, side.backend), side.exact)
            assert n == wn
    if case in ("one_chunk", "absorb"):
        assert all(n == 0 for _, _, n in want)
    if case == "heartbeat":
        assert any(r.kind == "emit" for r in want[0][0])


# ----------------------------------------------------- differential sweeps


def _differential(side, fraction, seed, speculative):
    wl = _wl(with_aggs=True)
    batch = _stream(n=180, t_max=40, seed=seed, groups=2)
    ds = apply_disorder(batch, DisorderConfig(model="bounded_skew",
                                              fraction=fraction,
                                              max_skew=12, seed=seed + 100))
    skew = 2 if speculative else ds.max_lateness()
    et = side.et(wl, cfg={"skew": skew, "speculative": speculative})
    recs = []
    for i in range(0, len(ds.order), 13):
        idx = np.asarray(ds.order[i:i + 13])
        recs += et.ingest(side.batch(EventBatch.from_unsorted(
            SCHEMA, ds.base.type_id[idx], ds.base.time[idx],
            ds.base.attrs[idx], ds.base.group[idx], seq=idx)))
    recs += et.flush(t_end=40)
    truth = side.runtime(wl).run(side.batch(batch), t_end=40)
    return recs, et.results(), truth, et.metrics.summary(), et


@pytest.mark.parametrize("speculative,seed", [(True, 3), (False, 4)],
                         ids=["bounded_skew_is_bitwise_exact",
                              "buffer_baseline_exact"])
def test_differential(speculative, seed):
    """``test_differential_bounded_skew_is_bitwise_exact`` and
    ``test_differential_buffer_baseline_exact``: the emission records, the
    final windows and the metrics equal the reference's, and the final
    windows equal the in-order runtime's on the time-sorted stream."""
    wrecs, want, wtruth, wm, _ = _differential(REF, 0.3, seed, speculative)
    assert_windows(want, wtruth, "ref", exact=True)
    for side in PORTS:
        recs, got, truth, m, et = _differential(side, 0.3, seed, speculative)
        assert_records(recs, wrecs, side.backend, side.exact)
        assert_windows(got, want, side.backend, side.exact)
        assert_windows(got, truth, side.backend, side.exact)
        assert m == wm
        if speculative:
            assert m["amendments"] > 0
            # the storms' re-folds ran stacked through the fold executor
            assert et.rt.fold_exec.window_folds > 0


def test_differential_across_micro_batch():
    """K = 4 fused pane execution gives the K = 1 records and windows."""
    for side in PORTS:
        recs, got, _, m, _ = _differential(side, 0.3, 3, True)
        wl = _wl(with_aggs=True)
        batch = _stream(n=180, t_max=40, seed=3, groups=2)
        ds = apply_disorder(batch, DisorderConfig(fraction=0.3, max_skew=12,
                                                  seed=103))
        et = side.et(wl, cfg={"skew": 2}, micro_batch=4)
        got4 = et.run_disordered(side.batch(ds.base), ds.order, chunk=13,
                                 t_end=40)
        assert_windows(got4, got, side.backend, exact=True)
        assert et.metrics.summary()["amendments"] == m["amendments"]


# ------------------------------------------------------------ service mode


def test_service_eventtime_revises_to_exact_results():
    qs = [Query("q1", Seq(A, Kleene(B)), within=10, slide=5),
          Query("q2", Kleene(B), within=10, slide=10)]
    batch = _stream(n=200, t_max=60, seed=7)
    ds = apply_disorder(batch, DisorderConfig(fraction=0.4, max_skew=14,
                                              seed=8))

    def run(side):
        ordered = side.service(qs)
        for i in range(0, len(batch), 40):
            ordered.feed(side.batch(batch.select(np.arange(
                i, min(i + 40, len(batch))))))
        ordered.close()
        svc = side.service(qs, eventtime={"skew": 2})
        for ch in ds.chunks(7):
            svc.feed(side.batch(ch))
        svc.close()
        return svc.revisions, svc.results, ordered.results, svc.expired_late

    (wrev, want, wordered, wexp), ports = _three(run)
    assert wrev and wexp == 0
    assert_windows(want, wordered, "ref", exact=True)
    for side, (rev, got, ordered, exp) in ports:
        assert_records(rev, wrev, side.backend, side.exact)
        assert_windows(got, want, side.backend, side.exact)
        assert_windows(got, ordered, side.backend, exact=True)
        assert exp == 0
        assert all(r.kind in ("emit", "retract", "amend") for r in rev)


def test_service_horizon_and_late_added_queries():
    """``test_service_honours_horizon_deeper_than_window`` and
    ``test_service_revision_does_not_resurrect_late_added_queries``."""
    qs = [Query("q1", Kleene(B), within=10, slide=10)]
    qnew = Query("qnew", Kleene(B), within=10, slide=10)

    def run(side):
        svc = side.service(qs, eventtime={"skew": 0, "lateness_horizon": 50})
        n = 60
        svc.feed(side.batch(_batch(np.ones(n), np.arange(n))))
        svc.feed(side.batch(_batch([1], [70])))
        before = svc.results[("q1", 0, 20)]["COUNT(*)"]
        recs = svc.revise(side.batch(_batch([1], [25])))
        svc2 = side.service(qs, eventtime={"skew": 0})
        svc2.feed(side.batch(_batch(np.ones(40), np.arange(40),
                                    np.arange(40) % 2)))
        svc2.add_query(side.wl(Workload(SCHEMA, [qnew])).queries[0])
        svc2.feed(side.batch(_batch(np.ones(10), np.arange(40, 50))))
        recs2 = svc2.revise(side.batch(_batch([1], [25])))
        return (recs, before, svc.results[("q1", 0, 20)]["COUNT(*)"],
                svc.expired_late, recs2, svc2._t_done)

    want, ports = _three(run)
    for side, got in ports:
        assert_records(got[0], want[0], side.backend, side.exact)
        assert_records(got[4], want[4], side.backend, side.exact)
        assert got[1:4] == want[1:4] and got[5] == want[5]
        recs, before, after, expired, recs2, t_done = got
        assert expired == 0 and after > before
        assert any(r.kind == "amend" and r.w0 == 20 for r in recs)
        assert recs2 and all(r.w0 == 20 and r.group == 0 for r in recs2)
        assert not any(r.query == "qnew" and r.w0 + 10 <= t_done
                       for r in recs2)


def test_service_expired_stragglers_charge_the_accountant():
    """The tail of ``test_service_revision_does_not_resurrect_late_added_
    queries``: stragglers beyond the horizon expire into the overload
    accountant, cell for cell as in the reference."""
    qs = [Query("q1", Seq(A, Kleene(B)), within=10, slide=10)]
    batch = _stream(n=150, t_max=60, seed=9)
    ds = apply_disorder(batch, DisorderConfig(model="adversarial_tail",
                                              fraction=0.3, seed=10,
                                              tail_scale=25.0))

    def run(side):
        svc = side.service(qs, eventtime={"skew": 0, "lateness_horizon": 5},
                           overload={"shed_policy": "benefit_weighted",
                                     "fixed_shed": 0.0})
        for ch in ds.chunks(9):
            svc.feed(side.batch(ch))
        svc.close()
        return (svc.expired_late, accountant_state(svc.overload.accountant),
                svc.results)

    want, ports = _three(run)
    assert want[0] > 0 and want[1][3] == want[0]
    for side, got in ports:
        assert got[:2] == want[:2]
        assert_windows(got[2], want[2], side.backend, side.exact)


# ------------------------------------------- bounded revision memory (cap)

MSCHEMA = StreamSchema(types=("A", "B"), attrs=("v",))


def _mwl(within=4, slide=2):
    return Workload(MSCHEMA, [
        Query("q", Seq(EventType("A"), Kleene(EventType("B"))),
              aggs=(count_star(),), within=within, slide=slide)])


def _mchunk(t0, evs):
    n = len(evs)
    return EventBatch(MSCHEMA, np.array([t for t, _ in evs], np.int32),
                      np.arange(t0, t0 + n),
                      np.array([[float(v)] for _, v in evs]).reshape(n, 1))


def _mpane(t0):
    return _mchunk(t0, [(0, 1), (1, 1)])


def _mruntime(side, cap, accountant=False):
    return side.et(_mwl(), accountant=accountant,
                   cfg={"watermark": "bounded_skew", "skew": 0,
                        "lateness_horizon": 100, "max_retained_panes": cap,
                        "speculative": True})


def test_cap_validation():
    with pytest.raises(ValueError):
        EventTimeConfig(max_retained_panes=0)
    with pytest.raises(ValueError):
        RefETC(max_retained_panes=0)


def _retained(et):
    return sorted(t0 for t0, ps in et._panes[0].items() if not ps.evicted)


def test_eviction_order_and_accounting():
    def run(side):
        rt = _mruntime(side, 2, accountant=True)
        recs = _ingest_all(rt, side, [_mpane(2 * p) for p in range(6)])
        return (recs, list(rt.evictions), _retained(rt),
                rt.metrics.evicted_panes, accountant_state(rt.accountant),
                [(rt._panes[g][t0].M is not None,
                  len(rt._panes[g][t0].events)) for g, t0 in rt.evictions],
                dataclasses.astuple(rt.accountant.window_bound(
                    "q", *rt.evictions[0])))

    want, ports = _three(run)
    for side, got in ports:
        assert_records(got[0], want[0], side.backend, side.exact)
        assert got[1:] == want[1:]
        recs, ev, retained, n_ev, acc, kept, wb = got
        assert [t0 for _g, t0 in ev] == sorted(t0 for _g, t0 in ev)
        assert len(retained) <= 2 and n_ev == len(ev) > 0
        assert acc[3] == acc[2] == 2 * len(ev)
        assert wb[3] is False
        assert all(m and n == 0 for m, n in kept)


def test_straggler_into_evicted_pane_expires():
    def run(side):
        rt = _mruntime(side, 1)
        _ingest_all(rt, side, [_mpane(2 * p) for p in range(5)])
        g, t0 = rt.evictions[0]
        e0, a0 = rt.metrics.expired, rt.metrics.amendments
        recs = rt.ingest(side.batch(_mchunk(t0 + 1, [(1, 9)])))
        return recs, (e0, rt.metrics.expired, a0, rt.metrics.amendments)

    want, ports = _three(run)
    for side, (recs, counts) in ports:
        assert_records(recs, want[0], side.backend, side.exact)
        assert counts == want[1]
        assert counts[1] == counts[0] + 1 and counts[3] == counts[2]
        assert not [r for r in recs if r.kind in ("retract", "amend")]


def test_straggler_into_retained_pane_still_revises():
    def run(side):
        rt = _mruntime(side, 3)
        _ingest_all(rt, side, [_mpane(2 * p) for p in range(4)])
        return rt.ingest(side.batch(_mchunk(_retained(rt)[0] + 1, [(1, 5)])))

    want, ports = _three(run)
    for side, recs in ports:
        assert_records(recs, want, side.backend, side.exact)
        kinds = [r.kind for r in recs]
        assert "retract" in kinds and "amend" in kinds


def test_results_match_uncapped_without_stragglers():
    def run(side):
        out = []
        for cap in (1, None):
            rt = _mruntime(side, cap)
            recs = _ingest_all(rt, side, [_mpane(2 * p) for p in range(8)])
            out.append((recs + rt.flush(), rt.results()))
        return out

    want, ports = _three(run)
    for side, got in ports:
        (crecs, capped), (urecs, uncapped) = got
        assert_windows(capped, uncapped, side.backend, exact=True)
        assert_records(crecs, want[0][0], side.backend, side.exact)
        assert_windows(capped, want[0][1], side.backend, side.exact)


def test_disorder_case_matches_benchmarks():
    """The port's copy of ``benchmarks/fig_disorder.py``'s workload,
    stream, disorder and event-time configurations equals the JAX
    package's."""
    from benchmarks.common import kleene_workload
    from benchmarks.fig_disorder import WORKLOAD_SHAPE
    from repro.streams.generator import NAMED_STREAMS
    from repro_torch.launch.fig_disorder import (disorder_case,
                                                 event_time_config)

    for dataset in ("ridesharing", "taxi"):
        wl, base, ds, t_end = disorder_case(dataset, minutes=2,
                                            events_per_minute=300,
                                            n_queries=3)
        schema = NAMED_STREAMS[dataset](minutes=1).schema
        assert interop.workload_spec(wl) == interop.workload_spec(
            kleene_workload(schema, 3, within=60, slide=15,
                            **WORKLOAD_SHAPE[dataset]))
        ref = NAMED_STREAMS[dataset](minutes=2, events_per_minute=300)
        rds = apply_disorder(ref, DisorderConfig(model="bounded_skew",
                                                 fraction=0.2, max_skew=12,
                                                 seed=5))
        for col in ("type_id", "time", "attrs", "group"):
            assert np.array_equal(getattr(base, col), getattr(ref, col))
        assert np.array_equal(ds.order, rds.order) and t_end == 120
        for spec in (True, False):
            cfg = event_time_config(ds, spec)
            assert (cfg.skew, cfg.speculative, cfg.lateness_horizon) == (
                2 if spec else max(rds.max_lateness(), 1), spec, None)
