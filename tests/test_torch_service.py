"""The port's streaming service (``repro_torch.core.service``) against the
JAX package's, on the CPU.

The scenarios of ``tests/test_service.py`` run through the reference (which
always replays on numpy), through the port on ``backend="np"`` and through
the port on ``backend="torch", device="cpu"``, on the same inputs made from
numpy seeds and carried across with ``repro_torch.interop``:

* the out-of-order buffer's released batches equal the reference's, column
  for column;
* emitted windows: np bitwise (``vals_equal``) against the reference's and
  against a batch run of the port's own ``HamletRuntime`` on the same
  backend, keyed by the same (shifted back) window starts; torch with COUNT
  exact, SUM/AVG within rtol 1e-12 and the non-finite pattern equal;
* the epoch arithmetic (epoch length, replay counts) and the dynamic
  add/remove of queries as the reference's.
"""

import math

import numpy as np
import pytest

from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.events import EventBatch, StreamSchema
from repro.core.pattern import EventType, Kleene, Seq
from repro.core.query import Query, Workload, agg_avg, agg_sum, count_star
from repro.core.service import HamletService as RefService
from repro.core.service import OutOfOrderBuffer as RefOOO
from repro_torch import interop
from repro_torch.core.engine import HamletRuntime, vals_equal
from repro_torch.core.service import HamletService, OutOfOrderBuffer

SCHEMA = StreamSchema(types=("A", "B", "C"), attrs=("v",))
A, B, C = map(EventType, "ABC")
BACKENDS = [("np", None), ("torch", "cpu")]
IDS = [b for b, _ in BACKENDS]


def port_wl(wl):
    return interop.workload_from(interop.workload_spec(wl))


def port_stream(batch):
    c = interop.stream_columns(batch)
    return interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                              c["type_id"], c["time"], c["attrs"], c["group"],
                              c["seq"])


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
            if not math.isfinite(wv):
                assert (math.isnan(gv) and math.isnan(wv)) or gv == wv, \
                    (tag, k, a, gv, wv)
            elif a.startswith("COUNT"):
                assert gv == wv, (tag, k, a, gv, wv)
            else:
                assert math.isclose(gv, wv, rel_tol=1e-12), (tag, k, a, gv, wv)


def _queries(aggs=False):
    a1 = (count_star(), agg_sum("B", "v")) if aggs else (count_star(),)
    a2 = (count_star(), agg_avg("B", "v")) if aggs else (count_star(),)
    return [Query("q1", Seq(A, Kleene(B)), aggs=a1, within=10, slide=5),
            Query("q2", Seq(C, Kleene(B)), aggs=a2, within=10, slide=10)]


def _port_queries(qs):
    return port_wl(Workload(SCHEMA, qs)).queries


def _stream(n=40, t_max=40, seed=0, groups=2):
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, n)
    times = np.sort(rng.integers(0, t_max, n))
    attrs = rng.integers(0, 5, (n, 1)).astype(float)
    return EventBatch(SCHEMA, types, times, attrs,
                      rng.integers(0, groups, n))


def _service(qs, backend, device, **kw):
    pwl = port_wl(Workload(SCHEMA, qs))
    return HamletService(pwl.schema, pwl.queries, backend=backend,
                         device=device, **kw)


def _feed(svc, batch, step, conv=lambda b: b):
    got = {}
    for i in range(0, len(batch), step):
        got.update(svc.feed(conv(batch.select(
            np.arange(i, min(i + step, len(batch)))))))
    got.update(svc.close())
    return got


def _columns(b):
    return (b.type_id.tolist(), b.time.tolist(),
            b.attrs.tolist() if len(b) else [], b.group.tolist())


def test_ooo_buffer_reorders_within_lateness():
    """Shuffled chunks through both buffers: every release equal to the
    reference's, the whole stream time-sorted and complete."""
    batch = _stream(seed=3)
    perm = np.random.default_rng(4).permutation(len(batch))
    for lateness in (50, 5, 0):
        buf = OutOfOrderBuffer(port_wl(Workload(SCHEMA, _queries())).schema,
                               lateness=lateness)
        ref = RefOOO(SCHEMA, lateness=lateness)
        outs = []
        for i in range(0, len(batch), 7):
            idx = perm[i:i + 7]
            cols = (batch.type_id[idx], batch.time[idx], batch.attrs[idx],
                    batch.group[idx])
            out = buf.feed_arrays(*cols)
            assert _columns(out) == _columns(ref.feed_arrays(*cols))
            outs.append(out)
        out = buf.flush()
        assert _columns(out) == _columns(ref.flush())
        outs.append(out)
        assert buf.dropped_late == ref.dropped_late
        merged = EventBatch.concat([port_stream(o) for o in outs if len(o)])
        assert (np.diff(merged.time) >= 0).all()
        if lateness == 50:
            assert buf.dropped_late == 0 and len(merged) == len(batch)
            assert sorted(merged.time.tolist()) == sorted(batch.time.tolist())


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
@pytest.mark.parametrize("micro_batch", [1, 4])
def test_service_matches_batch_run(backend, device, micro_batch):
    """Epoch-by-epoch feeding reproduces the one-shot runtime: the port's
    windows equal the reference service's and a batch run of the port's
    own runtime on the same backend, under the same window keys."""
    batch = _stream(n=60, t_max=40, seed=5)
    qs = _queries(aggs=True)
    ref = RefService(SCHEMA, qs)
    want = _feed(ref, batch, 9)
    for k, v in RefRuntime(Workload(SCHEMA, qs)).run(batch,
                                                     t_end=40).items():
        assert vals_equal(want[k], v), k
    svc = _service(qs, backend, device, micro_batch=micro_batch)
    got = _feed(svc, batch, 9, port_stream)
    assert_windows(got, want, backend, exact=backend == "np")
    assert svc._epoch_len == ref._epoch_len == 10
    assert svc.stats.windows_emitted == ref.stats.windows_emitted
    assert svc.stats.panes == ref.stats.panes
    batch_run = HamletRuntime(port_wl(Workload(SCHEMA, qs)), backend=backend,
                              device=device).run(port_stream(batch), t_end=40)
    assert set(batch_run) <= set(got)
    for k in batch_run:
        assert vals_equal(got[k], batch_run[k]), k
    # one replay runtime for every epoch, on the service's own device
    assert svc._rt.backend == backend and svc._rt.device == svc.device
    assert svc._rt.micro_batch == micro_batch


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_service_out_of_order_stream(backend, device):
    """Shuffled arrivals within the lateness bound: the reference's
    results, and the batch run's (unique timestamps, as in the reference's
    test: ties among duplicates follow arrival order)."""
    rng0 = np.random.default_rng(6)
    types = rng0.integers(0, 3, 30)
    times = np.sort(rng0.choice(np.arange(40), size=30, replace=False))
    attrs = rng0.integers(0, 5, (30, 1)).astype(float)
    batch = EventBatch(SCHEMA, types, times, attrs, rng0.integers(0, 2, 30))
    perm = np.random.default_rng(7).permutation(len(batch))
    runs = []
    for svc, conv in ((RefService(SCHEMA, _queries(), lateness=40),
                       lambda b: b),
                      (_service(_queries(), backend, device, lateness=40),
                       port_stream)):
        got = {}
        for i in range(0, len(batch), 11):
            idx = perm[i:i + 11]
            ready = svc._ooo.feed_arrays(batch.type_id[idx], batch.time[idx],
                                         batch.attrs[idx], batch.group[idx])
            svc._append(conv(ready))
            got.update(svc._drain(final=False))
        got.update(svc.close())
        runs.append(got)
    assert_windows(runs[1], runs[0], backend, exact=backend == "np")
    want = HamletRuntime(port_wl(Workload(SCHEMA, _queries())),
                         backend=backend, device=device).run(
        port_stream(batch), t_end=40)
    for k in want:
        assert vals_equal(runs[1][k], want[k]), k


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_service_dynamic_add_remove(backend, device):
    """A query added mid-stream reports from the next epoch on, a removed
    one stops, survivors are unaffected — window for window the
    reference's."""
    batch = _stream(n=80, t_max=60, seed=8, groups=1)
    q3 = Query("q3", Kleene(B), within=10, slide=10)
    runs = []
    for make, conv, q3x in (
            (lambda: RefService(SCHEMA, _queries()), lambda b: b, q3),
            (lambda: _service(_queries(), backend, device), port_stream,
             _port_queries([q3])[0])):
        svc = make()
        assert svc._epoch_len == 10
        first = svc.feed(conv(batch.select(np.nonzero(batch.time < 20)[0])))
        svc.add_query(q3x)
        svc.remove_query("q2")
        later = svc.feed(conv(batch.select(np.nonzero(batch.time >= 20)[0])))
        later.update(svc.close())
        assert all(k[0] != "q3" for k in first)
        assert any(k[0] == "q3" for k in later)
        assert all(not (k[0] == "q2" and k[2] >= 30) for k in later)
        runs.append((first, later, svc._query_since))
    for got, want in zip(runs[1][:2], runs[0][:2]):
        assert_windows(got, want, backend, exact=backend == "np")
    assert runs[1][2] == runs[0][2]
    want = HamletRuntime(port_wl(Workload(SCHEMA, _queries())),
                         backend=backend, device=device).run(
        port_stream(batch), t_end=60)
    emitted = {**runs[1][0], **runs[1][1]}
    for k, v in want.items():
        if k[0] == "q1" and k in emitted:
            assert vals_equal(emitted[k], v), k


def test_service_observability_epoch_spans():
    """With ``obs`` attached, each epoch replay adds an ``epoch`` span on
    the engine track, as in the reference; results are unchanged."""
    from repro_torch.obs import Observability

    batch = _stream(n=60, t_max=40, seed=5)
    plain = _feed(_service(_queries(), "np", None), batch, 9, port_stream)
    obs = Observability()
    svc = _service(_queries(), "np", None, obs=obs)
    got = _feed(svc, batch, 9, port_stream)
    assert_windows(got, plain, "obs", exact=True)
    epochs = [e for e in obs.tracer.events() if e.get("name") == "epoch"]
    assert len(epochs) == 4 and all(e["cat"] == "service" for e in epochs)
