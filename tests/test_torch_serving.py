"""The port's serving tier (session, scheduler, front-end, transport)
against the JAX package's, on the CPU.

Twins of ``tests/test_serving.py`` (without its checkpoint and prefetch
tests, which belong to the LM substrate) and ``tests/test_transport.py``,
on the same inputs carried across with ``repro_torch.interop``: the port's
front-end on ``np_backend="np"`` and ``np_backend="torch", device="cpu"``
against the reference's epoch-synchronous run of the merged stream —
bitwise on both backends here (the held rule of
``test_torch_shardsvc.hold`` is checked first) — for every seeded
interleaving of session submissions, in order and under event-time
disorder; delivery channels, continuous batching, admission, the sharded
adapter on the front-end's backend (the reference's runs numpy whatever it
is asked), the thread drive, the wire codecs (the reference's bytes), the
credit gate, loopback parity and socket hygiene.  And across packages: a
reference ``ServingClient`` against a port ``ServingServer`` and a port
client against a reference server, bitwise, with every pickled frame
naming builtins and numpy only.
"""

import asyncio
import os
import pickle
import threading
import time

import numpy as np
import pytest

from repro.core.engine import HamletRuntime as RefRuntime
from repro.eventtime.config import EventTimeConfig as RefETC
from repro.overload.config import OverloadConfig as RefOC
from repro.overload.runtime import OverloadRuntime as RefOverloadRuntime
from repro.serve import ServingClient as RefClient
from repro.serve import ServingFrontend as RefFrontend
from repro.serve import ServingServer as RefServer
from repro.serve.session import Delivery as RefDelivery
from repro.serve.transport import decode_deliveries as ref_decode_deliveries
from repro.serve.transport import encode_chunk as ref_encode_chunk
from repro.serve.transport import encode_deliveries as ref_encode_deliveries
from repro.streams.generator import (NAMED_STREAMS, DisorderConfig,
                                     apply_disorder)
from repro_torch.core.engine import vals_equal
from repro_torch.core.events import EventBatch
from repro_torch.eventtime.config import EventTimeConfig
from repro_torch.eventtime.frontier import FrontierSnapshot
from repro_torch.obs import Observability
from repro_torch.overload.config import OverloadConfig
from repro_torch.overload.ingress import IngressQueue
from repro_torch.serve import (ContinuousBatcher, CreditGate, ServingClient,
                               ServingFrontend, ServingServer)
from repro_torch.serve import transport as port_transport
from repro_torch.serve.session import Delivery
from repro_torch.serve.transport import (decode_chunk, decode_deliveries,
                                         encode_chunk, encode_deliveries)
from repro_torch.shardsvc import ShardServiceConfig, WatermarkAligner
from test_torch_shardsvc import (BACKEND_IDS, DATASETS, PORTS, REF, _wl,
                                 assert_same, port_stream, port_wl)
from test_torch_shardsvc import collect_garbage_after_module  # noqa: F401

NP = PORTS[0]

STREAM_KW = {"ridesharing": dict(events_per_minute=250, minutes=1,
                                 n_groups=6),
             "stock": dict(events_per_minute=300, minutes=1, n_groups=6),
             "smarthome": dict(events_per_minute=300, minutes=1,
                               n_groups=6),
             "taxi": dict(events_per_minute=250, minutes=1, n_groups=6)}


def _dataset(name, **kw):
    schema, kleene, heads = DATASETS[name]
    return (_wl(schema, kleene, heads),
            NAMED_STREAMS[name](**dict(STREAM_KW[name], **kw)))


def _by_tenant(stream, n_tenants, groups_per_tenant=2):
    parts = []
    for t in range(n_tenants):
        lo, hi = t * groups_per_tenant, (t + 1) * groups_per_tenant
        mask = (stream.group >= lo) & (stream.group < hi)
        parts.append(stream.select(np.flatnonzero(mask)))
    return parts


def _frontend(side, wl, **kw):
    """The port's front-end for one backend side (``side.kw`` becomes
    ``np_backend``/``device``), the reference's for ``REF``-like sides."""
    kw.setdefault("backend", "overload")
    if "overload" not in kw:
        kw["overload"] = dict(shed_policy="none", micro_batch=4)
    if kw["overload"] is not None:
        kw["overload"] = side.overload(**kw["overload"])
    else:
        del kw["overload"]
    if "eventtime" in kw:
        kw["eventtime"] = (RefETC if side.ref else EventTimeConfig)(
            **kw["eventtime"])
    kw.setdefault("groups_per_tenant", 2)
    if side.ref:
        return RefFrontend(wl, **kw)
    return ServingFrontend(port_wl(wl), np_backend=side.kw["backend"],
                           device=side.kw["device"], **kw)


def _reference_run(wl, stream, k=4):
    return RefOverloadRuntime(wl, RefOC(shed_policy="none",
                                        micro_batch=k)).run(stream)


def _trickle(fe, parts, seed, chunk=40, pump_p=0.5):
    """Random seeded interleaving: sessions submit chunks in shuffled
    order, pumping stochastically along the way."""
    rng = np.random.default_rng(seed)
    sessions = [fe.open_session(tenant=t) for t in range(len(parts))]
    cursors = [0] * len(parts)
    while any(c < len(p) for c, p in zip(cursors, parts)):
        t = int(rng.integers(0, len(parts)))
        if cursors[t] >= len(parts[t]):
            continue
        c0 = cursors[t]
        c1 = min(c0 + chunk, len(parts[t]))
        sessions[t].submit(parts[t].select(np.arange(c0, c1)))
        cursors[t] = c1
        if rng.random() < pump_p:
            fe.pump()
    for s in sessions:
        s.close()
    return sessions


def _wait_sessions_closed(fe, n, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while True:
        sess = fe.summary()["sessions"]
        if len(sess) >= n and all(s["closed"] for s in sess.values()):
            return
        assert time.perf_counter() < deadline, "sessions never closed"
        time.sleep(0.005)


def _delivery_tuple(d):
    return (d.kind, d.query, d.group, d.w0, d.revision,
            None if d.vals is None else tuple(sorted(d.vals.items())))


# ------------------------------------------------- determinism contract


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_serving_determinism_sweep(name, side):
    """For any interleaving of session submissions the drained results
    equal the reference's epoch-synchronous run of the merged stream —
    3 seeded schedules per dataset."""
    wl, stream = _dataset(name)
    want = _reference_run(wl, stream)
    parts = _by_tenant(port_stream(stream), 3)
    for seed in (0, 1, 2):
        fe = _frontend(side, wl)
        _trickle(fe, parts, seed)
        assert_same(fe.drain(), want, (name, seed))


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_serving_eventtime_disorder_determinism(name, side):
    """Event-time backend: a disordered arrival split over three sessions
    repairs to the reference's in-order batch run for every seeded
    interleaving."""
    wl, stream = _dataset(name)
    t_end = ((int(stream.time.max()) // 10) + 1) * 10
    want = RefRuntime(wl).run(stream, t_end=t_end)
    ds = apply_disorder(stream, DisorderConfig(fraction=0.3, max_skew=6,
                                               seed=5))
    base = port_stream(ds.base)
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        fe = _frontend(side, wl, backend="eventtime", overload=None,
                       eventtime=dict(skew=8), micro_batch=2, skew=8)
        sessions = [fe.open_session(tenant=t) for t in range(3)]
        cur = 0
        while cur < len(base):
            n = int(rng.integers(20, 60))
            idx = ds.order[cur:min(cur + n, len(base))]
            sub = EventBatch.from_unsorted(
                base.schema, base.type_id[idx], base.time[idx],
                base.attrs[idx], base.group[idx], seq=base.seq[idx])
            sessions[int(rng.integers(0, 3))].submit(sub)
            cur += n
            if rng.random() < 0.5:
                fe.pump()
        for s in sessions:
            s.close()
        fe.drain()
        got = {k: v for k, v in fe.results().items() if k in want}
        assert_same(got, want, (name, seed))


def test_session_ordering_per_group():
    """One session's channel sees each (query, group) window exactly once,
    in nondecreasing w0 order, only for its groups — and the very
    deliveries the reference's session sees."""
    wl, stream = _dataset("ridesharing")
    chans = {}
    for side in (NP, REF):
        fe = _frontend(side, wl, overload=dict(shed_policy="none",
                                               micro_batch=2))
        parts = _by_tenant(stream if side.ref else port_stream(stream), 3)
        sessions = _trickle(fe, parts, seed=3)
        fe.drain()
        total = 0
        chans[side.ref] = []
        for t, s in enumerate(sessions):
            seen_w0 = {}
            got = s.poll()
            for d in got:
                assert d.kind == "emit"
                assert d.group // 2 == t, "delivery routed to wrong tenant"
                seen_w0.setdefault((d.query, d.group), []).append(d.w0)
            total += len(got)
            for key, w0s in seen_w0.items():
                assert w0s == sorted(w0s), key
                assert len(set(w0s)) == len(w0s), key
            assert s.drained
            chans[side.ref].append(sorted(_delivery_tuple(d) for d in got))
        assert total == len(fe.results())
    assert chans[False] == chans[True]


def test_retraction_channel_delivery():
    """A straggler landing in an already emitted window gives a retract +
    amend pair on exactly the subscribing session's channel — the same
    records, in the same order, as the reference's."""
    wl, _ = _dataset("ridesharing")
    stream = NAMED_STREAMS["ridesharing"](events_per_minute=250, minutes=1,
                                          n_groups=4)
    chans = {}
    for side in (NP, REF):
        fe = _frontend(side, wl, backend="eventtime", overload=None,
                       eventtime=dict(skew=4, speculative=True), skew=0)
        s0 = fe.open_session(tenant=0)
        s1 = fe.open_session(tenant=1)
        st = stream if side.ref else port_stream(stream)
        g0 = st.select(np.flatnonzero(st.group < 2))
        g1 = st.select(np.flatnonzero(st.group >= 2))
        late_n = 8
        s1.submit(g1)
        s0.submit(g0.select(np.arange(late_n, len(g0))))
        fe.pump()
        s0.submit(g0.select(np.arange(late_n)))
        s0.close()
        s1.close()
        fe.drain()
        d0, d1 = s0.poll(), s1.poll()
        assert all(d.group < 2 for d in d0)
        assert all(d.group >= 2 for d in d1)
        assert {"retract", "amend"} <= {d.kind for d in d0}
        assert not any(d.kind == "retract" for d in d1)
        by_key = {}
        for d in d0:
            by_key.setdefault((d.query, d.group, d.w0), []).append(d)
        for key, ds in by_key.items():
            for i, d in enumerate(ds):
                if d.kind == "amend":
                    assert i > 0 and ds[i - 1].kind == "retract", key
                    assert not vals_equal(ds[i - 1].vals, d.vals)
        chans[side.ref] = ([_delivery_tuple(d) for d in d0],
                           [_delivery_tuple(d) for d in d1])
    assert chans[False] == chans[True]


# ------------------------------------------------- continuous batching


def test_continuous_batcher_watermark_and_seal():
    wl, _ = _dataset("ridesharing")
    cb = ContinuousBatcher(port_wl(wl).schema, pane=10, skew=0)
    schema = cb.schema
    cb.track(0)
    cb.track(1)
    t = np.arange(25, dtype=np.int64)
    b = EventBatch(schema, np.zeros(25, np.int32), t,
                   np.zeros((25, len(schema.attrs)), np.float64),
                   np.zeros(25, np.int64), seq=t)
    cb.stage(0, b)
    assert cb.watermark() == 0
    assert cb.seal() == (None, 0)
    cb.advance(1, 18)
    chunk, boundary = cb.seal()
    assert boundary == 10 and len(chunk) == 10
    cb.release(1)
    chunk, boundary = cb.seal()
    assert boundary == 20 and len(chunk) == 10
    assert cb.sealed_events == 20 and len(cb) == 5
    cb.release(0)
    assert cb.watermark() == 20
    assert cb.seal() == (None, 20)
    with pytest.raises(ValueError):
        ContinuousBatcher(schema, pane=0)


def test_session_opening_after_all_others_closed_keeps_its_stream():
    """A transient empty session set must not finalize: a session opening
    after every other closed still gets its windows."""
    wl, stream = _dataset("ridesharing")
    gpt = 3
    fe = _frontend(NP, wl, groups_per_tenant=gpt)
    p0, p1 = _by_tenant(port_stream(stream), 2, groups_per_tenant=gpt)
    hi = int(stream.time.max()) + 1
    sA = fe.open_session(tenant=1)
    sA.submit(p1)
    sA.advance_to(hi)
    sA.close()
    fe.pump()
    sB = fe.open_session(tenant=0)
    sB.submit(p0)
    sB.advance_to(hi)
    sB.close()
    assert_same(fe.drain(), _reference_run(wl, stream))
    got_b = [d for d in sB.poll() if d.kind != "retract"]
    assert got_b and all(d.group < gpt for d in got_b)


def test_sessions_fill_shared_microbatches():
    """Concurrent trickles land in the same K-pane fused flushes as the
    one-stream run (the reference's flush count)."""
    wl, stream = _dataset("ridesharing")
    K = 4
    ref_rt = RefOverloadRuntime(wl, RefOC(shed_policy="none", micro_batch=K))
    ref_rt.run(stream)
    fe = _frontend(NP, wl, overload=dict(shed_policy="none", micro_batch=K))
    _trickle(fe, _by_tenant(port_stream(stream), 3), seed=1, chunk=25,
             pump_p=0.8)
    fe.drain()
    srv_rt = fe._backend.rt
    assert srv_rt.metrics.summary()["panes"] == \
        ref_rt.metrics.summary()["panes"]
    assert srv_rt.rt.executor.flushes == pytest.approx(
        ref_rt.rt.executor.flushes, abs=2)


def test_session_admission_sheds_at_the_door():
    wl, stream = _dataset("ridesharing")
    fe = _frontend(NP, wl, overload=dict(shed_policy="drop_tail",
                                         fixed_shed=0.5),
                   session_admission=True)
    s = fe.open_session(tenant=0, groups="all")
    accepted = s.submit(port_stream(stream))
    assert accepted == pytest.approx(len(stream) * 0.5, rel=0.01)
    fe.drain()
    summ = fe.summary()
    assert summ["session_shed"] == len(stream) - accepted
    assert summ["sessions"][0]["shed"] == summ["session_shed"]


def test_ingress_queue_concurrent_producers_stress():
    """Many producer threads offering into one IngressQueue: no event is
    lost or duplicated."""
    wl, stream = _dataset("ridesharing")
    stream = port_stream(stream)
    q = IngressQueue(stream.schema, capacity=1 << 20)
    n_threads, per_thread = 8, 30
    rng = np.random.default_rng(0)
    cuts = np.sort(rng.choice(np.arange(1, len(stream)),
                              n_threads * per_thread - 1, replace=False))
    subs = [stream.select(np.arange(a, b))
            for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(stream)])]
    accepted = [0] * n_threads
    barrier = threading.Barrier(n_threads)

    def produce(i):
        barrier.wait()
        for sub in subs[i::n_threads]:
            accepted[i] += q.offer(sub)

    threads = [threading.Thread(target=produce, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sum(accepted) == len(stream)
    drained = q.poll_until(int(stream.time.max()) + 1)
    want = sorted(zip(stream.time.tolist(), stream.type_id.tolist()))
    got = sorted(zip(drained.time.tolist(), drained.type_id.tolist()))
    assert got == want


# ------------------------------------------------- parallel shard drive


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_parallel_shard_drive_bitwise_parity(side):
    """The thread drive (workers meeting at the aligner's rendezvous)
    equals the serial drive and the reference bitwise, aligned epochs
    included."""
    wl, stream = _dataset("stock")
    ref_svc = REF.service(wl, 4)
    want = ref_svc.run(stream, chunk_ticks=10)
    runs = {}
    for parallel in (False, True):
        svc = side.service(wl, 4, parallel=parallel)
        runs[parallel] = (svc.run(port_stream(stream), chunk_ticks=10),
                          svc.aligner.aligned_epoch)
        assert svc.drive_cycles > 0
    assert_same(runs[True][0], runs[False][0])
    assert_same(runs[True][0], want)
    assert runs[False][1] == runs[True][1] == ref_svc.aligner.aligned_epoch


def test_aligner_rendezvous_blocks_until_all_arrive():
    al = WatermarkAligner(3, align_every=10)
    out = {}

    def arrive(s, wm):
        out[s] = al.arrive(FrontierSnapshot(shard=s, watermark=wm,
                                            sealed_end=wm, processed_end=wm))

    threads = [threading.Thread(target=arrive, args=(s, 20 + s))
               for s in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=0.2)
    assert all(t.is_alive() for t in threads), \
        "rendezvous released before the last shard arrived"
    arrive(2, 25)
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive()
    assert set(out) == {0, 1, 2}
    assert len(set(out.values())) == 1, "shards saw different epochs"
    assert out[0] == 2


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_serving_sharded_backend_matches_single(side):
    """The sharded adapter (2 shards, thread drive) runs on the front-end's
    backend — forwarded to every shard — and equals the reference's
    single-runtime run."""
    wl, stream = _dataset("taxi")
    cfg = ShardServiceConfig(
        n_shards=2, admission="none", parallel=True,
        overload=OverloadConfig(shed_policy="none", micro_batch=4))
    fe = _frontend(side, wl, backend="sharded", shard_cfg=cfg,
                   overload=None)
    svc = fe._backend.svc
    assert svc.backend == side.kw["backend"]
    assert all(w.rt.rt.backend == side.kw["backend"] for w in svc.workers)
    assert fe.device == svc.device == svc.workers[0].device
    _trickle(fe, _by_tenant(port_stream(stream), 3), seed=2)
    assert_same(fe.drain(), _reference_run(wl, stream))


# ------------------------------------------------- pipelined flush


def test_pipelined_flush_bitwise_parity():
    from repro_torch.overload.runtime import OverloadRuntime

    wl, stream = _dataset("smarthome")
    want = _reference_run(wl, stream)
    for pipelined in (False, True):
        rt = OverloadRuntime(port_wl(wl), OverloadConfig(
            shed_policy="none", micro_batch=4, pipeline_flush=pipelined),
            backend="np")
        got = rt.run(port_stream(stream))
        rt.shutdown()
        assert_same(got, want, pipelined)


# ------------------------------------------------- async consumption


def test_async_stream_iterator_delivers_everything():
    wl, stream = _dataset("ridesharing")
    stream = port_stream(stream)
    fe = _frontend(NP, wl, overload=dict(shed_policy="none", micro_batch=2))
    s = fe.open_session(tenant=0, groups="all")

    async def consume():
        return [d async for d in s.stream()]

    async def main():
        task = asyncio.ensure_future(consume())
        loop = asyncio.get_running_loop()

        def feed():
            fe.start(interval_s=0.001)
            for t0 in range(0, int(stream.time.max()) + 1, 15):
                s.submit(stream.time_slice(t0, t0 + 15))
            s.close()
            fe.drain()

        await loop.run_in_executor(None, feed)
        return await task

    got = asyncio.run(main())
    assert len(got) == len(fe.results())
    assert s.drained


# ------------------------------------------------- lifecycle hygiene


@pytest.mark.parametrize("side", PORTS, ids=BACKEND_IDS)
def test_no_leaked_threads_after_drain(side):
    before = set(threading.enumerate())
    wl, stream = _dataset("ridesharing")
    fe = _frontend(side, wl, backend="sharded", overload=None,
                   shard_cfg=ShardServiceConfig(
                       n_shards=2, admission="none", parallel=True,
                       overload=OverloadConfig(shed_policy="none",
                                               micro_batch=2,
                                               pipeline_flush=True)))
    fe.start(interval_s=0.001)
    sessions = _trickle(fe, _by_tenant(port_stream(stream), 3), seed=0,
                        pump_p=0.0)
    assert_same(fe.drain(), _reference_run(wl, stream, k=2))
    for s in sessions:
        s.poll()
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and "ThreadPoolExecutor" not in repr(t)
              and "asyncio" not in t.name]
    assert not leaked, leaked


# ------------------------------------------------- observability surface


def test_serving_latency_surfaced_in_collect():
    wl, stream = _dataset("ridesharing")
    obs = Observability()
    fe = _frontend(NP, wl, overload=dict(shed_policy="none", micro_batch=2),
                   obs=obs)
    _trickle(fe, _by_tenant(port_stream(stream), 3), seed=0)
    fe.drain()
    out = obs.collect(serving=fe)
    srv = out["serving"]
    assert srv["deliveries"] > 0
    assert srv["latency_ms"]["n"] == srv["deliveries"]
    for sess in srv["sessions"].values():
        if sess["delivered"]:
            assert sess["p99_ms"] >= sess["p50_ms"] >= 0.0
    assert srv["tenants"]
    assert out["metrics"]["serve.deliveries"] == srv["deliveries"]
    assert out["metrics"]["serve.submitted"] == len(stream)
    assert out["metrics"]["serve.latency_ms"]["count"] == srv["deliveries"]
    assert "serve.flush" in {e["name"] for e in obs.tracer.events()}


# ================================================================ transport


def test_chunk_codec_roundtrip_is_zero_copy():
    """The SUBMIT payload is the reference's bytes, and decodes as views."""
    wl, stream = _dataset("stock")
    pstream = port_stream(stream)
    payload = encode_chunk(pstream)
    assert payload == ref_encode_chunk(stream)
    back = decode_chunk(port_wl(wl).schema, payload)
    for col in ("type_id", "time", "attrs", "group", "seq"):
        a, b = getattr(pstream, col), getattr(back, col)
        if a is None:
            assert b is None
            continue
        assert np.array_equal(a, b), col
        assert not b.flags.owndata, f"{col} was copied, not viewed"
    empty = pstream.select(np.arange(0))
    assert len(decode_chunk(pstream.schema, encode_chunk(empty))) == 0


def test_delivery_codec_roundtrip_values_and_interning():
    """The DELIVER payload is the reference's bytes and each package
    decodes the other's."""
    recs = [("emit", "q0", 3, 40, {"count": 7.0, "sum": float("nan")},
             0, 1.25),
            ("retract", "q0", 3, 40, None, 1, 0.5),
            ("amend", "q1", -2, 50, {"count": 9, "arr": np.arange(3.0)},
             2, 2000.0)]
    ds = [Delivery(*r) for r in recs]
    payload = encode_deliveries(ds, 123.5)
    assert payload == ref_encode_deliveries([RefDelivery(*r) for r in recs],
                                            123.5)
    for decode in (decode_deliveries, ref_decode_deliveries):
        t_enc, back = decode(payload)
        assert t_enc == 123.5 and len(back) == len(ds)
        for a, b in zip(ds, back):
            assert (a.kind, a.query, a.group, a.w0, a.revision) == \
                (b.kind, b.query, b.group, b.w0, b.revision)
            assert b.latency_ms == pytest.approx(a.latency_ms)
        assert back[0].vals["count"] == 7.0
        assert type(back[0].vals["count"]) is float
        assert np.isnan(back[0].vals["sum"])
        assert back[1].vals is None
        assert back[2].vals["count"] == 9
        assert type(back[2].vals["count"]) is int
        assert np.array_equal(back[2].vals["arr"], np.arange(3.0))
    assert payload.count(b"q0") == 1
    bad = [Delivery("emit", "q", 0, 0, {"x": EventTimeConfig()})]
    with pytest.raises(pickle.UnpicklingError):
        decode_deliveries(encode_deliveries(bad, 0.0))


def _loopback(fe_srv, make_client, wl, parts, n):
    """``n`` clients trickling ``parts`` through a server; returns the
    drained results, each client's END results and deliveries, and the
    server summary."""
    srv = fe_srv
    host, port = srv.start()
    out = {}
    opened = threading.Barrier(n)

    def run_client(t):
        c = make_client(host, port, t)
        opened.wait(timeout=30.0)
        for c0 in range(0, len(parts[t]), 40):
            c.submit(parts[t].select(
                np.arange(c0, min(c0 + 40, len(parts[t])))))
        c.close()
        got = list(c.deliveries())
        out[t] = (c.results, got)
        c.shutdown()

    threads = [threading.Thread(target=run_client, args=(t,))
               for t in range(n)]
    try:
        for th in threads:
            th.start()
        _wait_sessions_closed(srv.frontend, n)
        res = srv.drain()
        for th in threads:
            th.join(timeout=30.0)
            assert not th.is_alive()
    finally:
        srv.stop()
    return res, out, srv.summary()


@pytest.mark.parametrize("side,name", [(NP, n) for n in sorted(DATASETS)]
                         + [(PORTS[1], "ridesharing")],
                         ids=[f"np-{n}" for n in sorted(DATASETS)]
                         + ["torch-ridesharing"])
def test_loopback_parity_sweep(side, name):
    """Three port clients trickling tenant splits through a port server
    equal the reference's batch run, and each END frame carries exactly
    the subscribed subset."""
    wl, stream = _dataset(name)
    want = _reference_run(wl, stream)
    parts = _by_tenant(port_stream(stream), 3)
    res, out, summ = _loopback(
        ServingServer(_frontend(side, wl)),
        lambda h, p, t: ServingClient(h, p, tenant=t), wl, parts, 3)
    assert_same(res, want, name)
    n_deliver = 0
    for t in range(3):
        end_res, got = out[t]
        assert_same(end_res, {k: v for k, v in want.items()
                              if k[1] // 2 == t}, (name, t))
        assert all(d.group // 2 == t for d in got), "cross-tenant delivery"
        n_deliver += len(got)
    assert n_deliver == len(want)
    assert summ["frames_in"] > 0 and summ["bytes_out"] > 0
    assert summ["disconnects"] == 0


def test_loopback_eventtime_disorder_parity():
    """Disordered arrivals over the socket repair to the reference's
    in-order batch run."""
    wl, stream = _dataset("taxi")
    t_end = ((int(stream.time.max()) // 10) + 1) * 10
    want = RefRuntime(wl).run(stream, t_end=t_end)
    ds = apply_disorder(stream, DisorderConfig(fraction=0.3, max_skew=6,
                                               seed=5))
    base = port_stream(ds.base)
    fe = _frontend(NP, wl, backend="eventtime", overload=None,
                   eventtime=dict(skew=8), micro_batch=2, skew=8)
    srv = ServingServer(fe)
    host, port = srv.start()
    clients = [ServingClient(host, port, tenant=t) for t in range(3)]
    try:
        rng = np.random.default_rng(7)
        cur = 0
        while cur < len(base):
            n = int(rng.integers(20, 60))
            idx = ds.order[cur:min(cur + n, len(base))]
            sub = EventBatch.from_unsorted(
                base.schema, base.type_id[idx], base.time[idx],
                base.attrs[idx], base.group[idx], seq=base.seq[idx])
            clients[int(rng.integers(0, 3))].submit(sub)
            cur += n
        for c in clients:
            c.advance_to(t_end)
            c.close()
        _wait_sessions_closed(fe, 3)
        srv.drain()
        got = {k: v for k, v in fe.results().items() if k in want}
        assert_same(got, want)
        for c in clients:
            c.wait_end()
    finally:
        for c in clients:
            c.shutdown()
        srv.stop()


# --------------------------------------------------------- across packages


def _record_pickled_frames(monkeypatch, server_cls, client_cls):
    """Record every HELLO and END payload a server sends or a client sends
    (the protocol's pickled frames)."""
    frames = []

    srv_send = server_cls._send

    async def send(self, conn, ftype, payload):
        if ftype == 19:
            frames.append(("END", payload))
        return await srv_send(self, conn, ftype, payload)

    cli_send = client_cls._send

    def csend(self, ftype, payload):
        if ftype == 1:
            frames.append(("HELLO", payload))
        return cli_send(self, ftype, payload)

    monkeypatch.setattr(server_cls, "_send", send)
    monkeypatch.setattr(client_cls, "_send", csend)
    return frames


@pytest.mark.parametrize("direction", ["ref_client-port_server",
                                       "port_client-ref_server"])
def test_loopback_across_packages(direction, monkeypatch):
    """Either package's client against the other's server on ``np``:
    every END result equals the reference's batch run bitwise, and no
    pickled frame (HELLO, END) names torch or this package."""
    wl, stream = _dataset("ridesharing")
    want = _reference_run(wl, stream)
    if direction == "ref_client-port_server":
        srv = ServingServer(_frontend(NP, wl))
        frames = _record_pickled_frames(monkeypatch, ServingServer,
                                        RefClient)
        parts = _by_tenant(stream, 3)
        make = lambda h, p, t: RefClient(h, p, tenant=t)      # noqa: E731
    else:
        srv = RefServer(_frontend(REF, wl))
        frames = _record_pickled_frames(monkeypatch, RefServer,
                                        ServingClient)
        parts = _by_tenant(port_stream(stream), 3)
        make = lambda h, p, t: ServingClient(h, p, tenant=t)  # noqa: E731
    res, out, summ = _loopback(srv, make, wl, parts, 3)
    assert_same(res, want)
    for t in range(3):
        end_res, got = out[t]
        assert_same(end_res, {k: v for k, v in want.items()
                              if k[1] // 2 == t}, t)
        assert len(got) == len(end_res)
    kinds = [k for k, _ in frames]
    assert kinds.count("HELLO") == 3 and kinds.count("END") == 3
    for kind, payload in frames:
        assert b"torch" not in payload, kind    # nor repro_torch
        port_transport.plain_loads(payload)     # builtins and numpy only
    assert summ["disconnects"] == 0


def test_plain_loads_refuses_torch_and_port_objects():
    import datetime

    import torch

    assert port_transport.plain_loads(pickle.dumps(
        {("q", np.int64(1), 0): {"COUNT(*)": 2.0}, "a": np.arange(3)}))
    for bad in (torch.ones(1), EventTimeConfig(), datetime.date(2020, 1, 1)):
        with pytest.raises(pickle.UnpicklingError):
            port_transport.plain_loads(pickle.dumps(bad))


# ----------------------------------------------------------- backpressure


class _FakeFE:
    def __init__(self):
        self.sealed = 0
        self.staged = 0

    def sealed_to(self):
        return self.sealed

    def staged_events(self):
        return self.staged


class _Rec:
    def __init__(self):
        self.counts = {}
        self.blocked = []

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def observe_blocked(self, sid, ms):
        self.blocked.append((sid, ms))


def test_credit_gate_withholds_and_regrant_is_lossless():
    fe, rec = _FakeFE(), _Rec()
    gate = CreditGate(fe, window=10, staging_high=5, obs=rec)
    assert gate.register(1) == 10
    gate.on_submit(1, 4, t_max=10, now=0.0)
    gate.on_submit(1, 6, t_max=20, now=0.0)
    fe.sealed, fe.staged = 15, 9
    assert gate.poll(1, now=1.0) == 0
    assert gate.withheld == 4
    assert rec.counts["serve.credits_withheld"] == 4
    fe.sealed, fe.staged = 25, 2
    assert gate.poll(1, now=2.0) == 10
    assert gate.granted == 10
    assert rec.counts["serve.credits_granted"] == 10
    assert rec.blocked and rec.blocked[0][0] == 1
    assert rec.blocked[0][1] == pytest.approx(2000.0)
    gate.forget(1)
    assert gate.poll(1, now=3.0) == 0
    gate.on_submit(1, 5, t_max=30, now=3.0)
    assert gate.summary()["inflight"] == {}


def test_backpressure_bounds_staging_and_never_sheds():
    """A producer much faster than the seal: the credit window bounds
    staging, nothing is shed, the client blocks instead."""
    wl, stream = _dataset("ridesharing")
    stream = port_stream(stream)
    window, chunk, high = 48, 16, 1 << 10
    obs = Observability()
    fe = _frontend(NP, wl, session_admission=True, obs=obs)
    srv = ServingServer(fe, credit_window=window, staging_high=high)
    host, port = srv.start()
    try:
        c = ServingClient(host, port, tenant=0, groups="all")
        for c0 in range(0, len(stream), chunk):
            c.submit(stream.select(
                np.arange(c0, min(c0 + chunk, len(stream)))))
        c.close()
        _wait_sessions_closed(fe, 1)
        res = srv.drain()
        c.wait_end()
        c.shutdown()
    finally:
        srv.stop()
    summ = fe.summary()
    assert summ["session_shed"] == 0, "compliant client was shed"
    assert summ["sessions"][c.sid]["submitted"] == len(stream)
    assert summ["staging"]["hwm"] <= high + window + chunk
    gate = srv.summary()["credit"]
    assert gate["granted"] >= len(stream) - window
    assert c.blocked_s > 0.0, "producer never hit the credit wall"
    assert res
    metrics = obs.collect(serving=fe)["metrics"]
    assert metrics["serve.credits_granted"] >= len(stream) - window
    assert metrics["serve.staging_hwm"] == summ["staging"]["hwm"]
    assert [k for k in metrics if k.startswith("serve.blocked_ms.")]


# ------------------------------------------------------ disconnect races


def test_client_disconnect_mid_stream_frees_session_and_credits():
    """A hard socket drop closes the session and frees its credits; the
    survivor's windows equal the reference's."""
    wl, stream = _dataset("ridesharing")
    want = _reference_run(wl, stream)
    parts = _by_tenant(port_stream(stream), 2)
    fe = _frontend(NP, wl)
    srv = ServingServer(fe)
    host, port = srv.start()
    try:
        victim = ServingClient(host, port, tenant=0)
        survivor = ServingClient(host, port, tenant=1)
        victim.submit(parts[0].select(np.arange(min(40, len(parts[0])))))
        victim.kill()
        survivor.submit(parts[1])
        survivor.close()
        deadline = time.perf_counter() + 30.0
        while True:
            sess = fe.summary()["sessions"]
            if (srv.disconnects == 1 and sess[victim.sid]["closed"]
                    and sess[survivor.sid]["closed"]):
                break
            assert time.perf_counter() < deadline, "drop never detected"
            time.sleep(0.005)
        assert victim.sid not in srv.gate.summary()["inflight"]
        srv.drain(timeout=30.0)
        end = survivor.wait_end()
        survivor.shutdown()
    finally:
        srv.stop()
    assert_same(end, {k: v for k, v in want.items() if k[1] // 2 == 1})
    with pytest.raises(ConnectionError):
        list(victim.deliveries())


def test_dead_client_blocked_on_credits_unblocks():
    wl, stream = _dataset("ridesharing")
    fe = _frontend(NP, wl)
    srv = ServingServer(fe, credit_window=8)
    host, port = srv.start()
    try:
        c = ServingClient(host, port, tenant=0)
        err = []

        def push():
            try:
                c.submit(port_stream(stream), timeout=30.0)
            except (ConnectionError, TimeoutError) as e:
                err.append(e)

        th = threading.Thread(target=push)
        th.start()
        time.sleep(0.05)
        c.kill()
        th.join(timeout=10.0)
        assert not th.is_alive(), "submit hung on a dead connection"
        assert err and isinstance(err[0], ConnectionError)
    finally:
        srv.stop()


# -------------------------------------------------------------- hygiene


def test_no_leaked_threads_or_fds_after_stop():
    fds_before = len(os.listdir("/proc/self/fd"))
    before = set(threading.enumerate())
    wl, stream = _dataset("ridesharing")
    parts = _by_tenant(port_stream(stream), 2)
    fe = _frontend(NP, wl)
    srv = ServingServer(fe)
    host, port = srv.start()
    clients = [ServingClient(host, port, tenant=t) for t in range(2)]
    for t, c in enumerate(clients):
        c.submit(parts[t])
        c.close()
    _wait_sessions_closed(fe, 2)
    srv.drain()
    for c in clients:
        c.wait_end()
        c.shutdown()
    srv.stop()
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and "ThreadPoolExecutor" not in repr(t)
              and "asyncio" not in t.name]
    assert not leaked, leaked
    assert len(os.listdir("/proc/self/fd")) <= fds_before, "fd leak"


def test_bad_frame_type_drops_connection_cleanly():
    wl, _ = _dataset("ridesharing")
    fe = _frontend(NP, wl)
    srv = ServingServer(fe)
    host, port = srv.start()
    try:
        c = ServingClient(host, port, tenant=0)
        c._send(99, b"junk")
        deadline = time.perf_counter() + 10.0
        while not c._dead:
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        c.kill()
        assert fe.summary()["sessions"][c.sid]["closed"]
    finally:
        srv.stop()
