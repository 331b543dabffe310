"""The port's process-pool shard drive against the JAX package's, on the
CPU.

Twins of ``tests/test_procdrive.py`` on the same inputs (carried across
with ``repro_torch.interop``): the process drive of the port on
``backend="np"`` equals its serial drive and the reference's bitwise
(results, aligned epochs, fleet counts), ordered and event-time
disordered; the chunk codec writes the reference's bytes; a worker shuts
down cleanly and idempotently; rebalance is refused.  And what the port
adds: every reply from a worker holds builtins and numpy only (its plain
form rebuilds the same frontier, ``RunStats``, accountant and registry),
a worker reports its own kernel launch counts and imports no module of
jax or of the JAX package, and a worker that cannot start fails its
parent with the child's traceback.  Each worker process imports torch, so
the file keeps to ten spawns.
"""

import dataclasses
import multiprocessing as mp
import pickle
import threading

import numpy as np
import pytest
import torch

from repro.shardsvc.procdrive import _pack_columns as ref_pack_columns
from repro.streams.generator import (NAMED_STREAMS, STOCK_SCHEMA,
                                     TAXI_SCHEMA, DisorderConfig,
                                     apply_disorder)
from repro_torch.interop import plain_loads
from repro_torch.obs.facade import Observability
from repro_torch.overload import OverloadConfig
from repro_torch.shardsvc import ProcShardWorker, ShardServiceConfig
from repro_torch.shardsvc.procdrive import (INLINE_BYTES, _load_chunk,
                                            _pack_columns, _plain, _rebuild,
                                            _unpack_columns)
from repro_torch.shardsvc.service import ShardWorker
from test_torch_shardsvc import (PORTS, REF, _wl, assert_same, port_stream,
                                 port_wl)
from test_torch_shardsvc import collect_garbage_after_module  # noqa: F401

NP = PORTS[0]


def _stock():
    return (_wl(STOCK_SCHEMA, "Quote", ("Buy", "Sell")),
            NAMED_STREAMS["stock"](events_per_minute=300, minutes=1,
                                   n_groups=6))


# ---------------------------------------------------------------- parity


def test_process_drive_bitwise_parity_and_read_side():
    """parallel="process" pins each shard in a spawn process: results,
    aligned epochs and fleet counts equal the serial drive's and the
    reference's bitwise; the post-close read side answers from the
    shutdown snapshot; every worker launched no kernel (np), reports its
    counters and imported nothing of jax or the JAX package."""
    wl, stream = _stock()
    ref_svc = REF.service(wl, 4)
    want = ref_svc.run(stream, chunk_ticks=10)
    runs, epochs, counts = {}, {}, {}
    for parallel in (False, "process"):
        svc = NP.service(wl, 4, parallel=parallel)
        runs[parallel] = svc.run(port_stream(stream), chunk_ticks=10)
        epochs[parallel] = svc.aligner.aligned_epoch
        counts[parallel] = svc.stats().counts()
        assert svc.drive_cycles > 0
        if parallel == "process":
            assert svc.drive_wall_s > 0.0
            assert {k: dataclasses.astuple(r) for k, r in
                    svc.error_report().items()} == {
                k: dataclasses.astuple(r)
                for k, r in ref_svc.error_report().items()}
            out = svc.collect()
            assert out["router"]["drive_mode"] == "process"
            pids = {s["process"]["pid"] for s in out["shards"]}
            assert len(pids) == 4
            for s in out["shards"]:
                assert s["kernel_launches"] == {"hamlet_propagate": 0,
                                                "hamlet_dense": 0}
                assert s["foreign_modules"] == []
            with pytest.raises(RuntimeError):
                svc.workers[0]._rpc("cycle", None, 0, None)
    assert_same(runs["process"], runs[False])
    assert_same(runs["process"], want)
    assert epochs[False] == epochs["process"] == ref_svc.aligner.aligned_epoch
    assert counts[False] == counts["process"] == ref_svc.stats().counts()
    assert not mp.active_children(), "worker processes leaked past close()"


def test_process_drive_eventtime_disorder_parity():
    """Disordered arrival through per-shard reorder buffers inside worker
    processes: results and late accounting equal the serial drive's and
    the reference's."""
    wl = _wl(TAXI_SCHEMA, "Travel", ("Request", "Pickup"))
    stream = NAMED_STREAMS["taxi"](events_per_minute=250, minutes=1,
                                   n_groups=6)
    ds = apply_disorder(stream, DisorderConfig(
        model="bounded_skew", fraction=0.2, max_skew=6, seed=5))
    kw = dict(eventtime=True, skew=ds.max_lateness())
    want = REF.service(wl, 2, **kw).run_chunks(ds.chunks(64))
    runs, lost = {}, {}
    for parallel in (False, "process"):
        svc = NP.service(wl, 2, parallel=parallel, **kw)
        runs[parallel] = svc.run_chunks(port_stream(c)
                                        for c in ds.chunks(64))
        lost[parallel] = (sum(w.late_total for w in svc.workers),
                          sum(w.expired_total for w in svc.workers))
    assert_same(runs["process"], runs[False])
    assert_same(runs["process"], want)
    assert lost[False] == lost["process"] == (0, 0)
    assert not mp.active_children()


# ----------------------------------------------------------- chunk codec


def test_column_codec_roundtrip_inline_and_shm_sizes():
    """The codec writes the reference's bytes and reads them back, inline
    and through a shared-memory segment."""
    wl, stream = _stock()
    pwl, pstream = port_wl(wl), port_stream(stream)
    for n in (0, 3, len(stream)):
        sub = pstream.select(np.arange(n))
        payload = _pack_columns(sub)
        assert payload == ref_pack_columns(stream.select(np.arange(n)))
        back = _unpack_columns(pwl.schema, payload)
        for col in ("type_id", "time", "attrs", "group", "seq"):
            a, b = getattr(sub, col), getattr(back, col)
            assert (a is None and b is None) or np.array_equal(a, b), col
    big = pstream.select(
        np.repeat(np.arange(len(stream)), 1 + INLINE_BYTES // 1000))
    payload = _pack_columns(big)
    assert len(payload) > INLINE_BYTES
    from multiprocessing import shared_memory

    seg = shared_memory.SharedMemory(create=True, size=len(payload))
    try:
        seg.buf[:len(payload)] = payload
        back = _load_chunk(pwl.schema, {"shm": seg.name,
                                        "size": len(payload)})
    finally:
        seg.close()
        seg.unlink()
    assert np.array_equal(back.time, big.time)
    assert np.array_equal(back.attrs, big.attrs)


# ------------------------------------------------------------ plain replies


def test_worker_replies_are_plain_and_rebuild_exactly():
    """Each read-side reply of a worker, in its plain form, pickles with
    builtins and numpy only and rebuilds an equal object in the parent; a
    tensor or an object of this package is refused by ``plain_loads``."""
    wl, stream = _stock()
    pwl = port_wl(wl)
    w = ShardWorker(0, pwl, OverloadConfig(shed_policy="drop_tail",
                                           fixed_shed=0.3, micro_batch=4),
                    backend="np", obs=Observability.disabled())
    w.offer(port_stream(stream), int(stream.time.max()))
    w.close(int(stream.time.max()) + 1)
    w.drive()
    payloads = {"cycle": w.frontier(), "results": w.results(),
                "stats": w.stats(), "accountant": w.accountant(),
                "summary": w.summary(),
                "controller_state": w.controller_state(),
                "pending_flush": w.pending_flush(),
                "obs_registry": w.obs_registry()}
    assert w.accountant().total_shed > 0 and payloads["results"]
    for op, obj in payloads.items():
        back = _rebuild(op, plain_loads(pickle.dumps(_plain(op, obj))), pwl)
        if op == "accountant":
            assert back._shed == obj._shed and back.report() == obj.report()
            assert (back.total_shed, back.late_events, back._tainted) == \
                (obj.total_shed, obj.late_events, obj._tainted)
        elif op == "obs_registry":
            assert back.collect() == obj.collect() and len(back) > 0
        else:
            assert back == obj, op
    for bad in (torch.zeros(2), w.stats(), OverloadConfig()):
        with pytest.raises(pickle.UnpicklingError):
            plain_loads(pickle.dumps(bad))


# ------------------------------------------------------------- lifecycle


def test_process_worker_shutdown_is_idempotent_and_clean():
    wl, _ = _stock()
    before = set(threading.enumerate())
    w = ProcShardWorker(0, port_wl(wl), OverloadConfig(shed_policy="none",
                                                       micro_batch=4),
                        backend="np")
    w.wait_ready()
    assert w.pane > 0
    w.close(0)
    w.shutdown()
    w.shutdown()                      # second call is a no-op
    assert w.results() == {}          # snapshot survives the process
    assert w.pending_flush() is False
    assert not mp.active_children()
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
    assert not leaked, leaked


def test_worker_that_cannot_start_fails_the_parent():
    """A child whose runtime cannot be built (here: a backend it does not
    know) fails its handshake, and the parent raises with the child's
    traceback instead of running anything on a fallback."""
    wl, _ = _stock()
    w = ProcShardWorker(0, port_wl(wl), OverloadConfig(), backend="bogus")
    try:
        with pytest.raises(RuntimeError, match="could not start.*bogus"):
            w.wait_ready()
    finally:
        w.shutdown()
    assert not mp.active_children()


def test_process_mode_rejects_rebalance():
    wl, stream = _stock()
    svc = NP.service(wl, 2, parallel="process")
    try:
        svc.ingest(port_stream(stream).time_slice(0, 10))
        with pytest.raises(NotImplementedError):
            svc.plan_rebalance(group=0, to_shard=1)
    finally:
        svc.close()
    assert not mp.active_children()


# ------------------------------------------------------------- plumbing


def test_drive_mode_resolution_and_validation():
    assert ShardServiceConfig(parallel=False).drive_mode == "serial"
    assert ShardServiceConfig(parallel=True).drive_mode == "thread"
    assert ShardServiceConfig(parallel="thread").drive_mode == "thread"
    assert ShardServiceConfig(parallel="process").drive_mode == "process"
    with pytest.raises(ValueError):
        ShardServiceConfig(parallel="fork")
