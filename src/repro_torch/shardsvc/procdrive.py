"""Process-pool shard drive: long-lived worker processes past the GIL.

``ShardServiceConfig.parallel="thread"`` overlaps shard drive cycles on a
thread pool — but every pane of numpy work still serializes on the GIL,
so measured speedup on CPython is ~1.0x no matter the core count.  This
module runs each :class:`~repro_torch.shardsvc.service.ShardWorker` in its own
**long-lived worker process** instead:

* engine state stays pinned in the worker — ``HamletRuntime``, plan
  caches, the pane micro-batcher, the PID loop and the error accountant
  are built once per process and never cross the boundary;
* per drive cycle the parent ships only the shard's routed chunk: a
  pickled header over the command pipe plus the raw event columns in a
  ``multiprocessing.shared_memory`` segment (the same column layout the
  wire transport uses, so the child decodes with one memcpy); chunks
  under :data:`INLINE_BYTES` skip the segment and ride the pipe;
* the rendezvous is the command protocol itself: the parent dispatches
  one ``cycle`` command per worker (offer + heartbeat + drive), the
  children run concurrently, and the parent collects each reply — which
  carries the worker's post-drive :class:`FrontierSnapshot` — then feeds
  the aligner in shard order, exactly as the serial drive does.

Determinism: chunk columns cross as raw bytes and results return via
pickle, both of which preserve float64 bit patterns, and the aligner sees
the same frontier sequence as the serial drive — so process-drive results
are bitwise equal to the serial drive by construction, which the parity
tests assert across all four named workloads including event-time
disorder.

The spawn start method is used unconditionally: fork after CUDA has
started in the parent is unsafe, and spawn keeps the child's import set
explicit.  Rebalance (``plan_rebalance``) is not supported in process
mode — open-window instance handoff would require shipping live engine
state across the boundary; the service raises ``NotImplementedError``.

On the card each worker process opens its own CUDA context on the device
it is given, which crosses the spawn boundary as a string (``"cuda:0"``).
On the ``"cuda"`` backend the parent builds and loads the kernels before
it spawns anyone, so the children load the finished library and never run
``nvcc`` at once; a child that cannot open its device or load the kernels
fails its handshake, and the parent raises with the child's traceback
(there is no fallback to the host).  Replies carry builtins and numpy
only, never a tensor or an object of this package: the parent unpickles
them with :func:`repro_torch.interop.plain_loads`, which refuses anything
else, and rebuilds the frontier, ``RunStats``, error accountant and
metrics registry from their plain forms.  A worker's kernel launch counts
live in its own process: ``summary()`` reports them (``kernel_launches``).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import struct
import time
import traceback
from multiprocessing import shared_memory

from ..interop import plain_loads

__all__ = ["ProcShardWorker", "INLINE_BYTES"]

_CTX = mp.get_context("spawn")

INLINE_BYTES = 16 << 10     # chunks smaller than this ride the pipe

_CHUNK_HDR = struct.Struct("<IB")     # n events, has_seq (transport layout)


# --------------------------------------------------------------------------
# chunk shipping (pickled header + raw columns)
# --------------------------------------------------------------------------

def _pack_columns(batch) -> bytes:
    import numpy as np
    has_seq = batch.seq is not None
    parts = [_CHUNK_HDR.pack(len(batch), 1 if has_seq else 0),
             np.ascontiguousarray(batch.type_id).tobytes(),
             np.ascontiguousarray(batch.time).tobytes(),
             np.ascontiguousarray(batch.attrs).tobytes(),
             np.ascontiguousarray(batch.group).tobytes()]
    if has_seq:
        parts.append(np.ascontiguousarray(batch.seq).tobytes())
    return b"".join(parts)


def _unpack_columns(schema, payload) -> "object":
    import numpy as np

    from ..core.events import EventBatch
    buf = memoryview(payload)
    n, has_seq = _CHUNK_HDR.unpack_from(buf, 0)
    off = _CHUNK_HDR.size
    a = max(1, len(schema.attrs))
    type_id = np.frombuffer(buf, np.int32, n, off)
    off += 4 * n
    t = np.frombuffer(buf, np.int64, n, off)
    off += 8 * n
    attrs = np.frombuffer(buf, np.float64, n * a, off).reshape(n, a)
    off += 8 * n * a
    group = np.frombuffer(buf, np.int64, n, off)
    off += 8 * n
    seq = np.frombuffer(buf, np.int64, n, off) if has_seq else None
    return EventBatch(schema, type_id, t, attrs, group, seq=seq)


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to a parent-owned segment.

    Before 3.13 an attach also registers with the resource tracker — but a
    spawn child shares the *parent's* tracker process (the fd rides the
    spawn handshake), and the tracker's cache is a set: the child's
    register dedupes against the parent's and the parent's ``unlink()``
    removes the single entry.  Explicitly unregistering here would
    unbalance that accounting (tracker KeyError spam at unlink time), so
    the attach is left as-is."""
    return shared_memory.SharedMemory(name=name)


def _load_chunk(schema, header):
    """Child side of the shipment: rebuild the EventBatch.  Shared-memory
    payloads are copied out with one memcpy (``bytes(buf)``) so the
    segment can be released immediately after the reply."""
    if header is None:
        return None
    inline = header.get("inline")
    if inline is not None:
        return _unpack_columns(schema, inline)
    seg = _attach_shm(header["shm"])
    try:
        payload = bytes(seg.buf[:header["size"]])
    finally:
        seg.close()
    return _unpack_columns(schema, payload)


# --------------------------------------------------------------------------
# worker process main
# --------------------------------------------------------------------------

def _plain(op: str, payload):
    """Child side: ``payload`` of a reply to ``op`` as builtins and numpy."""
    if op in ("cycle", "close"):
        return dataclasses.astuple(payload)            # FrontierSnapshot
    if op == "stats":
        return dataclasses.asdict(payload)             # RunStats
    if op == "accountant":
        return {"pane": payload.pane,
                "shed": {k: list(v) for k, v in payload._shed.items()},
                "tainted": sorted(payload._tainted),
                "total_shed": payload.total_shed,
                "late_events": payload.late_events}
    if op == "obs_registry" and payload is not None:
        return {name: (m.kind, {a: getattr(m, a) for a in type(m).__slots__})
                for name, m in payload._m.items()}
    return payload


def _rebuild(op: str, plain, workload):
    """Parent side: the object a reply to ``op`` stands for."""
    if op in ("cycle", "close"):
        from ..eventtime.frontier import FrontierSnapshot
        return FrontierSnapshot(*plain)
    if op == "stats":
        from ..core.engine import RunStats
        return RunStats(**plain)
    if op == "accountant":
        from ..overload.accountant import ErrorAccountant
        acc = ErrorAccountant(workload, pane=plain["pane"])
        acc._shed = {tuple(k): list(v) for k, v in plain["shed"].items()}
        acc._tainted = set(plain["tainted"])
        acc.total_shed = plain["total_shed"]
        acc.late_events = plain["late_events"]
        return acc
    if op == "obs_registry" and plain is not None:
        from ..obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
        kinds = {c.kind: c for c in (Counter, Gauge, Histogram)}
        reg = MetricsRegistry()
        for name, (kind, slots) in plain.items():
            m = kinds[kind].__new__(kinds[kind])
            for a, v in slots.items():
                setattr(m, a, v)
            reg._m[name] = m
        return reg
    return plain


def _worker_main(conn, shard_id, workload, cfg, policy, backend, device,
                 eventtime, skew, lateness_horizon, obs_on) -> None:
    from ..obs.facade import Observability
    from .service import ShardWorker

    try:
        if backend == "cuda":
            from ..kernels import _build
            _build.load()       # the parent's build: loaded, not rebuilt
        w = ShardWorker(shard_id, workload, cfg, policy=policy,
                        backend=backend, device=device, eventtime=eventtime,
                        skew=skew, lateness_horizon=lateness_horizon,
                        obs=Observability.disabled() if obs_on else None)
    except Exception as e:  # noqa: BLE001 — surfaced parent-side
        conn.send(("error", (repr(e), traceback.format_exc())))
        conn.close()
        return
    conn.send(("ready", w.pane))
    schema = workload.schema
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        op = msg[0]
        try:
            if op == "cycle":
                _, header, safe_end, hb, throttle = msg
                w.throttle = throttle
                sub = _load_chunk(schema, header)
                if sub is not None:
                    w.offer(sub, safe_end)
                if hb is not None:
                    w.heartbeat(hb)
                w.drive()
                payload = w.frontier()
            elif op == "close":
                w.close(msg[1])
                payload = w.frontier()
            elif op == "results":
                payload = w.results()
            elif op == "stats":
                payload = w.stats()
            elif op == "accountant":
                payload = w.accountant()
            elif op == "summary":
                payload = w.summary()
            elif op == "controller_state":
                payload = w.controller_state()
            elif op == "pending_flush":
                payload = w.pending_flush()
            elif op == "obs_registry":
                payload = w.obs.registry if w.obs is not None else None
            elif op == "set":
                setattr(w, msg[1], msg[2])
                payload = None
            elif op == "shutdown":
                w.shutdown()
                conn.send((True, None, w.t_now, w.busy_s,
                           w.late_total, w.expired_total))
                break
            else:
                raise ValueError(f"unknown worker op {op!r}")
            conn.send((True, _plain(op, payload), w.t_now, w.busy_s,
                       w.late_total, w.expired_total))
        except Exception as e:  # noqa: BLE001 — surfaced parent-side
            conn.send((False, (repr(e), traceback.format_exc()),
                       w.t_now, w.busy_s, w.late_total, w.expired_total))
    conn.close()


# --------------------------------------------------------------------------
# parent-side proxy
# --------------------------------------------------------------------------

class ProcShardWorker:
    """Parent-side proxy exposing the :class:`ShardWorker` surface the
    service drives, backed by one long-lived spawn process.

    ``cycle_async``/``cycle_wait`` split one drive cycle into dispatch and
    collect so the service can run every shard's cycle concurrently; all
    other methods are synchronous RPCs.  ``t_now``/``busy_s``/``frontier``
    are served from the cache every reply refreshes — the read side never
    blocks on the worker mid-cycle.  ``device`` is a string (``"cuda:0"``)
    or None for the backend's default (module docstring).
    """

    def __init__(self, shard_id: int, workload, cfg, *, policy=None,
                 backend: str = "cuda", device: str | None = None,
                 eventtime: bool = False, skew: int = 0,
                 lateness_horizon: int | None = None, obs: bool = False,
                 clock=time.perf_counter):
        if backend == "cuda":
            from ..kernels import _build
            _build.load()       # build once, before any child could
        self.shard_id = int(shard_id)
        self._workload = workload
        self.throttle: int | None = None
        self.cap_t: int | None = None       # rebalance unsupported here
        self.pane: int | None = None
        self.obs = None                      # registry lives in the child
        self._t_now = 0
        self._busy_s = 0.0
        self.late_total = 0
        self.expired_total = 0
        self._frontier = None
        self._final: dict | None = None      # read-side snapshot at shutdown
        self._shm: shared_memory.SharedMemory | None = None
        self._inflight = False
        self._clock = clock
        self._conn, child = _CTX.Pipe()
        self._proc = _CTX.Process(
            target=_worker_main,
            args=(child, shard_id, workload, cfg, policy, backend, device,
                  eventtime, skew, lateness_horizon, obs),
            name=f"shard-proc-{shard_id}", daemon=True)
        self._proc.start()
        self._pid = self._proc.pid
        child.close()

    def wait_ready(self, timeout: float = 120.0) -> None:
        if self.pane is not None:
            return
        if not self._conn.poll(timeout):
            raise TimeoutError(f"shard process {self.shard_id} did not "
                               f"come up within {timeout}s")
        try:
            tag, info = plain_loads(self._conn.recv_bytes())
        except EOFError:
            raise RuntimeError(f"shard process {self.shard_id} exited "
                               "before its handshake") from None
        if tag == "error":
            err, tb = info
            raise RuntimeError(f"shard process {self.shard_id} could not "
                               f"start: {err}\n{tb}")
        if tag != "ready":
            raise RuntimeError(f"bad handshake from shard "
                               f"{self.shard_id}: {tag!r}")
        self.pane = info

    # ----------------------------------------------------------------- rpc

    def _recv(self, op: str):
        ok, payload, t_now, busy_s, late, expired = plain_loads(
            self._conn.recv_bytes())
        self._t_now = t_now
        self._busy_s = busy_s
        self.late_total = late
        self.expired_total = expired
        self._release_shm()
        if not ok:
            err, tb = payload
            raise RuntimeError(
                f"shard process {self.shard_id} failed: {err}\n{tb}")
        return _rebuild(op, payload, self._workload)

    _SNAPSHOT_OPS = ("results", "stats", "accountant", "summary",
                     "controller_state", "pending_flush", "obs_registry")

    def _rpc(self, op, *args):
        if self._final is not None:
            # process already gone: serve reads from the shutdown snapshot
            if op in self._final:
                return self._final[op]
            raise RuntimeError(f"shard process {self.shard_id} is shut "
                               f"down; op {op!r} unavailable")
        self._conn.send((op, *args))
        return self._recv(op)

    def _release_shm(self) -> None:
        if self._shm is not None:
            seg, self._shm = self._shm, None
            seg.close()
            seg.unlink()

    def _ship(self, batch):
        if batch is None:
            return None
        payload = _pack_columns(batch)
        if len(payload) <= INLINE_BYTES:
            return {"inline": payload}
        seg = shared_memory.SharedMemory(create=True, size=len(payload))
        seg.buf[:len(payload)] = payload
        self._shm = seg       # released once the cycle reply lands
        return {"shm": seg.name, "size": len(payload)}

    # --------------------------------------------------------- drive cycle

    def cycle_async(self, sub, safe_end: int, hb: int | None) -> None:
        # empty batches still ship (a few bytes inline): the child's
        # offer() must see safe_end so its step limit advances
        header = self._ship(sub)
        self._conn.send(("cycle", header, safe_end, hb, self.throttle))
        self._inflight = True

    def cycle_wait(self):
        self._inflight = False
        self._frontier = self._recv("cycle")
        return self._frontier

    # ----------------------------------------------- ShardWorker surface

    @property
    def t_now(self) -> int:
        return self._t_now

    @property
    def busy_s(self) -> float:
        return self._busy_s

    def frontier(self):
        if self._frontier is None:
            from ..eventtime.frontier import FrontierSnapshot
            return FrontierSnapshot(shard=self.shard_id, watermark=-1,
                                    sealed_end=0, processed_end=0)
        return self._frontier

    def close(self, t_end: int) -> None:
        self._frontier = self._rpc("close", t_end)

    def results(self) -> dict:
        return self._rpc("results")

    def stats(self):
        return self._rpc("stats")

    def accountant(self):
        return self._rpc("accountant")

    def summary(self) -> dict:
        s = self._rpc("summary")
        s["process"] = {"pid": self._pid}
        return s

    def controller_state(self):
        return self._rpc("controller_state")

    def pending_flush(self) -> bool:
        return self._rpc("pending_flush")

    def obs_registry(self):
        return self._rpc("obs_registry")

    def shutdown(self, timeout: float = 30.0) -> None:
        """Snapshot the read side, stop the worker process, serve every
        later read (``results``/``stats``/...) from the snapshot — so the
        service's post-close read API works identically to in-process
        workers."""
        if self._proc is None:
            return
        try:
            if self._proc.is_alive() and self._final is None:
                snap = {op: self._rpc(op) for op in self._SNAPSHOT_OPS}
                self._rpc("shutdown")
                self._final = snap
        except (BrokenPipeError, EOFError, OSError, RuntimeError):
            self._final = self._final or {}
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout)
        self._conn.close()
        self._release_shm()
        self._proc = None
