"""Pane-batch executor: ragged propagation jobs -> few bucketed launches.

The engine's plan phase walks every burst in a pane and *submits* its
propagation problems here instead of solving them inline; ``flush`` then
executes the backlog with one launch per size bucket:

* **dense jobs** (``mask is None``: strictly-lower all-ones adjacency) share
  a constant basis width per component, so they bucket by
  ``(next_pow2(b), d)`` with zero-row padding — padding is exact for the
  dense closed form — and run as one ``propagate_dense_batched`` call;
* **masked jobs** bucket by exact ``(b, d)`` (stacking needs equal shapes,
  and exact shapes keep each slice bitwise identical to the per-burst call)
  and run as one ``propagate_batched`` call per bucket;
* tiny masked jobs (``b <= 24`` on the numpy backend) keep the exact
  row-by-row oracle per item, matching the per-burst path bit for bit.

``batched=False`` degrades to the legacy one-launch-per-burst execution —
the differential tests assert the two modes agree bitwise.

``shard_slices`` is the pane-batch sharding hook: a callable mapping a
bucket's batch size to a list of slices (e.g.
``distributed.sharding.pane_bucket_shards``); each sub-batch is launched
separately so buckets can be split across devices/hosts.  Both kernels
compute every batch element on its own, so the split results are bitwise
those of the whole bucket.

Residency rules (cross-pane micro-batching support):

* **numpy backend** — the stacked *input* staging arrays are reused across
  flushes (one buffer per bucket shape, grown to the high-water batch size),
  so a steady-state stream stops allocating per pane.  Outputs are always
  freshly allocated: job results are views into them and must survive later
  flushes.
* **torch/cuda backends** — each bucket is stacked in a fresh host buffer
  and moved to the executor's ``device`` once, by a synchronous copy (so no
  host buffer can be reused while a copy is in flight); every bucket of a
  flush is launched before any result is pulled back, and the whole flush
  then syncs with **one** ``ops.device_get_all`` call, keeping bucket
  outputs device-resident for the duration of the flush.

A flush stages every bucket, then launches every bucket, then fetches:
with an ``obs`` attached these are its three steps, each timed once
(``execute.stage``, ``execute.launch``, ``execute.wait``; see
``Observability.step``), with the bytes each device backend moves each
way and, of those to the card, the masks'.  The unbatched legacy mode is
timed only as the phase's total.
"""

from __future__ import annotations

from dataclasses import dataclass
from time import perf_counter

import numpy as np

from ..kernels import ops
from ..obs.metrics import OCCUPANCY_BUCKETS

__all__ = ["PropagateJob", "PaneBatchExecutor"]

# numpy-backend threshold below which the exact row-loop oracle beats the
# doubling GEMMs for a single burst (mirrors ops.propagate_batched)
_FAST_MIN_B = 25
_DENSE_B_MAX = ops.DENSE_B_MAX


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclass
class PropagateJob:
    """One propagation problem: ``mask is None`` marks a dense burst."""

    base: np.ndarray              # [b, d]
    mask: np.ndarray | None       # [b, b] strictly-lower adjacency
    result: np.ndarray | None = None


class PaneBatchExecutor:
    def __init__(self, backend: str = "cuda", batched: bool = True,
                 shard_slices=None, obs=None, device=None):
        self.backend = backend
        # None on the np backend; raises when a missing GPU is asked for
        self.device = ops.resolve_device(backend, device)
        self.batched = batched
        self.shard_slices = shard_slices
        self.obs = obs
        self._pending: list[PropagateJob] = []
        # reusable host staging for stacked inputs, keyed by (kind, b, d,
        # dtype) and grown to the high-water bucket size (numpy backend only;
        # see the module docstring's residency rules)
        self._staging: dict[tuple, np.ndarray] = {}
        self.jobs = 0
        self.launches = 0
        self.flushes = 0

    def submit(self, base: np.ndarray,
               mask: np.ndarray | None = None) -> PropagateJob:
        job = PropagateJob(np.asarray(base), mask)
        self._pending.append(job)
        self.jobs += 1
        return job

    # -- execution --

    def flush(self, t_stage: float | None = None) -> None:
        """Execute the backlog.  ``t_stage``: the ``perf_counter`` reading
        at which the caller began building these jobs' injection rows, the
        start of the staging step (default: now)."""
        obs = self.obs
        if obs is not None and t_stage is None:
            t_stage = perf_counter()
        jobs, self._pending = self._pending, []
        if not jobs:
            if obs is not None:
                obs.step("execute.stage", "execute_stage_s", t_stage,
                         perf_counter())
            return
        self.flushes += 1
        l0 = self.launches
        if not self.batched:
            for j in jobs:
                self.launches += 1
                if j.mask is None:
                    out = ops.propagate_dense(j.base, backend=self.backend,
                                              device=self.device)
                else:
                    out = ops.propagate(j.base, j.mask, backend=self.backend,
                                        device=self.device)
                j.result = ops.device_get_all([out])[0]
            return
        dense = [j for j in jobs if j.mask is None
                 and j.base.shape[0] <= _DENSE_B_MAX]
        masked = [j for j in jobs if j.mask is not None]
        # oversize "dense" jobs fall back to an explicit all-ones mask
        for j in jobs:
            if j.mask is None and j.base.shape[0] > _DENSE_B_MAX:
                b = j.base.shape[0]
                j.mask = np.tril(np.ones((b, b)), k=-1)
                masked.append(j)
        staged = self._stage_dense(dense) + self._stage_masked(masked)
        if obs is not None:
            t_launch = perf_counter()
            obs.step("execute.stage", "execute_stage_s", t_stage, t_launch)
        # launch every bucket, then resolve the whole flush with one host
        # sync (device backends stay device-resident until here)
        launched = [(bucket, shape, sl, self._launch(base, mask))
                    for bucket, shape, sl, base, mask in staged]
        if obs is not None:
            t_wait = perf_counter()
            obs.step("execute.launch", "execute_launch_s", t_launch, t_wait)
        outs = ops.device_get_all([o for _, _, _, o in launched])
        full: dict[int, np.ndarray] = {}
        for (bucket, shape, sl, _), host in zip(launched, outs):
            arr = full.get(id(bucket))
            if arr is None:
                arr = full[id(bucket)] = np.empty(shape, dtype=host.dtype)
            arr[sl] = host
        done: set[int] = set()
        for bucket, _, _, _ in launched:
            if id(bucket) in done:
                continue
            done.add(id(bucket))
            arr = full[id(bucket)]
            for i, j in enumerate(bucket):
                j.result = arr[i, : j.base.shape[0]]
        if obs is None:
            return
        obs.observe("batch_exec.launches_per_flush", self.launches - l0,
                    OCCUPANCY_BUCKETS)
        if self.backend != "np":
            # what the device backends copy: each base, and each mask in
            # the base's dtype (``ops.propagate_batched``)
            masks = sum(mask.size * base.itemsize
                        for _, _, _, base, mask in staged if mask is not None)
            obs.step_count("execute_h2d_bytes", masks + sum(
                base.nbytes for _, _, _, base, _ in staged))
            obs.step_count("execute_mask_bytes", masks)
            obs.step_count("execute_d2h_bytes", sum(h.nbytes for h in outs))
        # the flush's device outputs and pinned host copies are freed
        # inside the wait step, not after its clock stops
        del staged, launched, outs
        obs.step("execute.wait", "execute_wait_s", t_wait, perf_counter())

    def _slices(self, nb: int) -> list[slice]:
        if self.shard_slices is None:
            return [slice(0, nb)]
        return list(self.shard_slices(nb))

    def _stage(self, key: tuple, nb: int, item_shape: tuple,
               dtype) -> np.ndarray:
        """A stacked staging buffer for the bucket ``key``, reused across
        flushes on the numpy backend (each bucket its own: every bucket of
        a flush is staged before any is launched)."""
        if self.backend != "np":
            return np.empty((nb,) + item_shape, dtype=dtype)
        key = key + (np.dtype(dtype),)
        buf = self._staging.get(key)
        if buf is None or buf.shape[0] < nb:
            buf = np.empty((nb,) + item_shape, dtype=dtype)
            self._staging[key] = buf
        return buf[:nb]

    def _launch(self, base: np.ndarray, mask) -> object:
        """One launch: the dense kernel (``mask is None``), the stacked
        row-loop oracle for tiny masked buckets on the numpy backend, or
        the masked kernel."""
        self.launches += 1
        if mask is None:
            return ops.propagate_dense_batched(base, backend=self.backend,
                                               device=self.device)
        if self.backend == "np" and base.shape[1] < _FAST_MIN_B:
            from ..kernels import ref

            # b row steps for the whole bucket, each slice bitwise equal to
            # the per-burst call
            return ref.numpy_prefix_propagate_batched(base, mask)
        return ops.propagate_batched(base, mask, backend=self.backend,
                                     device=self.device)

    def _stage_dense(self, jobs: list[PropagateJob]) -> list:
        buckets: dict[tuple, list[PropagateJob]] = {}
        for j in jobs:
            b, d = j.base.shape
            buckets.setdefault((_next_pow2(b), d, j.base.dtype), []).append(j)
        staged = []
        for (bp, d, dtype), bucket in buckets.items():
            nb = len(bucket)
            if self.obs is not None:
                self.obs.observe("batch_exec.bucket_occupancy", nb,
                                 OCCUPANCY_BUCKETS)
            stacked = self._stage(("dense", bp, d), nb, (bp, d), dtype)
            for i, j in enumerate(bucket):
                bj = j.base.shape[0]
                stacked[i, :bj] = j.base
                stacked[i, bj:] = 0.0
            staged += [(bucket, (nb, bp, d), sl, stacked[sl], None)
                       for sl in self._slices(nb)]
        return staged

    def _stage_masked(self, jobs: list[PropagateJob]) -> list:
        buckets: dict[tuple, list[PropagateJob]] = {}
        for j in jobs:
            buckets.setdefault(j.base.shape + (j.base.dtype,), []).append(j)
        staged = []
        for (b, d, dtype), bucket in buckets.items():
            nb = len(bucket)
            if self.obs is not None:
                self.obs.observe("batch_exec.bucket_occupancy", nb,
                                 OCCUPANCY_BUCKETS)
            base = self._stage(("mbase", b, d), nb, (b, d), dtype)
            mask = self._stage(("mmask", b, d, np.dtype(dtype)), nb, (b, b),
                               bucket[0].mask.dtype)
            for i, j in enumerate(bucket):
                base[i] = j.base
                mask[i] = j.mask
            staged += [(bucket, (nb, b, d), sl, base[sl], mask[sl])
                       for sl in self._slices(nb)]
        return staged
