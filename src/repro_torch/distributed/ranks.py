"""Ranks of a process group as spawned processes on one host.

``spawn_ranks(fn, n, store_dir=..., backend=...)`` starts ``n`` processes
(the ``spawn`` start method), makes each a rank of a ``torch.distributed``
group initialized from a ``file://`` store under ``store_dir`` (no port is
opened, so runs side by side never collide), calls ``fn(rank, n, *args)``
there and returns the ranks' results in rank order.  The backend is the
caller's: ``"gloo"`` for ranks on the CPU or several ranks sharing one
card, ``"nccl"`` for one card a rank.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback

__all__ = ["spawn_ranks"]

# after a rank fails, how long the others' errors are collected before the
# run ends: a rank's failure makes its peers' collectives fail in turn, and
# which error arrives first is a race
FAILURE_GRACE_S = 2.0


def _rank_main(fn, rank, n, store, backend, timeout, args, out):
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, n: int, *, store_dir: str, backend: str,
                args: tuple = (), timeout: float = 300.0) -> list:
    """``[fn(0, n, *args), ..., fn(n - 1, n, *args)]``, each run in its own
    process as that rank.  ``fn`` and ``args`` must pickle (a module-level
    function), and so must each result.  Raises if a rank raises, dies or
    has not returned within ``timeout`` seconds (every rank is then
    killed; a failure's message holds every failed rank's traceback); the
    process group's own collectives time out after ``timeout`` too."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, store, backend, timeout, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    failed: dict[int, str] = {}
    deadline = grace = time.monotonic() + timeout
    try:
        while len(results) + len(failed) < n:
            if failed and time.monotonic() > grace:
                break
            try:
                rank, ok, res = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and r not in failed
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank(s) {dead} died (exit codes "
                        f"{[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n)) - set(results))} did "
                        f"not return within {timeout} s")
                continue
            if ok:
                results[rank] = res
                continue
            if not failed:      # the others' errors follow within seconds
                grace = time.monotonic() + FAILURE_GRACE_S
            failed[rank] = res
        if failed:
            raise RuntimeError("\n".join(f"rank {r} failed:\n{failed[r]}"
                                         for r in sorted(failed)))
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [results[r] for r in range(n)]
