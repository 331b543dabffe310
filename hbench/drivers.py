"""The load drivers a traffic mix names (``"driver"``): each builds the
system under test from a configuration, makes its stream from the seed,
warms up, drives the measured window and returns the run's record for the
metric readers, with what the timed path emitted and the events it was
given, for the check.

* ``replay``: a closed loop over one reused ``HamletRuntime`` (the main
  path).  It is fed consecutive segments of the seeded stream, each K
  panes long (one flush a district) and rebased to tick 0, as fast as it takes
  them; segments are started while the window is open, and the window
  ends with the last one's results.  The warm-up is one segment of the
  cell's own shape, so the plan cache and the allocator start the window
  at the window's districts and density.
* ``open``: an open loop over one ``OverloadRuntime`` (``offer`` /
  ``step_pane``).  Stream ticks map to wall time at the mix's fixed
  ``offered_events_per_s``; each tick's events are offered when due, on a
  schedule that does not slow when the system does, and a pane is
  stepped once its last tick is offered.  A window result's latency runs
  from the due time of its district's last event in the window to the
  return of the ``step_pane`` that emitted it.  The loop runs K = 1 with no
  pipelined flush: only then is ``step_pane``'s return a window's emission
  (the runtime has no public emission time for K > 1).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

import numpy as np

from . import streamgen

# segment index of the replay warm-up, apart from the measured ones (0, 1, ...)
WARMUP_SEGMENT = 1 << 30
# stream-minutes the open loop replays, unpaced, before its window
OPEN_WARMUP_MINUTES = 2


@dataclasses.dataclass
class Expected:
    """Windows the timed path owes: every window start of ``starts`` for
    every district of ``groups`` over ``stream`` (only the keys in
    ``keep`` where it is given); ``tag`` tells segments apart."""

    stream: streamgen.Stream
    starts: list
    groups: list
    tag: int
    keep: set | None = None


@dataclasses.dataclass
class Run:
    """What a driver hands back: the metric readers' record, the window
    results the timed path emitted, and how to work out the expected ones.
    The program's state is not in it: it is freed when the driver
    returns, before the check."""

    record: dict
    got: dict
    expected: list   # [Expected]


def cell_stream(cfg: dict, mix: dict, seed: int, segment: int,
                minutes: float) -> streamgen.Stream:
    """Segment ``segment`` of the cell's stream: ``minutes`` of it over the
    mix's districts, each at the configuration's density, in the
    configuration's shapes."""
    return streamgen.district_stream(
        seed=seed, segment=segment, minutes=minutes,
        events_per_minute=cfg["events_per_group_minute"] * mix["districts"],
        districts=mix["districts"], n_types=len(cfg["schema"]["types"]),
        type_weights=cfg["type_weights"], burstiness=cfg["burstiness"],
        n_attrs=len(cfg["schema"]["attrs"]),
        attr_range=tuple(cfg["attr_range"]))


def segment_ticks(cfg: dict, mix: dict) -> int:
    """A replay segment's length: the mix's K panes, one flush a district."""
    return int(mix["micro_batch"]) * math.gcd(int(cfg["within"]),
                                              int(cfg["slide"]))


def _batch(wl, s: streamgen.Stream, sl: slice = slice(None)):
    from repro_torch.core.events import EventBatch

    return EventBatch(wl.schema, s.type_id[sl], s.time[sl], s.attrs[sl],
                      s.group[sl])


def _workload(cfg: dict):
    mod = importlib.import_module(f"hbench.queries.{cfg['pattern']}")
    return mod.workload(cfg)


def _obs(trace: bool):
    if not trace:
        return None
    from repro_torch.obs import Observability

    return Observability(trace=True, audit=False, capacity=1 << 20)


def _stats(rt) -> dict:
    return dataclasses.asdict(rt.stats)


def _kernel_shapes() -> dict:
    from repro_torch.kernels.hamlet_dense import dense_propagate_cuda
    from repro_torch.kernels.hamlet_propagate import \
        masked_prefix_propagate_cuda

    return {"masked_propagate": masked_prefix_propagate_cuda.shapes,
            "dense_propagate": dense_propagate_cuda.shapes}


def _trace(ctx, obs):
    """A started device trace over the window on a traced run, else None."""
    if not ctx.trace:
        return None
    from .devtrace import DeviceTrace

    return DeviceTrace(obs).start()


def _sync(ctx) -> None:
    if ctx.device is not None and str(ctx.device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def replay(ctx) -> Run:
    from repro_torch.core.engine import HamletRuntime
    from repro_torch.core.optimizer import DynamicPolicy

    cfg, mix = ctx.cfg, ctx.mix
    wl = _workload(cfg)
    obs = _obs(ctx.trace)
    rt = HamletRuntime(wl, policy=DynamicPolicy(), backend=ctx.backend,
                       device=ctx.device, micro_batch=mix["micro_batch"],
                       plan_cache=True, fold_exec=True, obs=obs)
    t_end = segment_ticks(cfg, mix)
    minutes = t_end / streamgen.TICKS_PER_MINUTE
    w = int(cfg["within"])
    starts = list(range(0, t_end - w + 1, int(cfg["slide"])))
    s = cell_stream(cfg, mix, ctx.seed, WARMUP_SEGMENT, minutes)
    rt.run(_batch(wl, s), t_end)
    _sync(ctx)
    ctx.window_opens()
    stats0 = _stats(rt)
    for shapes in _kernel_shapes().values():
        shapes.clear()
    done, got, seg_s = [], {}, []
    tr = _trace(ctx, obs)
    t0 = t1 = time.perf_counter()
    while t1 - t0 < ctx.seconds:
        i = len(done)
        s = cell_stream(cfg, mix, ctx.seed, i, minutes)
        res = rt.run(_batch(wl, s), t_end)
        done.append(s)
        got.update({(q, g, w0, i): v for (q, g, w0), v in res.items()})
        t = time.perf_counter()
        seg_s.append(t - t1)
        t1 = t
    device = tr.stop() if tr else None
    stats1 = _stats(rt)
    record = {
        "window_s": t1 - t0,
        "events": sum(len(s) for s in done),
        "segments": len(done),
        # each segment's events and seconds (generation included)
        "segment_events": [len(s) for s in done],
        "segment_s": seg_s,
        "stats": {k: stats1[k] - stats0[k] for k in stats1},
        "kernel_shapes": {k: dict(v) for k, v in _kernel_shapes().items()},
        "device": device,
    }
    expected = [Expected(s, starts, np.unique(s.group).tolist(), i)
                for i, s in enumerate(done)]
    return Run(record, got, expected)


def open_loop(ctx) -> Run:
    from repro_torch.core.optimizer import DynamicPolicy
    from repro_torch.overload import OverloadConfig, OverloadRuntime

    cfg, mix = ctx.cfg, ctx.mix
    wl = _workload(cfg)
    obs = _obs(ctx.trace)
    # nothing shed, and a queue no offer can fill
    ocfg = OverloadConfig(shed_policy="none", micro_batch=1,
                          queue_capacity=1 << 26, plan_cache=True,
                          fold_exec=True, pipeline_flush=False)
    ort = OverloadRuntime(wl, ocfg, policy=DynamicPolicy(),
                          backend=ctx.backend, device=ctx.device, obs=obs)
    pane = ort.pane
    per_tick = (cfg["events_per_group_minute"] * mix["districts"]
                / streamgen.TICKS_PER_MINUTE)
    tick_s = per_tick / mix["offered_events_per_s"]
    warm = int(round(OPEN_WARMUP_MINUTES * streamgen.TICKS_PER_MINUTE))
    warm -= warm % pane
    # ticks due inside the window, and every pane they complete
    n_due = int(math.floor(ctx.seconds / tick_s))
    last_tick = warm + n_due - 1
    n_panes = (last_tick + 1 - warm) // pane
    stream = cell_stream(cfg, mix, ctx.seed, 0,
                     (warm + n_panes * pane) / streamgen.TICKS_PER_MINUTE)
    lost = 0
    for t in range(0, warm, pane):
        b = _batch(wl, stream, stream.ticks(t, t + pane))
        lost += len(b) - ort.offer(b)
        ort.step_pane()
    _sync(ctx)
    ctx.window_opens()
    rt = ort.rt
    stats0 = _stats(rt)
    for shapes in _kernel_shapes().values():
        shapes.clear()
    done_at = np.zeros(n_panes)        # step_pane's return, per pane
    lag = np.zeros(n_panes)            # pane's last tick offered late by
    tr = _trace(ctx, obs)
    t0 = time.perf_counter()
    tick, p = warm, 0              # next tick to offer, pane to step
    while p < n_panes:
        now = time.perf_counter()
        due = min(warm + int((now - t0) / tick_s),
                  warm + n_panes * pane - 1)
        if due >= tick:
            b = _batch(wl, stream, stream.ticks(tick, due + 1))
            lost += len(b) - ort.offer(b)
            # the panes whose last tick went out with this offer
            first_end = warm + ((tick - warm) // pane + 1) * pane - 1
            for e in range(first_end, due + 1, pane):
                lag[(e - warm) // pane] = now - (t0 + (e - warm)
                                                 * tick_s)
            tick = due + 1
        if tick > warm + (p + 1) * pane - 1:
            ort.step_pane()
            done_at[p] = time.perf_counter()
            p += 1
            continue
        wait = t0 + (tick - warm) * tick_s - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
    t1 = time.perf_counter()
    device = tr.stop() if tr else None
    stats1 = _stats(rt)
    q = ort.queue
    lost += q.dropped + q.rejected + sum(m.late for m in ort.metrics.panes)
    got_all = ort.results()
    # windows the timed panes closed: a district's windows once its first
    # event has been seen (the runtime then opens its group)
    within, slide = int(cfg["within"]), int(cfg["slide"])
    pane_t0 = warm + pane * np.arange(n_panes)
    w0s = pane_t0 + pane - within
    closes = np.nonzero((w0s >= 0) & (w0s % slide == 0))[0]
    seen = {int(g): int(stream.time[np.argmax(stream.group == g)])
            for g in np.unique(stream.group)}
    keep, lat = set(), []
    for pi in closes:
        w0 = int(w0s[pi])
        sl = stream.ticks(w0, w0 + within)
        for g, ft in seen.items():
            if ft - ft % pane > pane_t0[pi]:
                continue
            keep.update((qq["name"], g, w0) for qq in cfg["queries"])
            # due time of the district's last event in the window
            ev_t = stream.time[sl][stream.group[sl] == g]
            last = int(ev_t[-1]) if len(ev_t) else w0 + within - 1
            lat.append((done_at[pi] - (t0 + (last - warm) * tick_s)) * 1e3)
    timed = sorted({int(w0s[pi]) for pi in closes})
    got = {(qn, g, w0, 0): v for (qn, g, w0), v in got_all.items()
           if w0 in set(timed)}
    window = stream.ticks(warm, warm + n_panes * pane)
    record = {
        "window_s": t1 - t0,
        "events": window.stop - window.start,
        "stats": {k: stats1[k] - stats0[k] for k in stats1},
        "kernel_shapes": {k: dict(v) for k, v in _kernel_shapes().items()},
        "device": device,
        # one latency a window result: each query's window of a district
        # closes at the same step
        "latency_ms": np.repeat(np.asarray(lat),
                                len(cfg["queries"])).tolist(),
        "pane_proc_ms": [m.proc_ms for m in ort.metrics.panes
                         if m.t0 >= warm],
        "offer_lag_ms": (lag * 1e3).tolist(),
        "lost_events": int(lost),
    }
    expected = [Expected(stream, timed, sorted(seen), 0, keep)]
    return Run(record, got, expected)


DRIVERS = {"replay": replay, "open": open_loop}
