"""A traced run's device record: ``torch.profiler`` over the measured
window, read from the profiler's raw records (not ``key_averages()``,
which first builds a Python event tree over every record).

* ``busy_s``: the union of the intervals in which a kernel, copy or set
  ran on the card, inside the window (the busy-share arithmetic of the
  port's ``chip_smoke.py``, with overlaps counted once);
* ``device_ops``: device seconds by operation name;
* ``idle_gaps``: the card's idle time inside the window, by what the host
  was doing then, as the program's own phase spans (``obs`` tracer:
  plan, execute, finalize, fold) say; time outside every span is the
  harness's and the runtime's glue (``other``).
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

MARK = "hbench.window"


class DeviceTrace:
    """``torch.profiler`` from :meth:`start` to :meth:`stop`; ``obs`` is
    the program's ``Observability`` facade (tracing on) whose phase spans
    name the host's work."""

    def __init__(self, obs):
        self.obs = obs
        self._obs_at: dict = {}

    def start(self) -> "DeviceTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = self._mark("start")
        return self

    def _mark(self, what: str) -> float:
        """A profiler range and an obs instant at one host instant;
        returns that instant on ``perf_counter``."""
        from torch.profiler import record_function

        with record_function(f"{MARK}.{what}"):
            t = time.perf_counter()
        self.obs.tracer.instant(f"{MARK}.{what}", cat="hbench")
        self._obs_at[what] = (t + time.perf_counter()) / 2
        return t

    def stop(self) -> dict:
        """Waits for the card, ends the trace and reads it."""
        import torch

        torch.cuda.synchronize()
        self._mark("end")
        self._prof.__exit__(None, None, None)
        return self._read()

    def _read(self) -> dict:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        marks = {}
        dev = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == cuda:
                dev.append((ev.start_ns(), ev.duration_ns(), ev.name()))
            elif ev.name().startswith(MARK):
                marks[ev.name()[len(MARK) + 1:]] = ev.start_ns()
        w0, w1 = marks["start"], marks["end"]
        by_name: dict = defaultdict(float)
        iv = []
        for s, d, name in dev:
            a, b = max(s, w0), min(s + d, w1)
            if b > a:
                iv.append((a, b))
                by_name[name] += (b - a) / 1e9
        iv.sort()
        merged: list = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_ns = sum(b - a for a, b in merged)
        gaps, cur = [], w0
        for a, b in merged:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if w1 > cur:
            gaps.append((cur, w1))
        return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
                "device_ops": dict(by_name),
                "idle_gaps": self._attribute(gaps, w0)}

    def _attribute(self, gaps: list, w0_ns: int) -> dict:
        """Idle seconds by the host phase span covering each gap's time
        (a gap is split where spans begin and end)."""
        out: dict = defaultdict(float)
        starts, ends, names = self._host_spans(w0_ns)
        for a, b in gaps:
            covered = 0
            i = int(np.searchsorted(ends, a, side="right"))
            while i < len(starts) and starts[i] < b:
                lo, hi = max(starts[i], a), min(ends[i], b)
                if hi > lo:
                    out[names[i]] += (hi - lo) / 1e9
                    covered += hi - lo
                i += 1
            if (b - a) - covered > 0:
                out["other"] += ((b - a) - covered) / 1e9
        return dict(out)

    def _host_spans(self, w0_ns: int):
        """The obs phase spans on the profiler's clock, as sorted,
        non-overlapping ``(starts, ends, names)``."""
        evs = self.obs.tracer.events()
        at = next(e["ts"] for e in evs if e["name"] == f"{MARK}.start")
        # a tracer timestamp is us since the tracer's origin on
        # perf_counter; the profiler's start mark is at perf_counter _t0
        origin = self._obs_at["start"] - at / 1e6

        def ns(ts):
            return w0_ns + (origin + ts / 1e6 - self._t0) * 1e9

        rows = sorted((ns(e["ts"]), ns(e["ts"] + e["dur"]), e["name"])
                      for e in evs
                      if e.get("ph") == "X" and e.get("cat") == "phase")
        starts, ends, names = [], [], []
        for a, b, name in rows:
            if starts and a < ends[-1]:
                a = ends[-1]
            if b > a:
                starts.append(a)
                ends.append(b)
                names.append(name)
        return np.array(starts), np.array(ends), names


def idle_pct(rec: dict):
    """The share of a traced run's window in which no kernel, copy or set
    ran on the card; None without a device record."""
    dev = rec.get("device")
    if not dev or not dev["window_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
