"""Chrome-trace span tracer with per-pane tracks and a bounded ring buffer.

Spans are recorded as tuples into a ``collections.deque(maxlen=capacity)``
ring (oldest events drop first, counted in :attr:`Tracer.dropped`) and
formatted lazily at export.  The layout follows the Chrome trace event
format so the output loads directly in Perfetto / ``chrome://tracing``:

* ``tid 0`` is the *engine* track: nested ``B``/``E`` duration spans
  (micro-batch flush, fold flush, service epochs); at K > 1 one measured
  ``X`` phase span per flush and phase (plan / execute / finalize) with
  ``args`` ``{"flush": id, "panes": K, "pane_keys": [...]}``; the
  top-level host phases ``ingress`` and ``admit`` of the streaming layer;
  and the ``X`` *step* spans (category ``"step"``) inside the phases:
  ``plan.prologue``, ``plan.edge``, ``plan.neg``, ``plan.decide``,
  ``plan.build``, ``execute.stage``, ``execute.launch``, ``execute.wait``,
  ``finalize.prep``, ``finalize.rounds``, ``finalize.wait`` and the
  collector's full passes, ``gc``.  Every span of one flush carries its
  ``flush`` id in ``args``.
* ``tid >= 1`` is one track per sampled pane, keyed by
  ``(group, pane_t0)``: at K = 1 the ``X`` phase spans of the pane (and
  its step spans), the ``fold`` phase at any K, and ``i`` instant events
  for lifecycle marks (ingest -> seal -> plan -> execute -> emit ->
  revise / evict).

Timestamps are microseconds relative to the tracer's origin, taken from
the *same* ``perf_counter`` readings the engine already uses for
``RunStats`` — so phase spans sum to the ``RunStats`` phase totals by
construction.  A flush of K > 1 panes is timed once, as a whole: no
per-pane span is made up for it.

The origin is anchored as a pair of ``perf_counter_ns`` and
``time.time_ns`` readings (the tightest of a few back-to-back samples),
written at export as a ``clock_sync`` metadata event.
:meth:`Tracer.unix_ns` places any ``ts`` on the Unix epoch, the clock of
``torch.profiler``'s ``start_ns()``; ``export_jsonl(path, epoch_ns=...)``
writes ``ts`` on that clock, so the program's events and those of the
profiler's ``export_chrome_trace`` (pass its ``baseTimeNanoseconds``)
share one time axis and load as one Perfetto timeline.

The export is strict JSONL (one event object per line).  Perfetto loads
the JSONL directly; for viewers that require the enveloped form, run::

    python -m repro_torch.obs.trace trace.jsonl trace.json

to wrap the events as ``{"traceEvents": [...]}``.
"""

from __future__ import annotations

import json
import os
from collections import deque
from time import perf_counter, perf_counter_ns, time_ns

_PHASES = ("plan", "execute", "finalize", "fold")
_MISSING = object()


def _clock_pair(samples: int = 5) -> tuple[int, int]:
    """One instant read on both clocks: ``(perf_counter_ns, time_ns)``,
    from the tightest of ``samples`` back-to-back readings."""
    best = None
    for _ in range(samples):
        a = perf_counter_ns()
        u = time_ns()
        b = perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


class _NullSpan:
    """No-op context manager returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_cat", "_args")

    def __init__(self, tr, name, cat, args):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._tr._begin(self._name, self._cat, self._args)
        return self

    def __exit__(self, *exc):
        self._tr._end(self._name)
        return False


class Tracer:
    """Bounded ring-buffer span recorder in Chrome trace event layout.

    ``capacity`` bounds the in-memory event ring (``capacity <= 0``
    disables the tracer entirely: every record call is a cheap guarded
    no-op and :meth:`span` returns a shared null context manager).
    ``sample`` records every N-th pane track; engine-track spans and
    unsampled-pane phase events are unaffected by sampling only in the
    sense that unsampled panes simply do not get a track (their events
    are skipped, keeping the ring for the panes that were kept).
    """

    def __init__(self, capacity: int = 1 << 18, sample: int = 1):
        self.capacity = int(capacity)
        self.sample = max(1, int(sample))
        self.enabled = self.capacity > 0
        self._events = deque(maxlen=max(1, self.capacity))
        self._t0_ns, self._unix0_ns = _clock_pair()
        self._t0 = self._t0_ns / 1e9
        self._stack: list[str] = []
        self._tids: dict = {}
        self._next_tid = 1
        self._panes_seen = 0
        self.dropped = 0
        self._pid = os.getpid()

    # ------------------------------------------------------------- internals

    def _ts(self, t: float | None = None) -> float:
        return ((perf_counter() if t is None else t) - self._t0) * 1e6

    def unix_ns(self, ts: float) -> int:
        """A tracer timestamp (us since the origin) as Unix-epoch ns, the
        clock of ``torch.profiler``'s ``start_ns()``."""
        return self._unix0_ns + round(ts * 1e3)

    def _emit(self, ev: tuple) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(ev)

    # ----------------------------------------------------------- pane tracks

    def pane_tid(self, key):
        """Track id for pane ``key``; ``None`` when the pane is sampled out."""
        tid = self._tids.get(key, _MISSING)
        if tid is not _MISSING:
            return tid
        self._panes_seen += 1
        if (self._panes_seen - 1) % self.sample:
            self._tids[key] = None
            return None
        tid = self._next_tid
        self._next_tid += 1
        self._tids[key] = tid
        self._emit(("M", "thread_name", "__metadata", 0.0, 0.0, tid,
                    {"name": f"pane g{key[0]} t{key[1]}"}))
        return tid

    # ------------------------------------------------------------- recording

    def complete(self, name, t_start, dur_s, key=None, cat="phase",
                 args=None) -> None:
        """Record a retrospective ``X`` event ``dur_s`` seconds long."""
        if not self.enabled:
            return
        tid = 0
        if key is not None:
            tid = self.pane_tid(key)
            if tid is None:
                return
        self._emit(("X", name, cat, self._ts(t_start), dur_s * 1e6, tid,
                    args))

    def instant(self, name, key=None, cat="lifecycle", args=None) -> None:
        if not self.enabled:
            return
        tid = 0
        if key is not None:
            tid = self.pane_tid(key)
            if tid is None:
                return
        self._emit(("i", name, cat, self._ts(), 0.0, tid, args))

    def span(self, name, cat="span", args=None):
        """Nestable ``B``/``E`` duration span on the engine track."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def _begin(self, name, cat, args) -> None:
        self._stack.append(name)
        self._emit(("B", name, cat, self._ts(), 0.0, 0, args))

    def _end(self, name) -> None:
        if self._stack and self._stack[-1] == name:
            self._stack.pop()
        self._emit(("E", name, "span", self._ts(), 0.0, 0, None))

    # --------------------------------------------------------------- export

    def __len__(self) -> int:
        return len(self._events)

    def events(self, epoch_ns: int | None = None) -> list[dict]:
        """Materialise the ring as Chrome trace event dicts, after a
        ``clock_sync`` metadata event holding the origin on both clocks.
        With ``epoch_ns``, each ``ts`` is microseconds after that Unix time
        (0: the Unix epoch itself) instead of after the tracer's origin."""
        if not self.enabled:
            return []
        shift = (0.0 if epoch_ns is None
                 else (self._unix0_ns - epoch_ns) / 1e3)
        out = [{"ph": "M", "name": "clock_sync", "cat": "__metadata",
                "ts": shift, "pid": self._pid, "tid": 0,
                "args": {"perf_counter_ns": self._t0_ns,
                         "unix_ns": self._unix0_ns}}]
        # a snapshot: the collector's hook may record a span while the
        # loop allocates (the ring is never iterated in place)
        for ph, name, cat, ts, dur, tid, args in list(self._events):
            ev = {"ph": ph, "name": name, "cat": cat,
                  "ts": round(ts + shift, 3), "pid": self._pid, "tid": tid}
            if ph == "X":
                ev["dur"] = round(dur, 3)
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def export_jsonl(self, path, epoch_ns: int | None = None) -> int:
        """Write strict JSONL (one event per line); returns event count.
        ``epoch_ns`` as in :meth:`events`: give a ``torch.profiler``
        chrome trace's ``baseTimeNanoseconds`` to share its time axis."""
        evs = self.events(epoch_ns)
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, sort_keys=True))
                f.write("\n")
        return len(evs)

    def phase_totals(self) -> dict:
        """Seconds of recorded ``X`` phase-span time, keyed by phase name."""
        tot = {}
        for ph, name, cat, _ts, dur, _tid, _args in list(self._events):
            if ph == "X" and cat == "phase":
                tot[name] = tot.get(name, 0.0) + dur / 1e6
        return tot


def jsonl_to_chrome(src, dst) -> int:
    """Wrap a JSONL trace as ``{"traceEvents": [...]}`` for strict viewers."""
    events = []
    with open(src) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    with open(dst, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="wrap a JSONL trace as a Chrome trace JSON envelope")
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)
    n = jsonl_to_chrome(args.src, args.dst)
    print(f"wrote {n} events -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
