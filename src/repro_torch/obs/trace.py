"""Chrome-trace span tracer with per-pane tracks and a bounded ring buffer.

Spans are recorded as tuples into a ``collections.deque(maxlen=capacity)``
ring (oldest events drop first, counted in :attr:`Tracer.dropped`) and
formatted lazily at export.  The layout follows the Chrome trace event
format so the output loads directly in Perfetto / ``chrome://tracing``:

* ``tid 0`` is the *engine* track: nested ``B``/``E`` duration spans
  (micro-batch flush, fold flush, service epochs) plus engine-wide
  ``X`` phase events that have no pane attribution.
* ``tid >= 1`` is one track per sampled pane, keyed by
  ``(group, pane_t0)``: ``X`` complete events for the four pipeline
  phases (plan / execute / finalize / fold) and ``i`` instant events for
  lifecycle marks (ingest -> seal -> plan -> execute -> emit ->
  revise / evict) and plan-cache lookups.

Timestamps are microseconds relative to tracer construction, taken from
the *same* ``perf_counter`` readings the engine already uses for
``RunStats`` — so per-pane phase spans sum to the ``RunStats`` phase
totals by construction.

The export is strict JSONL (one event object per line).  Perfetto loads
the JSONL directly; for viewers that require the enveloped form, run::

    python -m repro_torch.obs.trace trace.jsonl trace.json

to wrap the events as ``{"traceEvents": [...]}``.
"""

from __future__ import annotations

import json
import os
from collections import deque
from time import perf_counter

_PHASES = ("plan", "execute", "finalize", "fold")
_MISSING = object()


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
        self._t0 = perf_counter()
        self._stack: list[str] = []
        self._tids: dict = {}
        self._next_tid = 1
        self._panes_seen = 0
        self.dropped = 0
        self._pid = os.getpid()

    # ------------------------------------------------------------- internals

    def _ts(self, t: float | None = None) -> float:
        return ((perf_counter() if t is None else t) - self._t0) * 1e6

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

    def events(self) -> list[dict]:
        """Materialise the ring as Chrome trace event dicts."""
        out = []
        for ph, name, cat, ts, dur, tid, args in self._events:
            ev = {"ph": ph, "name": name, "cat": cat,
                  "ts": round(ts, 3), "pid": self._pid, "tid": tid}
            if ph == "X":
                ev["dur"] = round(dur, 3)
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def export_jsonl(self, path) -> int:
        """Write strict JSONL (one event per line); returns event count."""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, sort_keys=True))
                f.write("\n")
        return len(evs)

    def phase_totals(self) -> dict:
        """Seconds of recorded ``X`` phase-span time, keyed by phase name."""
        tot = {}
        for ph, name, cat, _ts, dur, _tid, _args in self._events:
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
