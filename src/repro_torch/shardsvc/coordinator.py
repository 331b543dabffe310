"""Cross-shard watermark alignment: the aligned-epoch protocol.

Each shard seals and processes panes against its **own** frontier (a
:class:`~repro_torch.eventtime.frontier.RoutedFrontier` — local bounded-skew
estimate advanced by router promises), so no shard ever waits on another to
seal.  What the fleet still needs is a *joint* notion of progress: which
prefix of event time is final **everywhere**, so that merged results,
global error certificates and rebalance boundaries can be published
against it.

The naive answer — the global minimum over shard frontiers — re-couples
the fleet: one slow shard pins the aligned frontier for everyone, which is
exactly the failure mode sharding was meant to remove.  The aligned-epoch
protocol instead works on coarse epochs (``align_every`` ticks, a pane
multiple) and excludes *laggards*:

* every shard reports a :class:`FrontierSnapshot` after each drive cycle
  (watermark / sealed frontier / processed frontier);
* a shard is **lagging** when its processed epoch trails the fleet's
  maximum by more than ``max_lag_epochs``;
* the **aligned epoch** is the minimum processed epoch over the
  non-lagging shards — it keeps advancing with the healthy majority while
  a slowed shard catches up.

Consumers must treat laggards honestly: ``aligned_results`` in the service
marks windows owned by lagging shards as *pending* rather than final.
Nothing is lost — a laggard's own sealing, retract/amend accounting and
results are untouched; it is only excluded from the fleet-final prefix
until it rejoins (hysteresis: a laggard rejoins once it is back within
``max_lag_epochs``).

Two call protocols feed the aligner:

* **serial** — the driver calls ``update`` per shard then ``align`` once,
  all on one thread (the epoch-synchronous service loop);
* **rendezvous** — under the thread-pool drive path every shard worker
  thread calls ``arrive(snapshot)`` at the end of its drive cycle.  The
  call blocks until all ``n_shards`` workers of the cycle have arrived;
  the last arrival computes the alignment *once* (so the published epoch
  is a function of a consistent set of frontiers, exactly as in the serial
  protocol) and releases the others.  This is a real concurrent barrier:
  the aligned epoch a cycle publishes is identical to what the serial
  protocol would publish for the same frontiers.
"""

from __future__ import annotations

import threading

from ..eventtime.frontier import FrontierSnapshot

__all__ = ["WatermarkAligner"]


class WatermarkAligner:
    def __init__(self, n_shards: int, align_every: int,
                 max_lag_epochs: int = 2):
        if align_every <= 0:
            raise ValueError("align_every must be positive")
        if max_lag_epochs < 0:
            raise ValueError("max_lag_epochs must be non-negative")
        self.n_shards = int(n_shards)
        self.align_every = int(align_every)
        self.max_lag_epochs = int(max_lag_epochs)
        self._snaps: dict[int, FrontierSnapshot] = {}
        self._aligned_epoch = 0        # monotone published frontier
        self.rounds = 0
        # rendezvous state (thread-pool drive path)
        self._cond = threading.Condition()
        self._arrived = 0
        self._generation = 0

    # ------------------------------------------------------------- updates

    def update(self, snap: FrontierSnapshot) -> None:
        if not (0 <= snap.shard < self.n_shards):
            raise ValueError(f"shard {snap.shard} out of range")
        self._snaps[snap.shard] = snap

    def align(self) -> int:
        """Recompute and publish the aligned epoch (monotone)."""
        self.rounds += 1
        epochs = self._epochs()
        lag = self.laggards()
        live = [e for s, e in epochs.items() if s not in lag]
        if live:
            self._aligned_epoch = max(self._aligned_epoch, min(live))
        return self._aligned_epoch

    def arrive(self, snap: FrontierSnapshot,
               timeout: float | None = 60.0) -> int:
        """Concurrent rendezvous: record ``snap`` and block until all
        ``n_shards`` workers of this drive cycle have arrived.  The last
        arrival runs :meth:`align` exactly once over the complete frontier
        set and wakes the rest; every caller returns the cycle's aligned
        epoch.  ``timeout`` bounds the wait so a crashed worker surfaces as
        an error instead of a hang."""
        with self._cond:
            self.update(snap)
            self._arrived += 1
            if self._arrived >= self.n_shards:
                self._arrived = 0
                self._generation += 1
                epoch = self.align()
                self._cond.notify_all()
                return epoch
            gen = self._generation
            while gen == self._generation:
                if not self._cond.wait(timeout):
                    raise RuntimeError(
                        f"alignment rendezvous timed out: "
                        f"{self._arrived}/{self.n_shards} arrived")
            return self._aligned_epoch

    # ------------------------------------------------------------- queries

    def _epochs(self) -> dict[int, int]:
        return {s: self._snaps[s].epoch(self.align_every)
                if s in self._snaps else 0 for s in range(self.n_shards)}

    def laggards(self) -> set[int]:
        """Shards whose processed epoch trails the fleet max by more than
        ``max_lag_epochs`` (excluded from alignment until they catch up)."""
        epochs = self._epochs()
        top = max(epochs.values(), default=0)
        return {s for s, e in epochs.items()
                if top - e > self.max_lag_epochs}

    @property
    def aligned_epoch(self) -> int:
        return self._aligned_epoch

    @property
    def aligned_time(self) -> int:
        """Event time through which every non-lagging shard has processed."""
        return self._aligned_epoch * self.align_every

    def status(self) -> dict:
        epochs = self._epochs()
        lag = self.laggards()
        return {
            "aligned_epoch": self._aligned_epoch,
            "aligned_time": self.aligned_time,
            "epochs": epochs,
            "laggards": sorted(lag),
            "watermarks": {s: snap.watermark
                           for s, snap in self._snaps.items()},
            "backlogs": {s: snap.backlog()
                         for s, snap in self._snaps.items()},
            "rounds": self.rounds,
        }
