"""Per-shard frontier export for the sharded service tier.

A shard in the sharded service (:mod:`repro_torch.shardsvc`) owns its
own watermark: its reorder buffer seals panes as *its* frontier allows, independently of
every other shard.  Two pieces make that work:

* :class:`RoutedFrontier` — the watermark policy a shard runs.  It is a
  bounded-skew estimate over the shard's **local** arrivals, advanced by
  *upstream promises*: the router heartbeats every shard with its global
  watermark after each routed chunk (the router has already forwarded every
  arrival at or below its own watermark, so "no shard-s event with time
  ``< t`` is still pending" is a sound promise even for a shard whose
  tenants are quiet).  Without the promise channel a quiet shard's frontier
  would stall at its last local event and hold its own sealing back forever;
  with it, sealing is driven by global stream progress while disorder
  tolerance stays local.
* :class:`FrontierSnapshot` — the per-shard state a shard exports to the
  cross-shard alignment coordinator (``shardsvc/coordinator.py``): the
  watermark, the sealed frontier (panes released by the reorder buffer) and
  the processed frontier (panes actually executed by the shard's pane
  loop).  Sealing and processing are deliberately separate axes — a shard
  that seals briskly but processes slowly is *lagging*, and the aligner
  excludes it from the aligned epoch instead of letting it stall the fleet.

Monotonicity: :class:`RoutedFrontier` inherits the enforced-in-``_advance``
monotone contract of every :class:`~repro_torch.eventtime.watermark
.WatermarkPolicy` — a stale router promise (behind the local estimate)
simply does not move the watermark.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .watermark import WM_MIN, WatermarkPolicy

__all__ = ["RoutedFrontier", "FrontierSnapshot"]


class RoutedFrontier(WatermarkPolicy):
    """Bounded-skew local estimate, advanced by upstream router promises.

    ``observe`` accounts the shard's own arrivals (watermark estimate
    ``local_max_seen - skew - 1``, the classic closed-bound off-by-one);
    ``heartbeat(group, t)`` is the promise channel: *no event with time
    < t is still pending for this shard* — it closes ``t - 1`` regardless
    of group (the router promises for the whole shard, so the group id is
    advisory).  The resulting watermark is the max of both sources, and
    monotone.
    """

    def __init__(self, skew: int = 0):
        super().__init__()
        if skew < 0:
            raise ValueError("skew must be non-negative")
        self.skew = int(skew)
        self._max_seen = WM_MIN
        self.promises = 0

    def heartbeat(self, group: int, t: int) -> int:
        self.promises += 1
        self._advance(int(t) - 1)
        return self._wm

    def _estimate(self, times: np.ndarray, groups) -> int:
        self._max_seen = max(self._max_seen, int(times.max()))
        return self._max_seen - self.skew - 1


@dataclass(frozen=True)
class FrontierSnapshot:
    """One shard's frontier state, as reported to the alignment coordinator.

    watermark      the shard's :class:`RoutedFrontier` watermark (ticks)
    sealed_end     panes ``[0, sealed_end)`` released by the reorder buffer
    processed_end  panes ``[0, processed_end)`` executed by the pane loop;
                   ``sealed_end - processed_end`` is the shard's processing
                   backlog in ticks
    """

    shard: int
    watermark: int
    sealed_end: int
    processed_end: int

    def epoch(self, align_every: int) -> int:
        """Aligned-epoch index this shard has *processed* through."""
        return self.processed_end // align_every

    def backlog(self) -> int:
        return max(0, self.sealed_end - self.processed_end)
