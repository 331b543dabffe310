"""Watermark policies: when is a pane *sealed*?

A watermark is a promise about the future of a disordered stream: after
observing some prefix of arrivals, ``watermark() = w`` asserts that events
with timestamp ``<= w`` are no longer expected.  The reorder buffer seals a
pane ``[t0, t0 + pane)`` once ``w >= t0 + pane - 1``; events arriving behind
the watermark are *late* (revisable within the lateness horizon, expired
beyond it).

Every policy is **monotone** by construction — ``watermark()`` never
regresses, even when its internal estimate would (adaptive skew shrinking,
a new group appearing with an old frontier).  The property tests in
``tests/test_property.py`` fuzz this invariant.

Policies
--------
* :class:`BoundedSkew` — ``max_seen - skew``; the classic fixed-allowance
  watermark for clock-skewed producers.
* :class:`PercentileAdaptive` — tracks the observed per-event lateness
  (``max_seen_before - t`` at arrival) in a ring buffer and sets the skew to
  a percentile of it: calm streams seal fast, disordered phases widen the
  allowance.
* :class:`GroupHeartbeat` — per-group frontiers; the watermark is the
  minimum frontier over live groups minus ``skew``.  A silent group holds
  the watermark back until it sends a :meth:`~WatermarkPolicy.heartbeat`
  or exceeds ``idle_timeout`` ticks behind the global frontier.
"""

from __future__ import annotations

import numpy as np

__all__ = ["WatermarkPolicy", "BoundedSkew", "PercentileAdaptive",
           "GroupHeartbeat", "make_watermark", "WM_MIN"]

WM_MIN = -(1 << 62)


class WatermarkPolicy:
    """Base: observes arrivals, exposes a monotone watermark."""

    def __init__(self) -> None:
        self._wm = WM_MIN

    def observe(self, times: np.ndarray, groups: np.ndarray | None = None
                ) -> int:
        """Account a chunk of arrivals (any order); returns the watermark."""
        if len(times):
            self._advance(self._estimate(np.asarray(times, dtype=np.int64),
                                         groups))
        return self._wm

    def heartbeat(self, group: int, t: int) -> int:
        """Liveness signal: ``group`` promises no events with time < t.
        Policies without per-group state treat it as an empty observation."""
        return self._wm

    def watermark(self) -> int:
        return self._wm

    # -- internals --

    def _advance(self, estimate: int) -> None:
        # monotonicity is enforced here, not trusted from the estimate
        if estimate > self._wm:
            self._wm = estimate

    def _estimate(self, times: np.ndarray, groups) -> int:
        raise NotImplementedError


class BoundedSkew(WatermarkPolicy):
    """``max_seen - skew - 1``: an event late by *exactly* ``skew`` ticks
    (timestamp ``max_seen - skew``) is still within the promised bound, so
    the watermark must stay strictly below it — the classic off-by-one of
    bounded-out-of-orderness watermarks."""

    def __init__(self, skew: int = 0):
        super().__init__()
        if skew < 0:
            raise ValueError("skew must be non-negative")
        self.skew = int(skew)
        self._max_seen = WM_MIN

    def _estimate(self, times: np.ndarray, groups) -> int:
        self._max_seen = max(self._max_seen, int(times.max()))
        return self._max_seen - self.skew - 1


class PercentileAdaptive(WatermarkPolicy):
    def __init__(self, percentile: float = 95.0, window: int = 256,
                 min_skew: int = 0, max_skew: int | None = None):
        super().__init__()
        if not (0.0 < percentile <= 100.0):
            raise ValueError("percentile must be in (0, 100]")
        self.percentile = float(percentile)
        self.window = int(window)
        self.min_skew = int(min_skew)
        self.max_skew = max_skew
        self._lateness = np.zeros(self.window, dtype=np.int64)
        self._fill = 0
        self._pos = 0
        self._max_seen = WM_MIN

    def _estimate(self, times: np.ndarray, groups) -> int:
        # lateness sample per arrival: how far behind the running frontier it
        # landed.  Computed against the frontier *before* each event in this
        # chunk (cummax over the chunk, seeded by the global max).
        frontier = np.maximum.accumulate(
            np.concatenate([[self._max_seen], times]))[:-1]
        late = np.maximum(frontier - times, 0)
        self._max_seen = max(self._max_seen, int(times.max()))
        for v in late:
            self._lateness[self._pos] = v
            self._pos = (self._pos + 1) % self.window
            self._fill = min(self._fill + 1, self.window)
        skew = self.min_skew
        if self._fill:
            q = float(np.percentile(self._lateness[: self._fill],
                                    self.percentile))
            skew = max(skew, int(np.ceil(q)))
        if self.max_skew is not None:
            skew = min(skew, int(self.max_skew))
        # -1: lateness exactly == skew is still within the tracked bound
        return self._max_seen - skew - 1

    @property
    def current_skew(self) -> int:
        if not self._fill:
            return self.min_skew
        q = int(np.ceil(np.percentile(self._lateness[: self._fill],
                                      self.percentile)))
        skew = max(self.min_skew, q)
        return skew if self.max_skew is None else min(skew, self.max_skew)


class GroupHeartbeat(WatermarkPolicy):
    """Per-group *closed bounds*: an observed event at ``t`` closes ``t - 1``
    for its group (equal-timestamp ties may still arrive), and a heartbeat
    ``(g, t)`` — the promise that no group-g event with time **< t** is
    pending — likewise closes ``t - 1``.  The watermark is the minimum
    closed bound over live groups, minus ``skew``."""

    def __init__(self, skew: int = 0, idle_timeout: int | None = None):
        super().__init__()
        if skew < 0:
            raise ValueError("skew must be non-negative")
        self.skew = int(skew)
        self.idle_timeout = idle_timeout
        self._bound: dict[int, int] = {}    # group -> largest closed time
        self._max_bound = WM_MIN

    def heartbeat(self, group: int, t: int) -> int:
        self._close(int(group), int(t) - 1)
        self._advance(self._from_bounds())
        return self._wm

    def _estimate(self, times: np.ndarray, groups) -> int:
        if groups is None:
            groups = np.zeros(len(times), dtype=np.int64)
        for g in np.unique(groups):
            self._close(int(g), int(times[groups == g].max()) - 1)
        return self._from_bounds()

    def _close(self, g: int, bound: int) -> None:
        self._bound[g] = max(self._bound.get(g, WM_MIN), bound)
        self._max_bound = max(self._max_bound, bound)

    def _from_bounds(self) -> int:
        live = list(self._bound.values())
        if self.idle_timeout is not None:
            # groups too far behind the global frontier stop holding the
            # watermark back — their next event would be late anyway
            live = [b for b in live
                    if self._max_bound - b <= self.idle_timeout] or \
                   [self._max_bound]
        return min(live) - self.skew


def make_watermark(config) -> WatermarkPolicy:
    """Build the policy named by an
    :class:`~repro_torch.eventtime.EventTimeConfig`."""
    if config.watermark == "bounded_skew":
        return BoundedSkew(skew=config.skew)
    if config.watermark == "percentile":
        return PercentileAdaptive(percentile=config.percentile,
                                  window=config.percentile_window,
                                  min_skew=config.skew,
                                  max_skew=config.max_skew)
    if config.watermark == "group_heartbeat":
        return GroupHeartbeat(skew=config.skew,
                              idle_timeout=config.idle_timeout)
    raise ValueError(f"unknown watermark policy {config.watermark!r}")
