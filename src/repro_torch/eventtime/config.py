"""Configuration for the event-time subsystem.

One dataclass gathers the knobs of the out-of-order layer: which watermark
policy seals panes, how far past the watermark a straggler may land and still
be *revised* into its pane (the lateness horizon), and whether panes are
executed speculatively on arrival (emit-then-amend) or buffered until the
watermark seals them (emit-once).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["EventTimeConfig"]

_POLICIES = ("bounded_skew", "percentile", "group_heartbeat")


@dataclass
class EventTimeConfig:
    """Opt-in event-time processing: reordering, watermarks, revision.

    watermark          "bounded_skew" | "percentile" | "group_heartbeat"
    skew               bounded-skew allowance (ticks): the watermark trails
                       the max seen timestamp by this much.  Also the floor
                       skew of the adaptive policies
    percentile         for "percentile": the observed-lateness percentile the
                       adaptive skew tracks
    percentile_window  for "percentile": ring-buffer size of lateness samples
    max_skew           ceiling on the adaptive skew (None = unbounded)
    idle_timeout       for "group_heartbeat": a group whose frontier trails
                       the global max by more than this stops holding the
                       watermark back (None = silent groups hold it forever;
                       send heartbeats to advance)
    max_retained_panes caps, per group partition, how many panes retain
                       their raw events for revision (bounded revision
                       memory).  When the cap is exceeded the *oldest*
                       retained panes are evicted: the pane is executed if
                       it has not been yet, its transfer matrices are kept
                       (emission and re-folds of *other* panes stay exact),
                       but its raw ``EventBatch`` is dropped — the evicted
                       events are expired into the shedding accountant
                       (``late_events``; bound certificates withdrawn) and
                       any later straggler landing in an evicted pane is
                       expired instead of absorbed.  MIN/MAX aggregates of
                       still-revisable windows covering an evicted pane lose
                       that pane's events.  None = retain for the whole
                       lateness horizon
    lateness_horizon   bounds how long pane state is retained for revision.
                       The speculative runtime expires an event only once
                       its pane has been *retired* (no still-revisable
                       window covers it: ``watermark - horizon -
                       max(within)`` behind); the reorder buffer expires
                       once an event is both behind the sealed frontier and
                       ``horizon`` behind the watermark.  Expired events are
                       counted and, when an accountant is attached, charged
                       as shed so the ``true <= 3^s * emitted`` story stays
                       sound.  None = never expire; revision depth is then
                       bounded only by what the consumer retains
                       (``HamletService`` retains — and therefore revises —
                       at most max(within) behind its emitted frontier)
    speculative        True: execute panes optimistically on arrival, emit as
                       soon as the stream frontier passes a window, amend on
                       late data.  False: buffer-everything baseline — emit a
                       window only once the watermark seals its last pane
    """

    watermark: str = "bounded_skew"
    skew: int = 8
    percentile: float = 95.0
    percentile_window: int = 256
    max_skew: int | None = None
    idle_timeout: int | None = None
    max_retained_panes: int | None = None
    lateness_horizon: int | None = None
    speculative: bool = True

    def __post_init__(self) -> None:
        if self.watermark not in _POLICIES:
            raise ValueError(f"unknown watermark policy {self.watermark!r}; "
                             f"have {_POLICIES}")
        if self.skew < 0:
            raise ValueError("skew must be non-negative")
        if not (0.0 < self.percentile <= 100.0):
            raise ValueError("percentile must be in (0, 100]")
        if self.lateness_horizon is not None and self.lateness_horizon < 0:
            raise ValueError("lateness_horizon must be non-negative")
        if self.max_retained_panes is not None and self.max_retained_panes < 1:
            raise ValueError("max_retained_panes must be >= 1")
