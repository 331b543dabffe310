"""Configuration for the bounded-latency overload runtime.

One dataclass gathers every knob of the overload subsystem so callers
(`OverloadRuntime`, `HamletService`, the launch CLI) opt in with a single
object.  The SLO is expressed on *pane* processing latency for the
runtime (epoch latency for the service, which drains at epoch granularity).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["OverloadConfig"]


@dataclass
class OverloadConfig:
    """Opt-in overload handling: admission control + shedding + SLO control.

    slo_ms             latency target the controller steers towards
    shed_policy        "none" | "drop_tail" | "random" | "benefit_weighted"
    pane_budget_events hard per-pane admission cap (events); None = uncapped.
                       This is the feed-forward part of admission control: it
                       bounds per-pane work even before the controller reacts.
    queue_capacity     ingress queue bound (events); arrivals beyond it are
                       dropped at ingress and counted
    high_watermark     queue fill fraction above which the queue stops
                       accepting (backpressure asserted)
    low_watermark      fill fraction below which it resumes accepting
    kp / ki / kd       PID gains on the relative latency error
                       ``(latency - slo) / slo``.  Keep the loop gain
                       ``(kp + ki) * overload_factor`` below ~1: the plant
                       gain scales with offered load, and a hot discrete
                       loop limit-cycles between shedding nothing and
                       everything
    kr                 gain on the *revision load* (disorder-aware admission
                       control): under out-of-order arrival the event-time
                       layer re-plans panes and re-folds emitted windows;
                       that work competes with fresh panes for the same
                       budget, so the controller treats the revision rate
                       (revisions per emitted window, fed by the caller) as
                       a second cost axis — a revision storm raises the shed
                       ratio even while pane latency still looks healthy.
                       0 disables the axis.
    max_shed           ceiling on the controller's shed ratio
    micro_batch        cross-pane fusion factor K: admitted panes accumulate
                       and execute as one fused launch set per K panes (the
                       controller then observes amortized per-pane time once
                       per micro-batch); 1 = exact per-pane control loop
    plan_cache         accepted and ignored: planning keeps no memo of
                       whole panes, and the benchmark's drivers still set it
    fold_exec          enable the stacked finalize/fold executor (see
                       ``core/fold_exec.py``); off = the sequential
                       per-graphlet replay (bitwise-identical results)
    fixed_shed         if set, bypass the controller and shed this constant
                       fraction (used for equal-ratio policy comparisons)
    min_burst_keep     fraction of each Kleene burst the benefit-weighted
                       policy protects in its primary shed phase (>= 1 event),
                       so ``E+`` patterns keep at least a match per burst
    benefit_model      "v1" | "v2" — which Def. 11/12 cost model weights bursts
    seed               rng seed for the random policy
    tick_seconds       maps stream ticks to wall seconds; when set, latency is
                       end-to-end (queueing backlog included), not just the
                       pane processing time
    pipeline_flush     run each micro-batch flush (plan -> execute ->
                       finalize -> fold) on a dedicated single worker thread
                       instead of inline: while flush N executes, the caller
                       thread keeps polling, admitting and shedding the
                       panes of flush N+1 (the host-side half of the
                       pipeline).  Flushes stay strictly FIFO on the one
                       worker, so results are identical to inline execution
                       whenever shed decisions are (``none``/``fixed_shed``
                       — with the live PID loop the controller observes a
                       flush one step later, the same class of trade as
                       ``micro_batch``).  Call ``shutdown()`` (or
                       ``results()``, which drains) before discarding the
                       runtime.
    """

    slo_ms: float = 50.0
    shed_policy: str = "benefit_weighted"
    pane_budget_events: int | None = None
    queue_capacity: int = 1 << 16
    high_watermark: float = 0.75
    low_watermark: float = 0.5
    kp: float = 0.1
    ki: float = 0.05
    kd: float = 0.0
    kr: float = 0.0
    max_shed: float = 0.98
    fixed_shed: float | None = None
    micro_batch: int = 1
    plan_cache: bool = True
    fold_exec: bool = True
    min_burst_keep: float = 0.25
    benefit_model: str = "v1"
    seed: int = 0
    tick_seconds: float | None = None
    pipeline_flush: bool = False

    def __post_init__(self) -> None:
        if self.shed_policy not in ("none", "drop_tail", "random",
                                    "benefit_weighted"):
            raise ValueError(f"unknown shed_policy {self.shed_policy!r}")
        if not (0.0 <= self.low_watermark <= self.high_watermark <= 1.0):
            raise ValueError("need 0 <= low_watermark <= high_watermark <= 1")
        if self.fixed_shed is not None and not (0.0 <= self.fixed_shed < 1.0):
            raise ValueError("fixed_shed must be in [0, 1)")
        if self.micro_batch < 1:
            raise ValueError("micro_batch must be >= 1")
        if self.kr < 0.0:
            raise ValueError("kr must be >= 0")
