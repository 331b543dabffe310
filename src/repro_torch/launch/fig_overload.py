"""The workload and stream of the overload figure's SLO-control experiment,
as the JAX package's ``benchmarks/fig_overload.py`` builds them (full
mode): paper workload 1 with 8 queries ``SEQ(head, Travel+)`` over heads
Request, Pickup and Dropoff, within 60 and slide 15, over an overload
scenario of the ridesharing stream — 1,500 events/min for 8 minutes with a
ramp to 1.5x, flash crowds of 3x at tick 160 and 4x at tick 320 (10 ticks
each), 4 groups, burstiness 0.9, seed 7.

    from repro_torch.launch.fig_overload import slo_control_case
    wl, stream, t_end = slo_control_case()

``fragmented_stream`` is the worst case the benchmark sizes the admission
cap with; ``detection_recall`` is the figure's utility metric.
"""

from __future__ import annotations

from ..streams.generator import (RIDESHARING_SCHEMA, OverloadStreamConfig,
                                 StreamConfig, bursty_stream, overload_stream)
from .fig9 import kleene_workload

__all__ = ["slo_control_case", "fragmented_stream", "detection_recall"]


def slo_control_case(minutes: int = 8, n_queries: int = 8):
    """``(workload, stream, t_end)`` of the SLO-control experiment (the
    benchmark's quick mode is ``minutes=4, n_queries=4``)."""
    t_end = minutes * 60
    wl = kleene_workload(RIDESHARING_SCHEMA, n_queries, kleene_type="Travel",
                         head_types=["Request", "Pickup", "Dropoff"],
                         within=60, slide=15)
    stream = overload_stream(OverloadStreamConfig(
        schema=RIDESHARING_SCHEMA, base_events_per_minute=1500,
        minutes=minutes, ramp_to=1.5,
        flash_crowds=((t_end // 3, 10, 3.0), (2 * t_end // 3, 10, 4.0)),
        n_groups=4, burstiness=0.9, type_weights=(1, 1, 6, 1, 1, 1), seed=7))
    return wl, stream, t_end


def detection_recall(truth: dict, got: dict) -> tuple[float, int]:
    """Fraction of the truth's windows with a nonzero COUNT whose shed run
    still emits a nonzero COUNT, and the number of such windows."""
    num = den = 0
    for k, v in truth.items():
        if v.get("COUNT(*)", 0.0) <= 0:
            continue
        den += 1
        num += got.get(k, {}).get("COUNT(*)", 0.0) > 0
    return num / max(den, 1), den


def fragmented_stream(events_per_minute: int = 1500, minutes: int = 1):
    """The benchmark's worst-case stream for sizing the admission cap: the
    same rate with fully fragmented bursts (burstiness 0), seed 11 — the
    per-pane cost under shedding follows the burst count, not the event
    count."""
    return bursty_stream(StreamConfig(
        schema=RIDESHARING_SCHEMA, events_per_minute=events_per_minute,
        minutes=minutes, n_groups=4, burstiness=0.0,
        type_weights=(1, 1, 6, 1, 1, 1), seed=11))
