"""The workload and disordered stream of the disorder figure, as the JAX
package's ``benchmarks/fig_disorder.py`` builds them (full mode): paper
workload 1 with 6 queries ``SEQ(head, Kleene+)`` within 60 and slide 15
over a named stream, 6 minutes at 600 events/min, disordered by the
``bounded_skew`` model (max skew 12, seed 5) and fed in wire chunks of 32.

    from repro_torch.launch.fig_disorder import disorder_case
    wl, base, ds, t_end = disorder_case(fraction=0.2)
    cfg = event_time_config(ds, speculative=True)

``event_time_config`` gives the figure's two modes: ``speculate`` (a tight
bounded-skew watermark, emit on the frontier, amend on late data) and
``buffer`` (a watermark as wide as the stream's measured lateness, emit
once).
"""

from __future__ import annotations

from ..eventtime import EventTimeConfig
from ..streams.generator import NAMED_STREAMS, DisorderConfig, apply_disorder
from .fig9 import kleene_workload

__all__ = ["WORKLOAD_SHAPE", "CHUNK", "disorder_case", "event_time_config"]

WORKLOAD_SHAPE = {
    "ridesharing": dict(kleene_type="Travel",
                        head_types=["Request", "Pickup", "Dropoff"]),
    "stock": dict(kleene_type="Quote", head_types=["Buy", "Sell"]),
    "smarthome": dict(kleene_type="Measure", head_types=["Load", "Work"]),
    "taxi": dict(kleene_type="Travel", head_types=["Request", "Pickup"]),
}
CHUNK = 32


def disorder_case(dataset: str = "ridesharing", fraction: float = 0.2,
                  model: str = "bounded_skew", minutes: int = 6,
                  events_per_minute: int = 600, n_queries: int = 6):
    """``(workload, base stream, disordered stream, t_end)`` of one row
    (the benchmark's quick mode is 2 minutes at 300 events/min with 3
    queries)."""
    schema = NAMED_STREAMS[dataset](minutes=1).schema
    wl = kleene_workload(schema, n_queries, within=60, slide=15,
                         **WORKLOAD_SHAPE[dataset])
    base = NAMED_STREAMS[dataset](minutes=minutes,
                                  events_per_minute=events_per_minute)
    ds = apply_disorder(base, DisorderConfig(model=model, fraction=fraction,
                                             max_skew=12, seed=5))
    return wl, base, ds, minutes * 60


def event_time_config(ds, speculative: bool) -> EventTimeConfig:
    """The figure's event-time configuration of one mode."""
    skew = 2 if speculative else max(ds.max_lateness(), 1)
    return EventTimeConfig(watermark="bounded_skew", skew=skew,
                           speculative=speculative, lateness_horizon=None)
