"""The workload and stream of the paper's Fig. 9/10 comparison (HAMLET
against GRETA, SHARON and MCEP while the event rate varies), as the JAX
package's ``benchmarks/fig9_vs_sota.py`` and ``benchmarks/common.py`` build
them: paper workload 1 (queries ``SEQ(head, Travel+)`` sharing the Kleene
sub-pattern, within 60 and slide 30, a ``speed`` predicate on every third
query) over the ridesharing stream with 4 groups and burstiness 0.95.

    from repro_torch.launch.fig9 import fig9_case
    wl, stream, t_end = fig9_case(events_per_minute=20000)

The paper runs 10,000-20,000 events per minute with 5-25 queries.
"""

from __future__ import annotations

from ..core.pattern import EventType, Kleene, Seq
from ..core.query import Pred, Query, Workload, count_star
from ..streams.generator import RIDESHARING_SCHEMA, ridesharing_stream

__all__ = ["HEADS", "kleene_workload", "fig9_case"]

HEADS = ["Request", "Accept", "Pickup", "Dropoff", "Cancel"]


def kleene_workload(schema, n_queries: int, *, kleene_type: str,
                    head_types: list[str], within: int = 60, slide: int = 30,
                    pred_attr: str | None = None) -> Workload:
    """Paper workload 1 shape: shared Kleene sub-pattern, same windows; the
    queries differ in their head type and (optionally) predicates."""
    T = EventType(kleene_type)
    qs = []
    for i in range(n_queries):
        head = EventType(head_types[i % len(head_types)])
        preds = None
        if pred_attr and i % 3 == 2:
            preds = {kleene_type: [Pred(pred_attr, "<", 4.0 + (i % 5))]}
        qs.append(Query(f"q{i}", Seq(head, Kleene(T)), aggs=(count_star(),),
                        preds=preds, within=within, slide=slide))
    return Workload(schema, qs)


def fig9_case(events_per_minute: int = 120, minutes: int = 2,
              n_queries: int = 5, seed: int = 0):
    """``(workload, stream, t_end)`` of one Fig. 9 point."""
    wl = kleene_workload(RIDESHARING_SCHEMA, n_queries, kleene_type="Travel",
                         head_types=HEADS, within=60, slide=30,
                         pred_attr="speed")
    stream = ridesharing_stream(events_per_minute=events_per_minute,
                                minutes=minutes, n_groups=4, seed=seed,
                                burstiness=0.95)
    return wl, stream, minutes * 60
