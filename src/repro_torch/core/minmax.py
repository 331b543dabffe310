"""MIN/MAX side path for the windowed runtime.

MIN/MAX are idempotent, not linear, so they do not ride the snapshot algebra.
Per Def. 5 they are only shareable between identical aggregates anyway; the
runtime retains the window's events for queries that request them and runs a
GRETA-style idempotent propagation at window close (see baselines/greta.py).
The trend counts that propagation reads come from the runtime's backend: on
``"cuda"`` the masked propagation kernel, on ``"torch"`` its plain version,
on ``"np"`` the numpy oracle; the min/max row loop itself runs on the host.
"""

from __future__ import annotations

from .events import EventBatch, StreamSchema
from .query import Agg, AtomicQuery

__all__ = ["window_minmax"]


def window_minmax(schema: StreamSchema, q: AtomicQuery, ev: EventBatch | None,
                  agg: Agg, run_type_ids: list[int] | None = None,
                  pane: int | None = None, backend: str = "cuda",
                  device=None) -> float:
    if ev is None or len(ev) == 0:
        return float("nan")
    from .baselines.greta import window_eval_greta

    sub_q_aggs = window_eval_greta(schema, q, ev, run_type_ids,
                                   backend=backend, pane=pane, device=device)
    return sub_q_aggs[repr(agg)]
