"""plan_edge_us_per_event.replay: the per-burst walk's edge masks and
their packed signature bits (``RunStats.plan_edge_s``, the ``plan.edge``
steps) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "plan_edge_s")
