"""admit_us_per_event.open: the streaming layer's admission clock
(``RunStats.admit_s``: ``step_pane``'s poll, late split and shedding,
and the partition by group ahead of the micro-batcher) over the window,
in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "admit_s")
