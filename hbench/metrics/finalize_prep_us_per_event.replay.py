"""finalize_prep_us_per_event.replay: finalize's preparation clock
(``RunStats.finalize_prep_s``: grouping by context, the flush-plan LRU,
building ``S``) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "finalize_prep_s")
