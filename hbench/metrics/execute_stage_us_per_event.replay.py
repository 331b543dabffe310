"""execute_stage_us_per_event.replay: execute's staging clock
(``RunStats.execute_stage_s``: the jobs' injection rows, bucketing and
host stacking) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "execute_stage_s")
