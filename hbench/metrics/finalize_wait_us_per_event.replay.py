"""finalize_wait_us_per_event.replay: finalize's wait clock
(``RunStats.finalize_wait_s``: its ``device_get_all`` fetch and the
scatter back to jobs) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "finalize_wait_s")
