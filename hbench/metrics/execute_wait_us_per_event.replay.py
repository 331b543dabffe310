"""execute_wait_us_per_event.replay: execute's wait clock
(``RunStats.execute_wait_s``: the one ``device_get_all`` fetch and the
unpacking into jobs) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "execute_wait_s")
