"""execute_launch_us_per_event.replay: execute's launch clock
(``RunStats.execute_launch_s``: the ``ops.propagate*`` calls, their
host-to-device copies included) over the window, in microseconds per
event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "execute_launch_s")
