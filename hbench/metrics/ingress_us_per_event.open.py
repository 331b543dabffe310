"""ingress_us_per_event.open: the streaming layer's ingress clock
(``RunStats.ingress_s``: host time in ``OverloadRuntime.offer``) over
the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "ingress_s")
