"""plan_decide_us_per_event.replay: the share/not-share decisions' clock
(``RunStats.plan_decide_s``: the dyn-fast fingerprint pass, or the
walk's divergence rows and ``policy.decide``) over the window, in
microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "plan_decide_s")
