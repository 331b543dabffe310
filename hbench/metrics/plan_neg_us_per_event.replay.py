"""plan_neg_us_per_event.replay: the per-burst walk's negation hits and the
``_NegStep`` steps built from them (``RunStats.plan_neg_s``, the
``plan.neg`` steps) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "plan_neg_s")
