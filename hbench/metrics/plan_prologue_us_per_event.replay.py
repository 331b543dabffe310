"""plan_prologue_us_per_event.replay: the plan prologue's clock
(``RunStats.plan_prologue_s``: the batched event filter, run-length
segmentation and stacked predicate pass) over the window, in
microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "plan_prologue_s")
