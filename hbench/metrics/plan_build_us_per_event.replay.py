"""plan_build_us_per_event.replay: the step-construction clock
(``RunStats.plan_build_s``: rehydrating a cached plan on a hit, building
and caching one on a miss) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "plan_build_s")
