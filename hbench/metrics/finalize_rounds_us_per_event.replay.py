"""finalize_rounds_us_per_event.replay: finalize's rounds clock
(``RunStats.finalize_rounds_s``: the ``fold_rounds_scan`` launch, or the
host round loop) over the window, in microseconds per event."""

from hbench.steps import us_per_event


def read(rec):
    return us_per_event(rec, "finalize_rounds_s")
