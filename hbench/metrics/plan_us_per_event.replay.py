"""plan_us_per_event.replay: the engine's own plan timer
(``RunStats.plan_s``) over the window, in microseconds per event."""


def read(rec):
    n = rec["events"]
    return rec["stats"]["plan_s"] / n * 1e6 if n else None
