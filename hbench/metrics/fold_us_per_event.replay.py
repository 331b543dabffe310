"""fold_us_per_event.replay: the engine's own fold timer
(``RunStats.fold_s``) over the window, in microseconds per event."""


def read(rec):
    n = rec["events"]
    return rec["stats"]["fold_s"] / n * 1e6 if n else None
