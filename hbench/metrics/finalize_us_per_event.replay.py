"""finalize_us_per_event.replay: the engine's own finalize timer
(``RunStats.finalize_s``) over the window, in microseconds per event."""


def read(rec):
    n = rec["events"]
    return rec["stats"]["finalize_s"] / n * 1e6 if n else None
