"""What the step readers share: a ``RunStats`` step clock (or count) of
the window per event, and the collector's share of the window.  Each
returns None when the window saw no event or the program under test has
no such field (it predates the step clocks)."""


def per_event(rec: dict, field: str, scale: float = 1.0):
    """``rec["stats"][field]`` per event of the window, times ``scale``."""
    n, v = rec["events"], rec["stats"].get(field)
    return v / n * scale if n and v is not None else None


def us_per_event(rec: dict, field: str):
    """A step clock (seconds) in microseconds per event of the window."""
    return per_event(rec, field, 1e6)


def gc_pause_pct(rec: dict):
    """The collector's pauses (``RunStats.gc_s``) as a share of the
    window; it pauses the whole process."""
    v = rec["stats"].get("gc_s")
    if not rec["events"] or v is None or not rec["window_s"]:
        return None
    return 100.0 * v / rec["window_s"]
