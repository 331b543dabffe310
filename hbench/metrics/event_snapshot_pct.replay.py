"""event_snapshot_pct.replay: the share of the rows of shared Kleene
graphlets that carry an event-level snapshot (``RunStats.snapshot_rows /
shared_rows``) over the window.  None where nothing was shared or the
program does not count the rows."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("snapshot_rows"), s.get("shared_rows")
    return 100.0 * v / n if v is not None and n else None
