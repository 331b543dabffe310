"""stacked_graphlet_pct.replay: the share of the window's graphlets that
the plan layer's stacked pass planned (``RunStats.stacked_graphlets /
graphlets``): single-query groups, built a burst at a time.  None where
the window planned no graphlet or the program does not count them."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("stacked_graphlets"), s.get("graphlets")
    return 100.0 * v / n if v is not None and n else None
