"""long_burst_pct.replay: the share of the window's Kleene burst rows that
lie in bursts of 128 rows or more (``RunStats.long_kleene_rows /
kleene_rows``, each burst counted once, not once a query).  None where
the window planned no Kleene burst or the program does not count them."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("long_kleene_rows"), s.get("kleene_rows")
    return 100.0 * v / n if v is not None and n else None
