"""large_count_pct.replay: the share of the window's emitted window results
that hold a finite value of 2^512 or more (``RunStats.large_count_windows
/ windows_emitted``), where the numpy and PyTorch backends' doubling may
leave float64.  None where the window emitted no result or the program
does not count them."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("large_count_windows"), s.get("windows_emitted")
    return 100.0 * v / n if v is not None and n else None
