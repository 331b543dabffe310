"""scan_flush_pct.replay: the share of finalize's (context, flush) plans
that ran the scan program, one device program for the whole flush
(``RunStats.scan_flushes / fold_flushes``), over the window.  None where no
flush was folded or the program does not count them."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("scan_flushes"), s.get("fold_flushes")
    return 100.0 * v / n if v is not None and n else None
