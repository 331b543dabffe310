"""div_collapsed_pct.replay: the share of the divergent (d > 0) graphlets
finalize folded through a state-free ``S`` block built with the flush plan
(``RunStats.div_collapsed / div_graphlets``), over the window.  None where
no divergent graphlet was folded or the program does not count them."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("div_collapsed"), s.get("div_graphlets")
    return 100.0 * v / n if v is not None and n else None
