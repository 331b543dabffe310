"""neg_round_pct.replay: the share of the panes' fold rounds in the flush
plans that carry a negation gate (``RunStats.neg_rounds / fold_rounds``)
over the window.  None where no round was folded or the program does not
count them."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("neg_rounds"), s.get("fold_rounds")
    return 100.0 * v / n if v is not None and n else None
