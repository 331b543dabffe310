"""decide_eval_pct.replay: the share of the window's sharing decisions
that the plan layer's policy evaluated fresh (``RunStats.decide_evals /
decisions``); the rest replayed from its memo or the pane memo.  None
where the window took no decision or the program does not count them."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("decide_evals"), s.get("decisions")
    return 100.0 * v / n if v is not None and n else None
