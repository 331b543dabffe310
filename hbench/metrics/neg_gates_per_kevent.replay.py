"""neg_gates_per_kevent.replay: the negation gates finalize applied to the
queries' state rows (``RunStats.neg_gates``, one per pane and hit) over
the window, per 1,000 events."""

from hbench.steps import per_event


def read(rec):
    return per_event(rec, "neg_gates", 1e3)
