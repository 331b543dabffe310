"""h2d_bytes_per_event.replay: the bytes execute hands the card
(``RunStats.execute_h2d_bytes``: each bucket's stacked bases, and masks
in the bases' dtype) over the window, per event."""

from hbench.steps import per_event


def read(rec):
    return per_event(rec, "execute_h2d_bytes")
