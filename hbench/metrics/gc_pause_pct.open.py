"""gc_pause_pct.open: gc_pause_pct.replay's reading, in the open cell."""

from hbench.steps import gc_pause_pct as read  # noqa: F401
