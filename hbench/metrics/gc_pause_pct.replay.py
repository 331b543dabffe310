"""gc_pause_pct.replay: the collector's pauses of the process
(``RunStats.gc_s``, counted through ``gc.callbacks`` while the program's
``Observability`` is attached) as a share of the window."""

from hbench.steps import gc_pause_pct as read  # noqa: F401
