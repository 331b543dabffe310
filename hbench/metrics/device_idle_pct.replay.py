"""device_idle_pct.replay: the share of the traced window in which no kernel,
copy or set ran on the card (profiler records, overlaps counted once)."""

from hbench.devtrace import idle_pct as read  # noqa: F401
