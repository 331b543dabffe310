"""device_idle_pct.open: device_idle_pct.replay's reading, in the open cell."""

from hbench.devtrace import idle_pct as read  # noqa: F401
