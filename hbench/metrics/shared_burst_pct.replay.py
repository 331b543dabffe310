"""shared_burst_pct.replay: the share of bursts the sharing policy
shared (``RunStats.shared_bursts / bursts``) over the window."""


def read(rec):
    s = rec["stats"]
    return 100.0 * s["shared_bursts"] / s["bursts"] if s["bursts"] else None
