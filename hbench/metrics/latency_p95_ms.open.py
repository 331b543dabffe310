"""latency_p95_ms.open: the 95th percentile of latency_p50_ms's latencies,
over every window result the timed panes emitted.  A per-layer reading:
at four fifths of the knee the queue amplifies the host's speed swings,
so it spreads too widely between runs to hold a bound."""

import numpy as np


def read(rec):
    lat = rec.get("latency_ms")
    return float(np.percentile(lat, 95)) if lat else None
