"""latency_p50_ms: median, over every window result the timed panes
emitted, of the time from the due time of its district's last event in the
window to the return of the step that emitted it."""

import numpy as np


def read(rec):
    lat = rec.get("latency_ms")
    return float(np.percentile(lat, 50)) if lat else None
