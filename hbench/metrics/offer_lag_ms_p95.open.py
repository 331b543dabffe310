"""offer_lag_ms_p95.open: the 95th percentile, over the timed panes, of
how late the load generator offered each pane's last tick (it offers
between steps, so a long step delays the next offers)."""

import numpy as np


def read(rec):
    v = rec.get("offer_lag_ms")
    return float(np.percentile(v, 95)) if v else None
