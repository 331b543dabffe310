"""pane_proc_ms_p95.open: the 95th percentile of the runtime's own
per-pane processing time (``PaneMetric.proc_ms``: host clock around the
flush, ending on its fetch) over the timed panes."""

import numpy as np


def read(rec):
    v = rec.get("pane_proc_ms")
    return float(np.percentile(v, 95)) if v else None
