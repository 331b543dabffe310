"""Event-time subsystem: out-of-order streams, watermarks, pane revision.

The paper (and the pane dataplane under ``repro_torch.core``) assumes arrival
order equals event time.  This layer sits between ingestion and the HAMLET
runtime and relaxes that:

* :mod:`watermark` — pluggable, provably monotone watermark policies
  (bounded skew, percentile-adaptive, per-group heartbeat);
* :mod:`reorder` — a reorder buffer that releases contiguous, time-sorted
  panes once the watermark seals them;
* :mod:`revision` — speculative pane execution with snapshot-based
  revision: panes run optimistically on arrival, late events re-plan only
  their pane and re-fold affected windows from stored transfer matrices,
  emitting retract/amend records;
* :mod:`frontier` — per-shard frontier export for the sharded service tier
  (:mod:`repro_torch.shardsvc`): a router-fed watermark policy plus the
  frontier snapshot shards report to the cross-shard alignment coordinator;
* hopelessly late events (behind the lateness horizon) are routed into the
  overload subsystem's error accountant, keeping the shedding bounds sound
  under disorder.

Everything here is host numpy; the panes it executes and the windows it
re-folds run on the runtime's backend (``"cuda"`` by default).
"""

from .config import EventTimeConfig  # noqa: F401
from .frontier import FrontierSnapshot, RoutedFrontier  # noqa: F401
from .reorder import ReorderBuffer, ReorderResult, SealedPane  # noqa: F401
from .revision import (EmissionRecord, EventTimeMetrics,  # noqa: F401
                       EventTimeRuntime)
from .watermark import (BoundedSkew, GroupHeartbeat,  # noqa: F401
                        PercentileAdaptive, WatermarkPolicy, make_watermark)
