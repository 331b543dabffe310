"""Unified observability: span tracer, metrics registry, sharing audit log.

The engine threads one :class:`Observability` facade (``obs=None`` by
default — zero cost when absent) through the pane pipeline:

* :mod:`repro_torch.obs.trace` — Chrome-trace/Perfetto span tracer with
  per-pane tracks, a bounded ring buffer, and a sampling knob.
* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms behind a name-keyed registry with merge-stable bucket layouts.
* :mod:`repro_torch.obs.audit` — the sharing-decision audit log recording
  every optimizer share/no-share decision and plan-key flip.

Everything here is host Python; nothing touches the device.
"""

from .audit import SharingAuditLog, SharingDecision
from .facade import PHASES, Observability
from .metrics import (DEPTH_BUCKETS, LAG_BUCKETS, LATENCY_MS_BUCKETS,
                      OCCUPANCY_BUCKETS, SERVE_LATENCY_MS_BUCKETS, Counter,
                      Gauge, Histogram, MetricsRegistry)
from .trace import NULL_SPAN, Tracer, jsonl_to_chrome

__all__ = [
    "Observability", "PHASES", "Tracer", "NULL_SPAN", "jsonl_to_chrome",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_MS_BUCKETS", "SERVE_LATENCY_MS_BUCKETS", "OCCUPANCY_BUCKETS",
    "LAG_BUCKETS", "DEPTH_BUCKETS", "SharingAuditLog", "SharingDecision",
]
