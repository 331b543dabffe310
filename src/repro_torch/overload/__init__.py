"""Overload runtime: pane-granular load shedding, backpressure, and
latency-bound admission control around the HAMLET dataplane.

The paper assumes every arriving event is processed; under sustained offered
load beyond hardware capacity that just grows latency without bound.  This
subsystem adds the graceful-degradation story: a bounded ingress queue with
watermark backpressure, pluggable shedding policies (including a
pattern-aware, benefit-weighted one), a PID controller that holds a latency
SLO, and an error accountant that certifies what the shedded results still
guarantee.
"""

from .accountant import ErrorAccountant, QueryErrorReport, WindowBound  # noqa: F401
from .config import OverloadConfig  # noqa: F401
from .controller import LatencyController  # noqa: F401
from .ingress import IngressQueue  # noqa: F401
from .runtime import OverloadMetrics, OverloadRuntime, PaneMetric  # noqa: F401
from .shedding import (BenefitWeighted, DropTail, RandomShed, ShedPlan,  # noqa: F401
                       TypeProfile, make_shedder)
