"""PID-style latency controller: observed pane latency -> shed ratio.

Position-form PI(D) on the relative latency error ``(latency - slo) / slo``.
The proportional term reacts to bursts within a pane or two; the integral
trims the steady-state shed ratio to exactly match sustained overload
(converging to ``1 - capacity/offered``, where the P-only ratio would leave a
standing error).  The plant gain scales with the overload factor — processing
time moves by ``offered/capacity · slo`` per unit of shed ratio — so the
default gains keep the discrete loop stable up to ~10x overload; a hotter
loop limit-cycles between shedding nothing and shedding everything.
Anti-windup: the integrator is clamped to the actuator range and frozen while
the output is saturated in the direction of the error.

Disorder-aware admission control: out-of-order streams add a cost axis pane
latency alone cannot see — every straggler behind the emitted frontier
re-plans its pane and re-folds the covering windows, and under a revision
storm that replay work crowds out fresh panes *before* per-pane latency
degrades (revisions run outside the admission path).  ``kr`` folds the
observed revision load (revisions per emitted window, supplied by the caller
that owns the event-time layer) into the same error signal, so the shed
ratio rises with disorder pressure as well as latency pressure and the
integrator trims against their sum.
"""

from __future__ import annotations

__all__ = ["LatencyController"]


def _clip(x: float, lo: float, hi: float) -> float:
    return lo if x < lo else hi if x > hi else x


class LatencyController:
    def __init__(self, slo_ms: float, kp: float = 0.1, ki: float = 0.05,
                 kd: float = 0.0, kr: float = 0.0, max_shed: float = 0.98,
                 fixed: float | None = None):
        if slo_ms <= 0:
            raise ValueError("slo_ms must be positive")
        self.slo_ms = float(slo_ms)
        self.kp, self.ki, self.kd = kp, ki, kd
        self.kr = float(kr)
        self.max_shed = float(max_shed)
        self.fixed = fixed
        self.shed_ratio = fixed if fixed is not None else 0.0
        self._i = 0.0
        self._prev_e: float | None = None
        self.updates = 0

    @classmethod
    def from_config(cls, cfg) -> "LatencyController":
        return cls(cfg.slo_ms, kp=cfg.kp, ki=cfg.ki, kd=cfg.kd,
                   kr=getattr(cfg, "kr", 0.0), max_shed=cfg.max_shed,
                   fixed=cfg.fixed_shed)

    def state(self) -> dict:
        """Control-loop state export for a supervising controller.

        The sharded service's router reads this per shard to actuate
        admission *upstream* of the ingress queues: ``shed_ratio`` is the
        actuator value, ``integrator``/``last_error`` expose how much of it
        is steady-state trim vs transient, ``saturated`` flags a shard whose
        controller is pinned at ``max_shed`` (shedding alone can no longer
        meet the SLO there — a rebalance candidate)."""
        return {
            "shed_ratio": self.shed_ratio,
            "integrator": self._i,
            "last_error": self._prev_e,
            "updates": self.updates,
            "slo_ms": self.slo_ms,
            "fixed": self.fixed,
            "saturated": self.fixed is None
            and self.shed_ratio >= self.max_shed,
        }

    def update(self, latency_ms: float,
               revision_load: float = 0.0) -> float:
        """Feed one latency observation (plus the optional revision-load
        observation, revisions per emitted window since the last update);
        returns the new shed ratio."""
        self.updates += 1
        if self.fixed is not None:
            return self.shed_ratio
        e = ((latency_ms - self.slo_ms) / self.slo_ms
             + self.kr * max(0.0, revision_load))
        d = 0.0 if self._prev_e is None else e - self._prev_e
        self._prev_e = e
        raw = self.kp * e + self._i + self.ki * e + self.kd * d
        saturated_up = raw >= self.max_shed and e > 0
        saturated_dn = raw <= 0.0 and e < 0
        if not (saturated_up or saturated_dn):
            self._i = _clip(self._i + self.ki * e, 0.0, self.max_shed)
        self.shed_ratio = _clip(self.kp * e + self._i + self.kd * d,
                                0.0, self.max_shed)
        return self.shed_ratio
