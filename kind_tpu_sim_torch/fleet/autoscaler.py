"""Queue-depth / SLO-driven replica autoscaling on the virtual clock.

The port's copy of ``kind_tpu_sim/fleet/autoscaler.py``: scale up when
the backlog a routable replica stays above ``up_backlog`` (or recent
attainment falls below ``min_attainment``), scale down when it stays
below ``down_backlog``; a breach must hold for ``breach_evals``
consecutive evaluations, and no action follows another within
``cooldown_s``. A new replica becomes routable ``warmup_s`` after the
decision (default 0.55 s, or KIND_TPU_SIM_FLEET_WARMUP_S); a scale-down
drains its victim before removing it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.analysis import knobs

WARMUP_S = 0.55  # the reference's default replica warm-up, virtual s


def resolve_warmup_s(value: Optional[float] = None) -> float:
    """``value``, else KIND_TPU_SIM_FLEET_WARMUP_S, else
    :data:`WARMUP_S`."""
    if value is not None:
        return float(value)
    return float(knobs.get(knobs.FLEET_WARMUP_S))


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    up_backlog: float = 8.0
    down_backlog: float = 1.0
    min_attainment: Optional[float] = 0.9
    breach_evals: int = 3
    cooldown_s: float = 1.0
    warmup_s: Optional[float] = None  # None -> resolve_warmup_s()


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    at_s: float
    action: str        # scale_up | scale_down | replica_ready
    replicas: int      # routable replicas after the action
    reason: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Autoscaler:
    """Pure decision logic: the fleet loop feeds it one observation
    an evaluation and enacts what it returns."""

    def __init__(self, cfg: AutoscalerConfig = AutoscalerConfig()):
        self.cfg = cfg
        self.warmup_s = resolve_warmup_s(cfg.warmup_s)
        self.events: List[ScaleEvent] = []
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_s = -1e18
        self._warming = 0  # replicas paid for but not yet routable

    def note_ready(self, at_s: float, replicas: int,
                   reason: str = "warmup complete") -> None:
        self._warming = max(0, self._warming - 1)
        self.events.append(ScaleEvent(
            at_s=round(at_s, 6), action="replica_ready",
            replicas=replicas, reason=reason))
        metrics.fleet_board().incr("replicas_ready")

    def evaluate(self, now: float, *, routable: int, backlog: float,
                 attainment: Optional[float]) -> Optional[str]:
        """One control-loop step: 'scale_up', 'scale_down' or None."""
        cfg = self.cfg
        per = backlog / max(1, routable + self._warming)
        slo_breach = (cfg.min_attainment is not None
                      and attainment is not None
                      and attainment < cfg.min_attainment)
        if per > cfg.up_backlog or slo_breach:
            self._up_streak += 1
            self._down_streak = 0
        elif per < cfg.down_backlog and not slo_breach:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        if now - self._last_action_s < cfg.cooldown_s:
            return None
        total = routable + self._warming
        if (self._up_streak >= cfg.breach_evals
                and total < cfg.max_replicas):
            self._up_streak = 0
            self._last_action_s = now
            self._warming += 1
            reason = "slo_attainment" if slo_breach else "queue_backlog"
            self.events.append(ScaleEvent(
                at_s=round(now, 6), action="scale_up",
                replicas=total + 1, reason=reason))
            metrics.fleet_board().incr("scale_up")
            return "scale_up"
        if (self._down_streak >= cfg.breach_evals
                and total > cfg.min_replicas and routable > 1):
            self._down_streak = 0
            self._last_action_s = now
            self.events.append(ScaleEvent(
                at_s=round(now, 6), action="scale_down",
                replicas=total - 1, reason="idle_capacity"))
            metrics.fleet_board().incr("scale_down")
            return "scale_down"
        return None

    def report(self) -> Dict[str, object]:
        ups = sum(1 for e in self.events if e.action == "scale_up")
        downs = sum(1 for e in self.events if e.action == "scale_down")
        return {
            "warmup_s": self.warmup_s,
            "scale_ups": ups,
            "scale_downs": downs,
            "events": [e.as_dict() for e in self.events],
        }
