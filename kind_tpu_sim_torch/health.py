"""Gray-failure detection: phi-accrual suspicion with hysteresis.

The port's copy of ``kind_tpu_sim/health.py``'s detector, which the
engine fleet (``fleet/sim.py``) feeds with each replica's time per
output token on the virtual clock. A gray failure is a replica that
stays alive but slow; nothing crashes, so only its latency shows it.

A sample's suspicion is phi = -log10 P(X >= x) under a normal model of
the GLOBAL sample stream (EWMA mean and variance, sigma floored so that
a near-constant baseline cannot make jitter look catastrophic): a
straggler is slow relative to its peers, never to its own history.

States, with hysteresis so one noisy sample cannot flap a component::

    healthy --(phi >= suspect_phi)--> suspect
    suspect --(clean sample)-------> healthy           ("cleared")
    suspect --(streak >= quarantine_evals)--> quarantined
    any     --(phi >= quarantine_phi, or failed probe)--> quarantined
    quarantined --(probe ok x probe_ok_required)--> healthy ("restored")

Every transition is recorded in :attr:`FailureDetector.events` and
counted on ``metrics.health_board()``. The detector draws no entropy
and records the clock its caller passes, so the same sample stream
gives the same event log.

Every threshold is an environment knob (``KIND_TPU_SIM_HEALTH_*``,
``DetectorConfig.from_env``); a detector built with no config resolves
them. :func:`detection_demo` runs the analytic fleet with one slowed
replica and prints what the detector saw (``health demo``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from kind_tpu_sim_torch import metrics

# component states
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"

# phi is capped here: erfc underflows around z ~ 38
PHI_CAP = 300.0


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Every detection threshold. ``suspect_phi`` / ``quarantine_phi``
    are suspicion levels (phi = 2: this slow happens < 1% of the time);
    ``quarantine_evals`` consecutive suspicious samples escalate suspect
    to quarantined; ``probe_ok_required`` clean probes lift a
    quarantine; the sigma floor is ``max(sigma_floor_frac * mean,
    sigma_floor_abs)``. ``probe_timeout_s`` and ``spec_age_ratio``
    belong to the reference's worker-grid consumer and are kept so the
    config is the reference's."""

    ewma_alpha: float = 0.25
    suspect_phi: float = 2.0
    quarantine_phi: float = 8.0
    quarantine_evals: int = 3
    probe_ok_required: int = 2
    probe_interval_s: float = 0.25
    min_samples: int = 4
    sigma_floor_frac: float = 0.1
    sigma_floor_abs: float = 1e-4
    probe_timeout_s: float = 2.0
    spec_age_ratio: float = 3.0

    @classmethod
    def from_env(cls) -> "DetectorConfig":
        """Each field from its ``KIND_TPU_SIM_HEALTH_*`` knob, else the
        knob's default (which is the field's default)."""
        # imported here: the fleet package imports this module
        from kind_tpu_sim_torch.fleet import knobs

        return cls(
            ewma_alpha=knobs.get(knobs.HEALTH_ALPHA),
            suspect_phi=knobs.get(knobs.HEALTH_SUSPECT_PHI),
            quarantine_phi=knobs.get(knobs.HEALTH_QUARANTINE_PHI),
            quarantine_evals=knobs.get(knobs.HEALTH_QUARANTINE_EVALS),
            probe_ok_required=knobs.get(knobs.HEALTH_PROBE_OK),
            probe_interval_s=knobs.get(knobs.HEALTH_PROBE_INTERVAL_S),
            min_samples=knobs.get(knobs.HEALTH_MIN_SAMPLES),
            sigma_floor_frac=knobs.get(knobs.HEALTH_SIGMA_FRAC),
            sigma_floor_abs=knobs.get(knobs.HEALTH_SIGMA_ABS),
            probe_timeout_s=knobs.get(knobs.HEALTH_PROBE_TIMEOUT_S),
            spec_age_ratio=knobs.get(knobs.HEALTH_SPEC_RATIO),
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Ewma:
    """Streaming mean and variance, exponentially weighted."""

    __slots__ = ("alpha", "mean", "var", "count")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        if self.count == 0:
            self.mean = value
            self.var = 0.0
        else:
            d = value - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1


@dataclasses.dataclass
class _Component:
    state: str = HEALTHY
    streak: int = 0            # consecutive suspicious samples
    good_probes: int = 0
    ewma: Optional[_Ewma] = None
    # an integrity quarantine is sticky: a defective chip is fast but
    # wrong, so latency probes would pass; only restore() lifts it
    sticky: bool = False


class FailureDetector:
    """Per-component gray-failure detection over one sample stream.

    ``observe(component, sample_s, now)`` ingests one latency sample and
    returns the transition it caused, if any: ``"suspected" | "cleared"
    | "quarantined" | "probe_ok" | "restored" | None``. Samples from a
    quarantined component count as probes. ``now`` is only recorded."""

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        self.cfg = cfg or DetectorConfig.from_env()
        self._global = _Ewma(self.cfg.ewma_alpha)
        self._comps: Dict[str, _Component] = {}
        self.events: List[dict] = []

    # -- model --------------------------------------------------------

    def _sigma(self) -> float:
        return max(math.sqrt(max(self._global.var, 0.0)),
                   self.cfg.sigma_floor_frac * self._global.mean,
                   self.cfg.sigma_floor_abs)

    def phi(self, value: float) -> float:
        """Suspicion of ``value`` against the global baseline; 0.0 while
        the baseline has fewer than ``min_samples`` samples."""
        if self._global.count < self.cfg.min_samples:
            return 0.0
        z = (value - self._global.mean) / self._sigma()
        if z <= 0:
            return 0.0
        sf = 0.5 * math.erfc(z / math.sqrt(2.0))
        if sf <= 1e-300:
            return PHI_CAP
        return min(PHI_CAP, -math.log10(sf))

    def relative_latency(self, component: str) -> float:
        """The component's EWMA service time over the global baseline,
        clipped to [0.25, 8]: the latency-aware router's weight (1.0
        while either side lacks samples)."""
        comp = self._comps.get(component)
        if (comp is None or comp.ewma is None
                or comp.ewma.count < self.cfg.min_samples
                or self._global.count < self.cfg.min_samples
                or self._global.mean <= 0):
            return 1.0
        return min(8.0, max(0.25, comp.ewma.mean / self._global.mean))

    # -- introspection ------------------------------------------------

    def _comp(self, component: str) -> _Component:
        comp = self._comps.get(component)
        if comp is None:
            comp = _Component(ewma=_Ewma(self.cfg.ewma_alpha))
            self._comps[component] = comp
        return comp

    def state(self, component: str) -> str:
        comp = self._comps.get(component)
        return comp.state if comp is not None else HEALTHY

    def quarantined(self, component: str) -> bool:
        return self.state(component) == QUARANTINED

    # -- transitions --------------------------------------------------

    def _transition(self, component: str, transition: str, now: float,
                    **info) -> str:
        ev = {"at_s": round(now, 6), "component": component,
              "transition": transition}
        ev.update(info)
        self.events.append(ev)
        counter = {"suspected": "suspicions", "quarantined": "quarantines",
                   "restored": "restores", "probe_ok": "probes_ok"}.get(
                       transition)
        if counter is not None:
            metrics.health_board().incr(counter)
        return transition

    def _quarantine(self, component: str, now: float, phi: float,
                    cause: str) -> str:
        comp = self._comp(component)
        comp.state = QUARANTINED
        comp.streak = 0
        comp.good_probes = 0
        metrics.recovery_log().record(
            "health_quarantine", component=component, cause=cause)
        return self._transition(component, "quarantined", now,
                                phi=round(phi, 3), cause=cause)

    def observe(self, component: str, sample_s: float,
                now: float) -> Optional[str]:
        comp = self._comp(component)
        if comp.state == QUARANTINED:
            ok = self.phi(sample_s) < self.cfg.suspect_phi
            return self.record_probe(component, ok, now)
        phi = self.phi(sample_s)
        comp.ewma.update(sample_s)
        transition = None
        if phi >= self.cfg.quarantine_phi:
            transition = self._quarantine(component, now, phi,
                                          cause="phi_hard")
        elif phi >= self.cfg.suspect_phi:
            comp.streak += 1
            if comp.streak >= self.cfg.quarantine_evals:
                transition = self._quarantine(component, now, phi,
                                              cause="phi_streak")
            elif comp.state == HEALTHY:
                comp.state = SUSPECT
                transition = self._transition(
                    component, "suspected", now, phi=round(phi, 3))
        else:
            comp.streak = 0
            if comp.state == SUSPECT:
                comp.state = HEALTHY
                transition = self._transition(component, "cleared", now)
        # suspicious samples stay out of the baseline: a straggler must
        # not drag the fleet's notion of normal toward itself
        if phi < self.cfg.suspect_phi:
            self._global.update(sample_s)
        return transition

    def record_probe(self, component: str, ok: bool,
                     now: float) -> Optional[str]:
        """One probe outcome. A failed probe quarantines from any state;
        ``probe_ok_required`` clean probes in a row lift a quarantine."""
        comp = self._comp(component)
        metrics.health_board().incr("probes")
        if not ok:
            comp.good_probes = 0
            metrics.health_board().incr("probe_failures")
            if comp.state != QUARANTINED:
                return self._quarantine(component, now, PHI_CAP,
                                        cause="probe_failure")
            return None
        if comp.state != QUARANTINED:
            return None
        if comp.sticky:
            # clean latency probes are no evidence of integrity
            return self._transition(component, "probe_ok", now)
        comp.good_probes += 1
        if comp.good_probes >= self.cfg.probe_ok_required:
            return self.restore(component, now, reason="probes")
        return self._transition(component, "probe_ok", now)

    def record_integrity(self, component: str, now: float,
                         cause: str = "sdc") -> Optional[str]:
        """Hard integrity evidence (an audit majority named this
        component): an immediate, sticky quarantine."""
        comp = self._comp(component)
        comp.sticky = True
        metrics.health_board().incr("integrity_quarantines")
        if comp.state == QUARANTINED:
            return None
        return self._quarantine(component, now, PHI_CAP, cause=cause)

    def restore(self, component: str, now: float,
                reason: str = "probes") -> str:
        """Lift a quarantine. The component's history resets: the
        replacement is a new individual."""
        comp = self._comp(component)
        comp.state = HEALTHY
        comp.streak = 0
        comp.good_probes = 0
        comp.sticky = False
        comp.ewma = _Ewma(self.cfg.ewma_alpha)
        metrics.recovery_log().record(
            "health_restore", component=component, reason=reason)
        return self._transition(component, "restored", now, reason=reason)

    # -- reporting ----------------------------------------------------

    def report(self) -> dict:
        states = {c: comp.state for c, comp in sorted(self._comps.items())}
        counts: Dict[str, int] = {}
        for ev in self.events:
            counts[ev["transition"]] = counts.get(ev["transition"], 0) + 1
        out = {
            "config": self.cfg.as_dict(),
            "components": states,
            "transition_counts": dict(sorted(counts.items())),
            "events": self.events,
            "baseline_mean_s": (round(self._global.mean, 6)
                                if self._global.count else None),
            "samples": self._global.count,
        }
        sticky = sorted(c for c, comp in self._comps.items() if comp.sticky)
        if sticky:
            out["integrity_quarantined"] = sticky
        return out


def detection_demo(seed: int = 0, components: int = 4,
                   samples: int = 120) -> dict:
    """Seeded synthetic detection run (``health demo``): one component,
    drawn from the chaos fault plan, turns straggler for the middle
    third of the stream, then recovers; the detector must quarantine
    it, restore it through probes, and never touch the healthy
    components. A function of (seed, components, samples) and the
    ``KIND_TPU_SIM_HEALTH_*`` knobs."""
    import random
    import zlib

    from kind_tpu_sim_torch import chaos

    plan = chaos.ChaosSchedule(seed).plan(
        kinds=("straggler_worker",), n_faults=1, horizon=8,
        targets=max(1, components))
    ev = plan.events[0]
    straggler = f"comp-{ev.target % max(1, components)}"
    factor = max(3.0, ev.param)
    rng = random.Random(zlib.crc32(
        f"health-demo:{seed}:{components}:{samples}".encode("utf-8")))
    det = FailureDetector(DetectorConfig.from_env())
    base = 0.05
    lo, hi = samples // 3, 2 * samples // 3
    for i in range(samples):
        comp = f"comp-{i % max(1, components)}"
        value = base * rng.uniform(0.9, 1.1)
        if comp == straggler and lo <= i < hi:
            value *= factor
        now = round(i * 0.1, 6)
        if det.quarantined(comp):
            det.record_probe(comp, ok=value < 2.0 * base, now=now)
        else:
            det.observe(comp, value, now)
    report = det.report()
    report.update({
        "seed": seed,
        "plan": plan.as_dict(),
        "straggler": straggler,
        "factor": round(factor, 3),
        "ok": bool(
            det.state(straggler) == HEALTHY
            and any(e["transition"] == "quarantined"
                    and e["component"] == straggler
                    for e in det.events)
            and not any(e["transition"] == "quarantined"
                        and e["component"] != straggler
                        for e in det.events)),
    })
    return report
