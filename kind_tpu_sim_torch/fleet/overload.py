"""Overload containment: the controls that keep saturation transient.

The port's copy of ``kind_tpu_sim/fleet/overload.py``. Past saturation,
clients retry and hedges double-send, and the amplified load can keep a
fleet saturated after the trigger clears. Four controls, each a
deterministic primitive the fleet router and loop thread through:

* :class:`TokenBucket`: client retry budgets (and hedge budgets).
  Retries spend tokens that first-attempt admissions earn, so a
  saturated fleet sees retry load shrink; ``retries_suppressed`` counts
  the refusals.
* The hedge delay: a hedge fires only once the primary has been in
  flight longer than a p9x of observed service times
  (:class:`LatencyQuantile`); the first completion wins and the loser
  is cancelled.
* :class:`CircuitBreaker`: per-replica breakers. A rolling-window
  failure ratio opens the breaker, a half-open trickle of probes tests
  recovery, success closes it.
* :class:`BrownoutController`: under sustained SLO breach the fleet
  degrades by steps (cap ``max_new``, no hedging, shed the low tier)
  and recovers one level at a time.

Everything is a function of (config, completion stream, the clock the
caller passes): no entropy, no wall time. An unset field resolves from
its environment knob (``KIND_TPU_SIM_OVERLOAD_*``, ``analysis/knobs.py``),
else the knob's default.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Dict, List, Optional

from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.fleet.loadgen import (
    TraceRequest,
    WorkloadSpec,
    generate_trace,
)
from kind_tpu_sim_torch.fleet.slo import FixedBucketHistogram

RETRY_BUDGET_ENV = knobs.OVERLOAD_RETRY_BUDGET
HEDGE_QUANTILE_ENV = knobs.OVERLOAD_HEDGE_QUANTILE
BREAKER_WINDOW_ENV = knobs.OVERLOAD_BREAKER_WINDOW
BROWNOUT_ENV = knobs.OVERLOAD_BROWNOUT


def resolve_retry_budget(value: Optional[float] = None) -> float:
    """Explicit value > env (KIND_TPU_SIM_OVERLOAD_RETRY_BUDGET) >
    0.1."""
    if value is not None:
        return float(value)
    return float(knobs.get(RETRY_BUDGET_ENV))


def resolve_hedge_quantile(value: Optional[float] = None) -> float:
    """Explicit value > env (KIND_TPU_SIM_OVERLOAD_HEDGE_QUANTILE) >
    0.95."""
    if value is not None:
        return float(value)
    return float(knobs.get(HEDGE_QUANTILE_ENV))


def resolve_breaker_window(value: Optional[int] = None) -> int:
    """Explicit value > env (KIND_TPU_SIM_OVERLOAD_BREAKER_WINDOW) >
    16."""
    if value is not None:
        return int(value)
    return int(knobs.get(BREAKER_WINDOW_ENV))


def resolve_brownout(value: Optional[bool] = None) -> bool:
    """Explicit value > env (KIND_TPU_SIM_OVERLOAD_BROWNOUT) > on."""
    if value is not None:
        return bool(value)
    return bool(knobs.get(BROWNOUT_ENV))


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """One fleet's overload-containment policy, every field in the
    reference's order with its default."""

    # client retries: attempts include the original, backoff doubles
    # per attempt (deterministic, no jitter)
    max_attempts: int = 3
    retry_backoff_s: float = 0.05
    # budget tokens earned per admitted first attempt (the bucket starts
    # full at `burst`); <= 0 disables the budget
    retry_budget_ratio: Optional[float] = None
    retry_budget_burst: float = 10.0
    # hedging: a copy to the next candidate once the primary is past the
    # hedge delay, bounded by its own token budget
    hedge: bool = True
    hedge_quantile: Optional[float] = None
    hedge_min_delay_s: float = 0.02
    hedge_warm_count: int = 16
    hedge_budget_ratio: float = 0.05
    hedge_budget_burst: float = 4.0
    # circuit breakers: rolling-window outcome ratio per replica
    breaker: bool = True
    breaker_window: Optional[int] = None
    breaker_failure_ratio: float = 0.5
    breaker_min_samples: int = 8
    breaker_open_s: float = 0.25
    breaker_probe_n: int = 2
    # brownout ladder: level 1 caps max_new and stops hedging, level 2
    # also sheds the low tier at admission
    brownout: Optional[bool] = None
    brownout_window: int = 48
    brownout_attainment: float = 0.5
    brownout_evals: int = 3
    brownout_recover_evals: int = 6
    brownout_max_new_cap: int = 4
    # share of requests in the low tier (hashed from the request id)
    low_tier_frac: float = 0.25

    @classmethod
    def uncontrolled(cls, max_attempts: int = 4,
                     retry_backoff_s: float = 0.05) -> "OverloadConfig":
        """The controls-off client: retries without a budget, no
        hedging, no breakers, no brownout."""
        return cls(max_attempts=max_attempts,
                   retry_backoff_s=retry_backoff_s,
                   retry_budget_ratio=0.0, hedge=False,
                   breaker=False, brownout=False)

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out.update(
            retry_budget_ratio=resolve_retry_budget(self.retry_budget_ratio),
            hedge_quantile=resolve_hedge_quantile(self.hedge_quantile),
            breaker_window=resolve_breaker_window(self.breaker_window),
            brownout=resolve_brownout(self.brownout))
        return out


def request_tier(request_id: str, low_frac: float) -> int:
    """1 (the sheddable low tier) for a stable ``low_frac`` share of
    ids, else 0; hashed on the base id, so a retry keeps its tier."""
    if low_frac <= 0:
        return 0
    base = request_id.split("~r", 1)[0]
    h = zlib.crc32(f"tier:{base}".encode("utf-8")) % 1000
    return 1 if h < int(low_frac * 1000) else 0


class TokenBucket:
    """``earn()`` adds ``ratio`` tokens an event (capped at ``burst``),
    ``spend()`` takes one whole token or refuses. The bucket starts
    full; a ``ratio`` of 0 disables it (every spend succeeds)."""

    __slots__ = ("ratio", "burst", "tokens", "earned", "spent",
                 "suppressed")

    def __init__(self, ratio: float, burst: float):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.earned = 0
        self.spent = 0
        self.suppressed = 0

    @property
    def disabled(self) -> bool:
        return self.ratio <= 0.0

    def earn(self, n: int = 1) -> None:
        if self.disabled:
            return
        self.earned += n
        self.tokens = min(self.burst, self.tokens + self.ratio * n)

    def spend(self) -> bool:
        if self.disabled:
            self.spent += 1
            return True
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            self.spent += 1
            return True
        self.suppressed += 1
        return False

    def report(self) -> Dict[str, object]:
        return {
            "ratio": self.ratio,
            "tokens": round(self.tokens, 6),
            "earned": self.earned,
            "spent": self.spent,
            "suppressed": self.suppressed,
        }


class LatencyQuantile:
    """Streaming quantile of dispatch-to-finish service times, the hedge
    delay's source. Until ``warm_count`` samples the delay is
    ``min_delay_s``."""

    def __init__(self, quantile: float, min_delay_s: float,
                 warm_count: int):
        self.quantile = quantile
        self.min_delay_s = min_delay_s
        self.warm_count = warm_count
        self.hist = FixedBucketHistogram(lo=1e-4, hi=1e3)

    def observe(self, service_s: float) -> None:
        if service_s >= 0:
            self.hist.observe(service_s)

    def delay_s(self) -> float:
        if self.hist.total < self.warm_count:
            return self.min_delay_s
        q = self.hist.percentile(self.quantile)
        return max(self.min_delay_s, q if q is not None else 0.0)


class CircuitBreaker:
    """One replica's breaker: closed -> (window failure ratio over the
    threshold) -> open -> (``open_s`` elapsed) -> half_open ->
    (``probe_n`` successes) -> closed; a half-open failure reopens it.
    The clock comes with every call."""

    __slots__ = ("cfg", "name", "window", "state", "open_until",
                 "half_open_ok", "half_open_inflight", "transitions",
                 "opens", "fast_sheds")

    def __init__(self, cfg: OverloadConfig, name: str):
        self.cfg = cfg
        self.name = name
        self.window: deque = deque(
            maxlen=resolve_breaker_window(cfg.breaker_window))
        self.state = "closed"
        self.open_until = 0.0
        self.half_open_ok = 0
        self.half_open_inflight = 0
        self.transitions: List[dict] = []
        self.opens = 0
        self.fast_sheds = 0

    def _transition(self, state: str, now: float) -> None:
        self.transitions.append({
            "at_s": round(now, 6), "from": self.state, "to": state})
        self.state = state

    def allow(self, now: float) -> bool:
        """May the replica take a request now? An open breaker past its
        hold turns half-open here; half-open admits at most ``probe_n``
        requests in flight."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now >= self.open_until:
                self._transition("half_open", now)
                self.half_open_ok = 0
                self.half_open_inflight = 0
                return True
            self.fast_sheds += 1
            return False
        return self.half_open_inflight < self.cfg.breaker_probe_n

    def note_dispatch(self) -> None:
        if self.state == "half_open":
            self.half_open_inflight += 1

    def record(self, ok: bool, now: float) -> None:
        """One terminal outcome at the replica; ``ok`` is its SLO
        verdict."""
        if self.state == "half_open":
            self.half_open_inflight = max(0, self.half_open_inflight - 1)
            if ok:
                self.half_open_ok += 1
                if self.half_open_ok >= self.cfg.breaker_probe_n:
                    self.window.clear()
                    self._transition("closed", now)
            else:
                self.opens += 1
                self.open_until = now + self.cfg.breaker_open_s
                self._transition("open", now)
            return
        self.window.append(0 if ok else 1)
        if self.state != "closed":
            return
        if len(self.window) < self.cfg.breaker_min_samples:
            return
        if sum(self.window) / len(self.window) >= (
                self.cfg.breaker_failure_ratio):
            self.opens += 1
            self.open_until = now + self.cfg.breaker_open_s
            self._transition("open", now)

    def report(self) -> Dict[str, object]:
        return {
            "state": self.state,
            "opens": self.opens,
            "fast_sheds": self.fast_sheds,
            "transitions": self.transitions,
        }


class BrownoutController:
    """The brownout ladder: level 0 full service, 1 caps ``max_new`` and
    stops hedging, 2 also sheds the low tier. ``brownout_evals``
    consecutive breaching evaluations escalate; ``recover_evals`` clean
    ones step down one level."""

    MAX_LEVEL = 2

    def __init__(self, cfg: OverloadConfig):
        self.cfg = cfg
        self.enabled = resolve_brownout(cfg.brownout)
        self.level = 0
        self.window: deque = deque(maxlen=cfg.brownout_window)
        self._breach_streak = 0
        self._ok_streak = 0
        self.transitions: List[dict] = []
        self.capped = 0
        self.tier_shed = 0

    def observe(self, ok: bool) -> None:
        self.window.append(1 if ok else 0)

    def evaluate(self, now: float) -> None:
        if not self.enabled:
            return
        if len(self.window) < max(4, self.window.maxlen // 4):
            return
        if sum(self.window) / len(self.window) < self.cfg.brownout_attainment:
            self._breach_streak += 1
            self._ok_streak = 0
        else:
            self._ok_streak += 1
            self._breach_streak = 0
        if (self._breach_streak >= self.cfg.brownout_evals
                and self.level < self.MAX_LEVEL):
            self._breach_streak = 0
            self.level += 1
            self.transitions.append({"at_s": round(now, 6),
                                     "level": self.level,
                                     "direction": "escalate"})
        elif (self._ok_streak >= self.cfg.brownout_recover_evals
                and self.level > 0):
            self._ok_streak = 0
            self.level -= 1
            self.transitions.append({"at_s": round(now, 6),
                                     "level": self.level,
                                     "direction": "recover"})

    def cap_max_new(self, max_new: int) -> int:
        if self.level >= 1 and max_new > self.cfg.brownout_max_new_cap:
            self.capped += 1
            return self.cfg.brownout_max_new_cap
        return max_new

    def hedging_allowed(self) -> bool:
        return self.level == 0

    def sheds_tier(self, tier: int) -> bool:
        if self.level >= 2 and tier >= 1:
            self.tier_shed += 1
            return True
        return False

    def report(self) -> Dict[str, object]:
        return {
            "enabled": self.enabled,
            "level": self.level,
            "capped": self.capped,
            "tier_shed": self.tier_shed,
            "transitions": self.transitions,
        }


class OverloadState:
    """One fleet's live overload state: retry buckets by origin (and
    tenant), hedge buckets by tenant with the delay quantile, breakers
    by replica, the brownout ladder, and the counters the report
    publishes."""

    def __init__(self, cfg: OverloadConfig):
        self.cfg = cfg
        self.retry_ratio = resolve_retry_budget(cfg.retry_budget_ratio)
        self._retry_buckets: Dict[str, TokenBucket] = {}
        # "" is the anonymous tenant: an untenanted fleet only uses it
        self._hedge_buckets: Dict[str, TokenBucket] = {
            "": TokenBucket(cfg.hedge_budget_ratio, cfg.hedge_budget_burst)}
        self.latency = LatencyQuantile(
            resolve_hedge_quantile(cfg.hedge_quantile),
            cfg.hedge_min_delay_s, cfg.hedge_warm_count)
        self.breakers: Dict[str, CircuitBreaker] = {}
        self.brownout = BrownoutController(cfg)
        self.counters: Dict[str, int] = {}

    def incr(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    # -- retry budget -------------------------------------------------

    def retry_bucket(self, origin: str, tenant: str = "") -> TokenBucket:
        key = f"{origin}/{tenant}" if tenant else origin
        bucket = self._retry_buckets.get(key)
        if bucket is None:
            bucket = TokenBucket(self.retry_ratio,
                                 self.cfg.retry_budget_burst)
            self._retry_buckets[key] = bucket
        return bucket

    def earn_retry(self, origin: str, tenant: str = "") -> None:
        self.retry_bucket(origin, tenant).earn()

    def spend_retry(self, origin: str, tenant: str = "") -> bool:
        ok = self.retry_bucket(origin, tenant).spend()
        self.incr("retries_scheduled" if ok else "retries_suppressed")
        return ok

    # -- hedging ------------------------------------------------------

    def hedge_bucket(self, tenant: str = "") -> TokenBucket:
        bucket = self._hedge_buckets.get(tenant)
        if bucket is None:
            bucket = TokenBucket(self.cfg.hedge_budget_ratio,
                                 self.cfg.hedge_budget_burst)
            self._hedge_buckets[tenant] = bucket
        return bucket

    def hedge_delay_s(self) -> float:
        return self.latency.delay_s()

    def hedge_enabled(self) -> bool:
        return self.cfg.hedge and self.brownout.hedging_allowed()

    def spend_hedge(self, tenant: str = "") -> bool:
        ok = self.hedge_bucket(tenant).spend()
        if not ok:
            self.incr("hedges_suppressed")
        return ok

    def observe_service(self, service_s: float, tenant: str = "") -> None:
        self.latency.observe(service_s)
        self.hedge_bucket(tenant).earn()

    # -- breakers -----------------------------------------------------

    def breaker(self, target: str) -> CircuitBreaker:
        b = self.breakers.get(target)
        if b is None:
            b = self.breakers[target] = CircuitBreaker(self.cfg, target)
        return b

    def breaker_allows(self, target: str, now: float) -> bool:
        return not self.cfg.breaker or self.breaker(target).allow(now)

    def breaker_dispatch(self, target: str) -> None:
        if self.cfg.breaker:
            self.breaker(target).note_dispatch()

    def breaker_record(self, target: str, ok: bool, now: float) -> None:
        if self.cfg.breaker:
            self.breaker(target).record(ok, now)

    # -- reporting ----------------------------------------------------

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "config": self.cfg.as_dict(),
            "counters": dict(sorted(self.counters.items())),
            "retry_budget": {origin: bucket.report() for origin, bucket in
                             sorted(self._retry_buckets.items())},
            "hedge_budget": self._hedge_buckets[""].report(),
            "brownout": self.brownout.report(),
        }
        if len(self._hedge_buckets) > 1:
            out["hedge_budget_by_tenant"] = {
                tenant: bucket.report() for tenant, bucket in
                sorted(self._hedge_buckets.items()) if tenant}
        if self.cfg.breaker:
            out["breakers"] = {name: b.report() for name, b in
                               sorted(self.breakers.items())}
        return out


def surge_trace(spec: WorkloadSpec, seed: int, t0: float, t1: float,
                multiplier: float) -> List[TraceRequest]:
    """The ``demand_surge`` workload: the seeded trace plus extra
    arrivals at ``(multiplier - 1) x rps`` in ``[t0, t1)``, drawn from a
    crc32 sub-seed of the arguments. Surge ids are ``s``-prefixed."""
    base = generate_trace(spec, seed)
    extra_rps = spec.rps * max(0.0, multiplier - 1.0)
    n_extra = int(extra_rps * max(0.0, t1 - t0))
    merged = list(base)
    if n_extra > 0:
        sub_seed = zlib.crc32(
            repr(("surge", seed, round(t0, 6), round(t1, 6),
                  round(multiplier, 6))).encode("utf-8"))
        surge_spec = dataclasses.replace(
            spec, process="poisson", rps=extra_rps, n_requests=n_extra)
        for req in generate_trace(surge_spec, sub_seed):
            at = round(t0 + req.arrival_s, 6)
            if at >= t1:
                break
            merged.append(dataclasses.replace(
                req, request_id=f"s{req.request_id}", arrival_s=at))
    merged.sort(key=lambda r: (r.arrival_s, r.request_id))
    return merged
