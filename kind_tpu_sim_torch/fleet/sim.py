"""The fleet loop over real engines: trace -> router -> replicas -> SLO.

The port's copy of the engine-backed path of
``kind_tpu_sim/fleet/sim.py``. One virtual-clock loop: arrivals due at a
tick boundary enter the router (or shed), the router places its queue by
policy, every replica advances one tick (an :class:`EngineReplica` runs
one ``step_round()`` of its engine), completions stream into the SLO
tracker and the completion log, and the autoscaler gets one observation
an evaluation interval. Chaos events (replica preemption and restore,
slowdown) fire at planned virtual times and displaced requests requeue
at the router.

Four control layers ride the loop when their :class:`FleetConfig` field
is set:

* ``health`` (a ``health.DetectorConfig``): the gray-failure detector
  reads each completion's time per output token; quarantined replicas
  leave the router's candidates, and suspect or quarantined ones get a
  probe request every ``probe_interval_s`` while traffic flows, until
  clean probes restore them.
* ``overload`` (an ``overload.OverloadConfig``): client retries of shed
  and expired requests on a budget, hedged copies on a second replica
  once the primary is a tail case (the first completion wins and the
  loser is cancelled or its late completion dropped), per-replica
  circuit breakers, and the brownout ladder.
* ``tenancy`` (a ``tenancy.TenancyConfig``): per-tenant admission
  quotas, deficit round robin at the router, brownout by declared tier,
  and a per-tenant SLO board.
* ``audit_frac`` > 0: that share of served requests is executed again
  on a replica that produced none of its results and the stream crcs are
  compared; a disagreement takes a third copy, and the majority names
  the replica to quarantine.

The loop is the reference's plain per-tick loop with its idle-gap
fast-forward (``_idle_gap``): across a gap where nothing can happen
before the next arrival or chaos event, the clock takes the same
tick-sized float additions without the per-tick work. The reference's
event-heap core is an execution strategy whose reports equal the plain
loop's; it is not ported. For a given config, trace, events and
weights, :meth:`FleetSim.run` returns the reference's report.

The :class:`FleetConfig` features that only the simulator's other
layers serve are refused with a ``ValueError`` that names them:
``sched``, ``training``, ``disagg``, ``zoo``, ``generations``,
``event_core=True`` and ``fast_forward=False``; so is a fleet without a
``replica_factory`` (the reference's analytic replicas). The reference
resolves an unset ``tick_s`` and ``audit_frac`` from the environment;
the port takes their defaults, 0.01 virtual seconds and 0.
"""

from __future__ import annotations

import dataclasses
import heapq
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.fleet.autoscaler import Autoscaler, AutoscalerConfig
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest, VirtualClock
from kind_tpu_sim_torch.fleet.overload import (
    OverloadConfig,
    OverloadState,
    request_tier,
)
from kind_tpu_sim_torch.fleet.router import (
    EngineReplica,
    ReplicaCompletion,
    Router,
)
from kind_tpu_sim_torch.fleet.slo import SloPolicy, SloTracker
from kind_tpu_sim_torch.fleet.tenancy import (
    TenancyConfig,
    TenancyState,
    tenant_of,
)
from kind_tpu_sim_torch.health import DetectorConfig, FailureDetector
from kind_tpu_sim_torch.models.serving import ServingEngine


TICK_S = 0.01  # the reference's default tick width, virtual seconds
SDC_RATE = 0.4  # the reference's default chip corruption rate


def resolve_tick_s(value: Optional[float] = None) -> float:
    """``value``, else :data:`TICK_S`."""
    return TICK_S if value is None else float(value)


def resolve_audit_frac(value: Optional[float] = None) -> float:
    """``value`` clamped to [0, 1], else 0 (the audit lane off)."""
    return 0.0 if value is None else max(0.0, min(1.0, float(value)))


class _Timers:
    """Payloads due at virtual times, popped in (time, push order): the
    reference's one-lane ``EventHeap``. Payloads are never compared."""

    def __init__(self):
        self._heap: List[tuple] = []
        self._seq = 0

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, time_s: float, payload) -> None:
        heapq.heappush(self._heap, (time_s, self._seq, payload))
        self._seq += 1

    def pop_due(self, now: float) -> list:
        out = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """A fleet-level fault at virtual time ``at_s``: ``preempt``
    displaces replica ``target``'s whole load and ``restore`` heals it;
    ``slow`` steps it every ``param``-th tick (``unslow`` undoes it);
    ``sdc_chip`` is recorded (an engine replica has no corruption
    model). The reference's node, link, domain, training, disaggregated
    and zoo actions need simulator layers the port does not carry and
    raise."""

    at_s: float
    action: str
    target: int
    param: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SimReplicaConfig:
    """The reference's analytic-replica service model. An engine fleet
    never reads it; it is kept so that ``FleetConfig.sim`` and the
    report's ``config`` section are the reference's."""

    max_slots: int = 4
    prefill_base_s: float = 0.010
    prefill_per_tok_s: float = 0.001
    tpot_s: float = 0.005
    max_queue: int = 64
    prefix_cache_entries: int = 8
    model_prefill_per_tok_s: tuple = ()
    model_tpot_s: tuple = ()
    model_swap_s: tuple = ()
    resident_model: str = ""

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        if not self.model_tpot_s:
            for key in ("model_prefill_per_tok_s", "model_tpot_s",
                        "model_swap_s", "resident_model"):
                del out[key]
        else:
            for key in ("model_prefill_per_tok_s", "model_tpot_s",
                        "model_swap_s"):
                out[key] = [list(pair) for pair in out[key]]
        return out


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The reference's fleet config, every field in order with its
    default. ``sched``, ``training``, ``disagg``, ``zoo`` and
    ``generations`` configure simulator layers the port does not carry:
    :class:`FleetSim` refuses them when set."""

    replicas: int = 2
    policy: str = "round-robin"
    tick_s: Optional[float] = None     # None -> resolve_tick_s()
    max_queue: int = 1024              # router admission bound
    max_virtual_s: float = 600.0       # runaway-loop backstop
    autoscale: bool = False
    eval_every_ticks: Optional[int] = None  # x tick_s, if no eval_every_s
    eval_every_s: Optional[float] = None
    slo: SloPolicy = SloPolicy(ttft_s=0.5, e2e_s=2.0)
    sim: SimReplicaConfig = SimReplicaConfig()
    autoscaler: AutoscalerConfig = AutoscalerConfig()
    sched: Optional[object] = None
    health: Optional[DetectorConfig] = None
    overload: Optional[OverloadConfig] = None
    training: Optional[object] = None
    disagg: Optional[object] = None
    tenancy: Optional[TenancyConfig] = None
    zoo: Optional[object] = None
    generations: Optional[tuple] = None
    zoo_large_model_gen: Optional[str] = None
    fast_forward: Optional[bool] = None  # False is refused
    event_core: Optional[bool] = None
    audit_frac: Optional[float] = None  # None -> resolve_audit_frac()
    columnar: Optional[bool] = None  # analytic fleets only: inert here

    def as_dict(self) -> dict:
        out = {
            "replicas": self.replicas,
            "policy": self.policy,
            "tick_s": resolve_tick_s(self.tick_s),
            "max_queue": self.max_queue,
            "max_virtual_s": self.max_virtual_s,
            "autoscale": self.autoscale,
            "slo": {k: v for k, v in dataclasses.asdict(self.slo).items()
                    if v is not None},
            "sim": self.sim.as_dict(),
        }
        if self.eval_every_s is not None:
            out["eval_every_s"] = self.eval_every_s
        if self.autoscale:
            out["autoscaler"] = dataclasses.asdict(self.autoscaler)
        for name in ("health", "overload", "tenancy"):
            layer = getattr(self, name)
            if layer is not None:
                out[name] = layer.as_dict()
        if self.zoo_large_model_gen is not None:
            out["zoo_large_model_gen"] = self.zoo_large_model_gen
        if self.audit_frac is not None:
            out["audit_frac"] = self.audit_frac
        return out


# the simulator layers each refused FleetConfig field configures
_SIMULATOR_LAYERS = {
    "sched": "the topology-aware cluster scheduler",
    "training": "training tenancy",
    "disagg": "disaggregated prefill/decode pools",
    "zoo": "the model zoo",
    "generations": "per-generation pricing of analytic replicas",
}

# chaos actions that need one of those layers, and the field naming it
_CHAOS_NEEDS = {
    "train_preempt": "training", "train_kill": "training",
    "sdc_train_chip": "training",
    "prefill_pool_loss": "disagg", "prefill_pool_restore": "disagg",
    "kv_degrade": "disagg", "kv_restore": "disagg",
    "model_swap_evict": "zoo",
    "domain_fault": "sched", "domain_restore": "sched",
}


def _refuse_unported(cfg: FleetConfig) -> None:
    for name, layer in _SIMULATOR_LAYERS.items():
        if getattr(cfg, name) is not None:
            raise ValueError(
                f"FleetConfig.{name} ({layer}) is a feature of the "
                "simulator's analytic fleet, not ported to the engine "
                "fleet")
    if cfg.event_core:
        raise ValueError(
            "FleetConfig.event_core (the simulator's event-heap core) is "
            "not ported: the engine fleet runs the plain per-tick loop "
            "with the idle-gap fast-forward, whose reports the event "
            "core's equal")
    if cfg.fast_forward is False:
        raise ValueError(
            "FleetConfig.fast_forward=False (the simulator's tick-by-tick "
            "walk of idle gaps) is not ported: the engine fleet always "
            "runs the idle-gap fast-forward, whose reports equal it")


def _is_probe(request_id: str) -> bool:
    return request_id.startswith("__probe-")


def _is_audit_copy(request_id: str) -> bool:
    return "~a" in request_id


class FleetSim:
    """One fleet run of engine replicas. ``replica_factory(replica_id)``
    builds a replica (an :class:`EngineReplica` around an engine whose
    ``clock`` is ``clock.now``)."""

    def __init__(self, cfg: FleetConfig,
                 trace: Sequence[TraceRequest],
                 replica_factory: Optional[Callable[[int], object]] = None,
                 chaos_events: Sequence[ChaosEvent] = (),
                 clock: Optional[VirtualClock] = None):
        _refuse_unported(cfg)
        if replica_factory is None:
            raise ValueError(
                "the simulator's analytic replicas (SimReplica) are not "
                "ported: pass a replica_factory of EngineReplicas")
        self.cfg = cfg
        self.clock = clock or VirtualClock()
        self.trace = sorted(trace, key=lambda r: (r.arrival_s, r.request_id))
        self.factory = replica_factory
        self.replicas = [self.factory(i) for i in range(cfg.replicas)]
        self.health = (FailureDetector(cfg.health)
                       if cfg.health is not None else None)
        self.overload = (OverloadState(cfg.overload)
                         if cfg.overload is not None else None)
        self.tenancy = (TenancyState(cfg.tenancy)
                        if cfg.tenancy is not None else None)
        self._tenant_trackers: Dict[str, SloTracker] = {}
        self.router = Router(self.replicas, policy=cfg.policy,
                             max_queue=cfg.max_queue, health=self.health,
                             overload=self.overload, tenancy=self.tenancy)
        if self.overload is not None:
            self.router.on_place = self._on_place
        self.chaos_events = sorted(chaos_events,
                                   key=lambda e: (e.at_s, e.target))
        self.tracker = SloTracker(cfg.slo)
        self.autoscaler = (Autoscaler(cfg.autoscaler) if cfg.autoscale
                           else None)
        self.log: List[dict] = []
        # recent attained flags: the autoscaler's SLO signal
        self._recent = deque(maxlen=64)
        self._next_replica_id = cfg.replicas
        # replicas paid for but not yet routable: (replica, reason) at
        # their ready time
        self._warming = _Timers()
        self._draining: List = []
        self.preemptions = 0
        self._now = 0.0
        self._ticks = 0
        self._pending = deque(self.trace)
        tick_s = resolve_tick_s(cfg.tick_s)
        if cfg.eval_every_s is not None:
            eval_every_s = cfg.eval_every_s
        elif cfg.eval_every_ticks is not None:
            eval_every_s = cfg.eval_every_ticks * tick_s
        else:
            eval_every_s = 10 * tick_s
        self._eval_ticks = max(1, int(round(eval_every_s / tick_s)))
        # gray failures: replicas a `slow` event degrades (the ground
        # truth false positives are judged against), and the probes
        self._slow_factor: Dict[int, float] = {}
        self._probe_last: Dict[str, float] = {}
        self._probe_n: Dict[str, int] = {}
        # overload: retries and hedge timers on the virtual clock
        self._retry_heap = _Timers()   # retried requests at their arrival
        self._hedge_heap = _Timers()   # (request, primary) at hedge time
        self._attempts: Dict[str, int] = {}
        self._hedges: Dict[str, dict] = {}
        self._hedge_dropped: set = set()
        self._completed_ids: set = set()
        # the audit lane: audits due (base ids), open audits, and each
        # quarantined replica's detection time
        self._audit_frac = resolve_audit_frac(cfg.audit_frac)
        self._audit_heap = _Timers()
        self._audits: Dict[str, dict] = {}
        self._sdc_detect_s: Dict[int, float] = {}
        self._sdc_active = self._audit_frac > 0.0

    def _replica_by_id(self, rid: int):
        for r in self.replicas + self._draining:
            if r.replica_id == rid:
                return r
        return None

    # -- gray failures -------------------------------------------------

    def _on_health_transition(self, rid: int, transition: str,
                              now: float) -> None:
        if transition != "quarantined":
            return
        metrics.recovery_log().record(
            "fleet_replica_quarantine", replica=rid, at_s=round(now, 6))
        if rid not in self._slow_factor:
            # detection fired on a replica nothing degrades
            metrics.health_board().incr("false_positives")

    def _probe_quarantined(self, now: float) -> None:
        """One probe request a probe interval to each suspect or
        quarantined replica that is alive: the router starves a suspect
        of traffic, and the detector needs its samples. Probes never
        enter the SLO log."""
        for replica in self.replicas:
            comp = f"replica-{replica.replica_id}"
            if not replica.healthy or self.health.state(comp) == "healthy":
                continue
            last = self._probe_last.get(comp)
            if (last is not None
                    and now - last < self.health.cfg.probe_interval_s):
                continue
            self._probe_last[comp] = now
            n = self._probe_n.get(comp, 0)
            self._probe_n[comp] = n + 1
            probe = TraceRequest(
                request_id=f"__probe-{replica.replica_id}-{n}",
                arrival_s=round(now, 6), prompt=(1,) * 8, max_new=4, seed=0)
            if replica.submit(probe, now):
                metrics.health_board().incr("probe_dispatches")

    def _observe_health(self, rid: int, comp: ReplicaCompletion,
                        now: float) -> None:
        # the detector's one channel: decode time per post-first token
        if comp.tokens < 2 or comp.first_s is None:
            return
        sample = (comp.finish_s - comp.first_s) / (comp.tokens - 1)
        transition = self.health.observe(f"replica-{rid}", sample, now=now)
        if transition is not None:
            self._on_health_transition(rid, transition, now)

    # -- tenancy and overload ------------------------------------------

    def _tenant_key(self, req) -> str:
        """The overload layer's tenant: the request's under isolation,
        '' otherwise."""
        if self.tenancy is None or not self.tenancy.isolation:
            return ""
        return tenant_of(req)

    def _shed(self, req: TraceRequest, now: float) -> None:
        self._record(ReplicaCompletion(
            request=req, dispatch_s=now, first_s=None, finish_s=now,
            tokens=0, tokens_crc=0, finish_reason="shed"), -1,
            brownout_observe=False)

    def _offer_arrival(self, req: TraceRequest, now: float,
                       fresh: bool) -> None:
        """One admission: a fresh arrival meets its tenant's quota, then
        earns retry budget; the brownout ladder sheds the low tier and
        caps ``max_new``; the router takes what survives."""
        ten = self.tenancy
        # a quota-refused request never entered the system: it funds no
        # retries and stays out of the brownout window
        if ten is not None and fresh and ten.admit(req, now) is not None:
            metrics.tenant_board().incr("tenant_quota_shed")
            self._shed(req, now)
            return
        ov = self.overload
        if ov is not None:
            if fresh:
                ov.earn_retry("local", self._tenant_key(req))
            bo = ov.brownout
            if ten is not None and ten.isolation:
                tier = ten.tier(tenant_of(req))
            else:
                tier = request_tier(req.request_id, ov.cfg.low_tier_frac)
            if bo.sheds_tier(tier):
                metrics.fleet_board().incr("brownout_shed")
                self._shed(req, now)
                return
            capped = bo.cap_max_new(req.max_new)
            if capped != req.max_new:
                req = dataclasses.replace(req, max_new=capped)
        shed = self.router.offer(req, now)
        if shed is not None:
            self._record(shed, -1)

    def _on_place(self, req: TraceRequest, replica, now: float) -> None:
        """The router's placement hook: arm the hedge timer at the p9x of
        observed service times."""
        ov = self.overload
        rid = req.request_id
        if _is_probe(rid) or not ov.hedge_enabled() or rid in self._hedges:
            return
        self._hedge_heap.push(now + ov.hedge_delay_s(), (req, replica))

    def _fire_hedges(self, now: float) -> None:
        """Due hedge timers: a request still in flight gets a copy on the
        next candidate, if the hedge budget allows."""
        ov = self.overload
        for req, primary in self._hedge_heap.pop_due(now):
            rid = req.request_id
            if rid in self._completed_ids or rid in self._hedges:
                continue
            if not ov.hedge_enabled():
                continue
            if not ov.spend_hedge(self._tenant_key(req)):
                continue
            for cand in self.router._pick_order(req, now):
                if cand is primary:
                    continue
                if cand.submit(req, now):
                    self._hedges[rid] = {"primary": primary, "hedge": cand}
                    ov.incr("hedges_issued")
                    ov.breaker_dispatch(f"replica-{cand.replica_id}")
                    break

    def _handle_completion(self, replica, comp: ReplicaCompletion) -> None:
        """A replica's completion through the overload filters: a
        cancelled hedge loser's late completion is dropped, the first of
        a hedged pair wins and cancels the loser, duplicates dedupe on
        the id."""
        ov = self.overload
        if ov is None:
            self._record(comp, replica.replica_id)
            return
        rid = comp.request.request_id
        if rid in self._hedge_dropped:
            self._hedge_dropped.discard(rid)
            ov.incr("hedge_late_drops")
            return
        if rid in self._completed_ids:
            return
        pair = self._hedges.pop(rid, None)
        if pair is not None:
            loser = (pair["hedge"] if replica is pair["primary"]
                     else pair["primary"])
            if replica is pair["hedge"]:
                ov.incr("hedge_wins")
            if loser.cancel(rid):
                ov.incr("hedge_cancels")
            else:
                self._hedge_dropped.add(rid)
        self._record(comp, replica.replica_id)

    def _complete(self, replica, comp: ReplicaCompletion, now: float) -> None:
        """A replica's completion to its consumer: a probe feeds the
        detector and an audit copy the vote, never the SLO log; user
        traffic goes through the overload filters to the log. (The
        reference logs a probe that finishes on a draining replica as
        user traffic: ROADMAP C-14.)"""
        rid = comp.request.request_id
        if _is_probe(rid):
            self._observe_health(replica.replica_id, comp, now)
        elif _is_audit_copy(rid):
            self._on_audit_result(replica, comp)
        else:
            self._handle_completion(replica, comp)

    def _maybe_retry(self, comp: ReplicaCompletion, now: float) -> None:
        """The client retry: a shed or expired attempt comes back after a
        doubling backoff if the retry budget allows."""
        ov = self.overload
        if comp.finish_reason not in ("shed", "deadline_exceeded"):
            return
        if ov.cfg.max_attempts <= 1:
            return
        req = comp.request
        base = req.request_id.split("~r", 1)[0]
        attempt = self._attempts.get(base, 1)
        if attempt >= ov.cfg.max_attempts:
            ov.incr("retries_exhausted")
            return
        if not ov.spend_retry("local", self._tenant_key(req)):
            return
        self._attempts[base] = attempt + 1
        delay = ov.cfg.retry_backoff_s * (2 ** (attempt - 1))
        at = round(now + delay, 6)
        self._retry_heap.push(at, dataclasses.replace(
            req, request_id=f"{base}~r{attempt}", arrival_s=at))

    def _requeue_front(self, displaced: List) -> None:
        """Displaced requests back to the router's queue head. An audit
        copy dies with its replica: its audit concludes on the results
        it has."""
        if self._audits:
            kept = []
            for req in displaced:
                if _is_audit_copy(req.request_id):
                    self._conclude_audit(req.request_id.split("~a", 1)[0])
                else:
                    kept.append(req)
            displaced = kept
        self.router.requeue_front(displaced)

    # -- the audit lane ------------------------------------------------

    def _dispatch_audit(self, base_id: str, now: float) -> None:
        """A due audit: a copy of the request on the first healthy,
        unquarantined replica that produced none of its results,
        submitted directly (real occupancy, never SLO traffic). With no
        such replica the audit is inconclusive and the answer stands."""
        st = self._audits.get(base_id)
        if st is None:
            return
        target = None
        for r in self.replicas:
            if not r.healthy or r.replica_id in st["results"]:
                continue
            if (self.health is not None
                    and self.health.quarantined(f"replica-{r.replica_id}")):
                continue
            target = r
            break
        st["copies"] += 1
        copy = dataclasses.replace(
            st["req"], request_id=f"{base_id}~a{st['copies']}",
            arrival_s=round(now, 6), deadline_s=None)
        if target is None or not target.submit(copy, now):
            self._conclude_audit(base_id)
            return
        metrics.integrity_board().incr("audit_copies")

    def _on_audit_result(self, replica, comp: ReplicaCompletion) -> None:
        """An audit copy finished: agreement closes the audit; a first
        disagreement takes one more copy on a third replica."""
        base_id = comp.request.request_id.split("~a", 1)[0]
        st = self._audits.get(base_id)
        if st is None:
            return
        if comp.finish_reason != "length":
            self._conclude_audit(base_id)  # the copy died: inconclusive
            return
        st["results"][replica.replica_id] = comp.tokens_crc
        st["order"].append(replica.replica_id)
        if len(set(st["results"].values())) == 1 or len(st["order"]) >= 3:
            self._conclude_audit(base_id)
            return
        self._audit_heap.push(comp.finish_s, base_id)

    def _conclude_audit(self, base_id: str) -> None:
        """Close an audit: on a disagreement the majority names the
        culprits (two-way splits of three name both original producers;
        without a third answer the original producer), and each is
        quarantined."""
        st = self._audits.pop(base_id, None)
        if st is None:
            return
        results, order = st["results"], st["order"]
        counts: Dict[int, int] = {}
        for c in results.values():
            counts[c] = counts.get(c, 0) + 1
        if len(order) >= 2 and max(counts.values()) < len(order):
            metrics.integrity_board().incr("audit_mismatches")
            if len(order) >= 3 and max(counts.values()) >= 2:
                good = next(c for c in counts if counts[c] >= 2)
                culprits = [rid for rid in order if results[rid] != good]
            elif len(order) >= 3:
                culprits = order[:2]
            else:
                culprits = order[:1]
            for rid in culprits:
                self._sdc_quarantine(rid, self._now)

    def _sdc_quarantine(self, rid: int, now: float) -> None:
        """Pull a replica an audit named: it fails (its work requeues),
        and the detector holds a sticky integrity quarantine on it."""
        if rid in self._sdc_detect_s:
            return
        self._sdc_detect_s[rid] = round(now, 6)
        self._sdc_active = True
        metrics.integrity_board().incr("chips_quarantined")
        metrics.recovery_log().record(
            "fleet_sdc_quarantine", replica=rid, cause="audit",
            at_s=round(now, 6))
        if self.health is not None:
            self.health.record_integrity(f"replica-{rid}", now,
                                         cause="audit")
        victim = self._replica_by_id(rid)
        if victim is not None and victim.healthy:
            displaced = victim.fail(now)
            self._requeue_front(displaced)
            self.preemptions += 1
            metrics.recovery_log().record(
                "fleet_sdc_chip_pulled", replica=rid,
                displaced=len(displaced), at_s=round(now, 6))

    def _sampled_for_audit(self, request_id: str) -> bool:
        # a nested crc, as the reference draws it: a single crc32 pass
        # is affine in the id's bits
        inner = zlib.crc32(request_id.encode("utf-8"))
        return (zlib.crc32(("audit:%d" % inner).encode("utf-8")) / 2**32
                < self._audit_frac)

    # -- bookkeeping ---------------------------------------------------

    def _record(self, comp: ReplicaCompletion, replica_id: int,
                brownout_observe: bool = True) -> None:
        req = comp.request
        finish = dict(
            arrival_s=req.arrival_s, first_s=comp.first_s,
            finish_s=comp.finish_s, tokens=comp.tokens,
            shed=comp.finish_reason == "shed",
            deadline_exceeded=comp.finish_reason == "deadline_exceeded")
        ok = self.tracker.observe(**finish)
        self._recent.append(ok)
        entry = {
            "request_id": req.request_id,
            "replica": replica_id,
            "prefix_group": req.prefix_group,
            "arrival_s": round(req.arrival_s, 6),
            "dispatch_s": round(comp.dispatch_s, 6),
            "first_s": (round(comp.first_s, 6)
                        if comp.first_s is not None else None),
            "finish_s": round(comp.finish_s, 6),
            "tokens": comp.tokens,
            "tokens_crc": comp.tokens_crc,
            "finish_reason": comp.finish_reason,
            "slo_ok": ok,
        }
        # as in the reference's wire format: only when set
        if req.tenant:
            entry["tenant"] = req.tenant
        if req.model:
            entry["model"] = req.model
        self.log.append(entry)
        served = comp.finish_reason not in ("shed", "deadline_exceeded")
        if (self._audit_frac > 0.0 and replica_id >= 0
                and comp.finish_reason == "length"
                and req.request_id not in self._audits
                and self._sampled_for_audit(req.request_id)):
            # into the audit lane: a second replica executes it again
            self._audits[req.request_id] = {
                "req": req, "results": {replica_id: comp.tokens_crc},
                "order": [replica_id], "copies": 0}
            self._audit_heap.push(comp.finish_s, req.request_id)
            metrics.integrity_board().incr("audits")
        if self.tenancy is not None:
            name = tenant_of(req)
            if name not in self._tenant_trackers:
                self._tenant_trackers[name] = SloTracker(self.cfg.slo)
            self._tenant_trackers[name].observe(**finish)
        if self.health is not None and replica_id >= 0 and served:
            self._observe_health(replica_id, comp, self._now)
        ov = self.overload
        if ov is not None:
            self._completed_ids.add(req.request_id)
            if brownout_observe:
                # the ladder must not read its own sheds as breach
                ov.brownout.observe(ok)
            if replica_id >= 0 and comp.finish_reason != "shed":
                ov.breaker_record(f"replica-{replica_id}", ok, self._now)
            if comp.first_s is not None and served:
                ov.observe_service(comp.finish_s - comp.dispatch_s,
                                   self._tenant_key(req))
            self._maybe_retry(comp, self._now)

    def _backlog(self) -> int:
        return (len(self.router.queue)
                + sum(r.outstanding() for r in self.replicas if r.healthy))

    def _apply_chaos(self, now: float) -> None:
        while self.chaos_events and self.chaos_events[0].at_s <= now:
            ev = self.chaos_events.pop(0)
            need = _CHAOS_NEEDS.get(ev.action)
            if need is None and ev.action.startswith(("node_", "link_")):
                need = "sched"
            if need is not None:
                raise ValueError(
                    f"{ev.action} chaos needs FleetConfig.{need} "
                    f"({_SIMULATOR_LAYERS[need]}), which the engine "
                    "fleet does not carry")
            victim = next((r for r in self.replicas
                           if r.replica_id == ev.target), None)
            if victim is None:
                continue
            if ev.action == "slow":
                factor = max(1.0, ev.param)
                self._slow_factor[ev.target] = factor
                victim.set_slowdown(factor)
                metrics.recovery_log().record(
                    "fleet_replica_slow", replica=ev.target,
                    factor=factor, at_s=round(now, 6))
            elif ev.action == "unslow":
                self._slow_factor.pop(ev.target, None)
                victim.set_slowdown(1.0)
                metrics.recovery_log().record(
                    "fleet_replica_unslow", replica=ev.target,
                    at_s=round(now, 6))
            elif ev.action == "sdc_chip":
                frac = (ev.param if ev.param > 0
                        else SDC_RATE)
                metrics.recovery_log().record(
                    "fleet_sdc_chip", replica=ev.target,
                    frac=round(frac, 6), at_s=round(now, 6))
            elif ev.action == "preempt" and victim.healthy:
                displaced = victim.fail(now)
                self._requeue_front(displaced)
                self.preemptions += 1
                metrics.fleet_board().incr("replica_preemptions")
                metrics.recovery_log().record(
                    "fleet_replica_preempt", replica=ev.target,
                    displaced=len(displaced), at_s=round(now, 6))
            elif ev.action == "restore" and not victim.healthy:
                victim.restore(now)
                metrics.recovery_log().record(
                    "fleet_replica_restore", replica=ev.target,
                    at_s=round(now, 6))

    def _autoscale(self, now: float) -> None:
        scaler = self.autoscaler
        # warming replicas come online first
        for replica, reason in self._warming.pop_due(now):
            self.replicas.append(replica)
            self.router.replicas.append(replica)
            scaler.note_ready(now, len(self.router.replicas), reason=reason)
        # a quarantined replica is missing capacity
        routable = sum(
            1 for r in self.router.replicas
            if r.healthy and (self.health is None or not
                              self.health.quarantined(
                                  f"replica-{r.replica_id}")))
        recent = list(self._recent)
        attainment = sum(recent) / len(recent) if recent else None
        action = scaler.evaluate(now, routable=routable,
                                 backlog=self._backlog(),
                                 attainment=attainment)
        if action == "scale_up":
            rid = self._next_replica_id
            self._next_replica_id += 1
            self._warming.push(now + scaler.warmup_s,
                               (self.factory(rid), "warmup complete"))
        elif action == "scale_down":
            # drain the highest-id healthy replica: no new traffic,
            # removed once idle
            victim = max((r for r in self.router.replicas if r.healthy),
                         key=lambda r: r.replica_id)
            self.router.replicas.remove(victim)
            self.replicas.remove(victim)
            self._draining.append(victim)

    # -- the loop ------------------------------------------------------

    def step(self, now: float, tick: float,
             pending: Optional[deque] = None) -> None:
        """One fleet tick at virtual time ``now``."""
        if pending is None:
            pending = self._pending
        self._now = now
        self._apply_chaos(now)
        while pending and pending[0].arrival_s <= now:
            self._offer_arrival(pending.popleft(), now, fresh=True)
        if self.overload is not None:
            for req in self._retry_heap.pop_due(now):
                self._offer_arrival(req, now, fresh=False)
        # due audits: the duplicate-compute copy (or the tiebreaker)
        for base_id in self._audit_heap.pop_due(now):
            self._dispatch_audit(base_id, now)
        if self.health is not None and (pending or self.router.queue):
            # probes only while user traffic flows: a probe loop must not
            # keep a drained fleet alive
            self._probe_quarantined(now)
        for comp in self.router.dispatch(now):
            self._record(comp, -1)
        if self.overload is not None:
            self._fire_hedges(now)
        for replica in list(self.replicas):
            for comp in replica.tick(now, tick):
                self._complete(replica, comp, now)
        for replica in list(self._draining):
            for comp in replica.tick(now, tick):
                self._complete(replica, comp, now)
            if replica.idle():
                self._draining.remove(replica)
        if self._ticks % self._eval_ticks == 0:
            if self.autoscaler is not None:
                self._autoscale(now)
            if self.overload is not None:
                self.overload.brownout.evaluate(now)
        self._ticks += 1

    def quiescent(self, pending: Optional[deque] = None) -> bool:
        """Nothing pending, in flight, warming, draining, due or left in
        the chaos plan: the loop's termination test."""
        if pending is None:
            pending = self._pending
        return bool(
            not pending and not self.router.queue and not self._warming
            and not self._audit_heap and not self._audits
            and all(r.idle() for r in self.replicas if r.healthy)
            and not self._draining and not self.chaos_events
            and not self._retry_heap and not self._hedge_heap)

    def _idle_gap(self, pending: deque) -> bool:
        """True when nothing can happen before the next arrival or chaos
        event: no queued, in-flight, warming or draining work, no open
        audit, and no tick-cadenced decision maker (autoscaler
        evaluations, health probes, the overload layer's timers and
        brownout evaluations)."""
        if (self.autoscaler is not None or self.health is not None
                or self.overload is not None):
            return False
        if self.router.queue or self._warming or self._draining:
            return False
        if self._audit_heap or self._audits:
            return False
        # a slowdown other than 1 rules out even an idle replica: its
        # stride counter advances on every tick() call, so skipping
        # ticks would shift its stepping phase
        return all(r.idle() and r.slowdown == 1.0 for r in self.replicas)

    def _advance(self, tick: float, pending: deque) -> None:
        """Advance the clock one tick, then through an idle gap with the
        same tick-sized float additions (a single n * tick jump would
        land on other floats)."""
        self.clock.advance(tick)
        if not self._idle_gap(pending):
            return
        next_s = pending[0].arrival_s if pending else float("inf")
        if self.chaos_events:
            next_s = min(next_s, self.chaos_events[0].at_s)
        limit = self.cfg.max_virtual_s
        while self.clock.now() < next_s and self.clock.now() <= limit:
            self.clock.advance(tick)

    def run(self) -> Dict[str, object]:
        boards = {"fleet": metrics.fleet_board(),
                  "health": metrics.health_board(),
                  "tenant": metrics.tenant_board(),
                  "integrity": metrics.integrity_board()}
        before = {name: board.counts() for name, board in boards.items()}

        def counters(name):
            return boards[name].snapshot_since(before[name])

        tick = resolve_tick_s(self.cfg.tick_s)
        pending = self._pending
        while True:
            now = self.clock.now()
            if now > self.cfg.max_virtual_s:
                break
            self.step(now, tick, pending)
            if self.quiescent(pending):
                break
            self._advance(tick, pending)
        self.log.sort(key=lambda e: (e["finish_s"], e["request_id"]))
        span = self.clock.now()
        report: Dict[str, object] = {
            "config": self.cfg.as_dict(),
            "requests": len(self.trace),
            "completed": len(self.log),
            "virtual_s": round(span, 6),
            "slo": self.tracker.report(span_s=span),
            "router": self.router.report(),
            "replicas": {
                str(r.replica_id): r.report()
                for r in sorted(self.replicas + self._draining,
                                key=lambda r: r.replica_id)},
            "completions": self.log,
            "fleet_counters": counters("fleet"),
            "ok": len(self.log) == len(self.trace),
        }
        if self.overload is not None:
            # with retries the log holds one entry an attempt: ok when
            # every request's base id reached a terminal outcome
            base_done = {e["request_id"].split("~r", 1)[0]
                         for e in self.log}
            report["ok"] = all(r.request_id in base_done
                               for r in self.trace)
            report["overload"] = self.overload.report()
        if self.tenancy is not None:
            ten_report = self.tenancy.report()
            ten_report["slo"] = {
                name: tracker.report(span_s=span)
                for name, tracker in sorted(self._tenant_trackers.items())}
            ten_report["counters"] = counters("tenant")
            report["tenancy"] = ten_report
        if self._sdc_active:
            report["integrity"] = {
                "audit_frac": round(self._audit_frac, 6),
                "detections": [{"replica": rid, "at_s": t} for rid, t in
                               sorted(self._sdc_detect_s.items())],
                "counters": counters("integrity"),
            }
        if self.preemptions:
            report["preemptions"] = self.preemptions
        if self.health is not None:
            report["health"] = {"detector": self.health.report(),
                                "counters": counters("health")}
        if self.autoscaler is not None:
            report["autoscaler"] = self.autoscaler.report()
        return report


def attainment_over(log: Sequence[dict], t_from: float,
                    t_to: float = float("inf")) -> Optional[float]:
    """SLO attainment of the requests arriving in [t_from, t_to): how
    the chaos scenarios compare service after recovery with the
    fault-free run's, without the backlog drain in the number."""
    window = [e for e in log if t_from <= e["arrival_s"] < t_to]
    if not window:
        return None
    return sum(1 for e in window if e["slo_ok"]) / len(window)


def engine_fleet(cfg: FleetConfig, trace: Sequence[TraceRequest], params,
                 model_cfg, serving, *, device="cuda",
                 chaos_events: Sequence[ChaosEvent] = ()) -> FleetSim:
    """A fleet whose replicas are :class:`EngineReplica` objects, each
    around a ``ServingEngine`` of ``model_cfg`` and ``serving`` over the
    shared ``params`` on ``device``; every engine reads the fleet's
    virtual clock."""
    clock = VirtualClock()

    def factory(rid):
        return EngineReplica(rid, ServingEngine(
            params, model_cfg, serving, device=device, clock=clock.now))

    return FleetSim(cfg, trace, replica_factory=factory,
                    chaos_events=chaos_events, clock=clock)
