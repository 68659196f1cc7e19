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

The loop is the reference's plain per-tick loop with its idle-gap
fast-forward (``_idle_gap``): across a gap where nothing can happen
before the next arrival or chaos event, the clock takes the same
tick-sized float additions without the per-tick work. The reference's
event-heap core is an execution strategy whose reports equal the plain
loop's; it is not ported. For a given config, trace, events and
weights, :meth:`FleetSim.run` returns the reference's ``requests``,
``completed``, ``virtual_s``, ``slo``, ``router``, ``completions`` and
``ok``.

The :class:`FleetConfig` features that only the simulator's other
layers serve are refused with a ``ValueError`` that names them:
``sched``, ``health``, ``overload``, ``training``, ``disagg``,
``tenancy``, ``zoo``, ``generations``, a positive ``audit_frac``,
``event_core=True`` and ``fast_forward=False``; so is a fleet without a
``replica_factory`` (the reference's analytic replicas). The reference
resolves an unset ``tick_s`` from the environment; the port takes its
default, 0.01 virtual seconds.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.fleet.autoscaler import Autoscaler, AutoscalerConfig
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest, VirtualClock
from kind_tpu_sim_torch.fleet.router import (
    EngineReplica,
    ReplicaCompletion,
    Router,
)
from kind_tpu_sim_torch.fleet.slo import SloPolicy, SloTracker
from kind_tpu_sim_torch.models.serving import ServingEngine


TICK_S = 0.01  # the reference's default tick width, virtual seconds
SDC_RATE = 0.4  # the reference's default chip corruption rate


def resolve_tick_s(value: Optional[float] = None) -> float:
    """``value``, else :data:`TICK_S`."""
    return TICK_S if value is None else float(value)


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
    default. ``sched``, ``health``, ``overload``, ``training``,
    ``disagg``, ``tenancy``, ``zoo`` and ``generations`` configure
    simulator layers the port does not carry: :class:`FleetSim` refuses
    them when set."""

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
    health: Optional[object] = None
    overload: Optional[object] = None
    training: Optional[object] = None
    disagg: Optional[object] = None
    tenancy: Optional[object] = None
    zoo: Optional[object] = None
    generations: Optional[tuple] = None
    zoo_large_model_gen: Optional[str] = None
    fast_forward: Optional[bool] = None  # False is refused
    event_core: Optional[bool] = None
    audit_frac: Optional[float] = None
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
        if self.zoo_large_model_gen is not None:
            out["zoo_large_model_gen"] = self.zoo_large_model_gen
        if self.audit_frac is not None:
            out["audit_frac"] = self.audit_frac
        return out


# the simulator layers each refused FleetConfig field configures
_SIMULATOR_LAYERS = {
    "sched": "the topology-aware cluster scheduler",
    "health": "the gray-failure detector",
    "overload": "overload containment (retries, hedges, breakers, "
                "brownout)",
    "training": "training tenancy",
    "disagg": "disaggregated prefill/decode pools",
    "tenancy": "multi-tenant isolation",
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
    if cfg.audit_frac is not None and cfg.audit_frac > 0.0:
        raise ValueError(
            "FleetConfig.audit_frac (the simulator's duplicate-compute "
            "integrity audit lane) is not ported")
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
        self.router = Router(self.replicas, policy=cfg.policy,
                             max_queue=cfg.max_queue)
        self.chaos_events = sorted(chaos_events,
                                   key=lambda e: (e.at_s, e.target))
        self.tracker = SloTracker(cfg.slo)
        self.autoscaler = (Autoscaler(cfg.autoscaler) if cfg.autoscale
                           else None)
        self.log: List[dict] = []
        # recent attained flags: the autoscaler's SLO signal
        self._recent = deque(maxlen=64)
        self._next_replica_id = cfg.replicas
        # replicas paid for but not yet routable: a heap of
        # (ready_at_s, order, (replica, reason))
        self._warming: List[tuple] = []
        self._warm_seq = 0
        self._draining: List = []
        self.preemptions = 0
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

    # -- bookkeeping ---------------------------------------------------

    def _record(self, comp: ReplicaCompletion, replica_id: int) -> None:
        req = comp.request
        ok = self.tracker.observe(
            arrival_s=req.arrival_s, first_s=comp.first_s,
            finish_s=comp.finish_s, tokens=comp.tokens,
            shed=comp.finish_reason == "shed",
            deadline_exceeded=comp.finish_reason == "deadline_exceeded")
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
                victim.set_slowdown(factor)
                metrics.recovery_log().record(
                    "fleet_replica_slow", replica=ev.target,
                    factor=factor, at_s=round(now, 6))
            elif ev.action == "unslow":
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
                self.router.requeue_front(displaced)
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
        while self._warming and self._warming[0][0] <= now:
            _, _, (replica, reason) = heapq.heappop(self._warming)
            self.replicas.append(replica)
            self.router.replicas.append(replica)
            scaler.note_ready(now, len(self.router.replicas), reason=reason)
        routable = sum(1 for r in self.router.replicas if r.healthy)
        recent = list(self._recent)
        attainment = sum(recent) / len(recent) if recent else None
        action = scaler.evaluate(now, routable=routable,
                                 backlog=self._backlog(),
                                 attainment=attainment)
        if action == "scale_up":
            rid = self._next_replica_id
            self._next_replica_id += 1
            heapq.heappush(self._warming, (
                now + scaler.warmup_s, self._warm_seq,
                (self.factory(rid), "warmup complete")))
            self._warm_seq += 1
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
        self._apply_chaos(now)
        while pending and pending[0].arrival_s <= now:
            shed = self.router.offer(pending.popleft(), now)
            if shed is not None:
                self._record(shed, -1)
        for comp in self.router.dispatch(now):
            self._record(comp, -1)
        for replica in list(self.replicas):
            for comp in replica.tick(now, tick):
                self._record(comp, replica.replica_id)
        for replica in list(self._draining):
            for comp in replica.tick(now, tick):
                self._record(comp, replica.replica_id)
            if replica.idle():
                self._draining.remove(replica)
        if (self._ticks % self._eval_ticks == 0
                and self.autoscaler is not None):
            self._autoscale(now)
        self._ticks += 1

    def quiescent(self, pending: Optional[deque] = None) -> bool:
        """Nothing pending, in flight, warming, draining or left in the
        chaos plan: the loop's termination test."""
        if pending is None:
            pending = self._pending
        return bool(
            not pending and not self.router.queue and not self._warming
            and all(r.idle() for r in self.replicas if r.healthy)
            and not self._draining and not self.chaos_events)

    def _idle_gap(self, pending: deque) -> bool:
        """True when nothing can happen before the next arrival or chaos
        event: no queued, in-flight, warming or draining work and no
        autoscaler evaluations (a tick-cadenced decision)."""
        if self.autoscaler is not None:
            return False
        if self.router.queue or self._warming or self._draining:
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
        board_before = metrics.fleet_board().counts()
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
        report: Dict[str, object] = {
            "config": self.cfg.as_dict(),
            "requests": len(self.trace),
            "completed": len(self.log),
            "virtual_s": round(self.clock.now(), 6),
            "slo": self.tracker.report(span_s=self.clock.now()),
            "router": self.router.report(),
            "replicas": {
                str(r.replica_id): r.report()
                for r in sorted(self.replicas + self._draining,
                                key=lambda r: r.replica_id)},
            "completions": self.log,
            "fleet_counters": metrics.fleet_board().snapshot_since(
                board_before),
            "ok": len(self.log) == len(self.trace),
        }
        if self.preemptions:
            report["preemptions"] = self.preemptions
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
