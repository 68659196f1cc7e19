"""The fleet loop: trace -> router -> replicas -> SLO.

The port's copy of ``kind_tpu_sim/fleet/sim.py``. One virtual-clock
loop: arrivals due at a tick boundary enter the router (or shed), the
router places its queue by policy, every replica advances one tick,
completions stream into the SLO tracker and the completion log, and the
autoscaler gets one observation an evaluation interval. Chaos events
(replica preemption and restore, slowdown) fire at planned virtual times
and displaced requests requeue at the router.

A replica is what ``replica_factory(replica_id)`` builds: an
:class:`EngineReplica` around one of the port's engines (``engine_fleet``
builds such a fleet; an engine runs one ``step_round()`` a tick), or,
with no factory, the analytic ``SimReplica`` of ``FleetConfig.sim``
(no device work: its slots run in closed form on the virtual clock).

Seven layers ride the loop when their :class:`FleetConfig` field is set:

* ``sched`` (a :class:`FleetSchedConfig`): every replica is a gang that
  ``kind_tpu_sim_torch.sched.ClusterScheduler`` places on a node
  inventory. A node drain or failure, a gray migration or an integrity
  quarantine evicts the gang: its engine fails (its streams requeue at
  the router's front) and heals ``bind_s`` + warm-up after the gang
  rebinds; a scale-up is bound through the scheduler. ``link_degrade``
  on an ICI domain slows every engine placed there
  (``collectives.ici_slowdown``), and ``domain_fault`` fails a whole
  rack (``rack_pods``).
* ``training`` (a ``training.TrainingConfig``, needs ``sched``):
  analytic training gangs placed under serving at a lower priority;
  serving gangs preempt them, and they checkpoint, resume and finish
  with a verified progress ledger.
* ``health`` (a ``health.DetectorConfig``): the gray-failure detector
  reads each completion's time per output token; quarantined replicas
  leave the router's candidates (and, under ``sched``, their gangs
  migrate off the suspect nodes one at a time), and suspect or
  quarantined ones get a probe request every ``probe_interval_s`` while
  traffic flows, until clean probes restore them.
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
  the replica to quarantine (under ``sched``, one chip of its node
  leaves the inventory and the gang rebinds). An analytic replica made
  defective by ``sdc_chip`` chaos corrupts a share of its fingerprints.
* ``disagg`` (a ``disagg.DisaggConfig``, analytic replicas only):
  prefill and decode pools priced from the cost model's calibration
  (the H100's unless KIND_TPU_SIM_CALIBRATION or the ``calibration``
  argument names another). A prefilled request ships its KV cache to
  the decode pool over a modeled link (the KV-transfer lane); with
  ``autoscale`` each pool scales on its own signal (TTFT for prefill,
  ITL or backlog for decode); chaos takes out the prefill pool or
  degrades the link.
* ``zoo`` (a ``zoo.ZooConfig``) and ``generations`` (generation names,
  cycled over replica ids): every replica is an analytic ``SimReplica``
  priced from its generation's calibration (``costmodel.load_generation``;
  the port registers ``h100``, and a scheduler-backed fleet takes the
  generation of ``FleetSchedConfig.replica_accelerator``, which for
  every label is ``h100``). With a zoo each generation warms the largest
  model it fits (``zoo.placements``), requests route warm first, a cold
  admission pays the model's swap time, the swaps land in a ledger on
  the model-swap lane, and ``model_swap_evict`` chaos drops every
  resident model. The report gains ``generations`` and ``zoo``. Neither
  composes with a replica factory or with ``disagg``.

Four execution strategies give byte-identical reports, as in the
reference: the event core (``event_core``, default on, knob
KIND_TPU_SIM_FLEET_EVENT_CORE) steps only the tick boundaries where
something can happen; without it the plain per-tick loop runs, with the
idle-gap fast-forward (``fast_forward``, default on, knob
KIND_TPU_SIM_FLEET_FF) or without. Across skipped boundaries the clock
takes the same tick-sized float additions; an analytic replica's
closed-form next events (``SimReplica.next_due``) tell the event core
which boundaries it may skip. For a given config, trace, events and
weights, :meth:`FleetSim.run` returns the reference's report. The
fourth is the columnar mirror of an analytic fleet (``columnar``, knob
KIND_TPU_SIM_FLEET_COLUMNAR, engaged by the knob from
``columnar.COLUMNAR_MIN_REPLICAS`` replicas on): the wake scan, the tick
fan-out, quiescence and least-outstanding routing read numpy columns
(``fleet/columnar.py``), and every scale event rebuilds them.

Knobs: KIND_TPU_SIM_FLEET_TICK_S (``resolve_tick_s``),
KIND_TPU_SIM_SDC_AUDIT_FRAC (``resolve_audit_frac``),
KIND_TPU_SIM_SDC_RATE, KIND_TPU_SIM_CALIBRATION,
KIND_TPU_SIM_GENERATION (``zoo.resolve_generation``),
KIND_TPU_SIM_ZOO_SWAP_FACTOR (``zoo.swap_s``).
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.fleet import knobs
from kind_tpu_sim_torch.fleet.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    resolve_warmup_s,
)
from kind_tpu_sim_torch.fleet.columnar import (
    COLUMNAR_MIN_REPLICAS,
    FleetColumns,
    resolve_columnar,
)
from kind_tpu_sim_torch.fleet.costmodel import (
    CostModel,
    generation_of_accelerator,
    kv_bytes_per_token,
    load_calibration,
    load_generation,
)
from kind_tpu_sim_torch.fleet.disagg import (
    DisaggConfig,
    KvHandoff,
    calibrated_sim_config,
    kv_transfer_s,
)
from kind_tpu_sim_torch.fleet.events import (
    LANE_ARRIVAL,
    LANE_AUTOSCALER,
    LANE_CHAOS,
    LANE_COMPLETION,
    LANE_INTEGRITY_AUDIT,
    LANE_KV_TRANSFER,
    LANE_MODEL_SWAP,
    DueSet,
    EventHeap,
    resolve_event_core,
)
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
    SimReplica,
    SimReplicaConfig,
)
from kind_tpu_sim_torch.fleet.slo import SloPolicy, SloTracker
from kind_tpu_sim_torch.fleet.tenancy import (
    TenancyConfig,
    TenancyState,
    tenant_of,
)
from kind_tpu_sim_torch.fleet.training import (
    TrainingConfig,
    TrainingTenant,
)
from kind_tpu_sim_torch.health import DetectorConfig, FailureDetector
from kind_tpu_sim_torch.parallel import collectives


def resolve_tick_s(value: Optional[float] = None) -> float:
    """``value``, else KIND_TPU_SIM_FLEET_TICK_S, else 0.01 virtual
    seconds."""
    if value is not None:
        return float(value)
    return float(knobs.get(knobs.FLEET_TICK_S))


def resolve_fast_forward(value: Optional[bool] = None) -> bool:
    """``value``, else KIND_TPU_SIM_FLEET_FF, else on: the plain loop
    skips the per-tick work across provably idle gaps."""
    if value is not None:
        return bool(value)
    return bool(knobs.get(knobs.FLEET_FF))


def resolve_audit_frac(value: Optional[float] = None) -> float:
    """``value``, else KIND_TPU_SIM_SDC_AUDIT_FRAC, else 0 (the audit
    lane off), clamped to [0, 1]."""
    if value is None:
        value = knobs.get(knobs.SDC_AUDIT_FRAC)
    return max(0.0, min(1.0, float(value)))


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """A fleet-level fault at virtual time ``at_s``: ``preempt``
    displaces replica ``target``'s whole load and ``restore`` heals it;
    ``slow`` steps it every ``param``-th tick (``unslow`` undoes it);
    ``sdc_chip`` makes an analytic replica's chip defective (it corrupts
    the share ``param`` of its completions until an integrity quarantine
    pulls it; an engine replica has no corruption model, and the event
    is only recorded). With ``FleetConfig.sched``: ``node_drain`` /
    ``node_fail`` cordon or break node index ``target`` and evict its
    gangs, ``node_restore`` heals it; ``link_degrade`` sets ICI domain index
    ``target``'s link factor to ``param`` (``link_restore`` heals it);
    ``domain_fault`` / ``domain_restore`` fail or heal every node of
    one rack (``FleetSchedConfig.rack_pods``). With
    ``FleetConfig.training``: ``train_preempt`` / ``train_kill``
    preempt gang ``target`` gracefully or hard, and ``sdc_train_chip``
    plants a defect on one of its chips. With ``FleetConfig.disagg``:
    ``prefill_pool_loss`` / ``prefill_pool_restore`` fail or heal every
    prefill replica, ``kv_degrade`` scales the KV link's bandwidth by
    ``param`` for transfers that start later (``kv_restore`` heals it).
    With ``FleetConfig.zoo``: ``model_swap_evict`` drops every replica's
    resident model (one pulse of a swap storm)."""

    at_s: float
    action: str
    target: int
    param: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FleetSchedConfig:
    """Scheduler-backed placement: every replica is a gang of
    ``replica_topology`` on ``replica_accelerator``, placed by the
    cluster scheduler (``policy``) on an inventory of ``pods`` at
    ``priority``; a placement costs ``bind_s``, then the replica warms
    up. ``ici_fraction`` is the share of service time in ICI
    collectives that a degraded link inflates (and the warm-up on a
    rebind); ``rack_pods`` groups that many consecutive pods into one
    failure domain (None: ungrouped). The reference's fields and
    defaults, in order."""

    pods: tuple = (("tpu-v5-lite-podslice", "4x8"),)
    policy: str = "ici"
    bind_s: float = 0.05
    replica_accelerator: str = "tpu-v5-lite-podslice"
    replica_topology: str = "2x4"
    priority: int = 10
    zone: str = "zone-a"
    ici_fraction: float = 0.35
    rack_pods: Optional[int] = None

    def as_dict(self) -> dict:
        out = {
            "pods": [list(p) for p in self.pods],
            "policy": self.policy,
            "bind_s": self.bind_s,
            "replica_accelerator": self.replica_accelerator,
            "replica_topology": self.replica_topology,
            "priority": self.priority,
            "ici_fraction": self.ici_fraction,
            "zone": self.zone,
        }
        if self.rack_pods is not None:
            out["rack_pods"] = self.rack_pods
        return out


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The reference's fleet config, every field in order with its
    default. ``zoo`` (a ``zoo.ZooConfig``), ``generations`` (a tuple of
    registered generation names) and ``zoo_large_model_gen`` (the
    generation whose replicas warm the zoo's largest model) configure
    the model zoo and per-generation pricing. ``fast_forward``,
    ``event_core`` and ``columnar`` choose how the loop runs, not what
    it computes, and stay out of :meth:`as_dict`."""

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
    sched: Optional[FleetSchedConfig] = None
    health: Optional[DetectorConfig] = None
    overload: Optional[OverloadConfig] = None
    training: Optional[TrainingConfig] = None
    disagg: Optional[DisaggConfig] = None
    tenancy: Optional[TenancyConfig] = None
    zoo: Optional[object] = None
    generations: Optional[tuple] = None
    zoo_large_model_gen: Optional[str] = None
    fast_forward: Optional[bool] = None  # None -> resolve_fast_forward()
    event_core: Optional[bool] = None    # None -> resolve_event_core()
    audit_frac: Optional[float] = None  # None -> resolve_audit_frac()
    columnar: Optional[bool] = None

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
        for name in ("sched", "health", "overload", "training", "disagg",
                     "tenancy", "zoo"):
            layer = getattr(self, name)
            if layer is not None:
                out[name] = layer.as_dict()
        if self.generations is not None:
            out["generations"] = list(self.generations)
        if self.zoo_large_model_gen is not None:
            out["zoo_large_model_gen"] = self.zoo_large_model_gen
        if self.audit_frac is not None:
            out["audit_frac"] = self.audit_frac
        return out


_DISAGG_CHAOS = ("prefill_pool_loss", "prefill_pool_restore",
                 "kv_degrade", "kv_restore")


def _is_probe(request_id: str) -> bool:
    return request_id.startswith("__probe-")


def _is_audit_copy(request_id: str) -> bool:
    return "~a" in request_id


class FleetSim:
    """One fleet run. ``replica_factory(replica_id)`` builds a replica
    (an :class:`EngineReplica` around an engine whose ``clock`` is
    ``clock.now``); without one every replica is a ``SimReplica`` of
    ``cfg.sim``. A disaggregated fleet (``cfg.disagg``) builds its own
    phased replicas, priced from ``calibration`` (a cost-model
    calibration dict; default: ``costmodel.load_calibration()``); a zoo
    or generation fleet builds replicas priced from its generations'
    files."""

    def __init__(self, cfg: FleetConfig,
                 trace: Sequence[TraceRequest],
                 replica_factory: Optional[Callable[[int], object]] = None,
                 chaos_events: Sequence[ChaosEvent] = (),
                 clock: Optional[VirtualClock] = None,
                 calibration: Optional[dict] = None):
        self.cfg = cfg
        self.clock = clock or VirtualClock()
        self.trace = sorted(trace, key=lambda r: (r.arrival_s, r.request_id))
        self._disagg = (cfg.disagg if cfg.disagg is not None
                        and cfg.disagg.enabled else None)
        self._cost = None
        self._disagg_sim_cfg = cfg.sim
        if self._disagg is not None:
            dis = self._disagg
            if cfg.sched is not None:
                raise ValueError(
                    "FleetConfig.disagg is incompatible with a "
                    "scheduler-backed fleet (FleetConfig.sched)")
            want = dis.prefill_replicas + dis.decode_replicas
            if cfg.replicas != want:
                raise ValueError(
                    f"FleetConfig.replicas={cfg.replicas} must equal "
                    f"the disagg pool sum {dis.prefill_replicas}+"
                    f"{dis.decode_replicas}={want}")
            if replica_factory is not None:
                raise ValueError(
                    "a disagg fleet builds its own phased replicas; "
                    "replica_factory is not supported")
            cal = (calibration if calibration is not None
                   else load_calibration())
            self._cost = CostModel(cal)
            self._kv_per_tok = kv_bytes_per_token(cal["geometry"],
                                                  dis.dtype)
            if dis.calibrated:
                self._disagg_sim_cfg = calibrated_sim_config(
                    cal, dis.dtype, max_slots=cfg.sim.max_slots,
                    max_queue=cfg.sim.max_queue,
                    prefix_cache_entries=cfg.sim.prefix_cache_entries)
            p = dis.prefill_replicas
            self.replicas = [
                SimReplica(i, self._disagg_sim_cfg,
                           phase="prefill" if i < p else "decode")
                for i in range(cfg.replicas)]
        # the model zoo and per-generation pricing: every replica is an
        # analytic one priced from its generation's calibration
        self._zoo = cfg.zoo
        self._generations: Optional[List[str]] = None
        self._gen_cals: Dict[str, dict] = {}
        self._gen_residents: Dict[str, str] = {}
        self._swap_heap = EventHeap()
        self._swap_log: List[dict] = []
        self._model_trackers: Dict[str, SloTracker] = {}
        if self._zoo is not None or cfg.generations is not None:
            from kind_tpu_sim_torch.fleet import zoo as zoo_mod

            if replica_factory is not None:
                raise ValueError(
                    "a zoo/generation fleet builds its own "
                    "calibrated replicas; replica_factory is not "
                    "supported")
            if self._disagg is not None:
                raise ValueError(
                    "FleetConfig.zoo/generations do not compose "
                    "with disagg phase pools yet (phase pools price "
                    "off the cost model's calibration)")
            if cfg.sched is not None:
                gens = (generation_of_accelerator(
                    cfg.sched.replica_accelerator),)
            elif cfg.generations:
                gens = tuple(cfg.generations)
            else:
                gens = (zoo_mod.resolve_generation(),)
            self._gen_cycle = gens
            self._generations = [gens[i % len(gens)]
                                 for i in range(cfg.replicas)]
            self._gen_cals = {g: load_generation(g)
                              for g in sorted(set(gens))}
            if self._zoo is not None:
                uniq = sorted(set(gens))
                self._gen_residents = dict(zip(
                    uniq, zoo_mod.placements(
                        self._zoo, uniq,
                        large_model_gen=cfg.zoo_large_model_gen)))
        self.factory = replica_factory or (
            lambda rid: SimReplica(rid, cfg.sim))
        if self._generations is not None:
            self.factory = self._make_gen_replica
        if self._disagg is None:
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
                             overload=self.overload,
                             disagg=self._disagg is not None,
                             tenancy=self.tenancy,
                             zoo=self._zoo is not None)
        for replica in self.replicas:
            self._install_tenant_caps(replica)
        if self.overload is not None:
            self.router.on_place = self._on_place
        # the columnar mirror, on analytic fleets only (no factory: every
        # replica a SimReplica, disaggregated and zoo fleets included)
        self._cols: Optional[FleetColumns] = None
        if replica_factory is None and (
                cfg.columnar is True
                or (resolve_columnar(cfg.columnar)
                    and cfg.replicas >= COLUMNAR_MIN_REPLICAS)):
            self._cols = FleetColumns(self.replicas)
            self.router._columns = self._cols
        self.chaos_events = sorted(chaos_events,
                                   key=lambda e: (e.at_s, e.target))
        self.tracker = SloTracker(cfg.slo,
                                  track_itl=self._disagg is not None)
        self.autoscaler = (Autoscaler(cfg.autoscaler)
                           if cfg.autoscale and self._disagg is None
                           else None)
        # a disaggregated fleet scales each pool on its own signal,
        # never below its declared size
        self._pool_scalers: Optional[Dict[str, Autoscaler]] = None
        if self._disagg is not None and cfg.autoscale:
            dis = self._disagg
            self._pool_scalers = {
                "prefill": Autoscaler(dataclasses.replace(
                    cfg.autoscaler, min_replicas=dis.prefill_replicas)),
                "decode": Autoscaler(dataclasses.replace(
                    cfg.autoscaler, min_replicas=dis.decode_replicas)),
            }
        # KV transfers in flight between the pools, at their delivery
        # time; ``kv_degrade`` scales the link for transfers scheduled
        # after it
        self._kv_heap = EventHeap()
        self._kv_factor = 1.0
        self._prefill_done_ids: set = set()
        # ids whose KV transfer a globe cell cancelled while it was on the
        # wire: the heap has no removal, so the transfer is dropped when
        # it is delivered
        self._kv_cancelled: set = set()
        self._kv_handoffs = 0
        self._kv_bytes_total = 0
        self._kv_transfer_s_total = 0.0
        # the pools' scaling signals: TTFT and ITL attainment
        self._recent_ttft = deque(maxlen=64)
        self._recent_itl = deque(maxlen=64)
        self.log: List[dict] = []
        # a globe cell's hook: called with (log entry, ReplicaCompletion)
        # for every completion as it is recorded
        self.on_complete: Optional[Callable] = None
        # recent attained flags: the autoscaler's SLO signal
        self._recent = deque(maxlen=64)
        self._next_replica_id = cfg.replicas
        # replicas paid for but not yet routable: (replica, reason) at
        # their ready time
        self._warming = EventHeap()
        # gang-evicted replicas awaiting their rebind and warm-up
        self._rebinding = EventHeap()
        self._draining: List = []
        self.preemptions = 0
        self.sched = None
        self._now = 0.0
        self._ticks = 0
        self._pending = deque(self.trace)
        self._fast_forward = resolve_fast_forward(cfg.fast_forward)
        self._event_core = resolve_event_core(cfg.event_core)
        tick_s = resolve_tick_s(cfg.tick_s)
        if cfg.eval_every_s is not None:
            eval_every_s = cfg.eval_every_s
        elif cfg.eval_every_ticks is not None:
            eval_every_s = cfg.eval_every_ticks * tick_s
        else:
            eval_every_s = 10 * tick_s
        self._eval_ticks = max(1, int(round(eval_every_s / tick_s)))
        # after a wake scan that steps the next boundary anyway, skip
        # the scan for a few boundaries (doubling, capped at 32): a cost
        # heuristic only, since stepping a boundary is always exact
        self._scan_holdoff = 0
        self._scan_backoff = 1
        # gray failures: replicas a `slow` event or a degraded ICI
        # domain slows (the ground truth false positives are judged
        # against), the probes, and quarantined gangs awaiting migration
        self._slow_factor: Dict[int, float] = {}
        self._link_slow: set = set()
        self._probe_last: Dict[str, float] = {}
        self._probe_n: Dict[str, int] = {}
        self._migrate_pending: List[int] = []
        # overload: retries and hedge timers on the virtual clock
        self._retry_heap = EventHeap()   # retried requests at their arrival
        self._hedge_heap = EventHeap()   # (request, primary) at hedge time
        self._attempts: Dict[str, int] = {}
        self._hedges: Dict[str, dict] = {}
        self._hedge_dropped: set = set()
        self._completed_ids: set = set()
        # the audit lane: audits due (base ids), open audits, and each
        # quarantined replica's detection time
        self._audit_frac = resolve_audit_frac(cfg.audit_frac)
        if self._audit_frac > 0.0 and self._disagg is not None:
            raise ValueError(
                "FleetConfig.audit_frac does not compose with "
                "disagg phase pools: audit copies are whole-request "
                "re-executions on unified replicas")
        self._audit_heap = EventHeap()
        self._audits: Dict[str, dict] = {}
        self._sdc_detect_s: Dict[int, float] = {}
        self._sdc_active = self._audit_frac > 0.0
        # training gangs co-scheduled under serving
        self.trainer: Optional[TrainingTenant] = None
        if cfg.sched is not None:
            self._init_scheduler(cfg.sched)
        if cfg.training is not None:
            if self.sched is None:
                raise ValueError(
                    "FleetConfig.training needs a scheduler-backed "
                    "fleet (set FleetConfig.sched): training gangs "
                    "are scheduler-placed workloads")
            self.trainer = TrainingTenant(cfg.training, self.sched)

    # -- the model zoo and per-generation pricing ----------------------

    def _gen_of(self, rid: int) -> str:
        """The generation replica ``rid`` prices as: the declared cycle,
        so scale-ups join it too."""
        return self._gen_cycle[rid % len(self._gen_cycle)]

    def _make_gen_replica(self, rid: int) -> SimReplica:
        """A replica priced from its generation's calibration; in a zoo
        fleet it carries the per-model prices, warms its generation's
        placement and reports its swaps to the swap lane."""
        from kind_tpu_sim_torch.fleet import zoo as zoo_mod

        gen = self._gen_of(rid)
        cal = self._gen_cals[gen]
        sim = self.cfg.sim
        if self._zoo is not None:
            rcfg = zoo_mod.model_sim_config(
                self._zoo, cal, max_slots=sim.max_slots,
                max_queue=sim.max_queue,
                prefix_cache_entries=sim.prefix_cache_entries,
                resident_model=self._gen_residents[gen])
        else:
            rcfg = calibrated_sim_config(
                cal, max_slots=sim.max_slots, max_queue=sim.max_queue,
                prefix_cache_entries=sim.prefix_cache_entries)
        replica = SimReplica(rid, rcfg)
        if self._zoo is not None:
            replica.on_swap = self._on_swap
        return replica

    def _on_swap(self, ev) -> None:
        """A replica began loading a model: the load's latency is already
        in the admitted slot's timeline, so the swap lane's event is
        bookkeeping, drained into the ledger in (ready, lane, seq)
        order."""
        self._swap_heap.push(ev.ready_s, LANE_MODEL_SWAP, ev)
        metrics.zoo_board().incr("model_swaps")

    # -- scheduler-backed placement ------------------------------------

    def _init_scheduler(self, sc: FleetSchedConfig) -> None:
        """Replicas become gangs on the inventory: the initial fleet
        binds at t=0 (an inventory that cannot place it is a config
        error), scale-ups queue through the scheduler, and evictions
        fail the engine of the evicted gang."""
        from kind_tpu_sim_torch import sched as sched_mod

        self.sched = sched_mod.ClusterScheduler(
            sched_mod.build_inventory(list(sc.pods), zone=sc.zone,
                                      rack_pods=sc.rack_pods),
            sched_mod.SchedConfig(policy=sc.policy, bind_s=sc.bind_s),
            on_evict=self._on_gang_evict)
        self._sched_cfg = sc
        self._gang_replica: Dict[str, int] = {}
        # gangs whose bind is awaited: name -> requested at
        self._gang_requested: Dict[str, float] = {}
        self.time_to_routable: List[float] = []
        for replica in self.replicas:
            name = f"replica-{replica.replica_id}"
            self.sched.submit(self._gang_request(name), 0.0)
            self._gang_replica[name] = replica.replica_id
        bound = self.sched.step(0.0)
        if len(bound) < len(self.replicas):
            raise ValueError(
                f"inventory cannot place the initial "
                f"{len(self.replicas)} replica(s); {len(bound)} bound")

    def _gang_request(self, name: str):
        from kind_tpu_sim_torch import sched as sched_mod

        sc = self._sched_cfg
        return sched_mod.SliceRequest(
            name=name, accelerator=sc.replica_accelerator,
            topology=sc.replica_topology, priority=sc.priority)

    def _replica_by_id(self, rid: int):
        for r in self.replicas + self._draining:
            if r.replica_id == rid:
                return r
        return None

    def _on_gang_evict(self, request) -> None:
        """A scheduler eviction: a training gang checkpoints (or, moved
        by defrag, repartitions); a serving gang's engine fails, its
        streams requeue at the router's front, and it heals only after
        its rebind and warm-up."""
        if self.trainer is not None and self.trainer.owns(request.name):
            bound = self.sched.bound.get(request.name)
            if bound is not None:
                # defrag moved the gang, which is already rebound
                dom = self.sched.inv.domains[bound.placement.domain]
                self.trainer.on_migrated(
                    request.name, self._now, dom.link_factor,
                    self._sched_cfg.bind_s)
            else:
                self.trainer.on_evicted(request.name, self._now)
            return
        rid = self._gang_replica.get(request.name)
        if rid is None:
            return
        victim = self._replica_by_id(rid)
        now = self._now
        if victim is not None and victim.healthy:
            displaced = victim.fail(now)
            self._requeue_front(displaced)
            self.preemptions += 1
            metrics.fleet_board().incr("replica_preemptions")
            metrics.recovery_log().record(
                "fleet_gang_evict", gang=request.name,
                displaced=len(displaced), at_s=round(now, 6))
        self._gang_requested[request.name] = now

    def _sched_step(self, now: float) -> None:
        """Bind pending gangs: a bound serving gang is routable
        ``bind_s`` + warm-up later (the warm-up inflated by its
        domain's link state); an evicted engine heals then, and a
        scale-up's new engine joins then."""
        if not self.sched.pending:
            return
        warmup = (self.autoscaler.warmup_s
                  if self.autoscaler is not None
                  else resolve_warmup_s())
        for gang in self.sched.step(now):
            name = gang.request.name
            if self.trainer is not None and self.trainer.owns(name):
                dom = self.sched.inv.domains[gang.placement.domain]
                self.trainer.on_bound(name, now, dom.link_factor,
                                      self._sched_cfg.bind_s)
                continue
            requested = self._gang_requested.pop(name, now)
            dom = self.sched.inv.domains[gang.placement.domain]
            warm_mult = collectives.ici_slowdown(
                dom.link_factor, self._sched_cfg.ici_fraction)
            ready_at = (now + self._sched_cfg.bind_s
                        + warmup * warm_mult)
            ttr = round(ready_at - requested, 6)
            self.time_to_routable.append(ttr)
            rid = self._gang_replica[name]
            existing = self._replica_by_id(rid)
            if existing is not None:
                # an evicted engine rebound: the same object heals
                self._rebinding.push(ready_at, LANE_CHAOS, existing)
            else:
                # a scale-up: a new engine warms up
                self._warming.push(
                    ready_at, LANE_AUTOSCALER,
                    (self.factory(rid),
                     f"bound+warm (time_to_routable={ttr}s)"))

    def _apply_node_chaos(self, ev: ChaosEvent, now: float) -> None:
        from kind_tpu_sim_torch import sched as sched_mod

        names = sorted(self.sched.inv.nodes)
        node = names[ev.target % len(names)]
        sched_mod.apply_node_event(self.sched, ev.action, node, now)
        if ev.action in ("node_drain", "node_fail"):
            metrics.recovery_log().record(
                f"fleet_{ev.action}", node=node, at_s=round(now, 6))

    def _apply_domain_chaos(self, ev: ChaosEvent, now: float) -> None:
        """A correlated failure: one event fails (or heals) every node
        of one rack failure domain."""
        from kind_tpu_sim_torch import sched as sched_mod

        fds = self.sched.inv.failure_domains()
        if not fds:
            raise ValueError(
                "domain chaos needs correlated failure domains "
                "(set FleetSchedConfig.rack_pods)")
        fd = fds[ev.target % len(fds)]
        action = ("node_fail" if ev.action == "domain_fault"
                  else "node_restore")
        nodes = self.sched.inv.failure_domain_nodes(fd)
        for node in nodes:
            sched_mod.apply_node_event(self.sched, action, node, now)
        self._sdc_active = True
        metrics.integrity_board().incr(
            "domain_faults" if action == "node_fail"
            else "domain_restores")
        metrics.recovery_log().record(
            f"fleet_{ev.action}", failure_domain=fd,
            nodes=len(nodes), at_s=round(now, 6))

    def _apply_link_chaos(self, ev: ChaosEvent, now: float) -> None:
        from kind_tpu_sim_torch import sched as sched_mod

        domains = sorted(self.sched.inv.domains)
        domain = domains[ev.target % len(domains)]
        if ev.action == "link_degrade":
            sched_mod.apply_link_event(
                self.sched, "link_degrade", domain,
                max(1e-3, ev.param), now)
            metrics.recovery_log().record(
                "fleet_link_degrade", domain=domain,
                factor=ev.param, at_s=round(now, 6))
        else:
            sched_mod.apply_link_event(
                self.sched, "link_restore", domain, 1.0, now)
            # the fault is gone: lift the avoid marks gray migrations
            # left on the domain's nodes
            for node in self.sched.inv.domains[domain].nodes.values():
                self.sched.inv.mark_avoid(node.name, False)
        self._refresh_link_slowdowns(now)

    def _refresh_link_slowdowns(self, now: float) -> None:
        """Every placed engine's slowdown from its ICI domain's link
        state (or an explicit `slow`, whichever is larger), the set of
        link-slowed replicas, and each training gang's ring rate."""
        self._link_slow = set()
        sc = self._sched_cfg
        for name, gang in sorted(self.sched.bound.items()):
            rid = self._gang_replica.get(name)
            if rid is None:
                if self.trainer is not None and self.trainer.owns(name):
                    # the gang's ring slows or heals: a rate change, no
                    # checkpoint
                    self.trainer.gangs[name].reprice(
                        now,
                        self.sched.inv.domains[
                            gang.placement.domain].link_factor)
                continue
            replica = self._replica_by_id(rid)
            if replica is None:
                continue
            mult = collectives.ici_slowdown(
                self.sched.inv.domains[gang.placement.domain]
                .link_factor, sc.ici_fraction)
            if mult > 1.0:
                self._link_slow.add(rid)
            replica.set_slowdown(
                max(mult, self._slow_factor.get(rid, 1.0)))

    # -- gray failures -------------------------------------------------

    def _gray_truth(self) -> set:
        return set(self._slow_factor) | self._link_slow

    def _on_health_transition(self, rid: int, transition: str,
                              now: float) -> None:
        if transition != "quarantined":
            return
        metrics.recovery_log().record(
            "fleet_replica_quarantine", replica=rid, at_s=round(now, 6))
        if rid not in self._gray_truth():
            # detection fired on a replica nothing degrades
            metrics.health_board().incr("false_positives")
        if self.sched is not None:
            self._migrate_pending.append(rid)

    def _drain_migrations(self, now: float) -> None:
        """At most one gray migration in flight: a quarantined replica
        waiting its turn keeps serving its work (slowly)."""
        if not self._migrate_pending:
            return
        if self._rebinding or self._gang_requested:
            return  # a migration or rebind is already in flight
        rid = self._migrate_pending.pop(0)
        if (self.health is not None
                and not self.health.quarantined(f"replica-{rid}")):
            return  # restored in the meantime
        self._migrate_gang(rid, now)

    def _migrate_gang(self, rid: int, now: float) -> None:
        """Move a quarantined replica's gang off the suspect nodes:
        mark them avoid and evict the gang (its engine fails and its
        streams requeue); the next scheduling pass rebinds it, scoring
        degraded domains and avoided nodes last."""
        name = f"replica-{rid}"
        gang = self.sched.bound.get(name)
        if gang is None:
            return
        for node in gang.placement.node_names:
            self.sched.inv.mark_avoid(node, True)
        self.sched.evict_gang(
            name, now,
            reason="gray: replica quarantined by the failure "
                   "detector; migrating off suspect hardware")
        metrics.health_board().incr("gray_migrations")

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

    def _install_tenant_caps(self, replica) -> None:
        """An analytic replica's per-tenant prefix-cache caps (the KV
        budget on the cache's stand-in): only under isolation, and only
        for tenants whose ``kv_budget_frac`` is below 1."""
        ten = self.tenancy
        if ten is None or not ten.isolation:
            return
        rcfg = getattr(replica, "cfg", None)
        if rcfg is None or not hasattr(rcfg, "prefix_cache_entries"):
            return
        entries = rcfg.prefix_cache_entries
        if entries <= 0:
            return
        caps: Dict[str, int] = {}
        for t in ten.cfg.tenants:
            cap = ten.kv_budget(t.name, entries)
            if cap is not None:
                caps[t.name] = cap
        if caps:
            replica.tenant_prefix_caps = caps

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
        self._hedge_heap.push(now + ov.hedge_delay_s(), LANE_COMPLETION,
                              (req, replica))

    def _fire_hedges(self, now: float) -> None:
        """Due hedge timers: a request still in flight gets a copy on the
        next candidate, if the hedge budget allows. A timer outlives a
        preemption that requeued its request onto another replica: a
        candidate that holds the request already is skipped (an engine
        would refuse the duplicate id), and the pair's primary is the
        replica of the primary's phase that holds the live copy, so the
        first completion cancels the right loser (ROADMAP C-17). (A
        prefilled request that moved on to the decode pool keeps its
        prefill replica as the primary, as in the reference.)"""
        ov = self.overload
        for req, primary in self._hedge_heap.pop_due(now):
            rid = req.request_id
            if rid in self._completed_ids or rid in self._hedges:
                continue
            if not ov.hedge_enabled():
                continue
            if not ov.spend_hedge(self._tenant_key(req)):
                continue
            holder = primary
            if not primary.holds(rid):
                phase = getattr(primary, "phase", "unified")
                holder = next((r for r in self.replicas + self._draining
                               if getattr(r, "phase", "unified") == phase
                               and r.holds(rid)), primary)
            for cand in self.router._pick_order(req, now):
                if cand is primary or cand.holds(rid):
                    continue
                if cand.submit(req, now):
                    self._hedges[rid] = {"primary": holder, "hedge": cand}
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
        detector and an audit copy the vote, never the SLO log; a
        prefill-pool replica's ``prefill_done`` starts a KV transfer;
        user traffic goes through the overload filters to the log. (The
        reference logs a probe that finishes on a draining replica as
        user traffic: ROADMAP C-14.)"""
        rid = comp.request.request_id
        if _is_probe(rid):
            self._observe_health(replica.replica_id, comp, now)
        elif _is_audit_copy(rid):
            self._on_audit_result(replica, comp)
        elif comp.finish_reason == "prefill_done":
            # not a terminal outcome: the KV cache leaves for the decode
            # pool, whose completion alone enters the log
            self._on_prefill_done(replica, comp)
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
        self._retry_heap.push(at, LANE_ARRIVAL, dataclasses.replace(
            req, request_id=f"{base}~r{attempt}", arrival_s=at))

    def displace_disagg(self) -> List[TraceRequest]:
        """The whole KV lane, queued handoffs and transfers on the wire,
        back to base requests (each prefills again): a failed globe cell
        loses no work. A transfer cancelled on the wire stays dropped:
        the hedge's winner owns its request."""
        out: List[TraceRequest] = []
        for h in self._kv_heap.pop_due(float("inf")):
            rid = h.request.request_id
            if rid in self._kv_cancelled:
                self._kv_cancelled.discard(rid)
                continue
            out.append(h.request)
        out.extend(h.request for h in self.router.kv_queue)
        self.router.kv_queue = []
        for r in out:
            self._prefill_done_ids.discard(r.request_id)
        return out

    def _requeue_front(self, displaced: List) -> None:
        """Displaced requests back to the router's queue head. An audit
        copy dies with its replica: its audit concludes on the results
        it has. A displaced request may prefill again, so it leaves the
        prefill dedupe set. A displaced copy of a hedged pair whose other
        copy is still held elsewhere is not requeued: the pair dissolves
        and that copy finishes as the request (requeued, the router could
        place it on the replica holding the other copy, and an engine
        refuses the duplicate id: ROADMAP C-19; the reference requeues
        it)."""
        if self._hedges:
            live = self.replicas + self._draining
            kept = []
            for req in displaced:
                rid = getattr(req, "request_id", None)
                if rid in self._hedges and any(r.holds(rid) for r in live):
                    del self._hedges[rid]
                    continue
                kept.append(req)
            displaced = kept
        if self._audits:
            kept = []
            for req in displaced:
                if _is_audit_copy(req.request_id):
                    self._conclude_audit(req.request_id.split("~a", 1)[0])
                else:
                    kept.append(req)
            displaced = kept
        if self._disagg is not None:
            for req in displaced:
                base = (req.request if getattr(req, "is_kv_handoff", False)
                        else req)
                self._prefill_done_ids.discard(base.request_id)
        self.router.requeue_front(displaced)

    # -- disaggregated pools -------------------------------------------

    def _on_prefill_done(self, replica, comp: ReplicaCompletion) -> None:
        """A prefill replica finished a prompt: the KV transfer, priced
        from the prompt's length, goes on the KV-transfer lane to the
        decode pool. A hedge's duplicate is deduped here: a request
        ships one KV cache."""
        rid = comp.request.request_id
        ov = self.overload
        if ov is not None and rid in self._hedge_dropped:
            self._hedge_dropped.discard(rid)
            ov.incr("hedge_late_drops")
            return
        if rid in self._prefill_done_ids or rid in self._completed_ids:
            return
        self._prefill_done_ids.add(rid)
        if ov is not None:
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
        if (not _is_probe(rid) and self.cfg.slo.ttft_s is not None
                and comp.first_s is not None):
            # the prefill pool's scaling signal
            self._recent_ttft.append(
                comp.first_s - comp.request.arrival_s
                <= self.cfg.slo.ttft_s)
        kv_bytes = len(comp.request.prompt) * self._kv_per_tok
        transfer = kv_transfer_s(kv_bytes, self._disagg.tier,
                                 self._kv_factor)
        handoff = KvHandoff(
            request=comp.request, dispatch_s=comp.dispatch_s,
            first_s=comp.first_s, tokens=comp.tokens,
            kv_bytes=kv_bytes, from_replica=replica.replica_id)
        self._kv_heap.push(round(comp.finish_s + transfer, 9),
                           LANE_KV_TRANSFER, handoff)
        self._kv_handoffs += 1
        self._kv_bytes_total += kv_bytes
        self._kv_transfer_s_total += transfer
        metrics.disagg_board().incr("prefills_done")

    def _apply_disagg_chaos(self, ev: ChaosEvent, now: float) -> None:
        if ev.action == "prefill_pool_loss":
            displaced: List[TraceRequest] = []
            lost = 0
            for r in self.replicas:
                if getattr(r, "phase", "unified") == "prefill" and r.healthy:
                    displaced.extend(r.fail(now))
                    lost += 1
            self._requeue_front(displaced)
            self.preemptions += lost
            metrics.disagg_board().incr("prefill_pool_losses")
            metrics.recovery_log().record(
                "fleet_prefill_pool_loss", replicas=lost,
                displaced=len(displaced), at_s=round(now, 6))
        elif ev.action == "prefill_pool_restore":
            healed = 0
            for r in self.replicas:
                if (getattr(r, "phase", "unified") == "prefill"
                        and not r.healthy):
                    r.restore(now)
                    healed += 1
            metrics.recovery_log().record(
                "fleet_prefill_pool_restore", replicas=healed,
                at_s=round(now, 6))
        elif ev.action == "kv_degrade":
            # transfers already on the wire keep their delivery time
            self._kv_factor = max(1e-3, ev.param)
            metrics.disagg_board().incr("kv_degrades")
            metrics.recovery_log().record(
                "fleet_kv_degrade", factor=ev.param, at_s=round(now, 6))
        elif ev.action == "kv_restore":
            self._kv_factor = 1.0
            metrics.recovery_log().record(
                "fleet_kv_restore", at_s=round(now, 6))

    def _pool_members(self, phase: str) -> List:
        return [r for r in self.router.replicas
                if getattr(r, "phase", "unified") == phase]

    def _autoscale_pools(self, now: float) -> None:
        """One evaluation a pool: prefill scales on TTFT attainment and
        the arrival backlog, decode on ITL attainment (queue depth
        without ``slo.itl_s``) and the KV lane's backlog. A scale-down
        drains the pool's highest-id healthy replica."""
        changed = False
        for replica, reason in self._warming.pop_due(now):
            self.replicas.append(replica)
            self.router.replicas.append(replica)
            self._install_tenant_caps(replica)
            changed = True
            phase = getattr(replica, "phase", "unified")
            self._pool_scalers[phase].note_ready(
                now, len(self._pool_members(phase)), reason=reason)
        for phase in ("prefill", "decode"):
            scaler = self._pool_scalers[phase]
            members = self._pool_members(phase)
            routable = sum(
                1 for r in members
                if r.healthy and (self.health is None
                                  or not self.health.quarantined(
                                      f"replica-{r.replica_id}")))
            healthy_out = sum(r.outstanding() for r in members
                              if r.healthy)
            if phase == "prefill":
                backlog = len(self.router.queue) + healthy_out
                recent = list(self._recent_ttft)
            else:
                backlog = (len(self.router.kv_queue) + len(self._kv_heap)
                           + healthy_out)
                recent = list(self._recent_itl)
            attainment = sum(recent) / len(recent) if recent else None
            action = scaler.evaluate(now, routable=routable,
                                     backlog=backlog,
                                     attainment=attainment)
            if action == "scale_up":
                rid = self._next_replica_id
                self._next_replica_id += 1
                self._warming.push(
                    now + scaler.warmup_s, LANE_AUTOSCALER,
                    (SimReplica(rid, self._disagg_sim_cfg, phase=phase),
                     f"{phase} warmup complete"))
                metrics.disagg_board().incr(f"{phase}_scale_ups")
            elif action == "scale_down":
                victims = [r for r in members if r.healthy]
                if not victims:
                    continue
                victim = max(victims, key=lambda r: r.replica_id)
                self.router.replicas.remove(victim)
                self.replicas.remove(victim)
                self._draining.append(victim)
                changed = True
                metrics.disagg_board().incr(f"{phase}_scale_downs")
        if changed and self._cols is not None:
            self._cols.rebuild(self.replicas)

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
        self._audit_heap.push(comp.finish_s, LANE_INTEGRITY_AUDIT, base_id)

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
        caught = False
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
            caught = order[0] in culprits
        if st["corrupted"]:
            # ground truth: a corrupted answer withheld and replaced by
            # the verified copy, or one that reached the user
            if caught:
                st["entry"]["sdc_caught"] = True
                metrics.integrity_board().incr("corrupted_caught")
            else:
                metrics.integrity_board().incr("corrupted_served")

    def _sdc_quarantine(self, rid: int, now: float,
                        cause: str = "audit") -> None:
        """Pull a replica an audit named: the detector holds a sticky
        integrity quarantine on it, and its engine fails (its work
        requeues). On a scheduler-backed fleet one chip of the gang's
        anchor node leaves the inventory and the gang is evicted, to
        rebind elsewhere."""
        if rid in self._sdc_detect_s:
            return
        self._sdc_detect_s[rid] = round(now, 6)
        self._sdc_active = True
        metrics.integrity_board().incr("chips_quarantined")
        metrics.recovery_log().record(
            "fleet_sdc_quarantine", replica=rid, cause=cause,
            at_s=round(now, 6))
        if self.health is not None:
            self.health.record_integrity(f"replica-{rid}", now,
                                         cause=cause)
        name = f"replica-{rid}"
        if self.sched is not None and self.sched.bound.get(name) is not None:
            gang = self.sched.bound[name]
            self.sched.inv.quarantine_chips(
                gang.placement.node_names[0], 1)
            self.sched.evict_gang(
                name, now,
                reason="sdc: integrity quarantine; rebinding off "
                       "the defective chip")
            return
        victim = self._replica_by_id(rid)
        if victim is not None and victim.healthy:
            displaced = victim.fail(now)
            self._requeue_front(displaced)
            self.preemptions += 1
            metrics.recovery_log().record(
                "fleet_sdc_chip_pulled", replica=rid,
                displaced=len(displaced), at_s=round(now, 6))

    def _on_train_sdc(self, verdict: dict, now: float) -> None:
        """A training gang's bisection named its culprit chip: a sticky
        integrity quarantine on the chip, and the chip leaves its
        node's capacity."""
        gang = verdict["gang"]
        chip = verdict["chip"]
        self._sdc_active = True
        metrics.integrity_board().incr("chips_quarantined")
        metrics.recovery_log().record(
            "fleet_sdc_train_quarantine", gang=gang, chip=chip,
            at_s=round(now, 6))
        if self.health is not None:
            self.health.record_integrity(f"{gang}-chip-{chip}", now,
                                         cause="bisection")
        bound = self.sched.bound.get(gang) if self.sched else None
        if bound is not None:
            names = bound.placement.node_names
            per = max(1, bound.placement.chips_per_node)
            node = names[min(chip // per, len(names) - 1)]
            self.sched.inv.quarantine_chips(node, 1)

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
        corrupted = comp.corrupted
        if corrupted:
            entry["corrupted"] = True
            metrics.integrity_board().incr("corrupted_produced")
        self.log.append(entry)
        served = comp.finish_reason not in ("shed", "deadline_exceeded")
        if (self._audit_frac > 0.0 and replica_id >= 0
                and comp.finish_reason == "length"
                and req.request_id not in self._audits
                and self._sampled_for_audit(req.request_id)):
            # into the audit lane: a second replica executes it again
            self._audits[req.request_id] = {
                "req": req, "entry": entry, "corrupted": corrupted,
                "results": {replica_id: comp.tokens_crc},
                "order": [replica_id], "copies": 0}
            self._audit_heap.push(comp.finish_s, LANE_INTEGRITY_AUDIT,
                                  req.request_id)
            metrics.integrity_board().incr("audits")
        elif corrupted:
            # not sampled: the wrong answer reaches the user
            metrics.integrity_board().incr("corrupted_served")
        if self._zoo is not None and req.model:
            if req.model not in self._model_trackers:
                self._model_trackers[req.model] = SloTracker(self.cfg.slo)
            self._model_trackers[req.model].observe(**finish)
        if self.tenancy is not None:
            name = tenant_of(req)
            if name not in self._tenant_trackers:
                self._tenant_trackers[name] = SloTracker(self.cfg.slo)
            self._tenant_trackers[name].observe(**finish)
        if self.health is not None and replica_id >= 0 and served:
            self._observe_health(replica_id, comp, self._now)
        if (self._disagg is not None and self.cfg.slo.itl_s is not None
                and comp.first_s is not None and comp.tokens >= 2):
            # the decode pool's scaling signal
            itl = (comp.finish_s - comp.first_s) / (comp.tokens - 1)
            self._recent_itl.append(itl <= self.cfg.slo.itl_s)
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
        if self.on_complete is not None:
            self.on_complete(self.log[-1], comp)

    def _backlog(self) -> int:
        if self._cols is not None:
            return (len(self.router.queue)
                    + self._cols.healthy_outstanding())
        return (len(self.router.queue)
                + sum(r.outstanding() for r in self.replicas if r.healthy))

    def _apply_chaos(self, now: float) -> None:
        while self.chaos_events and self.chaos_events[0].at_s <= now:
            ev = self.chaos_events.pop(0)
            if ev.action == "model_swap_evict":
                # one storm pulse: every resident model is dropped, so the
                # next request each replica admits pays a full load
                if self._zoo is None:
                    raise ValueError(
                        f"{ev.action} chaos needs a model zoo "
                        "(FleetConfig.zoo)")
                evicted = 0
                for r in self.replicas:
                    if getattr(r, "resident_model", ""):
                        r.resident_model = ""
                        evicted += 1
                metrics.recovery_log().record(
                    "fleet_model_swap_evict", evicted=evicted,
                    at_s=round(now, 6))
                continue
            if ev.action in _DISAGG_CHAOS:
                if self._disagg is None:
                    raise ValueError(
                        f"{ev.action} chaos needs a disaggregated fleet "
                        "(FleetConfig.disagg)")
                self._apply_disagg_chaos(ev, now)
                continue
            if ev.action in ("train_preempt", "train_kill"):
                if self.trainer is None:
                    raise ValueError(
                        f"{ev.action} chaos needs a training tenancy "
                        "(FleetConfig.training)")
                self.trainer.apply_chaos(ev.action, ev.target, now)
                continue
            if ev.action == "sdc_train_chip":
                if self.trainer is None:
                    raise ValueError(
                        "sdc_train_chip chaos needs a training tenancy "
                        "(FleetConfig.training)")
                frac = (ev.param if ev.param > 0
                        else float(knobs.get(knobs.SDC_RATE)))
                self._sdc_active = True
                self.trainer.apply_sdc(ev.target, frac, now)
                continue
            if ev.action.startswith(("domain_", "node_", "link_")):
                if self.sched is None:
                    raise ValueError(
                        f"{ev.action} chaos needs a scheduler-backed "
                        "fleet (FleetConfig.sched)")
                if ev.action.startswith("domain_"):
                    self._apply_domain_chaos(ev, now)
                elif ev.action.startswith("node_"):
                    self._apply_node_chaos(ev, now)
                else:
                    self._apply_link_chaos(ev, now)
                continue
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
                if self.sched is not None:
                    # a degraded link may still slow it
                    self._refresh_link_slowdowns(now)
                metrics.recovery_log().record(
                    "fleet_replica_unslow", replica=ev.target,
                    at_s=round(now, 6))
            elif ev.action == "sdc_chip":
                # no heal event: only an integrity quarantine stops it
                frac = (ev.param if ev.param > 0
                        else float(knobs.get(knobs.SDC_RATE)))
                if hasattr(victim, "set_corrupt"):
                    victim.set_corrupt(frac)
                    self._sdc_active = True
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
        changed = False
        # warming replicas come online first
        for replica, reason in self._warming.pop_due(now):
            self.replicas.append(replica)
            self.router.replicas.append(replica)
            self._install_tenant_caps(replica)
            changed = True
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
            if self.sched is not None:
                # routable after queue wait, placement and warm-up
                name = f"replica-{rid}"
                self.sched.submit(self._gang_request(name), now)
                self._gang_replica[name] = rid
                self._gang_requested[name] = now
            else:
                self._warming.push(now + scaler.warmup_s, LANE_AUTOSCALER,
                                   (self.factory(rid), "warmup complete"))
        elif action == "scale_down":
            # drain the highest-id healthy replica: no new traffic,
            # removed once idle
            victim = max((r for r in self.router.replicas if r.healthy),
                         key=lambda r: r.replica_id)
            self.router.replicas.remove(victim)
            self.replicas.remove(victim)
            self._draining.append(victim)
            changed = True
        if changed and self._cols is not None:
            self._cols.rebuild(self.replicas)

    # -- the loop ------------------------------------------------------

    def _step_sched(self, now: float) -> None:
        """The scheduler's part of a boundary: the trainer's arrivals,
        progress and releases, its bisection verdicts, one gray
        migration, the scheduling pass, and the rebound engines that
        heal now."""
        if self.trainer is not None:
            self.trainer.tick(now)
            for verdict in self.trainer.drain_sdc_verdicts():
                self._on_train_sdc(verdict, now)
        self._drain_migrations(now)
        self._sched_step(now)
        healed = self._rebinding.pop_due(now)
        for replica in healed:
            replica.restore(now)
            if getattr(replica, "corrupt_frac", 0.0):
                # rebound onto other chips: the defective one stayed in
                # quarantine
                replica.set_corrupt(0.0)
            metrics.recovery_log().record(
                "fleet_gang_rebound", replica=replica.replica_id,
                at_s=round(now, 6))
        if healed:
            self._refresh_link_slowdowns(now)
        for replica in healed:
            comp = f"replica-{replica.replica_id}"
            if self.health is not None and self.health.quarantined(comp):
                # rebound onto other hardware: a new individual
                self.health.restore(comp, now, reason="rebound")

    def step(self, now: float, tick: float,
             pending: Optional[deque] = None) -> None:
        """One fleet tick at virtual time ``now``."""
        if pending is None:
            pending = self._pending
        self._now = now
        self._apply_chaos(now)
        if self.sched is not None:
            self._step_sched(now)
        while pending and pending[0].arrival_s <= now:
            self._offer_arrival(pending.popleft(), now, fresh=True)
        if self.overload is not None:
            for req in self._retry_heap.pop_due(now):
                self._offer_arrival(req, now, fresh=False)
        # KV transfers delivered by this boundary join the decode lane,
        # placed in this same pass
        for handoff in self._kv_heap.pop_due(now):
            if handoff.request.request_id in self._kv_cancelled:
                self._kv_cancelled.discard(handoff.request.request_id)
                continue
            metrics.disagg_board().incr("kv_handoffs_delivered")
            self.router.offer_handoff(handoff)
        # finished weight loads enter the swap ledger (bookkeeping: the
        # loads' latency is already in their slots' timelines)
        for ev in self._swap_heap.pop_due(now):
            self._swap_log.append(ev.as_dict())
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
        if self._cols is not None:
            # only the replicas that can act in this window, in list
            # order: the others' ticks are no-ops
            reps = self._cols.replicas
            targets = [reps[i] for i in
                       self._cols.active_indices(now + tick)]
        else:
            targets = list(self.replicas)
        for replica in targets:
            for comp in replica.tick(now, tick):
                self._complete(replica, comp, now)
        for replica in list(self._draining):
            for comp in replica.tick(now, tick):
                self._complete(replica, comp, now)
            if replica.idle():
                self._draining.remove(replica)
                if self.sched is not None:
                    self.sched.release(
                        f"replica-{replica.replica_id}", now,
                        reason="scale-down drained")
        if self._ticks % self._eval_ticks == 0:
            if self.autoscaler is not None:
                self._autoscale(now)
            if self._pool_scalers is not None:
                self._autoscale_pools(now)
            if self.overload is not None:
                self.overload.brownout.evaluate(now)
            if self.trainer is not None:
                # the elastic ladder (a no-op unless an elastic gang is
                # live, so skipped evaluation boundaries stay no-ops)
                self.trainer.evaluate(now)
        self._ticks += 1

    def quiescent(self, pending: Optional[deque] = None) -> bool:
        """Nothing pending, in flight, warming, draining, due, left in
        the chaos plan, training or awaiting a bind: the loop's
        termination test."""
        if pending is None:
            pending = self._pending
        return bool(
            not pending and not self.router.queue and not self._warming
            and not self._kv_heap and not self.router.kv_queue
            and not self._swap_heap
            and not self._audit_heap and not self._audits
            and (self._cols.all_idle() if self._cols is not None
                 else all(r.idle() for r in self.replicas if r.healthy))
            and not self._draining and not self.chaos_events
            and not self._retry_heap and not self._hedge_heap
            and (self.trainer is None or self.trainer.quiescent())
            and not (self.sched is not None
                     and (self.sched.pending or self._rebinding)))

    def _idle_gap(self, pending: deque) -> bool:
        """True when nothing can happen before the next arrival or chaos
        event: no queued, in-flight, warming or draining work, no open
        audit, no scheduler or training activity, and no tick-cadenced
        decision maker (autoscaler evaluations, health probes, the
        overload layer's timers and brownout evaluations)."""
        if (self.autoscaler is not None or self.health is not None
                or self.overload is not None
                or self._pool_scalers is not None):
            return False
        if self.trainer is not None and not self.trainer.quiescent():
            return False
        if self.router.queue or self._warming or self._draining:
            return False
        if self._kv_heap or self.router.kv_queue or self._swap_heap:
            return False
        if self._audit_heap or self._audits:
            return False
        # a slowdown other than 1 rules out even an idle replica: an
        # engine's stride counter advances on every tick() call, so
        # skipping ticks would shift its stepping phase
        if not all(r.idle() and r.slowdown == 1.0 for r in self.replicas):
            return False
        return not (self.sched is not None and (
            self.sched.pending or self._rebinding
            or self._gang_requested or self._migrate_pending))

    def _next_wake(self, pending: deque, tick: float = 0.0) -> DueSet:
        """When does step() stop being a no-op? A queued request or KV
        handoff, scheduler activity, a draining replica or an engine
        mid-stream (or slowed) answer ``immediate``; arrivals, chaos,
        timers, KV deliveries, warm-ups, rebinds, training events and
        probe deadlines answer with the time of the first boundary that
        must be stepped; an analytic replica answers with its
        closed-form slot events. A pure read, valid until a boundary is
        stepped."""
        due = DueSet()
        if pending:
            due.at(pending[0].arrival_s)
        if self.chaos_events:
            ev0 = self.chaos_events[0]
            at = ev0.at_s
            if ev0.action in ("slow", "unslow", "link_degrade",
                              "link_restore"):
                # a slowdown changes from the boundary it applies at, so
                # the boundary before it is stepped too, as the plain
                # loop steps it
                at = max(0.0, at - tick)
            due.at(at)
        due.at(self._retry_heap.peek_time())
        due.at(self._hedge_heap.peek_time())
        due.at(self._kv_heap.peek_time())
        # a finished model load enters the ledger at its ready time
        due.at(self._swap_heap.peek_time())
        due.at(self._audit_heap.peek_time())
        if self.trainer is not None:
            # gang arrivals and segment ends; progress between them is
            # closed form
            self.trainer.due(due)
        if self.router.queue or self.router.kv_queue or self._draining:
            return due.need_now()
        if self.sched is not None and (
                self.sched.pending or self._gang_requested
                or self._migrate_pending):
            return due.need_now()
        due.at(self._warming.peek_time())
        due.at(self._rebinding.peek_time())
        if self._cols is not None:
            ge, cover = self._cols.wake()
            due.at(ge)
            due.covering(cover)
        else:
            for replica in self.replicas:
                nd = getattr(replica, "next_due", None)
                if nd is None:
                    # an engine's stride counter advances on every tick()
                    # call, so only an idle, unslowed engine may be
                    # skipped
                    if not (replica.idle() and replica.slowdown == 1.0):
                        return due.need_now()
                    continue
                ge, cover = nd()
                due.at(ge)
                due.covering(cover)
        if self.health is not None and pending:
            # a probe a probe interval to each suspect or quarantined
            # live replica while user traffic flows
            for replica in self.replicas:
                comp = f"replica-{replica.replica_id}"
                if (not replica.healthy
                        or self.health.state(comp) == "healthy"):
                    continue
                last = self._probe_last.get(comp)
                due.at(0.0 if last is None else
                       last + self.health.cfg.probe_interval_s)
        return due

    def _skip_uninteresting(self, tick: float, pending: deque) -> None:
        """The event core's jump: from the boundary just reached, keep
        advancing (tick-sized float additions, as the plain loop takes
        them) past every boundary where step() is a no-op. Skipped
        boundaries still count into the tick index, so evaluations land
        on the plain loop's boundaries."""
        b = self.clock.now()
        if pending and pending[0].arrival_s <= b:
            return
        if self._scan_holdoff > 0:
            self._scan_holdoff -= 1
            return
        if self.chaos_events and self.chaos_events[0].at_s <= b:
            return
        due = self._next_wake(pending, tick)
        if due.immediate:
            return
        evals_away = -1
        if (self.autoscaler is not None or self._pool_scalers is not None
                or self.overload is not None
                or (self.trainer is not None
                    and self.trainer.wants_evals())):
            # the autoscaler, the brownout ladder and the elastic
            # ladder evaluate on the tick grid: those boundaries are
            # stepped in every mode
            r = self._ticks % self._eval_ticks
            evals_away = (self._eval_ticks - r) % self._eval_ticks
            if evals_away == 0:
                return
        due_ge = due.ge
        due_cover = due.cover
        limit = self.cfg.max_virtual_s
        adv = self.clock.advance
        now = self.clock.now
        skipped = 0
        while True:
            b = now()
            if b > limit or due_ge <= b or due_cover <= b + tick:
                break
            adv(tick)
            self._ticks += 1
            skipped += 1
            if evals_away > 0:
                evals_away -= 1
                if evals_away == 0:
                    break
        if skipped:
            self._scan_backoff = 1
        else:
            self._scan_holdoff = self._scan_backoff
            self._scan_backoff = min(self._scan_backoff * 2, 32)

    def _advance(self, tick: float, pending: deque) -> None:
        """Advance the clock one tick; then, with the event core, past
        every boundary where nothing can happen; without it, with the
        fast-forward, through a provably idle gap up to the next arrival
        or chaos event. The clock takes the same tick-sized float
        additions in every mode (a single n * tick jump would land on
        other floats)."""
        self.clock.advance(tick)
        if self._event_core:
            self._skip_uninteresting(tick, pending)
            return
        if not self._fast_forward or not self._idle_gap(pending):
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
                  "integrity": metrics.integrity_board(),
                  "disagg": metrics.disagg_board(),
                  "zoo": metrics.zoo_board()}
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
        if self.trainer is not None:
            tr = self.trainer.report()
            report["training"] = tr
            report["ok"] = bool(report["ok"] and tr["ledger_ok"])
        if self.tenancy is not None:
            ten_report = self.tenancy.report()
            ten_report["slo"] = {
                name: tracker.report(span_s=span)
                for name, tracker in sorted(self._tenant_trackers.items())}
            ten_report["counters"] = counters("tenant")
            report["tenancy"] = ten_report
        if self._generations is not None:
            # the generation each replica was priced as
            report["generations"] = {
                str(r.replica_id): self._gen_of(r.replica_id)
                for r in sorted(self.replicas + self._draining,
                                key=lambda r: r.replica_id)}
        if self._zoo is not None:
            report["zoo"] = {
                "per_model_slo": {
                    name: tracker.report(span_s=span)
                    for name, tracker in
                    sorted(self._model_trackers.items())},
                "residents": {
                    str(r.replica_id): getattr(r, "resident_model", "")
                    for r in sorted(self.replicas + self._draining,
                                    key=lambda r: r.replica_id)},
                "swaps": {"completed": len(self._swap_log),
                          "log": self._swap_log},
                "counters": counters("zoo"),
            }
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
        if self._disagg is not None:
            report["disagg"] = self._disagg_report(counters("disagg"))
        if self.sched is not None:
            ttrs = self.time_to_routable
            warmup = (self.autoscaler.warmup_s
                      if self.autoscaler is not None
                      else resolve_warmup_s())
            report["scheduler"] = {
                "policy": self._sched_cfg.policy,
                "flat_warmup_s": round(warmup, 6),
                "bind_s": self._sched_cfg.bind_s,
                "time_to_routable": {
                    "count": len(ttrs),
                    "mean_s": (round(sum(ttrs) / len(ttrs), 6)
                               if ttrs else None),
                    "max_s": round(max(ttrs), 6) if ttrs else None,
                },
                "events": self.sched.events,
                "event_counts": self.sched.report()["event_counts"],
            }
        return report

    def _disagg_report(self, counters: dict) -> dict:
        pools: Dict[str, dict] = {}
        for phase in ("prefill", "decode"):
            members = [r for r in self.replicas + self._draining
                       if getattr(r, "phase", "unified") == phase]
            pools[phase] = {"replicas": len(members),
                            "healthy": sum(1 for r in members
                                           if r.healthy)}
        out = {
            "config": self._disagg.as_dict(),
            "pools": pools,
            "kv": {
                "handoffs": self._kv_handoffs,
                "bytes_total": self._kv_bytes_total,
                "transfer_s_total": round(self._kv_transfer_s_total, 6),
                "tier": self._disagg.tier,
            },
            "calibration_errors": self._cost.errors(),
            "counters": counters,
        }
        if self._pool_scalers is not None:
            out["autoscalers"] = {p: s.report() for p, s in
                                  sorted(self._pool_scalers.items())}
        return out


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
    # the engine's module loads torch: imported here, so the analytic
    # fleet and the globe import without it
    from kind_tpu_sim_torch.models.serving import ServingEngine

    clock = VirtualClock()

    def factory(rid):
        return EngineReplica(rid, ServingEngine(
            params, model_cfg, serving, device=device, clock=clock.now))

    return FleetSim(cfg, trace, replica_factory=factory,
                    chaos_events=chaos_events, clock=clock)
