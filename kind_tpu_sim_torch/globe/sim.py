"""The globe driver: zones of cells behind one front door (the port's
copy of ``kind_tpu_sim/globe/sim.py``).

The fleet-of-fleets (docs/GLOBE.md): per-zone seeded demand (with
optional follow-the-sun diurnal phase offsets) arrives at the front
door, which admits each request to a cell — nearest healthy first,
capacity-aware, spill-bounded; every cell is a full
:class:`~kind_tpu_sim_torch.fleet.FleetSim` (optionally scheduler-backed on
its own zone-labeled inventory) stepped in lockstep on ONE shared
virtual clock; a global capacity planner moves a spot-replica budget
between the cells' autoscalers as the sun moves the load.

Chaos grows the **blast-radius tier** here: ``zone_loss`` kills every
cell in a zone (their whole load re-enters the front door and spills
cross-zone), ``herd_failover`` is the same failure under peak burst
(the spill bound is what keeps it from cascading), ``dcn_degrade``
browns out a zone's inter-zone links (the tier-parameterized ring
cost model from parallel/collectives.py sets the inflation), and
``cell_drain`` is planned maintenance. Per-zone SLO boards prove
containment: a fault's damage must stay inside its failure domain.

Determinism: everything is a pure function of (config, seed) —
per-zone traces derive sub-seeds from ``KIND_TPU_SIM_GLOBE_SEED``,
cells iterate in name order, the front door scores without entropy —
so `globe run --seed 7` twice emits byte-identical reports.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.fleet import knobs
from kind_tpu_sim_torch.parallel import collectives
from kind_tpu_sim_torch.fleet.autoscaler import AutoscalerConfig
from kind_tpu_sim_torch.fleet.loadgen import (
    TraceRequest,
    VirtualClock,
    WorkloadSpec,
    generate_trace,
)
from kind_tpu_sim_torch.fleet.events import (
    LANE_ARRIVAL,
    LANE_COMPLETION,
    DueSet,
    EventHeap,
    resolve_event_core,
)
from kind_tpu_sim_torch.fleet.overload import OverloadConfig, OverloadState
from kind_tpu_sim_torch.fleet.router import SimReplicaConfig
from kind_tpu_sim_torch.fleet.sim import (
    FleetConfig,
    FleetSchedConfig,
    resolve_fast_forward,
    resolve_tick_s,
)
from kind_tpu_sim_torch.fleet.tenancy import (
    TenancyConfig,
    TenancyState,
    tenant_of,
)
from kind_tpu_sim_torch.fleet.training import TrainingConfig
from kind_tpu_sim_torch.fleet.slo import SloPolicy, SloTracker
from kind_tpu_sim_torch.globe.cell import Cell, CellConfig
from kind_tpu_sim_torch.globe.frontdoor import FrontDoor, FrontDoorConfig
from kind_tpu_sim_torch.globe.planner import GlobalPlanner, PlannerConfig

GLOBE_SEED_ENV = knobs.GLOBE_SEED

GLOBE_CHAOS_ACTIONS = (
    "zone_loss", "zone_restore", "herd_failover",
    "dcn_degrade", "dcn_restore", "cell_drain", "cell_undrain",
)


def resolve_seed(seed: Optional[int] = None) -> int:
    """Explicit seed > env (KIND_TPU_SIM_GLOBE_SEED) > 0."""
    if seed is not None:
        return int(seed)
    return int(knobs.get(GLOBE_SEED_ENV))


@dataclasses.dataclass(frozen=True)
class GlobeWorkloadSpec:
    """Per-zone demand. With ``follow_the_sun`` and a diurnal
    process, zone i's rate profile is phase-shifted by i/len(zones)
    of a period — the staggered peaks the planner's spot budget
    chases."""

    process: str = "poisson"
    rps: float = 40.0
    n_per_zone: int = 200
    prompt_len: Tuple[int, int] = (8, 24)
    max_new: Tuple[int, int] = (4, 12)
    shared_prefix_frac: float = 0.0
    prefix_groups: int = 4
    deadline_s: Optional[float] = None
    diurnal_period_s: float = 20.0
    follow_the_sun: bool = True

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["prompt_len"] = list(self.prompt_len)
        d["max_new"] = list(self.max_new)
        return d


@dataclasses.dataclass(frozen=True)
class GlobeChaosEvent:
    """One blast-radius fault. ``target`` names a zone (``zone_*``,
    ``herd_failover``, ``dcn_*``) or a cell (``cell_*``); ``param``
    is the DCN link bandwidth factor for ``dcn_degrade``."""

    at_s: float
    action: str
    target: str
    param: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class GlobeConfig:
    zones: Tuple[str, ...] = ("zone-a", "zone-b", "zone-c")
    cells_per_zone: int = 1
    replicas_per_cell: int = 2
    policy: str = "least-outstanding"   # per-cell router policy
    tick_s: Optional[float] = None
    max_virtual_s: float = 600.0
    sim: SimReplicaConfig = SimReplicaConfig()
    slo: SloPolicy = SloPolicy(ttft_s=1.0, e2e_s=5.0)
    # scheduler-backed cells: each cell's replicas are gangs on its
    # own zone-labeled inventory (FleetConfig.sched, docs/SCHED.md)
    sched: bool = True
    sched_policy: str = "ici"
    # inventory shape of every cell's scheduler (None keeps the
    # FleetSchedConfig default of one 4x8 pod) — a training cell
    # needs headroom beyond serving for the elastic ladder to have
    # anything to scavenge (docs/TRAINING.md)
    cell_pods: Optional[Tuple] = None
    autoscale: bool = False
    autoscaler: AutoscalerConfig = AutoscalerConfig()
    frontdoor: FrontDoorConfig = FrontDoorConfig()
    planner: Optional[PlannerConfig] = None
    # overload containment (docs/OVERLOAD.md): per-origin client
    # retry budgets and cross-cell hedging live at the FRONT DOOR
    # (the client tier); the embedded cells inherit breakers and
    # brownout but never their own retries/hedges — two stacked
    # retry loops would be an amplifier of their own
    overload: Optional[OverloadConfig] = None
    # training tenancy (docs/TRAINING.md): the named cells run this
    # TrainingConfig co-scheduled under their serving fleet (strict
    # priority); empty training_cells defaults to the first cell.
    # Requires scheduler-backed cells (sched=True).
    training: Optional[TrainingConfig] = None
    training_cells: Tuple[str, ...] = ()
    # multi-tenancy (docs/TENANCY.md): per-zone traces draw the
    # tenant/user model, quotas are charged ONCE at the front door
    # (cells inherit the tenancy minus quotas — weighted-fair
    # queuing and KV budgets, no double metering)
    tenancy: Optional[TenancyConfig] = None
    # model zoo (docs/ZOO.md): a ZooConfig stamps every zone trace
    # with model names (fresh crc32 stream — zoo-off traces keep
    # their bytes) and turns on warm-cell spill at the front door
    zoo: Optional[object] = None
    # heterogeneous cells (docs/ZOO.md): accelerator generation
    # names cycled over cells in name order — scheduler-backed
    # cells request the generation's accelerator label (the
    # FleetSchedConfig.replica_accelerator path), analytic cells
    # price its calibration directly. None keeps historical bytes.
    generations: Optional[Tuple[str, ...]] = None
    workload: GlobeWorkloadSpec = GlobeWorkloadSpec()
    # one-way DCN latency unit between adjacent zones; zone pairs
    # farther apart in the zone list cost proportionally more
    dcn_base_s: float = 0.01
    intra_zone_s: float = 0.0005
    # contractlint: ok(drift) -- execution strategy: ff-on vs ff-off reports must diff clean
    fast_forward: Optional[bool] = None
    # event-heap core (None -> resolve_event_core(), default on) —
    # an execution strategy like fast_forward: byte-identical on or
    # off, so it stays OUT of as_dict()
    # contractlint: ok(drift) -- execution strategy: heap-core on vs off reports must diff clean
    event_core: Optional[bool] = None

    def cell_names(self) -> List[str]:
        return [f"{z}/c{i}" for z in self.zones
                for i in range(self.cells_per_zone)]

    def resolve_training_cells(self) -> List[str]:
        """The cells that host the training tenancy: the explicit
        list, or the first cell when training is set and no list is
        given."""
        if self.training is None:
            return []
        if self.training_cells:
            names = set(self.cell_names())
            unknown = [c for c in self.training_cells
                       if c not in names]
            if unknown:
                raise ValueError(
                    f"training_cells {unknown} not in "
                    f"{sorted(names)}")
            return list(self.training_cells)
        return self.cell_names()[:1]

    def as_dict(self) -> dict:
        out = {
            "zones": list(self.zones),
            "cells_per_zone": self.cells_per_zone,
            "replicas_per_cell": self.replicas_per_cell,
            "policy": self.policy,
            "tick_s": resolve_tick_s(self.tick_s),
            "max_virtual_s": self.max_virtual_s,
            "sim": self.sim.as_dict(),
            "slo": {k: v for k, v in
                    dataclasses.asdict(self.slo).items()
                    if v is not None},
            "sched": (self.sched_policy if self.sched else None),
            "cell_pods": ([list(p) for p in self.cell_pods]
                          if self.cell_pods is not None else None),
            "autoscale": self.autoscale,
            "autoscaler": (dataclasses.asdict(self.autoscaler)
                           if self.autoscale else None),
            "frontdoor": self.frontdoor.as_dict(),
            "planner": (self.planner.as_dict()
                        if self.planner is not None else None),
            "workload": self.workload.as_dict(),
            "dcn_base_s": self.dcn_base_s,
            "intra_zone_s": self.intra_zone_s,
        }
        if self.overload is not None:
            out["overload"] = self.overload.as_dict()
        if self.tenancy is not None:
            out["tenancy"] = self.tenancy.as_dict()
        if self.training is not None:
            out["training"] = self.training.as_dict()
            out["training_cells"] = sorted(
                self.resolve_training_cells())
        if self.zoo is not None:
            out["zoo"] = self.zoo.as_dict()
        if self.generations is not None:
            out["generations"] = list(self.generations)
        return out


# -- per-zone traffic --------------------------------------------------


def zone_seed(seed: int, zone: str) -> int:
    """Each zone's private loadgen stream, derived from the globe
    seed — the ChaosSchedule recipe, so zone traffic identity is
    exactly (seed, zone) identity."""
    return zlib.crc32(f"globe:{seed}:{zone}".encode("utf-8"))


def generate_globe_traces(
        cfg: GlobeConfig,
        seed: Optional[int] = None) -> Dict[str, List[TraceRequest]]:
    """One seeded trace per zone; request ids are zone-prefixed so
    they stay unique in the global completion log. Diurnal zones get
    follow-the-sun phase offsets (zone i peaks i/len of a period
    later)."""
    seed = resolve_seed(seed)
    w = cfg.workload
    out: Dict[str, List[TraceRequest]] = {}
    for i, zone in enumerate(cfg.zones):
        phase = 0.0
        if (w.follow_the_sun and w.process == "diurnal"
                and len(cfg.zones) > 1):
            phase = round(
                i * w.diurnal_period_s / len(cfg.zones), 6)
        spec = WorkloadSpec(
            process=w.process, rps=w.rps,
            n_requests=w.n_per_zone,
            prompt_len=w.prompt_len, max_new=w.max_new,
            shared_prefix_frac=w.shared_prefix_frac,
            prefix_groups=w.prefix_groups,
            deadline_s=w.deadline_s,
            diurnal_period_s=w.diurnal_period_s,
            phase_s=phase,
            tenancy=cfg.tenancy,
            zoo=cfg.zoo)
        out[zone] = [
            dataclasses.replace(r,
                                request_id=f"{zone}/{r.request_id}")
            for r in generate_trace(spec, zone_seed(seed, zone))]
    return out


def save_globe_trace(path: str,
                     traces: Dict[str, List[TraceRequest]]) -> None:
    """One JSON object per line with the origin zone riding along —
    byte-stable (sorted keys, zone then arrival order)."""
    with open(path, "w", encoding="utf-8") as fh:
        for zone in sorted(traces):
            for req in traces[zone]:
                d = req.as_dict()
                d["origin"] = zone
                fh.write(json.dumps(d, sort_keys=True))
                fh.write("\n")


def load_globe_trace(path: str) -> Dict[str, List[TraceRequest]]:
    out: Dict[str, List[TraceRequest]] = {}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            zone = d.pop("origin")
            out.setdefault(zone, []).append(
                TraceRequest.from_dict(d))
    return out


def fleet_config_for(cfg: GlobeConfig, zone: str,
                     training: bool = False,
                     generation: Optional[str] = None
                     ) -> FleetConfig:
    """The embedded FleetConfig one cell of ``cfg`` runs in ``zone``.
    Module-level (not a GlobeSim method) so shard workers
    (globe/shard.py) build byte-identical cells from the wire copy
    of the config without a parent driver object. ``generation``
    makes this cell's replicas price against that accelerator
    generation (docs/ZOO.md): scheduler-backed cells request the
    generation's accelerator label — the end-to-end
    ``replica_accelerator`` path — analytic cells carry the
    generation name directly."""
    sched_cfg = None
    if cfg.sched:
        kw: Dict[str, object] = {"policy": cfg.sched_policy,
                                 "zone": zone}
        if cfg.cell_pods is not None:
            kw["pods"] = cfg.cell_pods
        if generation is not None:
            from kind_tpu_sim_torch.fleet.costmodel import (
                GENERATION_ACCELERATORS,
                GENERATION_SCHED_TOPOLOGY,
            )

            accel = GENERATION_ACCELERATORS[generation]
            pod_topo, rep_topo = GENERATION_SCHED_TOPOLOGY[accel]
            kw["replica_accelerator"] = accel
            kw["replica_topology"] = rep_topo
            if cfg.cell_pods is None:
                kw["pods"] = ((accel, pod_topo),)
        sched_cfg = FleetSchedConfig(**kw)
    return FleetConfig(
        training=(cfg.training if training else None),
        replicas=cfg.replicas_per_cell, policy=cfg.policy,
        tick_s=cfg.tick_s,
        # the FRONT DOOR is the admission layer: its per-cell
        # hard limit keeps cell queues bounded, so the cell
        # router never sheds on its own (max_queue=0 = no bound)
        max_queue=0,
        max_virtual_s=cfg.max_virtual_s,
        autoscale=cfg.autoscale,
        slo=cfg.slo, sim=cfg.sim,
        autoscaler=cfg.autoscaler,
        zoo=cfg.zoo,
        # a scheduler-backed cell derives its generation from the
        # accelerator label above; an analytic cell carries it
        generations=((generation,)
                     if generation is not None and not cfg.sched
                     else None),
        sched=sched_cfg,
        # cells keep the replica-tier controls (breakers,
        # brownout) but the CLIENT lives at the front door:
        # cell-level retries and hedges stay off
        overload=(dataclasses.replace(cfg.overload,
                                      max_attempts=1,
                                      hedge=False)
                  if cfg.overload is not None else None),
        # cells keep weighted-fair queuing + KV budgets but NOT the
        # quotas — those are charged once, at the front door
        tenancy=(cfg.tenancy.without_quotas()
                 if cfg.tenancy is not None else None),
        fast_forward=False)  # the globe fast-forwards, not cells


# -- the driver --------------------------------------------------------


class GlobeSim:
    """One globe run: cells in name order, one shared clock, the
    front door as the only traffic source, blast-radius chaos at
    planned virtual times."""

    def __init__(self, cfg: GlobeConfig,
                 traces: Optional[Dict[str, List[TraceRequest]]]
                 = None,
                 seed: Optional[int] = None,
                 chaos_events: Sequence[GlobeChaosEvent] = ()):
        self.cfg = cfg
        self.seed = resolve_seed(seed)
        self.clock = VirtualClock()
        self.traces = (traces if traces is not None
                       else generate_globe_traces(cfg, self.seed))
        unknown = set(self.traces) - set(cfg.zones)
        if unknown:
            raise ValueError(
                f"trace zones {sorted(unknown)} not in config "
                f"zones {list(cfg.zones)}")
        for ev in chaos_events:
            if ev.action not in GLOBE_CHAOS_ACTIONS:
                raise ValueError(
                    f"unknown globe chaos action {ev.action!r}; "
                    f"known: {', '.join(GLOBE_CHAOS_ACTIONS)}")
        self.chaos_events = sorted(
            chaos_events, key=lambda e: (e.at_s, e.action, e.target))
        self.chaos_applied: List[dict] = []
        self._zone_idx = {z: i for i, z in enumerate(cfg.zones)}
        self._dcn_factor: Dict[str, float] = {}
        training_cells = set(cfg.resolve_training_cells())
        if training_cells and not cfg.sched:
            raise ValueError(
                "GlobeConfig.training needs scheduler-backed cells "
                "(sched=True): training gangs are scheduler-placed "
                "workloads")
        self.cells = self._build_cells(training_cells)
        self._wire_cells()
        self._cell_by_name = {c.name: c for c in self.cells}
        # overload containment at the client tier (docs/OVERLOAD.md):
        # per-origin retry budgets, per-cell breakers, cross-cell
        # hedging — all timers on EventHeaps, never wall clock
        self.overload = (OverloadState(cfg.overload)
                         if cfg.overload is not None else None)
        # front-door tenancy (docs/TENANCY.md): quotas metered here,
        # once, on fresh arrivals — the cells run without_quotas()
        self.tenancy = (TenancyState(cfg.tenancy)
                        if cfg.tenancy is not None else None)
        self._g_retry = EventHeap()    # (due, ARRIVAL, (req, origin))
        self._g_hedge = EventHeap()    # (due, COMPLETION, ...)
        self._g_attempts: Dict[str, int] = {}
        self._g_hedged: Dict[str, dict] = {}
        self._g_dropped: set = set()
        self._g_completed: set = set()
        self.frontdoor = FrontDoor(cfg.frontdoor, self.cells,
                                   self.rtt_s,
                                   overload=self.overload)
        if self.overload is not None:
            self.frontdoor.on_admit = self._on_admit
        self.planner = (GlobalPlanner(cfg.planner, self.cells)
                        if cfg.planner is not None else None)
        self._next_eval = 0.0
        self.tracker = SloTracker(cfg.slo)
        self._zone_tracker = {z: SloTracker(cfg.slo)
                              for z in cfg.zones}
        self._origin: Dict[str, str] = {}
        self.log: List[dict] = []
        self._arrivals: deque = deque(sorted(
            ((req, zone) for zone, reqs in self.traces.items()
             for req in reqs),
            key=lambda t: (t[0].arrival_s, t[0].request_id)))
        self.requests = len(self._arrivals)
        self._ff = resolve_fast_forward(cfg.fast_forward)
        self._event_core = resolve_event_core(cfg.event_core)
        # empty ticks skipped by fast-forward / boundaries skipped
        # by the event core — observability only, NOT in the report
        # (each mode on/off must diff clean)
        self.ff_skipped = 0
        self.ev_skipped = 0
        # wake-scan backoff (see fleet/sim.py): stepping is always
        # safe, so scan frequency is a pure cost heuristic
        self._scan_holdoff = 0
        self._scan_backoff = 1

    def _build_cells(self, training_cells: set) -> List[Cell]:
        """Cell construction, factored so the sharded driver
        (globe/shard.py) can override it with worker-resident cells
        behind parent-side proxies. With ``generations`` set, cell i
        (name order) runs generation i % len — the mixed-generation
        fleet (docs/ZOO.md)."""
        gens = self.cfg.generations
        return [
            Cell(CellConfig(name=name, zone=name.split("/")[0],
                            fleet=fleet_config_for(
                                self.cfg, name.split("/")[0],
                                training=name in training_cells,
                                generation=(gens[i % len(gens)]
                                            if gens else None))),
                 self.clock)
            for i, name in enumerate(self.cfg.cell_names())]

    def _wire_cells(self) -> None:
        """Hook every cell's completion stream into the globe log /
        trackers — a no-op in the sharded driver, where the hook
        runs on the parent against streamed completion records."""
        for cell in self.cells:
            cell.sim.on_complete = self._completion_hook(cell)

    # -- DCN model ----------------------------------------------------

    def rtt_s(self, z_from: str, z_to: str) -> float:
        """Modeled round trip between a request's origin zone and a
        cell's zone. Inter-zone distance scales with zone-list
        separation; a browned-out link (``dcn_degrade``) inflates
        every path touching the degraded zone by the shared
        tier-parameterized ring cost model (transfer time is inverse
        in the slowest link's bandwidth factor)."""
        zi = self._zone_idx[z_from]
        zj = self._zone_idx[z_to]
        if zi == zj:
            return 2.0 * self.cfg.intra_zone_s
        base = 2.0 * self.cfg.dcn_base_s * (1.0 + 0.5 * abs(zi - zj))
        factor = min(self._dcn_factor.get(z_from, 1.0),
                     self._dcn_factor.get(z_to, 1.0))
        if factor < 1.0:
            base *= collectives.tier_slowdown(factor, 1.0,
                                              tier="dcn")
        return base

    # -- completion stream --------------------------------------------

    def _completion_hook(self, cell: Cell):
        def hook(entry: dict, comp) -> None:
            rid = entry["request_id"]
            now = self.clock.now()
            ov = self.overload
            if ov is not None:
                if rid in self._g_dropped:
                    # cancelled hedge loser finishing anyway: the
                    # winner's stream is the request's one output
                    self._g_dropped.discard(rid)
                    ov.incr("hedge_late_drops")
                    return
                if rid in self._g_completed:
                    return
                pair = self._g_hedged.pop(rid, None)
                if pair is not None:
                    loser_name = (pair["hedge"]
                                  if cell.name == pair["primary"]
                                  else pair["primary"])
                    if cell.name == pair["hedge"]:
                        ov.incr("hedge_wins")
                    loser = self._cell_by_name[loser_name]
                    if loser.cancel(rid):
                        ov.incr("hedge_cancels")
                    else:
                        self._g_dropped.add(rid)
                self._g_completed.add(rid)
            origin = self._origin.get(rid, cell.zone)
            g = dict(entry)
            g["cell"] = cell.name
            g["serving_zone"] = cell.zone
            g["origin"] = origin
            self.log.append(g)
            req = comp.request
            shed = comp.finish_reason == "shed"
            expired = comp.finish_reason == "deadline_exceeded"
            self.tracker.observe(
                arrival_s=req.arrival_s, first_s=comp.first_s,
                finish_s=comp.finish_s, tokens=comp.tokens,
                shed=shed, deadline_exceeded=expired)
            self._zone_tracker[origin].observe(
                arrival_s=req.arrival_s, first_s=comp.first_s,
                finish_s=comp.finish_s, tokens=comp.tokens,
                shed=shed, deadline_exceeded=expired)
            self.frontdoor.note_result(cell.name, g["slo_ok"], now)
            if ov is not None:
                if shed or expired:
                    self._g_maybe_retry(req, origin, now)
                elif comp.first_s is not None:
                    ov.observe_service(comp.finish_s
                                       - comp.dispatch_s,
                                       self._tenant_key(req))
        return hook

    def _tenant_key(self, req) -> str:
        """Per-(origin, tenant) budget key: the declared tenant when
        isolation is on, else "" (the shared per-origin buckets —
        untenanted globes keep their historical streams)."""
        if self.tenancy is not None and self.tenancy.isolation:
            return tenant_of(req)
        return ""

    # -- overload containment at the front door (docs/OVERLOAD.md) ----

    def _on_admit(self, req: TraceRequest, origin: str, cell: Cell,
                  now: float) -> None:
        """Front-door admission hook: arm the cross-cell hedge
        timer at the p9x of observed service times."""
        rid = req.request_id
        if (not self.overload.hedge_enabled()
                or rid in self._g_hedged
                or rid in self._g_completed):
            return
        self._g_hedge.push(now + self.overload.hedge_delay_s(),
                           LANE_COMPLETION, (req, origin, cell.name))

    def _g_fire_hedges(self, now: float) -> None:
        """Due hedge timers: a request still unfinished past its
        hedge delay gets a copy admitted to the second-best cell —
        budget-gated, herd-bounded (candidates already respect the
        hard limit); first completion wins and the loser is
        cancelled wherever it is (even mid-DCN-flight)."""
        ov = self.overload
        for req, origin, primary in self._g_hedge.pop_due(now):
            rid = req.request_id
            if rid in self._g_completed or rid in self._g_hedged:
                continue
            if not ov.hedge_enabled():
                continue
            if not ov.spend_hedge(self._tenant_key(req)):
                continue
            for cand in self.frontdoor._candidates(origin, now):
                if cand.name == primary:
                    continue
                self._g_hedged[rid] = {"primary": primary,
                                       "hedge": cand.name}
                cand.admit(req, now + self.rtt_s(origin, cand.zone))
                ov.incr("hedges_issued")
                ov.breaker_dispatch(cand.name)
                break

    def _g_maybe_retry(self, req: TraceRequest, origin: str,
                       now: float) -> None:
        """The per-origin client retry model: a shed or expired
        attempt retries after deterministic doubling backoff IF the
        origin zone's token-bucket budget allows — the suppressed
        count is the proof that a saturated globe sees retry load
        shrink, not amplify."""
        ov = self.overload
        if ov.cfg.max_attempts <= 1:
            return
        base = req.request_id.split("~r", 1)[0]
        attempt = self._g_attempts.get(base, 1)
        if attempt >= ov.cfg.max_attempts:
            ov.incr("retries_exhausted")
            return
        if not ov.spend_retry(origin, self._tenant_key(req)):
            return
        self._g_attempts[base] = attempt + 1
        delay = ov.cfg.retry_backoff_s * (2 ** (attempt - 1))
        at = round(now + delay, 6)
        retry = dataclasses.replace(
            req, request_id=f"{base}~r{attempt}", arrival_s=at)
        self._origin[retry.request_id] = origin
        self._g_retry.push(at, LANE_ARRIVAL, (retry, origin))

    def _record_frontdoor_shed(self, req: TraceRequest,
                               origin: str, now: float,
                               retryable: bool = True) -> None:
        entry = {
            "request_id": req.request_id,
            "cell": None, "serving_zone": None, "origin": origin,
            "replica": -1, "prefix_group": req.prefix_group,
            "arrival_s": round(req.arrival_s, 6),
            "dispatch_s": round(now, 6), "first_s": None,
            "finish_s": round(now, 6), "tokens": 0,
            "tokens_crc": 0, "finish_reason": "shed",
            "slo_ok": False,
        }
        if getattr(req, "tenant", ""):
            entry["tenant"] = req.tenant
        if getattr(req, "model", ""):
            entry["model"] = req.model
        self.log.append(entry)
        self.tracker.observe(
            arrival_s=req.arrival_s, first_s=None, finish_s=now,
            tokens=0, shed=True)
        self._zone_tracker[origin].observe(
            arrival_s=req.arrival_s, first_s=None, finish_s=now,
            tokens=0, shed=True)
        if self.overload is not None:
            self._g_completed.add(req.request_id)
            if retryable:
                self._g_maybe_retry(req, origin, now)

    # -- blast-radius chaos -------------------------------------------

    def _cells_of(self, zone: str) -> List[Cell]:
        return [c for c in self.cells if c.zone == zone]

    def _apply_chaos(self, now: float) -> None:
        while self.chaos_events and self.chaos_events[0].at_s <= now:
            ev = self.chaos_events.pop(0)
            self.chaos_applied.append(
                dict(ev.as_dict(), applied_at_s=round(now, 6)))
            if ev.action in ("zone_loss", "herd_failover"):
                self._lose_zone(ev.target, now, ev.action)
            elif ev.action == "zone_restore":
                for cell in self._cells_of(ev.target):
                    cell.restore(now)
                metrics.globe_board().incr("zone_restores")
                metrics.recovery_log().record(
                    "globe_zone_restore", zone=ev.target,
                    at_s=round(now, 6))
            elif ev.action == "dcn_degrade":
                self._dcn_factor[ev.target] = max(1e-3, ev.param)
                metrics.globe_board().incr("dcn_degrades")
                metrics.recovery_log().record(
                    "globe_dcn_degrade", zone=ev.target,
                    factor=ev.param, at_s=round(now, 6))
            elif ev.action == "dcn_restore":
                self._dcn_factor.pop(ev.target, None)
                metrics.globe_board().incr("dcn_restores")
                metrics.recovery_log().record(
                    "globe_dcn_restore", zone=ev.target,
                    at_s=round(now, 6))
            elif ev.action == "cell_drain":
                for cell in self.cells:
                    if cell.name == ev.target:
                        cell.draining = True
                metrics.globe_board().incr("cell_drains")
                metrics.recovery_log().record(
                    "globe_cell_drain", cell=ev.target,
                    at_s=round(now, 6))
            elif ev.action == "cell_undrain":
                for cell in self.cells:
                    if cell.name == ev.target:
                        cell.draining = False
                metrics.globe_board().incr("cell_undrains")

    def _lose_zone(self, zone: str, now: float,
                   action: str) -> None:
        """A whole zone goes dark: every cell in it fails, and its
        entire displaced load re-enters the front door in arrival
        order — the thundering herd the spill bound must absorb
        without cascading into the survivors."""
        displaced: List[TraceRequest] = []
        for cell in self._cells_of(zone):
            displaced.extend(cell.fail(now))
        displaced.sort(key=lambda r: (r.arrival_s, r.request_id))
        metrics.globe_board().incr("zone_losses")
        metrics.recovery_log().record(
            f"globe_{action}", zone=zone,
            displaced=len(displaced), at_s=round(now, 6))
        for req in displaced:
            origin = self._origin.get(req.request_id, zone)
            shed = self.frontdoor.offer(req, origin, now,
                                        readmit=True)
            if shed is not None:
                self._record_frontdoor_shed(req, origin, now)

    # -- the loop -----------------------------------------------------

    def _done(self) -> bool:
        return bool(
            not self._arrivals and not self.frontdoor.queue
            and not self.chaos_events
            and not self._g_retry and not self._g_hedge
            and all(c.quiescent() for c in self.cells))

    def _skip_uninteresting(self, tick: float) -> None:
        """The event-core jump at globe scale (docs/PERFORMANCE.md
        "The event core"): cells stop being per-tick steppers and
        become event producers — each answers when anything inside
        it (DCN delivery, slot event, warm-up, scheduler activity)
        next lands, the front door and planner contribute their own
        instants, and every boundary in between is skipped by the
        identical tick-sized float additions. Skipped boundaries
        still count into each ALIVE cell's tick-grid index so
        per-cell autoscaler cadences land on the identical
        boundaries as the lockstep loop (a dead cell's index is
        frozen either way — it is not stepped)."""
        # dense-path fast exits: this boundary will be stepped no
        # matter what — skip the cell scan
        b = self.clock.now()
        if self._arrivals and self._arrivals[0][0].arrival_s <= b:
            return
        if self._scan_holdoff > 0:
            self._scan_holdoff -= 1
            return
        if self.chaos_events and self.chaos_events[0].at_s <= b:
            return
        if self.frontdoor.queue:
            return
        due = DueSet()
        if self._arrivals:
            due.at(self._arrivals[0][0].arrival_s)
        if self.chaos_events:
            due.at(self.chaos_events[0].at_s)
        if self.planner is not None:
            due.at(self._next_eval)
        # front-door retry/hedge timers are boundary-condition
        # events like arrivals
        due.at(self._g_retry.peek_time())
        due.at(self._g_hedge.peek_time())
        if self.frontdoor.queue:
            due.need_now()
        alive_sims = []
        evals_away = -1
        for cell in self.cells:
            due.merge(cell.event_due())
            if cell.alive:
                sim = cell.sim
                alive_sims.append(sim)
                if (sim.autoscaler is not None
                        or sim.overload is not None
                        or (sim.trainer is not None
                            and sim.trainer.wants_evals())):
                    # cell brownout ladders and training elastic
                    # ladders evaluate on the same tick grid as
                    # autoscalers — eval boundaries must be
                    # stepped in both modes
                    r = sim._ticks % sim._eval_ticks
                    away = (sim._eval_ticks - r) % sim._eval_ticks
                    if evals_away < 0 or away < evals_away:
                        evals_away = away
        if due.immediate or evals_away == 0:
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
            for sim in alive_sims:
                sim._ticks += 1
            skipped += 1
            if evals_away > 0:
                evals_away -= 1
                if evals_away == 0:
                    break
        self.ev_skipped += skipped
        if skipped:
            self._scan_backoff = 1
        else:
            self._scan_holdoff = self._scan_backoff
            self._scan_backoff = min(self._scan_backoff * 2, 32)

    def _advance(self, tick: float) -> None:
        """One clock tick — then, with the event core enabled, past
        every provably uninteresting boundary; or, across a globally
        idle gap (every cell idle, front door drained, no planner)
        with the legacy fast-forward, every empty tick up to the
        next arrival/chaos event. Always by the same sequence of
        tick-sized additions (byte-identical replays, docs/FLEET.md
        fast-forward contract)."""
        self.clock.advance(tick)
        if self._event_core:
            self._skip_uninteresting(tick)
            return
        if (not self._ff or self.planner is not None
                or self.overload is not None):
            return
        if self.frontdoor.queue:
            return
        if not all(c.idle_gap() for c in self.cells):
            return
        next_s = (self._arrivals[0][0].arrival_s
                  if self._arrivals else float("inf"))
        if self.chaos_events:
            next_s = min(next_s, self.chaos_events[0].at_s)
        limit = self.cfg.max_virtual_s
        adv = self.clock.advance
        now = self.clock.now
        while now() < next_s and now() <= limit:
            adv(tick)
            self.ff_skipped += 1

    def run(self) -> Dict[str, object]:
        board_before = metrics.globe_board().counts()
        self._tenant_before = metrics.tenant_board().counts()
        self._zoo_before = metrics.zoo_board().counts()
        tick = resolve_tick_s(self.cfg.tick_s)
        # origin map first: displaced requests keep their origin
        # wherever they complete
        for zone, reqs in self.traces.items():
            for req in reqs:
                self._origin[req.request_id] = zone
        while True:
            now = self.clock.now()
            if now > self.cfg.max_virtual_s:
                break
            self._apply_chaos(now)
            if self.planner is not None:
                while now >= self._next_eval:
                    self.planner.evaluate(now)
                    self._next_eval = round(
                        self._next_eval
                        + self.cfg.planner.eval_every_s, 9)
            while (self._arrivals
                   and self._arrivals[0][0].arrival_s <= now):
                req, origin = self._arrivals.popleft()
                if self.tenancy is not None:
                    # quota check FIRST: a quota-refused request
                    # never funds a retry budget nor retries itself
                    if self.tenancy.admit(req, now) is not None:
                        metrics.tenant_board().incr(
                            "tenant_quota_shed")
                        self._record_frontdoor_shed(
                            req, origin, now, retryable=False)
                        continue
                if self.overload is not None:
                    # first-attempt admissions fund the origin's
                    # retry budget
                    self.overload.earn_retry(
                        origin, self._tenant_key(req))
                shed = self.frontdoor.offer(req, origin, now)
                if shed is not None:
                    self._record_frontdoor_shed(req, origin, now)
            if self.overload is not None:
                for req, origin in self._g_retry.pop_due(now):
                    shed = self.frontdoor.offer(req, origin, now)
                    if shed is not None:
                        self._record_frontdoor_shed(req, origin,
                                                    now)
            self.frontdoor.pump(now)
            if self.overload is not None:
                self._g_fire_hedges(now)
            for cell in self.cells:
                cell.deliver_due(now)
                cell.step(now, tick)
            if self._done():
                break
            self._advance(tick)
        self.log.sort(key=lambda e: (e["finish_s"],
                                     e["request_id"]))
        return self._report(board_before)

    # -- reporting ----------------------------------------------------

    def _report(self, board_before: Dict[str, int]
                ) -> Dict[str, object]:
        span = self.clock.now()
        served_local = sum(
            1 for e in self.log
            if e["serving_zone"] is not None
            and e["serving_zone"] == e["origin"])
        zones: Dict[str, dict] = {}
        for zone in self.cfg.zones:
            entries = [e for e in self.log
                       if e["origin"] == zone]
            zones[zone] = {
                "requests": len(entries),
                "spilled_out": sum(
                    1 for e in entries
                    if e["serving_zone"] is not None
                    and e["serving_zone"] != zone),
                "shed": sum(1 for e in entries
                            if e["finish_reason"] == "shed"),
                "slo": self._zone_tracker[zone].report(
                    span_s=span),
            }
        report: Dict[str, object] = {
            "config": self.cfg.as_dict(),
            "seed": self.seed,
            "requests": self.requests,
            "completed": len(self.log),
            "virtual_s": round(span, 6),
            "global_slo": self.tracker.report(span_s=span),
            "served_in_origin_zone": served_local,
            "zones": zones,
            "cells": {c.name: c.report() for c in self.cells},
            "frontdoor": self.frontdoor.report(),
            "completions": self.log,
            "globe_counters":
                metrics.globe_board().snapshot_since(board_before),
            "ok": len(self.log) == self.requests,
        }
        if self.overload is not None:
            # with retries the log carries one entry per ATTEMPT;
            # ok when every original request reached a terminal
            # outcome (its base id appears)
            base_done = {e["request_id"].split("~r", 1)[0]
                         for e in self.log}
            report["ok"] = all(
                req.request_id in base_done
                for reqs in self.traces.values() for req in reqs)
            report["overload"] = self.overload.report()
        if self.tenancy is not None:
            ten_report = self.tenancy.report()
            ten_report["counters"] = metrics.tenant_board(
                ).snapshot_since(self._tenant_before)
            report["tenancy"] = ten_report
        trainers = {c.name: c.sim.trainer for c in self.cells
                    if c.sim.trainer is not None}
        if trainers:
            # the globe-level training roll-up: per-cell detail
            # lives in cells[*].training; the verdict joins ok
            trep = {name: t.report()
                    for name, t in sorted(trainers.items())}
            report["training"] = {
                "cells": sorted(trainers),
                "all_done": all(t["all_done"]
                                for t in trep.values()),
                "ledger_ok": all(t["ledger_ok"]
                                 for t in trep.values()),
                "lost_steps": sum(t["lost_steps"]
                                  for t in trep.values()),
                "rerun_steps": sum(t["rerun_steps"]
                                   for t in trep.values()),
            }
            report["ok"] = bool(report["ok"]
                                and report["training"]["ledger_ok"])
        if self.cfg.zoo is not None:
            report["zoo"] = {
                "warm": {c.name: sorted(c.models_warm())
                         for c in self.cells},
                "counters": metrics.zoo_board().snapshot_since(
                    self._zoo_before),
            }
        if self.chaos_applied:
            report["chaos"] = self.chaos_applied
        if self.planner is not None:
            report["planner"] = self.planner.report()
        return report


def attainment_over(log: Sequence[dict], t_from: float,
                    t_to: float = float("inf"),
                    zone: Optional[str] = None) -> Optional[float]:
    """SLO attainment over requests ARRIVING in a window, optionally
    restricted to one origin zone — how the globe chaos scenarios
    judge recovery and containment without the backlog-drain period
    polluting the number."""
    window = [e for e in log
              if t_from <= e["arrival_s"] < t_to
              and (zone is None or e["origin"] == zone)]
    if not window:
        return None
    return sum(1 for e in window if e["slo_ok"]) / len(window)
