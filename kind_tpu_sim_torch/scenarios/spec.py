"""ScenarioSpec — the declarative scenario layer (the port's copy of
``kind_tpu_sim/scenarios/spec.py``).

A :class:`ScenarioSpec` names one chaos experiment as pure data:
workload x topology x fault schedule x invariant set. Two flavors
share the class:

* ``kind="spec"`` — fully declarative. :func:`run_spec` compiles the
  spec into a concrete simulation: it generates the seeded workload,
  resolves every :class:`FaultWindow` (windows are FRACTIONS of the
  trace span, so the same spec scales across workloads) into
  fleet/globe chaos events, runs the sim, and returns the report.
  This is what the fuzzer (scenarios/fuzz.py) draws and what shrunk
  repros under ``tests/repros/`` pin; every run is priced from the
  H100's calibration and generation registry (``fleet/costmodel.py``).
* ``kind="legacy"`` — one of the hand-written scenarios in
  ``chaos.py``. The spec carries the scenario's declarative metadata
  (fault kinds, scope, named invariants, replayability) while the
  original function stays the executor, so every legacy name keeps
  producing byte-identical reports through the registry
  (scenarios/registry.py).

Everything here is a pure function of (spec, seed): specs round-trip
through sorted-keys JSON (:meth:`ScenarioSpec.as_dict` /
:meth:`ScenarioSpec.from_dict`), which is the repro-pinning contract
— a violation the fuzzer shrinks is replayable from its file alone.

The wire key ``needs_jax`` is the reference's, kept so that its pinned
repros load and the reports stay byte-equal; in the port it says that a
scenario drives device work (``chaos.Scenario.device``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from kind_tpu_sim_torch.chaos import FAULT_KINDS, FAULT_SCHEMAS
from kind_tpu_sim_torch.fleet import costmodel

SPEC_KINDS = ("spec", "legacy")

# Serving-replica service shape shared by every compiled spec: the
# fuzzer varies load and faults, not the replica micro-model.
_PROMPT_LEN = (4, 16)
_MAX_NEW = (4, 10)

# The generation mix every zoo-flavored spec runs on: replicas
# (fleet) or cells (globe) cycle over the registry's generations. The
# reference cycles a small-HBM and a big-HBM TPU generation; the port's
# registry holds the H100 alone, so every replica or cell runs it.
_SPEC_GENERATIONS = tuple(costmodel.GENERATIONS)


@dataclasses.dataclass(frozen=True)
class WorkloadDims:
    """The workload axes a spec varies: arrival process, rate, trace
    length, and the per-request deadline. Lengths stay at the module
    defaults — the fuzzer explores load shape, not token shape."""

    process: str = "poisson"     # poisson | bursty | diurnal
    rps: float = 40.0
    n_requests: int = 100
    deadline_s: Optional[float] = None

    def as_dict(self) -> dict:
        return {
            "process": self.process,
            "rps": self.rps,
            "n_requests": self.n_requests,
            "deadline_s": self.deadline_s,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadDims":
        return cls(process=d["process"], rps=float(d["rps"]),
                   n_requests=int(d["n_requests"]),
                   deadline_s=d.get("deadline_s"))


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Where the spec runs: one serving fleet (optionally
    scheduler-backed, the prerequisite for node/link/training
    faults) or a multi-zone globe."""

    kind: str = "fleet"          # fleet | globe
    replicas: int = 2            # fleet replicas / globe per cell
    sched: bool = False          # fleet only (globe cells always are)
    zones: int = 2               # globe only
    cells_per_zone: int = 1      # globe only
    disagg: bool = False         # fleet only; phase-split pools
    tenancy: bool = False        # fleet only; default_tenancy() pop
    # model zoo: default_zoo() traffic on a fleet (fleet) or cells
    # (globe) cycled over _SPEC_GENERATIONS — the prerequisite for the
    # zoo fault kinds
    zoo: bool = False
    # sampled duplicate-compute integrity audits:
    # this fraction of served requests re-executes on a second
    # replica and CRC-compares — the serving-side SDC detection
    # channel. 0 (the default) keeps the audit lane off and every
    # pre-SDC pinned spec byte-identical.
    audit_frac: float = 0.0

    def as_dict(self) -> dict:
        out = {
            "kind": self.kind,
            "replicas": self.replicas,
            "sched": self.sched,
            "zones": self.zones,
            "cells_per_zone": self.cells_per_zone,
            "disagg": self.disagg,
            "tenancy": self.tenancy,
        }
        # conditional so every pre-zoo pinned spec keeps its bytes
        if self.zoo:
            out["zoo"] = True
        if self.audit_frac:
            out["audit_frac"] = self.audit_frac
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        return cls(kind=d["kind"], replicas=int(d["replicas"]),
                   sched=bool(d["sched"]), zones=int(d["zones"]),
                   cells_per_zone=int(d["cells_per_zone"]),
                   disagg=bool(d.get("disagg", False)),
                   tenancy=bool(d.get("tenancy", False)),
                   zoo=bool(d.get("zoo", False)),
                   audit_frac=float(d.get("audit_frac", 0.0)))


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    """One timed fault: ``kind`` (a FAULT_KINDS member) strikes
    ``target`` over ``[start_frac, end_frac]`` of the trace span.
    Fractions keep the window meaningful under trace shrinking —
    the shrinker halves ``n_requests`` without re-deriving the
    schedule. ``param`` is the kind's magnitude per its
    FaultSchema (0 = no magnitude)."""

    kind: str
    start_frac: float
    end_frac: float
    target: int = 0
    param: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: "
                f"{', '.join(FAULT_KINDS)}")
        if not 0.0 <= self.start_frac <= self.end_frac <= 1.0:
            raise ValueError(
                f"fault window [{self.start_frac}, {self.end_frac}]"
                " must satisfy 0 <= start <= end <= 1")

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "start_frac": self.start_frac,
            "end_frac": self.end_frac,
            "target": self.target,
            "param": self.param,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultWindow":
        return cls(kind=d["kind"],
                   start_frac=float(d["start_frac"]),
                   end_frac=float(d["end_frac"]),
                   target=int(d["target"]),
                   param=float(d["param"]))


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named chaos experiment as data. ``invariants`` names
    entries of the invariant catalog (scenarios/invariants.py)
    checked on every run; for ``kind="spec"`` the UNIVERSAL set is
    checked regardless (that is what universal means)."""

    name: str
    description: str = ""
    kind: str = "spec"
    seed: int = 0
    topology: TopologySpec = TopologySpec()
    workload: WorkloadDims = WorkloadDims()
    faults: Tuple[FaultWindow, ...] = ()
    fault_kinds: Tuple[str, ...] = ()   # legacy metadata only
    training_gangs: int = 0
    overload: bool = False
    invariants: Tuple[str, ...] = ()
    needs_jax: bool = False     # the wire key: the port's Scenario.device
    slow: bool = False
    replayable: bool = False
    max_virtual_s: float = 240.0

    def __post_init__(self) -> None:
        if self.kind not in SPEC_KINDS:
            raise ValueError(
                f"unknown spec kind {self.kind!r}; known: "
                f"{', '.join(SPEC_KINDS)}")
        for k in self.fault_kinds:
            if k not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {k!r} in spec "
                    f"{self.name!r}")

    def all_fault_kinds(self) -> Tuple[str, ...]:
        """The kinds this spec exercises: declared metadata for
        legacy scenarios, derived from the windows for spec runs."""
        if self.kind == "legacy":
            return tuple(sorted(set(self.fault_kinds)))
        return tuple(sorted({f.kind for f in self.faults}))

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "kind": self.kind,
            "seed": self.seed,
            "topology": self.topology.as_dict(),
            "workload": self.workload.as_dict(),
            "faults": [f.as_dict() for f in self.faults],
            "fault_kinds": list(self.fault_kinds),
            "training_gangs": self.training_gangs,
            "overload": self.overload,
            "invariants": list(self.invariants),
            "needs_jax": self.needs_jax,
            "slow": self.slow,
            "replayable": self.replayable,
            "max_virtual_s": self.max_virtual_s,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            kind=d.get("kind", "spec"),
            seed=int(d.get("seed", 0)),
            topology=TopologySpec.from_dict(d["topology"]),
            workload=WorkloadDims.from_dict(d["workload"]),
            faults=tuple(FaultWindow.from_dict(f)
                         for f in d.get("faults", ())),
            fault_kinds=tuple(d.get("fault_kinds", ())),
            training_gangs=int(d.get("training_gangs", 0)),
            overload=bool(d.get("overload", False)),
            invariants=tuple(d.get("invariants", ())),
            needs_jax=bool(d.get("needs_jax", False)),
            slow=bool(d.get("slow", False)),
            replayable=bool(d.get("replayable", False)),
            max_virtual_s=float(d.get("max_virtual_s", 240.0)),
        )


# -- spec validation ---------------------------------------------------


def spec_problems(spec: ScenarioSpec) -> List[str]:
    """Why ``spec`` cannot compile (empty = valid). The fuzzer only
    emits valid specs by construction; this is the gate for repro
    files and hand-written specs."""
    problems: List[str] = []
    if spec.kind == "legacy":
        return problems
    topo = spec.topology
    if topo.kind not in ("fleet", "globe"):
        problems.append(
            f"unknown topology kind {topo.kind!r} (fleet|globe)")
        return problems
    exclusive = 0
    for f in spec.faults:
        schema = FAULT_SCHEMAS.get(f.kind)
        if schema is None:
            problems.append(f"fault kind {f.kind!r} has no schema")
            continue
        if not schema.fuzzable:
            problems.append(
                f"fault kind {f.kind!r} is not composable into a "
                "spec run (FaultSchema.fuzzable is False)")
        if topo.kind not in schema.scopes:
            problems.append(
                f"fault kind {f.kind!r} does not apply to "
                f"{topo.kind!r} topologies (scopes: "
                f"{', '.join(schema.scopes)})")
        if "sched" in schema.needs and (topo.kind == "fleet"
                                        and not topo.sched):
            problems.append(
                f"fault kind {f.kind!r} needs a scheduler-backed "
                "fleet (topology.sched)")
        if "training" in schema.needs and spec.training_gangs <= 0:
            problems.append(
                f"fault kind {f.kind!r} needs training_gangs > 0")
        if "overload" in schema.needs and not spec.overload:
            problems.append(
                f"fault kind {f.kind!r} needs overload controls on")
        if "disagg" in schema.needs and not (topo.kind == "fleet"
                                             and topo.disagg):
            problems.append(
                f"fault kind {f.kind!r} needs a disaggregated "
                "fleet (topology.disagg)")
        if "tenancy" in schema.needs and not (topo.kind == "fleet"
                                              and topo.tenancy):
            problems.append(
                f"fault kind {f.kind!r} needs a tenanted fleet "
                "(topology.tenancy)")
        if "zoo" in schema.needs and not topo.zoo:
            problems.append(
                f"fault kind {f.kind!r} needs a model-zoo "
                "topology (topology.zoo)")
        if "sdc" in schema.needs and topo.kind != "fleet":
            problems.append(
                f"fault kind {f.kind!r} only applies to fleet "
                "topologies (the SDC machinery is per fleet)")
        if schema.exclusive:
            exclusive += 1
    if exclusive > 1:
        problems.append(
            "at most one exclusive fault kind (zone_loss / "
            "herd_failover / demand_surge / noisy_neighbor / "
            "tenant_surge) per spec")
    if topo.tenancy and topo.kind != "fleet":
        problems.append(
            "topology.tenancy only applies to fleet topologies "
            "(globe tenancy runs through GlobeConfig.tenancy)")
    if topo.disagg and topo.kind != "fleet":
        problems.append(
            "topology.disagg only applies to fleet topologies")
    if topo.disagg and topo.sched:
        problems.append(
            "topology.disagg is incompatible with a scheduler-"
            "backed fleet (phased pools pin their own placements)")
    if topo.zoo and topo.disagg:
        problems.append(
            "topology.zoo is incompatible with a disaggregated "
            "fleet (the zoo's warm-pool state is per unified "
            "replica)")
    if topo.audit_frac and topo.kind != "fleet":
        problems.append(
            "topology.audit_frac only applies to fleet topologies")
    if topo.audit_frac and topo.disagg:
        problems.append(
            "topology.audit_frac is incompatible with a "
            "disaggregated fleet (audit copies are whole-request "
            "re-executions on unified replicas)")
    if not 0.0 <= topo.audit_frac <= 1.0:
        problems.append(
            f"topology.audit_frac {topo.audit_frac} must lie in "
            "[0, 1]")
    if topo.zoo and topo.kind == "fleet" and topo.sched:
        problems.append(
            "topology.zoo spec fleets pin generations directly; "
            "scheduler-backed zoo fleets run through FleetConfig "
            "(FleetSchedConfig.replica_accelerator)")
    if spec.training_gangs and topo.kind == "fleet" and not topo.sched:
        problems.append(
            "training_gangs need a scheduler-backed fleet")
    if spec.training_gangs and topo.kind == "globe":
        problems.append(
            "spec runs keep training on fleet topologies "
            "(globe training needs bespoke cell headroom)")
    if topo.kind == "globe" and topo.zones < 2:
        # zone-scale faults need a spill destination; the compiler
        # (_globe_events) always spares zone 0, which only works
        # when another zone exists
        if any(f.kind in ("zone_loss", "herd_failover", "cell_drain",
                          "generation_cell_drain")
               for f in spec.faults):
            problems.append(
                "zone-scale faults need at least 2 zones (zone 0 "
                "is always spared as the spill destination)")
    return problems


# -- compiling a spec into a run --------------------------------------


def _trace_span(trace) -> float:
    if not trace:
        return 0.0
    return max(r.arrival_s for r in trace)


def _fleet_events(spec: ScenarioSpec, span: float):
    """FaultWindow -> fleet ChaosEvents. Strike at start, heal at
    end; replica_flap cycles twice inside its window; the train
    kinds are instantaneous (the gang guard/rollback machinery IS
    the recovery)."""
    from kind_tpu_sim_torch import fleet

    events = []
    replicas = max(1, spec.topology.replicas)
    for f in sorted(spec.faults,
                    key=lambda w: (w.start_frac, w.kind, w.target)):
        t0 = round(span * f.start_frac, 6)
        t1 = round(span * f.end_frac, 6)
        if f.kind == "replica_preempt":
            rid = f.target % replicas
            events.append(fleet.ChaosEvent(t0, "preempt", rid))
            events.append(fleet.ChaosEvent(t1, "restore", rid))
        elif f.kind == "replica_flap":
            rid = f.target % replicas
            mid0 = round(t0 + (t1 - t0) * 0.4, 6)
            mid1 = round(t0 + (t1 - t0) * 0.6, 6)
            events.append(fleet.ChaosEvent(t0, "preempt", rid))
            events.append(fleet.ChaosEvent(mid0, "restore", rid))
            events.append(fleet.ChaosEvent(mid1, "preempt", rid))
            events.append(fleet.ChaosEvent(t1, "restore", rid))
        elif f.kind == "slow_replica":
            rid = f.target % replicas
            events.append(fleet.ChaosEvent(
                t0, "slow", rid, max(1.0, f.param)))
            events.append(fleet.ChaosEvent(t1, "unslow", rid))
        elif f.kind == "node_drain":
            node = f.target % 4   # default 4x8 pod = 4 hosts
            events.append(fleet.ChaosEvent(t0, "node_drain", node))
            events.append(fleet.ChaosEvent(t1, "node_restore",
                                           node))
        elif f.kind == "node_fail":
            node = f.target % 4
            events.append(fleet.ChaosEvent(t0, "node_fail", node))
            events.append(fleet.ChaosEvent(t1, "node_restore",
                                           node))
        elif f.kind == "degraded_link":
            events.append(fleet.ChaosEvent(
                t0, "link_degrade", 0, max(0.01, f.param)))
            events.append(fleet.ChaosEvent(t1, "link_restore", 0))
        elif f.kind == "prefill_pool_loss":
            events.append(fleet.ChaosEvent(
                t0, "prefill_pool_loss", 0))
            events.append(fleet.ChaosEvent(
                t1, "prefill_pool_restore", 0))
        elif f.kind == "kv_transfer_degrade":
            events.append(fleet.ChaosEvent(
                t0, "kv_degrade", 0, max(0.01, f.param)))
            events.append(fleet.ChaosEvent(t1, "kv_restore", 0))
        elif f.kind == "train_preempt":
            gang = f.target % max(1, spec.training_gangs)
            events.append(fleet.ChaosEvent(t0, "train_preempt",
                                           gang))
        elif f.kind == "train_kill":
            gang = f.target % max(1, spec.training_gangs)
            events.append(fleet.ChaosEvent(t0, "train_kill", gang))
        elif f.kind == "sdc_chip":
            # instantaneous strike, NO heal: the defect persists
            # until detection quarantines the chip —
            # on a training fleet it seeds a gang chip, else a
            # serving replica's chip
            if spec.training_gangs > 0:
                # raw target: the trainer hashes it into a gang
                # chip index, any value is a valid seed
                events.append(fleet.ChaosEvent(
                    t0, "sdc_train_chip", f.target,
                    max(0.0, f.param)))
            else:
                # serving strikes must name a live replica — the
                # sim matches replica_id exactly, so an unwrapped
                # fuzz/tune target of 0..7 on a small fleet would
                # silently miss
                events.append(fleet.ChaosEvent(
                    t0, "sdc_chip", f.target % replicas,
                    max(0.0, f.param)))
        elif f.kind == "correlated_domain_fault":
            events.append(fleet.ChaosEvent(
                t0, "domain_fault", f.target))
            events.append(fleet.ChaosEvent(
                t1, "domain_restore", f.target))
        elif f.kind == "model_swap_storm":
            # `param` eviction pulses spread evenly across the
            # window — each one drops every resident model, so the
            # warm pool rebuilds from scratch that many times
            pulses = max(1, int(f.param))
            for k in range(pulses):
                frac = k / max(1, pulses - 1) if pulses > 1 else 0.0
                events.append(fleet.ChaosEvent(
                    round(t0 + (t1 - t0) * frac, 6),
                    "model_swap_evict", 0))
        # demand_surge is a trace transform, not an event
    return events


def _globe_events(spec: ScenarioSpec, span: float, zones, cells):
    from kind_tpu_sim_torch import globe

    events = []
    for f in sorted(spec.faults,
                    key=lambda w: (w.start_frac, w.kind, w.target)):
        t0 = round(span * f.start_frac, 6)
        t1 = round(span * f.end_frac, 6)
        if f.kind in ("zone_loss", "herd_failover"):
            # spare zone 0: the spill destination (spec_problems)
            zone = zones[1 + f.target % max(1, len(zones) - 1)]
            events.append(globe.GlobeChaosEvent(t0, f.kind, zone))
            events.append(globe.GlobeChaosEvent(
                t1, "zone_restore", zone))
        elif f.kind == "dcn_degrade":
            zone = zones[f.target % len(zones)]
            events.append(globe.GlobeChaosEvent(
                t0, "dcn_degrade", zone, max(0.01, f.param)))
            events.append(globe.GlobeChaosEvent(
                t1, "dcn_restore", zone))
        elif f.kind == "cell_drain":
            cell = cells[1 + f.target % max(1, len(cells) - 1)]
            events.append(globe.GlobeChaosEvent(
                t0, "cell_drain", cell))
            events.append(globe.GlobeChaosEvent(
                t1, "cell_undrain", cell))
        elif f.kind == "generation_cell_drain":
            # generation-skewed capacity loss: every cell of the
            # targeted generation drains at once — the models only
            # that generation fits must ride out the window on warm
            # survivors or shed loudly. Cell 0 is always spared (the
            # spill-destination rule); on the port's one generation
            # that drains every cell but cell 0.
            gens = _SPEC_GENERATIONS
            gen = gens[f.target % len(gens)]
            for i, cell in enumerate(cells):
                if i == 0 or gens[i % len(gens)] != gen:
                    continue
                events.append(globe.GlobeChaosEvent(
                    t0, "cell_drain", cell))
                events.append(globe.GlobeChaosEvent(
                    t1, "cell_undrain", cell))
    return events


def _training_config(spec: ScenarioSpec):
    from kind_tpu_sim_torch import fleet

    if not spec.training_gangs:
        return None
    # topology 2x8 = one host ROW on the default 4x8 inventory: it
    # tiles next to the serving replicas' 2x4 placements (the
    # `fleet run --train` shape, cli.py)
    return fleet.TrainingConfig(gangs=tuple(
        fleet.TrainingGangConfig(name=f"gang{i}", topology="2x8",
                                 total_steps=40)
        for i in range(spec.training_gangs)))


def run_spec(spec: ScenarioSpec, seed: Optional[int] = None,
             event_core: Optional[bool] = None) -> Dict[str, object]:
    """Compile and run one declarative spec; the report is a pure
    function of (spec, seed). ``event_core`` forces the event-heap
    core on/off (None = knob default) — the lever the
    event-core-equality invariant pulls."""
    if spec.kind == "legacy":
        raise ValueError(
            f"spec {spec.name!r} is a legacy scenario; run it via "
            "scenarios.registry (chaos.run_scenario)")
    problems = spec_problems(spec)
    if problems:
        raise ValueError(
            f"invalid spec {spec.name!r}: " + "; ".join(problems))
    use_seed = spec.seed if seed is None else int(seed)
    if spec.topology.kind == "globe":
        return _run_globe_spec(spec, use_seed, event_core)
    return _run_fleet_spec(spec, use_seed, event_core)


def _run_fleet_spec(spec: ScenarioSpec, seed: int,
                    event_core: Optional[bool]) -> Dict[str, object]:
    from kind_tpu_sim_torch import fleet

    tenancy = None
    if spec.topology.tenancy:
        from kind_tpu_sim_torch.fleet.tenancy import default_tenancy
        tenancy = default_tenancy()
    zoo = None
    if spec.topology.zoo:
        from kind_tpu_sim_torch.fleet.zoo import default_zoo
        zoo = default_zoo()
    wl = fleet.WorkloadSpec(
        process=spec.workload.process, rps=spec.workload.rps,
        n_requests=spec.workload.n_requests,
        prompt_len=_PROMPT_LEN, max_new=_MAX_NEW,
        deadline_s=spec.workload.deadline_s,
        tenancy=tenancy, zoo=zoo)
    base = fleet.generate_trace(wl, seed)
    span = _trace_span(base)
    surges = [f for f in spec.faults if f.kind == "demand_surge"]
    tsurges = [f for f in spec.faults
               if f.kind in ("noisy_neighbor", "tenant_surge")]
    if surges:
        s = surges[0]
        trace = fleet.surge_trace(
            wl, seed, round(span * s.start_frac, 6),
            round(span * s.end_frac, 6), max(1.0, s.param))
    elif tsurges:
        # the tenant-scoped surge transforms:
        # noisy_neighbor floods from the batch scavenger, a
        # tenant_surge strikes the tenant the target indexes
        from kind_tpu_sim_torch.fleet.tenancy import tenant_surge_trace
        s = tsurges[0]
        names = sorted(t.name for t in tenancy.tenants)
        batch = [t.name for t in tenancy.tenants
                 if t.qos == "batch"]
        who = (batch[0] if s.kind == "noisy_neighbor" and batch
               else names[s.target % len(names)])
        trace = tenant_surge_trace(
            wl, seed, round(span * s.start_frac, 6),
            round(span * s.end_frac, 6), max(1.0, s.param), who)
    else:
        trace = base
    if any(f.kind == "correlated_domain_fault"
           for f in spec.faults):
        # domain faults need labeled failure domains: a 4-pod
        # inventory grouped 2 pods per rack, so one
        # draw takes out half the fleet's placements at once
        sched = fleet.FleetSchedConfig(
            pods=(("tpu-v5-lite-podslice", "4x8"),) * 4,
            rack_pods=2)
    elif spec.topology.sched:
        sched = fleet.FleetSchedConfig()
    else:
        sched = None
    disagg = None
    if spec.topology.disagg:
        # even split, prefill-heavy remainder; spec_problems already
        # rejected disagg x sched
        p = max(1, spec.topology.replicas // 2)
        d = max(1, spec.topology.replicas - p)
        disagg = fleet.DisaggConfig(prefill_replicas=p,
                                    decode_replicas=d)
    cfg = fleet.FleetConfig(
        replicas=(disagg.prefill_replicas + disagg.decode_replicas
                  if disagg else spec.topology.replicas),
        policy="least-outstanding",
        sched=sched,
        overload=(fleet.OverloadConfig() if spec.overload
                  else None),
        training=_training_config(spec),
        disagg=disagg,
        tenancy=tenancy,
        zoo=zoo,
        generations=(_SPEC_GENERATIONS if zoo is not None
                     else None),
        audit_frac=(spec.topology.audit_frac
                    if spec.topology.audit_frac else None),
        max_virtual_s=spec.max_virtual_s,
        event_core=event_core)
    events = _fleet_events(spec, span)
    return fleet.FleetSim(cfg, trace, chaos_events=events).run()


def _run_globe_spec(spec: ScenarioSpec, seed: int,
                    event_core: Optional[bool]) -> Dict[str, object]:
    from kind_tpu_sim_torch import globe

    zones = tuple(f"zone-{chr(ord('a') + i)}"
                  for i in range(spec.topology.zones))
    zoo = None
    if spec.topology.zoo:
        from kind_tpu_sim_torch.fleet.zoo import default_zoo
        zoo = default_zoo()
    cfg = globe.GlobeConfig(
        zones=zones,
        cells_per_zone=spec.topology.cells_per_zone,
        replicas_per_cell=spec.topology.replicas,
        overload=(globe.OverloadConfig() if spec.overload
                  else None),
        zoo=zoo,
        generations=(_SPEC_GENERATIONS if zoo is not None
                     else None),
        workload=globe.GlobeWorkloadSpec(
            process=spec.workload.process,
            rps=spec.workload.rps,
            n_per_zone=spec.workload.n_requests,
            prompt_len=_PROMPT_LEN, max_new=_MAX_NEW,
            deadline_s=spec.workload.deadline_s),
        max_virtual_s=spec.max_virtual_s,
        event_core=event_core)
    traces = globe.generate_globe_traces(cfg, seed)
    span = max((_trace_span(t) for t in traces.values()),
               default=0.0)
    cells = cfg.cell_names()
    events = _globe_events(spec, span, list(zones), cells)
    return globe.GlobeSim(cfg, traces=traces, seed=seed,
                          chaos_events=events).run()
