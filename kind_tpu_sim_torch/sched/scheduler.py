"""Deterministic gang scheduler over the simulated TPU inventory.

The port's copy of ``kind_tpu_sim/sched/scheduler.py``, the ``sched run``
loop and its seeded workload included. The control loop the reference
exists to let people *test* but never
models itself: a pending queue of slice requests, gang (all-or-
nothing) admission onto the :mod:`~kind_tpu_sim_torch.sched.inventory`,
pluggable placement scoring, priority preemption, and a
defragmentation pass — all on the fleet's virtual clock, all pure
functions of (config, seed).

Scheduling semantics, mapped from real Cloud TPU / GKE behavior:

* **Gang admission** — a multi-host slice binds every host of its
  contiguous block or nothing; a partially-placed gang would be a
  deadlock generator (half a v5e-16 can't run a single collective).
* **Scoring policies** — ``binpack`` (most-allocated feasible spot
  first: consolidates, frees whole domains), ``spread`` (least-
  allocated first: blast-radius insurance), ``ici`` (fragmentation-
  aware: pick the placement that leaves the LARGEST contiguous free
  host block — the policy that keeps multi-host slices placeable).
* **Priority preemption** — a gang that cannot fit may evict
  strictly-lower-priority gangs (lowest priority first, youngest
  binding first) until its placement is feasible; victims requeue.
* **Defragmentation** — ``defrag_pass()`` proposes migrations of
  strictly-lower-priority gangs to open a contiguous hole for a
  stuck pending gang; each migration must itself be placeable, so
  the pass converges (bounded by live gang count) and never
  displaces equal-or-higher priority work.

Every decision appends one event to :attr:`ClusterScheduler.events`
— ``Queued`` / ``Scheduled`` / ``FailedScheduling`` / ``Preempted`` /
``Migrated`` / ``Released`` — with kubernetes-style reasons, so the
same seed + config always yields a byte-identical event log
(the ``sched run --seed N`` contract).
"""

from __future__ import annotations

import dataclasses
import random
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch import topology as topo
from kind_tpu_sim_torch.sched.inventory import (
    Inventory,
    Placement,
    build_inventory,
)

POLICIES = ("binpack", "spread", "ici")

SCHED_SEED_ENV = knobs.SCHED_SEED


def resolve_seed(seed: Optional[int] = None) -> int:
    """Explicit seed > env (KIND_TPU_SIM_SCHED_SEED) > 0."""
    if seed is not None:
        return int(seed)
    return int(knobs.get(SCHED_SEED_ENV))


@dataclasses.dataclass(frozen=True)
class SliceRequest:
    """One gang: a TPU slice request with scheduling metadata.

    ``topology`` is the requested chip grid (e.g. ``4x4``); the host
    block it needs is derived through
    :class:`~kind_tpu_sim_torch.topology.SliceTopology` exactly as the
    orchestrator derives worker counts. ``hold_s`` is how long the
    gang runs once bound (0 = forever); ``priority`` follows the
    kubernetes convention (higher evicts lower)."""

    name: str
    accelerator: str = topo.DEFAULT_ACCELERATOR
    topology: str = topo.DEFAULT_TOPOLOGY
    priority: int = 0
    arrival_s: float = 0.0
    hold_s: float = 0.0
    pool: Optional[str] = None
    # pin to one topology.kubernetes.io/zone (None = any zone): the
    # kubeface maps a zone nodeSelector here, and the globe layer's
    # per-zone cells pin their gangs to their own zone's inventory
    zone: Optional[str] = None

    @property
    def slice_topo(self) -> topo.SliceTopology:
        return topo.make_slice(self.accelerator, self.topology)

    @property
    def num_hosts(self) -> int:
        return self.slice_topo.num_hosts

    @property
    def host_block(self) -> Tuple[int, ...]:
        return self.slice_topo.host_grid

    @property
    def chips_per_node(self) -> int:
        return self.slice_topo.chips_per_host

    @property
    def num_chips(self) -> int:
        return self.slice_topo.num_chips

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "accelerator": self.accelerator,
            "topology": self.topology,
            "priority": self.priority,
            "arrival_s": round(self.arrival_s, 6),
            "hold_s": round(self.hold_s, 6),
            "pool": self.pool,
            "zone": self.zone,
        }


@dataclasses.dataclass
class BoundGang:
    request: SliceRequest
    placement: Placement
    bound_s: float
    seq: int                      # binding order (preemption age key)
    release_s: Optional[float]    # None = runs forever

    def as_dict(self) -> dict:
        return {
            "request": self.request.as_dict(),
            "placement": self.placement.as_dict(),
            "bound_s": round(self.bound_s, 6),
        }


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Scheduler knobs. ``cycle_s`` is the virtual time between
    scheduling passes; ``bind_s`` models per-gang binding latency
    (API-server + kubelet admission), charged once per gang —
    time-to-routable = queue wait + bind_s (+ consumer warm-up)."""

    policy: str = "ici"
    preemption: bool = True
    defrag: bool = True
    cycle_s: float = 0.1
    bind_s: float = 0.05
    max_defrag_moves: int = 4     # migrations per pass

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {self.policy!r}; known: "
                f"{', '.join(POLICIES)}")


class ClusterScheduler:
    """The pending queue + placement engine over one Inventory.

    ``on_evict(request)`` fires for every preempted/migrated gang
    BEFORE it requeues — the hook the fleet layer uses to route
    scheduler evictions through the chaos ``replica_preempt``
    machinery (displaced serving traffic requeues at the router)."""

    def __init__(self, inventory: Inventory,
                 cfg: SchedConfig = SchedConfig(),
                 on_evict: Optional[
                     Callable[[SliceRequest], None]] = None):
        self.inv = inventory
        self.cfg = cfg
        self.on_evict = on_evict
        self.pending: List[SliceRequest] = []
        self.bound: Dict[str, BoundGang] = {}
        self.events: List[dict] = []
        self.unschedulable: List[SliceRequest] = []
        self._seq = 0
        self._arrival_seq: Dict[str, int] = {}
        # kube-scheduler-style event dedup: FailedScheduling repeats
        # with an UNCHANGED message are counted, not re-emitted (a
        # stuck gang would otherwise spam one event per cycle)
        self._last_fail_msg: Dict[str, str] = {}
        self.failed_attempts = 0

    # -- events ------------------------------------------------------

    def _event(self, at_s: float, etype: str, gang: str,
               message: str, **extra) -> None:
        ev = {"at_s": round(at_s, 6), "type": etype, "gang": gang,
              "message": message}
        ev.update(extra)
        self.events.append(ev)

    # -- queue -------------------------------------------------------

    def submit(self, req: SliceRequest, now: float) -> None:
        if req.name in self._arrival_seq:
            raise ValueError(f"duplicate gang name {req.name!r}")
        self._arrival_seq[req.name] = self._seq
        self._seq += 1
        self.pending.append(req)
        self._event(now, "Queued", req.name,
                    f"{req.accelerator} {req.topology} "
                    f"priority={req.priority}")
        metrics.sched_board().incr("gangs_submitted")

    def _queue_order(self) -> List[SliceRequest]:
        """Priority desc, then arrival order — the strict service
        order every pass walks."""
        return sorted(
            self.pending,
            key=lambda r: (-r.priority, self._arrival_seq[r.name]))

    # -- placement scoring -------------------------------------------

    def _score(self, req: SliceRequest,
               p: Placement) -> Tuple:
        """Lower is better; ties break on (domain, anchor), so the
        choice is a pure function of inventory state. Two GRAY keys
        lead every policy (docs/HEALTH.md): a degraded-link domain
        scores after every healthy one, and a placement touching
        `avoid`-marked (gray-suspect) nodes after every clean one —
        degraded capacity is last-resort capacity, never a tie-break
        winner."""
        dom = self.inv.domains[p.domain]
        gray = (1 if dom.degraded else 0,
                1 if any(self.inv.nodes[n].avoid
                         for n in p.node_names) else 0)
        if self.cfg.policy == "binpack":
            # most-allocated feasible domain, then node, first
            return gray + (dom.free_chips(),
                           sum(self.inv.nodes[n].free
                               for n in p.node_names),
                           p.domain, p.anchor)
        if self.cfg.policy == "spread":
            return gray + (-dom.free_chips(),
                           -sum(self.inv.nodes[n].free
                                for n in p.node_names),
                           p.domain, p.anchor)
        # ici: simulate the bind, keep the placement that leaves the
        # largest contiguous free host block (least fragmentation)
        self.inv.bind(p)
        try:
            frag = -dom.largest_free_block()
        finally:
            self.inv.release(p)
        return gray + (frag, dom.free_chips(), p.domain, p.anchor)

    def _best_placement(
            self, req: SliceRequest) -> Optional[Placement]:
        cands = self.inv.candidate_placements(
            accelerator=req.accelerator,
            host_block=req.host_block,
            chips_per_node=req.chips_per_node,
            pool=req.pool, zone=req.zone)
        if not cands:
            return None
        return min(cands, key=lambda p: self._score(req, p))

    # -- binding -----------------------------------------------------

    def _bind(self, req: SliceRequest, placement: Placement,
              now: float) -> BoundGang:
        self.inv.bind(placement)
        gang = BoundGang(
            request=req, placement=placement,
            bound_s=now, seq=self._seq,
            release_s=(now + self.cfg.bind_s + req.hold_s
                       if req.hold_s > 0 else None))
        self._seq += 1
        self.bound[req.name] = gang
        self._event(
            now, "Scheduled", req.name,
            f"bound {req.num_hosts} host(s) in {placement.domain} "
            f"at {','.join(str(c) for c in placement.anchor)}",
            nodes=list(placement.node_names))
        metrics.sched_board().incr("gangs_scheduled")
        return gang

    def _evict(self, gang: BoundGang, now: float,
               reason: str, requeue: bool = True) -> None:
        self.inv.release(gang.placement)
        del self.bound[gang.request.name]
        self._event(now, "Preempted", gang.request.name, reason,
                    nodes=list(gang.placement.node_names))
        metrics.sched_board().incr("preemptions")
        if self.on_evict is not None:
            self.on_evict(gang.request)
        if requeue:
            self.pending.append(gang.request)

    def withdraw(self, name: str, now: float,
                 reason: str = "withdrawn") -> bool:
        """Remove a PENDING gang from the queue and free its name
        for resubmission — the training tenant's elastic-resize
        lever (docs/TRAINING.md): evict, withdraw the auto-requeued
        old-shape request, resubmit at the new shape. A bound gang
        must be evicted or released first."""
        for i, req in enumerate(self.pending):
            if req.name == name:
                del self.pending[i]
                self._arrival_seq.pop(name, None)
                self._last_fail_msg.pop(name, None)
                self._event(now, "Withdrawn", name, reason)
                metrics.sched_board().incr("gangs_withdrawn")
                return True
        return False

    def release(self, name: str, now: float,
                reason: str = "completed") -> None:
        gang = self.bound.pop(name, None)
        if gang is None:
            return
        self.inv.release(gang.placement)
        self._event(now, "Released", name, reason)
        metrics.sched_board().incr("gangs_released")

    def evict_gang(self, name: str, now: float,
                   reason: str) -> bool:
        """Evict one bound gang by name and requeue it — the gray-
        failure migration entry point (docs/HEALTH.md): a fleet that
        quarantined a replica evicts its gang here, and the next
        scheduling pass rebinds it wherever the (degraded-last,
        avoid-last) scoring sends it, through the same bounded
        defrag/preemption machinery as any pending gang."""
        gang = self.bound.get(name)
        if gang is None:
            return False
        self._evict(gang, now, reason)
        metrics.sched_board().incr("gray_evictions")
        return True

    # -- preemption --------------------------------------------------

    def _try_preempt(self, req: SliceRequest,
                     now: float) -> Optional[Placement]:
        """Evict strictly-lower-priority gangs until ``req`` fits.
        Victim order: lowest priority first, youngest binding first
        — the kubernetes eviction convention. Rolls back (no
        eviction happens) if even evicting every eligible victim
        would not make the gang placeable."""
        victims = sorted(
            (g for g in self.bound.values()
             if g.request.priority < req.priority),
            key=lambda g: (g.request.priority, -g.seq))
        if not victims:
            return None
        evicted: List[BoundGang] = []
        placement = None
        for victim in victims:
            self.inv.release(victim.placement)
            evicted.append(victim)
            placement = self._best_placement(req)
            if placement is not None:
                break
        if placement is None:
            for victim in evicted:
                self.inv.bind(victim.placement)
            return None
        # commit: rebind the trial-released victims, then evict them
        # for real so accounting and hooks fire exactly once each
        for victim in evicted:
            self.inv.bind(victim.placement)
        for victim in evicted:
            self._evict(
                victim, now,
                f"preempted by higher-priority gang {req.name} "
                f"(priority {victim.request.priority} < "
                f"{req.priority})")
        return self._best_placement(req)

    # -- defragmentation ---------------------------------------------

    def defrag_pass(self, req: SliceRequest, now: float) -> bool:
        """Open a contiguous hole for ``req`` by MIGRATING strictly-
        lower-priority gangs (evict + immediately rebind elsewhere).
        A move only commits when the displaced gang has somewhere
        else to go AND the move makes ``req`` placeable (or strictly
        grows the largest free block); at most
        ``cfg.max_defrag_moves`` migrations. Returns True when
        ``req`` became placeable."""
        moves = 0
        while moves < self.cfg.max_defrag_moves:
            if self._best_placement(req) is not None:
                return True
            movable = sorted(
                (g for g in self.bound.values()
                 if g.request.priority < req.priority),
                key=lambda g: (g.request.priority, -g.seq))
            moved = False
            for gang in movable:
                before = max(
                    (d.largest_free_block()
                     for d in self.inv.domains.values()), default=0)
                self.inv.release(gang.placement)
                target = self._best_alternative(gang)
                if target is None:
                    self.inv.bind(gang.placement)
                    continue
                self.inv.bind(target)
                fits = self._best_placement(req) is not None
                after = max(
                    (d.largest_free_block()
                     for d in self.inv.domains.values()), default=0)
                if not fits and after <= before:
                    # useless move: roll back
                    self.inv.release(target)
                    self.inv.bind(gang.placement)
                    continue
                old = gang.placement
                gang.placement = target
                self._event(
                    now, "Migrated", gang.request.name,
                    f"defrag: {old.domain}@"
                    f"{','.join(str(c) for c in old.anchor)} -> "
                    f"{target.domain}@"
                    f"{','.join(str(c) for c in target.anchor)} "
                    f"to place {req.name}",
                    nodes=list(target.node_names))
                metrics.sched_board().incr("defrag_migrations")
                if self.on_evict is not None:
                    self.on_evict(gang.request)
                moves += 1
                moved = True
                break
            if not moved:
                return self._best_placement(req) is not None
        return self._best_placement(req) is not None

    def _best_alternative(
            self, gang: BoundGang) -> Optional[Placement]:
        """Best NEW placement for a migrating gang (its old one is
        already released); must differ from the old anchor so a
        'migration' cannot be a no-op."""
        req = gang.request
        cands = [
            p for p in self.inv.candidate_placements(
                accelerator=req.accelerator,
                host_block=req.host_block,
                chips_per_node=req.chips_per_node,
                pool=req.pool, zone=req.zone)
            if (p.domain, p.anchor) != (gang.placement.domain,
                                        gang.placement.anchor)]
        if not cands:
            return None
        return min(cands, key=lambda p: self._score(req, p))

    # -- the scheduling pass -----------------------------------------

    def step(self, now: float) -> List[BoundGang]:
        """One scheduling cycle: release expired gangs, then walk
        the queue in strict (priority, FIFO) order. A gang that
        cannot be placed — even after preemption/defrag — emits
        FailedScheduling and BLOCKS lower-priority pending gangs of
        the same or larger shape only via ordering (smaller gangs
        behind it may still fit; kube-scheduler behaves the same
        way across priority bands)."""
        for name in sorted(self.bound):
            gang = self.bound[name]
            if (gang.release_s is not None
                    and gang.release_s <= now):
                self.release(name, now, reason="hold expired")
        newly: List[BoundGang] = []
        for req in self._queue_order():
            placement = self._best_placement(req)
            via = "fit"
            if placement is None and self.cfg.defrag:
                if self.defrag_pass(req, now):
                    placement = self._best_placement(req)
                    via = "defrag"
            if placement is None and self.cfg.preemption:
                placement = self._try_preempt(req, now)
                if placement is not None:
                    via = "preemption"
            if placement is None:
                free = self.inv.free_chips()
                msg = (f"0/{len(self.inv.nodes)} nodes available: "
                       f"insufficient contiguous google.com/tpu "
                       f"(need {req.num_hosts} whole host(s) "
                       f"x{req.chips_per_node} chips, "
                       f"{free} chips free, fragmented)")
                self.failed_attempts += 1
                metrics.sched_board().incr("failed_scheduling")
                if self._last_fail_msg.get(req.name) != msg:
                    self._last_fail_msg[req.name] = msg
                    self._event(now, "FailedScheduling",
                                req.name, msg)
                continue
            self._last_fail_msg.pop(req.name, None)
            self.pending.remove(req)
            gang = self._bind(req, placement, now)
            if via != "fit":
                self.events[-1]["via"] = via
            newly.append(gang)
        return newly

    # -- reporting ---------------------------------------------------

    def placement_snapshot(self) -> dict:
        return {
            name: self.bound[name].as_dict()
            for name in sorted(self.bound)}

    def report(self) -> dict:
        counts: Dict[str, int] = {}
        for ev in self.events:
            counts[ev["type"]] = counts.get(ev["type"], 0) + 1
        return {
            "policy": self.cfg.policy,
            "events": self.events,
            "event_counts": dict(sorted(counts.items())),
            "bound": self.placement_snapshot(),
            "pending": [r.as_dict() for r in self._queue_order()],
            "inventory": self.inv.as_dict(),
        }


# ---------------------------------------------------------------------
# seeded workload + the `sched run` simulation loop


@dataclasses.dataclass(frozen=True)
class SchedWorkloadSpec:
    """Seeded gang-arrival workload for the scheduler sim. Shapes
    are drawn from ``shapes`` (accelerator, topology, weight);
    priorities uniform over ``priorities``; arrivals exponential at
    ``gangs_per_s`` on the virtual clock; holds uniform in
    ``hold_s``."""

    n_gangs: int = 24
    gangs_per_s: float = 2.0
    shapes: Tuple = (
        ("tpu-v5-lite-podslice", "2x4", 4),   # single host
        ("tpu-v5-lite-podslice", "4x4", 3),   # 2 hosts
        ("tpu-v5-lite-podslice", "4x8", 2),   # 4 hosts
        ("tpu-v5-lite-podslice", "2x2", 2),   # sub-host (4 chips)
    )
    priorities: Tuple[int, ...] = (0, 0, 1, 2)
    hold_s: Tuple[float, float] = (2.0, 10.0)


def generate_gangs(spec: SchedWorkloadSpec,
                   seed: Optional[int] = None) -> List[SliceRequest]:
    """Pure function of (spec, seed) — the ChaosSchedule recipe: the
    rng is keyed by the canonical argument repr, so workload identity
    is exactly argument identity."""
    seed = resolve_seed(seed)
    key = repr((seed, dataclasses.astuple(spec)))
    rng = random.Random(zlib.crc32(key.encode("utf-8")))
    weights = [s[2] for s in spec.shapes]
    now = 0.0
    out: List[SliceRequest] = []
    for i in range(spec.n_gangs):
        now += rng.expovariate(spec.gangs_per_s)
        acc, topo_str, _ = rng.choices(
            list(spec.shapes), weights=weights)[0]
        out.append(SliceRequest(
            name=f"gang-{i:03d}",
            accelerator=acc,
            topology=topo_str,
            priority=rng.choice(list(spec.priorities)),
            arrival_s=round(now, 6),
            hold_s=round(rng.uniform(*spec.hold_s), 6),
        ))
    return out


@dataclasses.dataclass(frozen=True)
class SchedSimConfig:
    """One `sched run`: inventory shape + scheduler knobs + seeded
    workload + optional node chaos."""

    pods: Tuple = (("tpu-v5-lite-podslice", "4x8"),
                   ("tpu-v5-lite-podslice", "4x8"))
    sched: SchedConfig = SchedConfig()
    workload: SchedWorkloadSpec = SchedWorkloadSpec()
    max_virtual_s: float = 600.0
    # (at_s, action, node_name): node_drain cordons + evicts,
    # node_fail breaks, node_restore heals either
    node_events: Tuple = ()


def run_sched_sim(cfg: SchedSimConfig,
                  seed: Optional[int] = None) -> dict:
    """Drive a seeded gang workload through the scheduler on the
    virtual clock; the report (sorted-keys JSON) is byte-identical
    for the same (cfg, seed)."""
    seed = resolve_seed(seed)
    board_before = metrics.sched_board().counts()
    inv = build_inventory(list(cfg.pods))
    sched = ClusterScheduler(inv, cfg.sched)
    gangs = generate_gangs(cfg.workload, seed)
    pending_arrivals = list(gangs)
    node_events = sorted(cfg.node_events,
                         key=lambda e: (e[0], e[2], e[1]))
    now = 0.0
    bound_at: Dict[str, float] = {}
    ttr: Dict[str, float] = {}
    while now <= cfg.max_virtual_s:
        while node_events and node_events[0][0] <= now:
            _, action, node_name = node_events.pop(0)
            apply_node_event(sched, action, node_name, now)
        while (pending_arrivals
               and pending_arrivals[0].arrival_s <= now):
            sched.submit(pending_arrivals.pop(0), now)
        for gang in sched.step(now):
            name = gang.request.name
            bound_at[name] = now
            ttr[name] = round(
                now - gang.request.arrival_s + cfg.sched.bind_s, 6)
        if (not pending_arrivals and not sched.pending
                and not node_events
                and all(g.release_s is None
                        for g in sched.bound.values())):
            break
        now = round(now + cfg.sched.cycle_s, 9)
    ttrs = [ttr[g.name] for g in gangs if g.name in ttr]
    report = {
        "seed": seed,
        "policy": cfg.sched.policy,
        "gangs": len(gangs),
        "scheduled": len(ttr),
        "virtual_s": round(now, 6),
        "time_to_routable": {
            "mean_s": (round(sum(ttrs) / len(ttrs), 6)
                       if ttrs else None),
            "max_s": round(max(ttrs), 6) if ttrs else None,
        },
        "events": sched.events,
        "event_counts": sched.report()["event_counts"],
        "placement": sched.placement_snapshot(),
        "sched_counters": metrics.sched_board().snapshot_since(
            board_before),
        "ok": len(ttr) == len(gangs),
    }
    return report


def apply_link_event(sched: ClusterScheduler, action: str,
                     domain_id: str, factor: float,
                     now: float) -> None:
    """The gray face of the scheduler: ``link_degrade`` marks an ICI
    domain's slowest link at ``factor`` of nominal bandwidth — the
    domain stays schedulable but scores LAST and every consumer's
    modeled collective time inflates (docs/HEALTH.md);
    ``link_restore`` heals it."""
    if domain_id not in sched.inv.domains:
        raise ValueError(f"unknown ICI domain {domain_id!r}")
    if action == "link_degrade":
        sched.inv.set_link_factor(domain_id, factor)
        sched._event(now, "LinkDegraded", "-",
                     f"{domain_id} link_factor={factor}")
        metrics.sched_board().incr("links_degraded")
    elif action == "link_restore":
        sched.inv.set_link_factor(domain_id, 1.0)
        sched._event(now, "LinkRestored", "-", domain_id)
        metrics.sched_board().incr("links_restored")
    else:
        raise ValueError(f"unknown link event {action!r}")


def apply_node_event(sched: ClusterScheduler, action: str,
                     node_name: str, now: float) -> None:
    """The chaos face of the scheduler: ``node_drain`` cordons the
    node and evicts (requeues) every gang with a chip on it —
    kubectl drain; ``node_fail`` additionally marks the node broken
    (capacity gone) — a host crash; ``node_restore`` heals both."""
    inv = sched.inv
    if node_name not in inv.nodes:
        raise ValueError(f"unknown node {node_name!r}")
    if action == "node_restore":
        inv.uncordon(node_name)
        inv.restore_node(node_name)
        sched._event(now, "NodeRestored", "-", node_name)
        metrics.sched_board().incr("nodes_restored")
        return
    if action == "node_drain":
        inv.cordon(node_name)
        metrics.sched_board().incr("nodes_drained")
    elif action == "node_fail":
        inv.fail_node(node_name)
        metrics.sched_board().incr("nodes_failed")
    else:
        raise ValueError(f"unknown node event {action!r}")
    sched._event(now, "NodeDrained" if action == "node_drain"
                 else "NodeFailed", "-", node_name)
    victims = [g for g in sched.bound.values()
               if node_name in g.placement.node_names]
    for gang in sorted(victims, key=lambda g: g.seq):
        sched._evict(
            gang, now,
            f"{action}: node {node_name} "
            + ("drained" if action == "node_drain" else "failed"))
        metrics.recovery_log().record(
            f"sched_{action}_evict", gang=gang.request.name,
            node=node_name, at_s=round(now, 6))
