"""Simulated node inventory for the cluster scheduler.

The port's copy of ``kind_tpu_sim/sched/inventory.py``. The
scheduler's world model, derived from
:mod:`kind_tpu_sim_torch.topology`: every simulated TPU pool is one or more **ICI
domains** (physical pods/slices), each a grid of hosts; every host is
a :class:`Node` carrying ``google.com/tpu`` chip capacity, its GKE
label set (accelerator, topology, worker id, host coordinate), and a
pool/zone assignment.

Placement granularity mirrors Cloud TPU:

* a **multi-host** slice request binds an axis-aligned contiguous
  block of WHOLE hosts inside one ICI domain (ICI only wires grid
  neighbors — see :func:`kind_tpu_sim_torch.topology.enumerate_block_anchors`);
* a **single-host** request (``chips <= chips_per_host``) binds chips
  on one node and may share the host with other single-host slices —
  the v5e sub-host shapes (1x1, 2x2, 2x4) are chip-granular.

The inventory is pure bookkeeping: feasibility enumeration and
free-capacity accounting live here, *choosing* among feasible
placements (binpack / spread / ICI-contiguity scoring, preemption,
defrag) is :mod:`kind_tpu_sim_torch.sched.scheduler`'s job.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from kind_tpu_sim_torch import topology as topo

LABEL_POOL = "kind-tpu-sim.dev/pool"
LABEL_ZONE = "topology.kubernetes.io/zone"
# soft anti-affinity: the gray-failure layer marks nodes a
# quarantined gang vacated so its rebind (and later placements)
# steer elsewhere while the hardware stays suspect (docs/HEALTH.md)
LABEL_AVOID = "kind-tpu-sim.dev/avoid"


@dataclasses.dataclass
class Node:
    """One simulated host: a kind worker owning a block of chips."""

    name: str
    domain: str                    # owning ICI domain id
    coord: Tuple[int, ...]         # host coordinate in the domain grid
    capacity: int                  # google.com/tpu allocatable
    pool: str
    zone: str
    labels: Dict[str, str]
    free: int = -1                 # -1 -> set to capacity in __post_init__
    cordoned: bool = False         # drained: no new bindings
    broken: bool = False           # failed: capacity gone entirely
    avoid: bool = False            # gray-suspect: schedulable, scored last
    # correlated-failure grouping (docs/SDC.md): the rack / power
    # domain this host shares with others, "" when ungrouped — one
    # correlated_domain_fault takes out every node with the label
    failure_domain: str = ""
    # chip-granular quarantine (docs/SDC.md): defective chips pulled
    # out of allocatable capacity while the rest of the host serves
    quarantined_chips: int = 0

    def __post_init__(self) -> None:
        if self.free < 0:
            self.free = self.capacity

    @property
    def schedulable(self) -> bool:
        return not self.cordoned and not self.broken

    @property
    def whole_free(self) -> bool:
        """Free for a multi-host gang: the ENTIRE host is unused."""
        return self.schedulable and self.free == self.capacity

    def as_dict(self) -> dict:
        out = {
            "name": self.name,
            "domain": self.domain,
            "coord": list(self.coord),
            "capacity": self.capacity,
            "free": self.free,
            "pool": self.pool,
            "zone": self.zone,
            "cordoned": self.cordoned,
            "broken": self.broken,
            "avoid": self.avoid,
        }
        # conditional so every pre-SDC inventory report keeps its bytes
        if self.failure_domain:
            out["failure_domain"] = self.failure_domain
        if self.quarantined_chips:
            out["quarantined_chips"] = self.quarantined_chips
        return out


@dataclasses.dataclass
class IciDomain:
    """One physical pod/slice: a host grid wired by ICI.

    ``link_factor`` models the domain's slowest ICI link as a
    bandwidth multiplier in (0, 1]: 1.0 is a healthy fabric; below
    that the domain is GRAY-degraded — still schedulable, but scored
    last and inflating every collective on it
    (parallel/collectives.ici_slowdown, docs/HEALTH.md)."""

    domain_id: str
    accelerator: str               # topo.ACCELERATORS key
    host_grid: Tuple[int, ...]
    nodes: Dict[Tuple[int, ...], Node]
    link_factor: float = 1.0

    @property
    def spec(self) -> topo.AcceleratorSpec:
        return topo.ACCELERATORS[self.accelerator]

    @property
    def degraded(self) -> bool:
        return self.link_factor < 1.0

    def free_chips(self) -> int:
        return sum(n.free for n in self.nodes.values()
                   if n.schedulable)

    def whole_free_coords(self) -> set:
        return {c for c, n in self.nodes.items() if n.whole_free}

    def largest_free_block(self) -> int:
        """Host count of the largest axis-aligned box of whole-free
        hosts — the fragmentation metric ICI-contiguity scoring
        maximizes. Brute force over all box shapes/anchors; domain
        grids are tens of hosts, not thousands."""
        free = self.whole_free_coords()
        if not free:
            return 0
        best = 1
        shapes = _box_shapes(self.host_grid)
        for shape in shapes:
            size = 1
            for d in shape:
                size *= d
            if size <= best:
                continue
            for anchor in topo.enumerate_block_anchors(
                    self.host_grid, shape):
                if all(c in free
                       for c in topo.block_coords(anchor, shape)):
                    best = size
                    break
        return best


def _box_shapes(grid: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """All axis-aligned box shapes that could fit in ``grid``,
    largest volume first (so largest_free_block can early-exit)."""
    ranges = [range(1, d + 1) for d in grid]
    shapes: List[Tuple[int, ...]] = []

    def rec(prefix: Tuple[int, ...], rest) -> None:
        if not rest:
            shapes.append(prefix)
            return
        for v in rest[0]:
            rec(prefix + (v,), rest[1:])

    rec((), ranges)
    shapes.sort(key=lambda s: (-_prod(s), s))
    return shapes


def _prod(t: Tuple[int, ...]) -> int:
    out = 1
    for v in t:
        out *= v
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """A concrete feasible binding for one gang: which nodes, how
    many chips on each. Multi-host placements carry the anchor of
    their contiguous block; single-host ones anchor at the node."""

    domain: str
    anchor: Tuple[int, ...]
    node_names: Tuple[str, ...]
    chips_per_node: int

    def as_dict(self) -> dict:
        return {
            "domain": self.domain,
            "anchor": list(self.anchor),
            "nodes": list(self.node_names),
            "chips_per_node": self.chips_per_node,
        }


class Inventory:
    """All schedulable nodes, grouped into ICI domains."""

    def __init__(self, domains: List[IciDomain]):
        self.domains: Dict[str, IciDomain] = {
            d.domain_id: d for d in domains}
        self.nodes: Dict[str, Node] = {}
        for d in domains:
            for node in d.nodes.values():
                if node.name in self.nodes:
                    raise ValueError(
                        f"duplicate node name {node.name!r}")
                self.nodes[node.name] = node

    # -- feasibility -------------------------------------------------

    def candidate_placements(
        self, *, accelerator: str, host_block: Tuple[int, ...],
        chips_per_node: int, pool: Optional[str] = None,
        zone: Optional[str] = None,
    ) -> List[Placement]:
        """Every feasible placement, deterministic order (domain id,
        then anchor lexicographic). ``host_block`` is the request's
        host grid — ``(1,) * ndims`` means single-host and admits
        chip-granular sharing; anything larger requires whole-free
        hosts in a contiguous block. ``zone`` pins the placement to
        domains whose nodes carry that topology.kubernetes.io/zone
        (the kubeface nodeSelector contract, docs/GLOBE.md)."""
        out: List[Placement] = []
        single = all(b == 1 for b in host_block)
        for did in sorted(self.domains):
            dom = self.domains[did]
            if dom.accelerator != accelerator:
                continue
            if pool is not None and any(
                    n.pool != pool for n in dom.nodes.values()):
                continue
            if zone is not None and any(
                    n.zone != zone for n in dom.nodes.values()):
                continue
            if len(host_block) != len(dom.host_grid):
                continue
            if single:
                for coord in sorted(dom.nodes):
                    node = dom.nodes[coord]
                    if (node.schedulable
                            and node.free >= chips_per_node):
                        out.append(Placement(
                            domain=did, anchor=coord,
                            node_names=(node.name,),
                            chips_per_node=chips_per_node))
                continue
            # a host with quarantined chips is never whole for a
            # multi-host gang, whose hosts each give chips_per_node
            # (the reference offers it and bind() then raises: ROADMAP
            # C-16)
            free = {c for c in dom.whole_free_coords()
                    if dom.nodes[c].capacity >= chips_per_node}
            for anchor in topo.enumerate_block_anchors(
                    dom.host_grid, host_block):
                coords = topo.block_coords(anchor, host_block)
                if all(c in free for c in coords):
                    out.append(Placement(
                        domain=did, anchor=anchor,
                        node_names=tuple(
                            dom.nodes[c].name for c in coords),
                        chips_per_node=chips_per_node))
        return out

    # -- accounting --------------------------------------------------

    def bind(self, placement: Placement) -> None:
        for name in placement.node_names:
            node = self.nodes[name]
            if node.free < placement.chips_per_node:
                raise RuntimeError(
                    f"bind over capacity on {name}")
            node.free -= placement.chips_per_node

    def release(self, placement: Placement) -> None:
        for name in placement.node_names:
            node = self.nodes[name]
            node.free = min(node.capacity,
                            node.free + placement.chips_per_node)

    def cordon(self, node_name: str) -> None:
        self.nodes[node_name].cordoned = True

    def uncordon(self, node_name: str) -> None:
        self.nodes[node_name].cordoned = False

    def fail_node(self, node_name: str) -> None:
        self.nodes[node_name].broken = True

    def restore_node(self, node_name: str) -> None:
        self.nodes[node_name].broken = False

    def mark_avoid(self, node_name: str, flag: bool = True) -> None:
        """Soft anti-affinity: an avoid node stays schedulable but
        the scheduler prefers any placement that skips it."""
        node = self.nodes[node_name]
        node.avoid = flag
        if flag:
            node.labels[LABEL_AVOID] = "true"
        else:
            node.labels.pop(LABEL_AVOID, None)

    def quarantine_chips(self, node_name: str,
                         count: int = 1) -> None:
        """Chip-granular quarantine (docs/SDC.md): pull ``count``
        defective chips out of the node's allocatable capacity —
        finer than cordon/fail, the rest of the host keeps working —
        and mark the host avoid so new placements steer elsewhere."""
        node = self.nodes[node_name]
        count = min(count, node.capacity)
        node.capacity -= count
        node.free = min(node.free, node.capacity)
        node.quarantined_chips += count
        self.mark_avoid(node_name, True)

    def restore_chips(self, node_name: str,
                      count: Optional[int] = None) -> None:
        """Return quarantined chips to service (all by default) —
        the hardware-replaced path; clears avoid once the host is
        whole again."""
        node = self.nodes[node_name]
        back = (node.quarantined_chips if count is None
                else min(count, node.quarantined_chips))
        node.quarantined_chips -= back
        node.capacity += back
        node.free = min(node.capacity, node.free + back)
        if node.quarantined_chips == 0:
            self.mark_avoid(node_name, False)

    def failure_domain_nodes(self, failure_domain: str) -> List[str]:
        """Names of every node sharing one rack/power domain — the
        blast radius of a correlated_domain_fault (docs/SDC.md)."""
        return sorted(n.name for n in self.nodes.values()
                      if n.failure_domain == failure_domain)

    def failure_domains(self) -> List[str]:
        """Sorted distinct rack/power domain labels in the fleet
        ("" means no correlated grouping was declared)."""
        return sorted({n.failure_domain
                       for n in self.nodes.values()
                       if n.failure_domain})

    def set_link_factor(self, domain_id: str,
                        factor: float) -> None:
        if not 0.0 < factor <= 1.0:
            raise ValueError(
                f"link factor must be in (0, 1]; got {factor}")
        self.domains[domain_id].link_factor = factor

    # -- reporting ---------------------------------------------------

    def free_chips(self) -> int:
        return sum(d.free_chips() for d in self.domains.values())

    def capacity_chips(self) -> int:
        return sum(n.capacity for n in self.nodes.values()
                   if not n.broken)

    def as_dict(self) -> dict:
        return {
            "domains": {
                did: {
                    "accelerator": d.accelerator,
                    "host_grid": list(d.host_grid),
                    "link_factor": d.link_factor,
                    "free_chips": d.free_chips(),
                    "largest_free_block_hosts":
                        d.largest_free_block(),
                    "nodes": [d.nodes[c].as_dict()
                              for c in sorted(d.nodes)],
                }
                for did, d in sorted(self.domains.items())
            },
            "free_chips": self.free_chips(),
            "capacity_chips": self.capacity_chips(),
        }


def build_inventory(
    pods: List[Tuple[str, str]],
    *, pool: str = "default", zone: str = "zone-a",
    name_prefix: str = "tpu-node",
    rack_pods: Optional[int] = None,
) -> Inventory:
    """Inventory from physical pod shapes: ``pods`` is a list of
    (accelerator, topology) — each entry one ICI domain whose host
    grid comes from :class:`~kind_tpu_sim_torch.topology.SliceTopology`
    (so a v4-style ``2x2xN`` chip grid yields contiguous-placeable
    host sub-blocks). A 3-tuple (accelerator, topology, zone) entry
    overrides ``zone`` for THAT pod — how a multi-zone inventory
    (one failure domain per zone, docs/GLOBE.md) is declared. Node
    names/labels mirror what the orchestrator applies to kind
    workers. ``rack_pods`` groups every ``rack_pods`` consecutive
    pods into one rack/power ``failure_domain`` label
    (``rack-0``, ``rack-1``, ...) so correlated_domain_fault
    (docs/SDC.md) has a blast radius to draw; None (the default)
    leaves nodes ungrouped and every pre-SDC report byte-identical."""
    domains: List[IciDomain] = []
    for idx, pod in enumerate(pods):
        accelerator, topology = pod[0], pod[1]
        pod_zone = pod[2] if len(pod) > 2 else zone
        rack = (f"rack-{idx // rack_pods}"
                if rack_pods and rack_pods > 0 else "")
        s = topo.make_slice(accelerator, topology)
        did = f"pod-{idx}"
        nodes: Dict[Tuple[int, ...], Node] = {}
        coords = s.host_coords()
        for worker_id, coord in enumerate(coords):
            labels = dict(s.node_labels(worker_id))
            labels[LABEL_POOL] = pool
            labels[LABEL_ZONE] = pod_zone
            nodes[coord] = Node(
                name=f"{name_prefix}-{idx}-{worker_id}",
                domain=did,
                coord=coord,
                capacity=s.chips_per_host,
                pool=pool,
                zone=pod_zone,
                labels=labels,
                failure_domain=rack,
            )
        domains.append(IciDomain(
            domain_id=did, accelerator=accelerator,
            host_grid=s.host_grid, nodes=nodes))
    return Inventory(domains)
