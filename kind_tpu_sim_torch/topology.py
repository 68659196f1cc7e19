"""TPU slice topology math for the simulated cluster's inventory.

The port's copy of what the scheduler and the training gangs read from
``kind_tpu_sim/topology.py``: the accelerator table, the node label and
taint keys, topology parsing, :class:`SliceTopology` (chips, hosts, the
host grid, per-host labels) and the contiguous sub-block geometry the
scheduler's ICI-fit placement enumerates. The inventory describes the
simulated TPU cluster the fleet's gangs are placed on, so its labels
stay the reference's TPU labels; the engines themselves run on
whatever device the fleet was built for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

# Node label keys.  GKE-compatible where a GKE convention exists, a
# simulator-scoped domain otherwise.
LABEL_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"
LABEL_TOPOLOGY = "cloud.google.com/gke-tpu-topology"
LABEL_WORKER_ID = "kind-tpu-sim.dev/worker-id"
LABEL_HOST_COORD = "kind-tpu-sim.dev/host-coord"
LABEL_SLICE_ID = "kind-tpu-sim.dev/slice-id"  # multislice (DCN) tier
LABEL_HARDWARE_TYPE = "hardware-type"  # selector key kept from the reference

# Taint applied to simulated TPU nodes (GKE uses google.com/tpu=present).
TAINT_KEY = "google.com/tpu"
TAINT_VALUE = "present"
TAINT_EFFECT = "NoSchedule"


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """Static facts about one TPU generation as simulated here."""

    gke_type: str             # value of LABEL_ACCELERATOR
    family: str               # "v5litepod", "v4", "v5p"
    ndims: int                # topology rank: 2 for v5e, 3 for v4/v5p
    host_bounds: Tuple[int, ...]  # chip grid owned by one host
    cores_per_chip: int       # naming only: v4/v5p advertise 2 cores/chip

    @property
    def chips_per_host(self) -> int:
        return math.prod(self.host_bounds)


ACCELERATORS: Dict[str, AcceleratorSpec] = {
    "tpu-v5-lite-podslice": AcceleratorSpec(
        gke_type="tpu-v5-lite-podslice",
        family="v5litepod",
        ndims=2,
        host_bounds=(2, 4),
        cores_per_chip=1,
    ),
    "tpu-v4-podslice": AcceleratorSpec(
        gke_type="tpu-v4-podslice",
        family="v4",
        ndims=3,
        host_bounds=(2, 2, 1),
        cores_per_chip=2,
    ),
    "tpu-v5p-slice": AcceleratorSpec(
        gke_type="tpu-v5p-slice",
        family="v5p",
        ndims=3,
        host_bounds=(2, 2, 1),
        cores_per_chip=2,
    ),
}

DEFAULT_ACCELERATOR = "tpu-v5-lite-podslice"
DEFAULT_TOPOLOGY = "4x4"


def parse_topology(topology: str) -> Tuple[int, ...]:
    """``"4x4"`` -> ``(4, 4)``; validates positive integers."""
    try:
        dims = tuple(int(part) for part in topology.lower().split("x"))
    except ValueError as exc:
        raise ValueError(f"malformed topology {topology!r}") from exc
    if not dims or any(d < 1 for d in dims):
        raise ValueError(f"malformed topology {topology!r}")
    return dims


def format_topology(dims: Tuple[int, ...]) -> str:
    return "x".join(str(d) for d in dims)


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A concrete simulated TPU slice: accelerator generation + topology.

    ``hosts`` maps 1:1 onto kind worker nodes; worker IDs are assigned
    row-major over the host grid, matching libtpu's task ordering.
    """

    spec: AcceleratorSpec
    dims: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.dims) != self.spec.ndims:
            raise ValueError(
                f"{self.spec.gke_type} expects {self.spec.ndims}-D topology, "
                f"got {format_topology(self.dims)}"
            )
        # Single-host slices (<= one host's worth of chips) may be any
        # shape; multi-host slices must tile exactly into host blocks.
        if self.num_chips > self.spec.chips_per_host:
            for dim, host_dim in zip(self.dims, self.spec.host_bounds):
                if dim < host_dim or dim % host_dim:
                    raise ValueError(
                        f"topology {format_topology(self.dims)} not "
                        f"divisible by host bounds {self.spec.host_bounds}"
                    )

    # -- sizes ----------------------------------------------------------

    @property
    def num_chips(self) -> int:
        return math.prod(self.dims)

    @property
    def host_grid(self) -> Tuple[int, ...]:
        """How hosts tile the chip grid, e.g. 4x4 over 2x4 hosts -> (2, 1)."""
        if self.num_chips <= self.spec.chips_per_host:
            return (1,) * self.spec.ndims
        return tuple(
            dim // host_dim
            for dim, host_dim in zip(self.dims, self.spec.host_bounds)
        )

    @property
    def num_hosts(self) -> int:
        if self.num_chips <= self.spec.chips_per_host:
            return 1
        return math.prod(self.host_grid)

    @property
    def chips_per_host(self) -> int:
        return self.num_chips // self.num_hosts

    # -- per-host structure --------------------------------------------

    def host_coords(self) -> List[Tuple[int, ...]]:
        """Row-major (last dim fastest) coordinates of each host."""
        grid = self.host_grid
        coords: List[Tuple[int, ...]] = []
        for flat in range(self.num_hosts):
            coord = []
            rem = flat
            for stride in _suffix_products(grid):
                coord.append(rem // stride)
                rem %= stride
            coords.append(tuple(coord))
        return coords

    # -- simulator surface ---------------------------------------------

    def _check_worker(self, worker_id: int) -> None:
        if not 0 <= worker_id < self.num_hosts:
            raise ValueError(
                f"worker_id {worker_id} out of range for "
                f"{self.num_hosts}-host slice"
            )

    def node_labels(self, worker_id: int) -> Dict[str, str]:
        """Labels the orchestrator applies to kind worker ``worker_id``."""
        self._check_worker(worker_id)
        coord = self.host_coords()[worker_id]
        return {
            LABEL_HARDWARE_TYPE: "tpu",
            LABEL_ACCELERATOR: self.spec.gke_type,
            LABEL_TOPOLOGY: format_topology(self.dims),
            LABEL_WORKER_ID: str(worker_id),
            LABEL_HOST_COORD: ",".join(str(c) for c in coord),
        }


def _suffix_products(grid: Tuple[int, ...]) -> List[int]:
    out: List[int] = []
    acc = 1
    for d in reversed(grid):
        out.append(acc)
        acc *= d
    return list(reversed(out))


# ---------------------------------------------------------------------
# contiguous sub-block geometry (the scheduler's ICI-fit primitive)


def enumerate_block_anchors(
    outer: Tuple[int, ...], block: Tuple[int, ...]
) -> List[Tuple[int, ...]]:
    """Every anchor (minimum corner) at which an axis-aligned
    ``block`` fits inside the ``outer`` grid, in lexicographic order.

    This is the geometric core of ICI-contiguous placement
    (:mod:`kind_tpu_sim.sched`): a multi-host slice request occupies
    a contiguous axis-aligned box of hosts inside one ICI domain's
    host grid — TPU ICI links only connect grid neighbors, so a
    non-contiguous gang would have no wired path between its hosts.
    No rotation: slice topologies are requested in pod orientation
    (GKE does not rotate slices either).
    """
    if len(outer) != len(block):
        raise ValueError(
            f"rank mismatch: outer {outer} vs block {block}")
    if any(b < 1 for b in block):
        raise ValueError(f"malformed block {block}")
    if any(b > o for o, b in zip(outer, block)):
        return []
    ranges = [range(o - b + 1) for o, b in zip(outer, block)]
    anchors: List[Tuple[int, ...]] = []

    def rec(prefix: Tuple[int, ...], rest) -> None:
        if not rest:
            anchors.append(prefix)
            return
        for v in rest[0]:
            rec(prefix + (v,), rest[1:])

    rec((), ranges)
    return anchors


def block_coords(
    anchor: Tuple[int, ...], block: Tuple[int, ...]
) -> List[Tuple[int, ...]]:
    """Row-major coordinates of every cell in the axis-aligned box
    ``block`` anchored at ``anchor``."""
    coords: List[Tuple[int, ...]] = []

    def rec(prefix: Tuple[int, ...], dims) -> None:
        if not dims:
            coords.append(prefix)
            return
        a, b = dims[0]
        for v in range(a, a + b):
            rec(prefix + (v,), dims[1:])

    rec((), list(zip(anchor, block)))
    return coords


def make_slice(
    accelerator: str = DEFAULT_ACCELERATOR,
    topology: str = DEFAULT_TOPOLOGY,
) -> SliceTopology:
    try:
        spec = ACCELERATORS[accelerator]
    except KeyError as exc:
        raise ValueError(
            f"unknown accelerator {accelerator!r}; "
            f"known: {sorted(ACCELERATORS)}"
        ) from exc
    return SliceTopology(spec=spec, dims=parse_topology(topology))
