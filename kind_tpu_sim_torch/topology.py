"""TPU slice topology math for the simulated cluster.

The port's copy of ``kind_tpu_sim/topology.py``: the accelerator table,
the node label and taint keys, topology parsing, :class:`SliceTopology`
(chips, hosts, the host grid, per-host labels, the libtpu worker
environment and the device plugin's device IDs), the contiguous
sub-block geometry the scheduler's ICI-fit placement enumerates, and
:class:`MultiSlice` (the DCN tier). The scheduler's inventory, the
cluster layer's ``tpu`` vendor (``config.SimConfig``, ``cluster.py``,
the plugin DaemonSet) and the multi-host launchers and manifests
(``parallel/mesh.py``, ``parallel/multihost.py``) read it; the
standard library is all it imports. The simulated TPU cluster keeps the
reference's TPU labels, and the engines run on whatever device the
fleet was built for.
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
# slice 0's rendezvous port: the multislice coordinator's here, each
# host's jax.distributed / torch.distributed one in parallel/multihost.py
DEFAULT_COORDINATOR_PORT = 8476


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

    @property
    def accelerator_type(self) -> str:
        """libtpu-style name, e.g. ``v5litepod-16`` or ``v4-16``.

        v4/v5p names count TensorCores (2/chip); v5e counts chips.
        """
        n = self.num_chips * self.spec.cores_per_chip
        return f"{self.spec.family}-{n}"

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

    def chip_bounds_for_host(self) -> Tuple[int, ...]:
        """Chip-grid block owned by each host (CHIPS_PER_HOST_BOUNDS)."""
        if self.num_chips <= self.spec.chips_per_host:
            return self.dims
        return self.spec.host_bounds

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

    def worker_env(
        self, worker_id: int, hostnames: List[str] | None = None
    ) -> Dict[str, str]:
        """The libtpu/JAX environment contract for one simulated worker.

        These are the variables a real TPU VM exposes and that
        ``jax.distributed`` / libtpu probe at startup; the device plugin
        injects them via its Allocate response so a pod landing on the
        node sees a coherent TPU worker identity.
        """
        self._check_worker(worker_id)
        if hostnames is None:
            hostnames = default_hostnames(self.num_hosts)
        bounds = self.chip_bounds_for_host()
        host_grid = self.host_grid
        # libtpu bounds strings are always 3-D; pad 2-D (v5e) with 1.
        pad = (1,) * (3 - len(bounds))
        env = {
            "TPU_ACCELERATOR_TYPE": self.accelerator_type,
            "TPU_CHIPS_PER_HOST_BOUNDS": ",".join(
                str(d) for d in bounds + pad
            ),
            "TPU_HOST_BOUNDS": ",".join(
                str(d) for d in host_grid + (1,) * (3 - len(host_grid))
            ),
            "TPU_WORKER_ID": str(worker_id),
            "TPU_WORKER_HOSTNAMES": ",".join(hostnames),
            "TPU_SKIP_MDS_QUERY": "true",
        }
        return env

    def device_ids(self, worker_id: int) -> List[str]:
        """Stable device-plugin IDs for one host's chips, e.g. ``tpu-0-3``."""
        self._check_worker(worker_id)
        base = worker_id * self.chips_per_host
        return [
            f"tpu-{worker_id}-{base + i}"
            for i in range(self.chips_per_host)
        ]


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


def default_hostnames(num_hosts: int) -> List[str]:
    """Stable in-cluster DNS names for the multi-host JAX StatefulSet.

    Matches ``pods/jax-multihost.yaml`` (headless service ``tpu-sim`` in
    the default namespace).
    """
    return [
        f"jax-tpu-{i}.tpu-sim.default.svc.cluster.local"
        for i in range(num_hosts)
    ]


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


# ---------------------------------------------------------------------
# multislice (DCN tier)


@dataclasses.dataclass(frozen=True)
class MultiSlice:
    """N identical ICI slices joined over DCN (TPU multislice).

    The real system: each slice is its own ICI domain; traffic between
    slices rides the data-center network, coordinated by libtpu's
    "megascale" layer, which workers discover through MEGASCALE_* env
    vars. The simulator mirrors exactly that split: per-slice worker
    identity stays `SliceTopology.worker_env` (the ICI contract), this
    class adds the cross-slice contract (env + labels), and
    the port's ``parallel/mesh.py`` (which names this class
    ``MultiSliceShape``) gives its worlds the same outermost 'dcn' axis.
    """

    slice_topo: SliceTopology
    num_slices: int

    def __post_init__(self) -> None:
        if self.num_slices < 1:
            raise ValueError("num_slices must be >= 1")

    @property
    def num_chips(self) -> int:
        return self.num_slices * self.slice_topo.num_chips

    @property
    def num_hosts(self) -> int:
        return self.num_slices * self.slice_topo.num_hosts

    def _check_slice(self, slice_id: int) -> None:
        if not 0 <= slice_id < self.num_slices:
            raise ValueError(
                f"slice_id {slice_id} out of range for "
                f"{self.num_slices}-slice job")

    def node_labels(self, slice_id: int, worker_id: int) -> Dict[str, str]:
        """Per-node labels: the slice's own labels plus the slice id,
        so scheduling can pin a replica group to one ICI domain."""
        self._check_slice(slice_id)
        labels = dict(self.slice_topo.node_labels(worker_id))
        labels[LABEL_SLICE_ID] = str(slice_id)
        return labels

    def device_ids(self, global_worker: int) -> List[str]:
        """Device-plugin IDs for one node by its GLOBAL worker index —
        the job-level counterpart of ``SliceTopology.device_ids``.

        The plugin derives IDs from NODE_NAME's global index with the
        same ``worker_id * chips + i`` scheme regardless of slice
        (DevicePlugin::DeviceIds, plugin/src/device_plugin.cc:151), so
        this is THE in-Python source of truth for any tooling (chaos,
        tests) addressing nodes of slice >= 1."""
        if not 0 <= global_worker < self.num_hosts:
            raise ValueError(
                f"global worker {global_worker} out of range for "
                f"{self.num_hosts}-host job")
        chips = self.slice_topo.chips_per_host
        base = global_worker * chips
        return [
            f"tpu-{global_worker}-{base + i}" for i in range(chips)
        ]

    def hostnames(self) -> List[str]:
        """Canonical pod DNS names across every slice, slice-major —
        THE global list the device plugin receives whole and windows
        per slice. Single-slice jobs keep the historical names
        (`default_hostnames`); multislice jobs get one StatefulSet +
        headless Service per slice (manifests.jax_multihost_manifest),
        hence per-slice DNS."""
        if self.num_slices == 1:
            return default_hostnames(self.slice_topo.num_hosts)
        return [
            f"jax-tpu-s{s}-{i}.tpu-sim-s{s}.default.svc.cluster.local"
            for s in range(self.num_slices)
            for i in range(self.slice_topo.num_hosts)
        ]

    def slice_hostnames(self, slice_id: int) -> List[str]:
        """One slice's window of :meth:`hostnames` — each slice is its
        own jax.distributed world."""
        self._check_slice(slice_id)
        h = self.slice_topo.num_hosts
        return self.hostnames()[slice_id * h:(slice_id + 1) * h]

    def megascale_env(
        self, slice_id: int,
        coordinator: str | None = None,
    ) -> Dict[str, str]:
        """libtpu's cross-slice discovery contract (the DCN analog of
        ``worker_env``): which slice this worker belongs to, how many
        slices exist, and where slice 0's coordinator lives."""
        self._check_slice(slice_id)
        if coordinator is None:
            coordinator = (f"{self.hostnames()[0]}:"
                           f"{DEFAULT_COORDINATOR_PORT}")
        return {
            "MEGASCALE_COORDINATOR_ADDRESS": coordinator,
            "MEGASCALE_NUM_SLICES": str(self.num_slices),
            "MEGASCALE_SLICE_ID": str(slice_id),
        }

    def worker_env(
        self, slice_id: int, worker_id: int,
        hostnames: List[str] | None = None,
    ) -> Dict[str, str]:
        """Full env for one worker: ICI identity (with THIS slice's
        hostname window — each slice is its own jax.distributed
        world) + DCN identity. Matches what the device plugin's
        AllocateEnv computes from the global list."""
        if hostnames is None:
            hostnames = self.slice_hostnames(slice_id)
        env = self.slice_topo.worker_env(worker_id, hostnames)
        env.update(self.megascale_env(slice_id))
        return env


def make_multislice(
    num_slices: int,
    accelerator: str = DEFAULT_ACCELERATOR,
    topology: str = DEFAULT_TOPOLOGY,
) -> MultiSlice:
    return MultiSlice(slice_topo=make_slice(accelerator, topology),
                      num_slices=num_slices)
