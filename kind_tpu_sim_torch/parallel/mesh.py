"""Named meshes of ranks, in PyTorch.

Counterpart of ``kind_tpu_sim/parallel/mesh.py``. The reference lays
``jax.devices()`` out in a ``jax.sharding.Mesh``; here a device is a
rank of the ``torch.distributed`` world (one process each), and a
``Mesh`` lays the world's ranks out in the same grid with the same axis
names and order:

* ``slice_mesh`` -- the physical ('host', 'chip') mesh of a slice;
* ``training_mesh`` -- ('data', 'model'[, 'seq']), data outermost;
* ``multislice_mesh`` -- ('dcn', 'data', 'model'[, 'seq']);
* ``auto_training_mesh`` -- a near-square (data, model) split.

``SliceShape`` and ``MultiSliceShape`` also carry the environment
contract a simulated host is started with: the reference's
``topology.SliceTopology.worker_env`` and ``MultiSlice.megascale_env`` /
``worker_env``, key for key (``parallel/multihost.py`` launches hosts
from it).

A mesh spans the whole world: a rank outside it would have nothing to
run, so a world of another size raises ("needs N devices"). Every
process group a collective may ride (the ranks that differ only along a
set of axes) is created when the mesh is, in one fixed order on every
rank, because ``torch.distributed`` makes every rank take part in
making every group.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

# the chips per host of the reference's accelerators (its topology
# module's host bounds), and its default slice
_HOST_BOUNDS = {
    "tpu-v5-lite-podslice": (2, 4),
    "tpu-v4-podslice": (2, 2, 1),
    "tpu-v5p-slice": (2, 2, 1),
}
# (family, cores a chip) of each, for the libtpu accelerator name
_NAMING = {
    "tpu-v5-lite-podslice": ("v5litepod", 1),
    "tpu-v4-podslice": ("v4", 2),
    "tpu-v5p-slice": ("v5p", 2),
}
ACCELERATORS = tuple(_HOST_BOUNDS)
DEFAULT_ACCELERATOR = "tpu-v5-lite-podslice"
DEFAULT_TOPOLOGY = "4x4"
# the slice contract's rendezvous port (defined beside the multi-host
# identity, as in the reference)
from kind_tpu_sim_torch.parallel.multihost import (  # noqa: E402
    DEFAULT_COORDINATOR_PORT,
)


def _fmt(dims) -> str:
    return "x".join(str(d) for d in dims)


@dataclasses.dataclass(frozen=True)
class SliceShape:
    """The reference's ``topology.SliceTopology`` as the port needs it:
    the chip grid, how many hosts own it, and each host's environment
    contract (``worker_env``)."""

    accelerator: str
    dims: Tuple[int, ...]

    @property
    def num_chips(self) -> int:
        return math.prod(self.dims)

    @property
    def _bounds(self) -> Tuple[int, ...]:
        return _HOST_BOUNDS[self.accelerator]

    @property
    def host_grid(self) -> Tuple[int, ...]:
        """How hosts tile the chip grid, e.g. 4x4 over 2x4 hosts ->
        (2, 1)."""
        if self.num_chips <= math.prod(self._bounds):
            return (1,) * len(self.dims)
        return tuple(d // b for d, b in zip(self.dims, self._bounds))

    @property
    def num_hosts(self) -> int:
        return math.prod(self.host_grid)

    @property
    def chips_per_host(self) -> int:
        return self.num_chips // self.num_hosts

    @property
    def accelerator_type(self) -> str:
        """libtpu's name, e.g. ``v5litepod-16`` or ``v4-16`` (v4 and
        v5p count TensorCores, two a chip)."""
        family, cores = _NAMING[self.accelerator]
        return f"{family}-{self.num_chips * cores}"

    def chip_bounds_for_host(self) -> Tuple[int, ...]:
        """The chip block each host owns (CHIPS_PER_HOST_BOUNDS)."""
        if self.num_chips <= math.prod(self._bounds):
            return self.dims
        return self._bounds

    def _check_worker(self, worker_id: int) -> None:
        if not 0 <= worker_id < self.num_hosts:
            raise ValueError(
                f"worker_id {worker_id} out of range for "
                f"{self.num_hosts}-host slice")

    def worker_env(self, worker_id: int,
                   hostnames: Optional[List[str]] = None) -> Dict[str, str]:
        """The libtpu/JAX environment of one simulated worker, as the
        device plugin injects it (the reference's ``worker_env``)."""
        self._check_worker(worker_id)
        if hostnames is None:
            hostnames = default_hostnames(self.num_hosts)
        bounds = self.chip_bounds_for_host()
        grid = self.host_grid
        return {
            "TPU_ACCELERATOR_TYPE": self.accelerator_type,
            "TPU_CHIPS_PER_HOST_BOUNDS": ",".join(
                str(d) for d in bounds + (1,) * (3 - len(bounds))),
            "TPU_HOST_BOUNDS": ",".join(
                str(d) for d in grid + (1,) * (3 - len(grid))),
            "TPU_WORKER_ID": str(worker_id),
            "TPU_WORKER_HOSTNAMES": ",".join(hostnames),
            "TPU_SKIP_MDS_QUERY": "true",
        }


def default_hostnames(num_hosts: int) -> List[str]:
    """The in-cluster DNS names of the multi-host StatefulSet."""
    return [f"jax-tpu-{i}.tpu-sim.default.svc.cluster.local"
            for i in range(num_hosts)]


def make_slice(accelerator: str = DEFAULT_ACCELERATOR,
               topology: str = DEFAULT_TOPOLOGY) -> SliceShape:
    """``topology.make_slice``: ``"2x4"`` -> dims (2, 4), with its
    checks (rank of the topology, multi-host slices tiled by whole
    hosts)."""
    if accelerator not in _HOST_BOUNDS:
        raise ValueError(f"unknown accelerator {accelerator!r}; "
                         f"known: {sorted(_HOST_BOUNDS)}")
    try:
        dims = tuple(int(p) for p in topology.lower().split("x"))
    except ValueError as exc:
        raise ValueError(f"malformed topology {topology!r}") from exc
    if not dims or min(dims) < 1:
        raise ValueError(f"malformed topology {topology!r}")
    bounds = _HOST_BOUNDS[accelerator]
    if len(dims) != len(bounds):
        raise ValueError(f"{accelerator} expects {len(bounds)}-D topology, "
                         f"got {_fmt(dims)}")
    if math.prod(dims) > math.prod(bounds) and any(
            d < b or d % b for d, b in zip(dims, bounds)):
        raise ValueError(f"topology {_fmt(dims)} not divisible by host "
                         f"bounds {bounds}")
    return SliceShape(accelerator, dims)


@dataclasses.dataclass(frozen=True)
class MultiSliceShape:
    """The reference's ``topology.MultiSlice``: ``num_slices`` identical
    slices, each its own world, joined over the data-centre network
    whose contract is the MEGASCALE_* environment."""

    slice_shape: SliceShape
    num_slices: int

    def __post_init__(self) -> None:
        if self.num_slices < 1:
            raise ValueError("num_slices must be >= 1")

    @property
    def num_chips(self) -> int:
        return self.num_slices * self.slice_shape.num_chips

    @property
    def num_hosts(self) -> int:
        return self.num_slices * self.slice_shape.num_hosts

    def _check_slice(self, slice_id: int) -> None:
        if not 0 <= slice_id < self.num_slices:
            raise ValueError(
                f"slice_id {slice_id} out of range for "
                f"{self.num_slices}-slice job")

    def hostnames(self) -> List[str]:
        """Every slice's pod names, slice-major (one StatefulSet and
        headless Service a slice; one slice keeps the plain names)."""
        h = self.slice_shape.num_hosts
        if self.num_slices == 1:
            return default_hostnames(h)
        return [f"jax-tpu-s{s}-{i}.tpu-sim-s{s}.default.svc.cluster.local"
                for s in range(self.num_slices) for i in range(h)]

    def slice_hostnames(self, slice_id: int) -> List[str]:
        self._check_slice(slice_id)
        h = self.slice_shape.num_hosts
        return self.hostnames()[slice_id * h:(slice_id + 1) * h]

    def megascale_env(self, slice_id: int,
                      coordinator: Optional[str] = None) -> Dict[str, str]:
        """The cross-slice contract: this worker's slice, how many
        there are, and where slice 0's coordinator lives."""
        self._check_slice(slice_id)
        if coordinator is None:
            coordinator = (f"{self.hostnames()[0]}:"
                           f"{DEFAULT_COORDINATOR_PORT}")
        return {
            "MEGASCALE_COORDINATOR_ADDRESS": coordinator,
            "MEGASCALE_NUM_SLICES": str(self.num_slices),
            "MEGASCALE_SLICE_ID": str(slice_id),
        }

    def worker_env(self, slice_id: int, worker_id: int,
                   hostnames: Optional[List[str]] = None) -> Dict[str, str]:
        """One worker's whole environment: its slice's identity (that
        slice's hostnames) and the cross-slice contract."""
        if hostnames is None:
            hostnames = self.slice_hostnames(slice_id)
        env = self.slice_shape.worker_env(worker_id, hostnames)
        env.update(self.megascale_env(slice_id))
        return env


def make_multislice(num_slices: int,
                    accelerator: str = DEFAULT_ACCELERATOR,
                    topology: str = DEFAULT_TOPOLOGY) -> MultiSliceShape:
    return MultiSliceShape(make_slice(accelerator, topology), num_slices)


class Mesh:
    """The world's ranks in a named grid, as seen from this rank.

    ``devices`` is the grid of ranks (the reference's device grid),
    ``axis_names`` its names, ``shape`` name -> size, ``coords`` this
    rank's coordinate along each axis. ``group(*axes)`` is the process
    group of the ranks that share this rank's coordinates on every
    other axis; ``group_rank`` converts a coordinate on ``axes`` into a
    rank of the world."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs a torch.distributed world: start the ranks "
                "with kind_tpu_sim_torch.parallel.launch")
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, self.devices.shape))))
        self._groups: Dict[Tuple[str, ...], object] = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                self._groups[axes] = self._make_group(axes)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _make_group(self, axes):
        keep = [self.axis_names.index(a) for a in axes]
        other = [i for i in range(len(self.axis_names)) if i not in keep]
        grid = self.devices.transpose(other + keep).reshape(
            -1, math.prod(self.devices.shape[i] for i in keep))
        group, _ = dist.new_subgroups_by_enumeration(grid.tolist())
        return group

    def axis_size(self, *axes: str) -> int:
        """The product of these axes' sizes; an absent axis counts 1."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_index(self, *axes: str) -> int:
        """This rank's coordinate along these axes taken jointly (the
        first outermost); an absent axis counts as size 1."""
        index = 0
        for a in axes:
            index = index * self.shape.get(a, 1) + self.coords.get(a, 0)
        return index

    def group(self, *axes: str):
        """The process group over ``axes`` (present ones, in mesh
        order), or None when none of them is in the mesh."""
        present = tuple(a for a in self.axis_names if a in axes)
        return self._groups.get(present) if present else None

    def group_rank(self, **coords: int) -> int:
        """The world rank at this rank's coordinates with ``coords``
        replaced."""
        where = dict(self.coords, **coords)
        return int(self.devices[tuple(where[a] for a in self.axis_names)])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank={self.rank}, "
                f"backend={self.backend!r})")


def _world(n: int) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"need {n} devices, have no torch.distributed world (start "
            "the ranks with kind_tpu_sim_torch.parallel.launch)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} devices, have {world} ({dist.get_backend()})")
    return world


def _exact(want: int, what: str) -> None:
    world = _world(want)
    if world != want:
        raise ValueError(f"{what} needs {want} devices, got {world}")


def slice_mesh(s: Optional[SliceShape] = None) -> Mesh:
    """Physical mesh (host, chip) over the slice's chip count."""
    if s is None:
        s = make_slice()
    _exact(s.num_chips, f"slice {'x'.join(map(str, s.dims))}")
    return Mesh((s.num_hosts, s.chips_per_host), ("host", "chip"))


def training_mesh(data: int, model: int, seq: int = 1) -> Mesh:
    """Logical (data, model[, seq]) mesh, 'data' outermost."""
    _exact(data * model * seq,
           f"mesh {data}x{model}x{seq}")
    if seq > 1:
        return Mesh((data, model, seq), ("data", "model", "seq"))
    return Mesh((data, model), ("data", "model"))


def multislice_mesh(num_slices: int, data: int, model: int,
                    seq: int = 1) -> Mesh:
    """Hierarchical ('dcn', 'data', 'model'[, 'seq']) mesh: the outermost
    'dcn' axis groups the ranks into ``num_slices`` contiguous slices."""
    _exact(num_slices * data * model * seq,
           f"multislice {num_slices}x({data}x{model}x{seq})")
    if seq > 1:
        return Mesh((num_slices, data, model, seq),
                    ("dcn", "data", "model", "seq"))
    return Mesh((num_slices, data, model), ("dcn", "data", "model"))


def auto_training_mesh(n_devices: Optional[int] = None,
                       with_seq: bool = False) -> Mesh:
    """Split the world into a near-square (data, model) mesh."""
    n = n_devices if n_devices is not None else _world(1)
    model = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            model = cand
            break
    data = n // model
    if with_seq and model % 2 == 0:
        return training_mesh(data, model // 2, 2)
    return training_mesh(data, model)


def mesh_axis_sizes(mesh: Mesh) -> Tuple[int, ...]:
    return tuple(mesh.devices.shape)
