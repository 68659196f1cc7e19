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

``SliceShape`` and ``MultiSliceShape`` are the port's
``topology.SliceTopology`` and ``topology.MultiSlice``, which also carry
the environment contract a simulated host is started with
(``worker_env``, ``megascale_env``; ``parallel/multihost.py`` launches
hosts from it).

A mesh spans the whole world: a rank outside it would have nothing to
run, so a world of another size raises ("needs N devices"). Every
process group a collective may ride (the ranks that differ only along a
set of axes) is created when the mesh is, in one fixed order on every
rank, because ``torch.distributed`` makes every rank take part in
making every group.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

# the slice contract (the chip grid, its hosts and each host's
# environment) is the port's topology module's, under the mesh's names
from kind_tpu_sim_torch.topology import (  # noqa: F401
    MultiSlice as MultiSliceShape,
    SliceTopology as SliceShape,
    make_multislice,
    make_slice,
)


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
