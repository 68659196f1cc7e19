"""Collective smokes over a mesh of ranks, in PyTorch.

Counterpart of ``kind_tpu_sim/parallel/collectives.py``: the "does the
fabric work" checks. The reference lowers each smoke through
``shard_map`` to a psum / ppermute / all-gather over its device grid;
here every rank of the mesh holds its own element of the same input
(rank i holds i + 1 for the psum, and so on) and calls the collective
on the mesh's process group. The reports have the reference's keys and
values. The analytic ring model the simulator's cost math reads
(``ring_allreduce_s``, ``tier_slowdown``) is a copy of the reference's;
it needs no torch, so the smokes import torch themselves and the
simulator's layers (a globe shard's cold worker among them) load this
module without it.

Every smoke must be called on every rank of the mesh; each rank gets
the same report.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

TIER_LINK_GBPS: Dict[str, float] = {"ici": 90.0, "dcn": 25.0}
TIER_FRACTION: Dict[str, float] = {"ici": 0.35, "dcn": 0.10}
DEFAULT_ICI_GBPS = TIER_LINK_GBPS["ici"]
DEFAULT_DCN_GBPS = TIER_LINK_GBPS["dcn"]


def _tier_gbps(tier: str) -> float:
    if tier not in TIER_LINK_GBPS:
        raise ValueError(
            f"unknown interconnect tier {tier!r}; known: "
            f"{', '.join(sorted(TIER_LINK_GBPS))}")
    return TIER_LINK_GBPS[tier]


def ring_allreduce_s(size_bytes: float, participants: int,
                     link_gbps: Optional[float] = None,
                     link_factors: Optional[Sequence[float]] = None,
                     tier: str = "ici") -> float:
    """Modeled wall time of a bandwidth-optimal ring all-reduce: each
    participant moves 2 (n-1)/n of the bytes at the pace of the ring's
    slowest link (``link_factors`` in (0, 1]); no latency term."""
    if participants <= 1:
        return 0.0
    if link_gbps is None:
        link_gbps = _tier_gbps(tier)
    if size_bytes < 0 or link_gbps <= 0:
        raise ValueError(
            f"need size_bytes >= 0 and link_gbps > 0; got "
            f"{size_bytes}, {link_gbps}")
    slowest = min(link_factors) if link_factors else 1.0
    if not 0.0 < slowest <= 1.0:
        raise ValueError(
            f"link factors must be in (0, 1]; got {slowest}")
    bytes_per_s = link_gbps * 1e9 / 8.0 * slowest
    transits = 2.0 * (participants - 1) / participants
    return transits * size_bytes / bytes_per_s


def tier_slowdown(link_factor: float,
                  fraction: Optional[float] = None,
                  tier: str = "ici") -> float:
    """Amdahl's service-time multiplier for a workload spending
    ``fraction`` of its time in collectives on ``tier`` when the tier's
    slowest link runs at ``link_factor`` of nominal bandwidth."""
    if not 0.0 < link_factor <= 1.0:
        raise ValueError(
            f"link_factor must be in (0, 1]; got {link_factor}")
    if fraction is None:
        if tier not in TIER_FRACTION:
            raise ValueError(
                f"unknown interconnect tier {tier!r}; known: "
                f"{', '.join(sorted(TIER_FRACTION))}")
        fraction = TIER_FRACTION[tier]
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(
            f"fraction must be in [0, 1]; got {fraction}")
    return 1.0 + fraction * (1.0 / link_factor - 1.0)


def ici_slowdown(link_factor: float,
                 ici_fraction: float = 0.35) -> float:
    """The ICI instance of :func:`tier_slowdown`."""
    return tier_slowdown(link_factor, ici_fraction, tier="ici")


def dcn_slowdown(link_factor: float,
                 dcn_fraction: Optional[float] = None) -> float:
    """The DCN instance of :func:`tier_slowdown`."""
    return tier_slowdown(link_factor, dcn_fraction, tier="dcn")


def _device(mesh) -> "torch.device":  # noqa: F821
    """Where this rank's smoke tensors live: its card under NCCL, else
    the device ``launch.spawn`` gave the rank (gloo reduces and gathers
    a card's tensors too)."""
    import torch

    from kind_tpu_sim_torch.parallel import launch

    if mesh.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return launch.rank_device()


def _mine(mesh, values: np.ndarray,
          device=None) -> "torch.Tensor":  # noqa: F821
    """This rank's element of an array laid out like the mesh grid."""
    import torch

    where = tuple(mesh.coords[a] for a in mesh.axis_names)
    return torch.tensor([float(values[where])], dtype=torch.float32,
                        device=device or _device(mesh))


def psum_smoke(mesh=None) -> Dict[str, object]:
    """All-reduce over every rank of the mesh; rank (i, j) holds
    i*cols+j+1, so every rank must end with sum(1..n)."""
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel.mesh import slice_mesh

    if mesh is None:
        mesh = slice_mesh()
    n = mesh.size
    x = _mine(mesh, np.arange(1.0, n + 1.0).reshape(mesh.devices.shape))
    dist.all_reduce(x, group=mesh.group(*mesh.axis_names))
    total = float(x[0])
    expected = n * (n + 1) / 2
    return {
        "collective": "psum",
        "devices": n,
        "result": total,
        "expected": expected,
        "ok": abs(total - expected) < 1e-6,
    }


def ring_permute_smoke(mesh=None) -> Dict[str, object]:
    """Each rank passes its value to the next rank on the last mesh axis
    (wrapping), point to point: the ring step of ring attention."""
    import torch
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel.mesh import slice_mesh

    if mesh is None:
        mesh = slice_mesh()
    from kind_tpu_sim_torch.parallel import tp

    axis = mesh.axis_names[-1]
    ring = mesh.shape[axis]
    grid = np.arange(float(mesh.size)).reshape(mesh.devices.shape)
    x = _mine(mesh, grid)
    got = x  # a ring of one passes its value to itself
    pos = mesh.coords[axis]
    if ring > 1:
        # under gloo a card's value crosses through the host
        got = tp.start_exchange(
            x, mesh.group_rank(**{axis: (pos + 1) % ring}),
            mesh.group_rank(**{axis: (pos - 1) % ring})).wait()
    expected = np.roll(grid, 1, axis=-1)
    ok = torch.tensor([float(abs(float(got[0]) - _mine(
        mesh, expected, x.device)[0]) < 1e-6)], device=x.device)
    # every rank reports the whole ring: ok only where every rank is
    dist.all_reduce(ok, op=dist.ReduceOp.MIN,
                    group=mesh.group(*mesh.axis_names))
    return {
        "collective": "ppermute",
        "ring_size": ring,
        "ok": bool(ok[0] == 1.0),
    }


def all_gather_smoke(mesh=None) -> Dict[str, object]:
    """all_gather along the first (host) axis: group g holds g, and the
    gathered sum must be the sum over groups on every rank."""
    import torch
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel.mesh import slice_mesh

    if mesh is None:
        mesh = slice_mesh()
    axis = mesh.axis_names[0]
    groups = mesh.shape[axis]
    x = torch.tensor([float(mesh.coords[axis])], device=_device(mesh))
    parts = [torch.empty_like(x) for _ in range(groups)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    out = float(torch.cat(parts).sum())
    ok = torch.tensor([float(abs(out - sum(range(groups))) < 1e-6)],
                      device=x.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN,
                    group=mesh.group(*mesh.axis_names))
    return {
        "collective": "all_gather",
        "groups": groups,
        "ok": bool(ok[0] == 1.0),
    }


def hierarchical_psum_smoke(mesh) -> Dict[str, object]:
    """Two-tier reduction over a multislice mesh: the psum over every
    axis but 'dcn' (within a slice, ICI) first, then over 'dcn' (across
    slices). Checks both tiers: after the first every rank of a slice
    holds its slice's subtotal, after the second the global total."""
    import torch
    import torch.distributed as dist

    if "dcn" not in mesh.axis_names:
        raise ValueError(f"mesh has no 'dcn' axis: {mesh.axis_names}")
    ici_axes = tuple(a for a in mesh.axis_names if a != "dcn")
    shape = mesh.devices.shape
    values = np.arange(1.0, mesh.size + 1.0).reshape(shape)
    x = _mine(mesh, values)
    dist.all_reduce(x, group=mesh.group(*ici_axes))
    ici = x.clone()
    dist.all_reduce(x, group=mesh.group("dcn"))
    parts = [torch.empty_like(ici) for _ in range(shape[0])]
    dist.all_gather(parts, ici, group=mesh.group("dcn"))
    ici_arr = torch.cat(parts).cpu().numpy().astype(np.float64)
    per_slice = values.reshape(shape[0], -1).sum(axis=1)
    ok = torch.tensor([float(np.allclose(ici_arr, per_slice)
                             and np.allclose(float(x[0]), per_slice.sum()))],
                      device=x.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN,
                    group=mesh.group(*mesh.axis_names))
    return {
        "collective": "hierarchical_psum",
        "slices": shape[0],
        "ici_subtotals": ici_arr.tolist(),
        "global": float(x[0]),
        "ok": bool(ok[0] == 1.0),
    }


def run_all(mesh=None) -> Dict[str, object]:
    """The full fabric smoke suite; `ok` only if every collective is."""
    results = {
        "psum": psum_smoke(mesh),
        "ppermute": ring_permute_smoke(mesh),
        "all_gather": all_gather_smoke(mesh),
    }
    results["ok"] = all(r["ok"] for r in results.values())
    return results
