"""Simulator configuration of the cluster layer (the port's copy of
``kind_tpu_sim/config.py``).

Replaces the source system's global-mutating flag loop
(kind-gpu-sim.sh:31-43) with a validated dataclass. Everything the
source hardcoded — worker count (kind-gpu-sim.sh:93-97), fake GPUs per
node (:113,:116) — is configurable here, and the TPU vendor gains
slice-topology parameters. The three vendors and their extended
resources are the reference's (``kind_tpu_sim/__init__.py``): the
``nvidia`` vendor's workers are the ``nvidia.com/gpu`` nodes the port's
GPU pods land on.
"""

from __future__ import annotations

import dataclasses

from kind_tpu_sim_torch import topology as topo

RESOURCE_TPU = "google.com/tpu"
RESOURCE_ROCM = "amd.com/gpu"
RESOURCE_NVIDIA = "nvidia.com/gpu"

VENDORS = ("tpu", "rocm", "nvidia")

RESOURCE_BY_VENDOR = {
    "tpu": RESOURCE_TPU,
    "rocm": RESOURCE_ROCM,
    "nvidia": RESOURCE_NVIDIA,
}


@dataclasses.dataclass
class SimConfig:
    # flags shared with the reference (defaults at kind-gpu-sim.sh:4-7)
    registry_port: int = 5000
    cluster_name: str = "kind-tpu-sim"
    image_name: str = ""

    # simulated hardware shape
    vendor: str = "tpu"
    accelerator: str = topo.DEFAULT_ACCELERATOR
    tpu_topology: str = topo.DEFAULT_TOPOLOGY
    num_slices: int = 1          # >1: TPU multislice (DCN tier)
    gpus_per_node: int = 2       # rocm/nvidia parity (kind-gpu-sim.sh:113,116)
    gpu_workers: int = 2         # worker count for rocm/nvidia clusters

    # behavior knobs
    capacity_mode: str = "plugin"   # "plugin" (durable) | "patch" (reference parity)
    runtime: str = "auto"           # "auto" | "docker" | "podman" | "fake"
    registry_image: str = "public.ecr.aws/docker/library/registry:2"
    registry_name: str = "kind-registry"
    plugin_ready_timeout_s: int = 60
    verbose: bool = False

    def __post_init__(self) -> None:
        if self.vendor not in VENDORS:
            raise ValueError(
                f"unknown vendor {self.vendor!r}; expected one of {VENDORS}"
            )
        if self.capacity_mode not in ("plugin", "patch"):
            raise ValueError(
                f"capacity_mode must be 'plugin' or 'patch', "
                f"got {self.capacity_mode!r}"
            )
        if self.runtime not in ("auto", "docker", "podman", "fake"):
            raise ValueError(f"unknown runtime {self.runtime!r}")
        if not 1 <= self.registry_port <= 65535:
            raise ValueError(f"bad registry port {self.registry_port}")
        if self.gpus_per_node < 1 or self.gpu_workers < 1:
            raise ValueError("gpus_per_node and gpu_workers must be >= 1")
        if self.num_slices < 1:
            raise ValueError("num_slices must be >= 1")

    @property
    def slice(self) -> topo.SliceTopology:
        """The simulated TPU slice (only meaningful for vendor='tpu')."""
        return topo.make_slice(self.accelerator, self.tpu_topology)

    @property
    def multislice(self) -> topo.MultiSlice:
        """All slices of the simulated job (num_slices may be 1)."""
        return topo.MultiSlice(slice_topo=self.slice,
                               num_slices=self.num_slices)

    @property
    def workers(self) -> int:
        """kind worker-node count: one per TPU host across every
        slice, or gpu_workers."""
        if self.vendor == "tpu":
            return self.num_slices * self.slice.num_hosts
        return self.gpu_workers
