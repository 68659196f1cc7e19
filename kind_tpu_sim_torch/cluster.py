"""Cluster provisioning and fake-device node preparation (layer L3; the
port's copy of ``kind_tpu_sim/cluster.py``).

This is the TPU-first re-design of the source system's simulation core
(kind-gpu-sim.sh:100-128).  Two deliberate departures:

* **Topology, not a flat integer.**  TPU workers get the full GKE-style
  label set from :mod:`kind_tpu_sim_torch.topology` (accelerator type, slice
  topology, worker id, ICI host coordinate) so topology-aware scheduling
  can be exercised — the reference only sets ``<vendor>/gpu.present``.
* **Durable capacity.**  In the default ``plugin`` capacity mode, node
  capacity comes from the in-repo device plugin's ListAndWatch stream
  (durable across kubelet restarts).  ``patch`` mode reproduces the
  reference's one-shot status-subresource patch
  (kind-gpu-sim.sh:113,116) for mechanism parity and for bring-up
  before the plugin image exists.

``create nvidia`` labels each worker ``hardware-type=gpu`` and
``nvidia.com/gpu.present=true``, taints it ``gpu=true:NoSchedule`` and
patches its ``nvidia.com/gpu`` capacity (``--gpus-per-node``, 2): the
nodes the port's GPU pods (``manifests.torch_gpu_pod``) select and
tolerate. ``kind-config.yaml`` is written in the working directory.
"""

from __future__ import annotations

import logging
from typing import List

from kind_tpu_sim_torch import manifests
from kind_tpu_sim_torch import topology as topo
from kind_tpu_sim_torch.config import RESOURCE_BY_VENDOR, SimConfig
from kind_tpu_sim_torch.registry import LocalRegistry
from kind_tpu_sim_torch.runtime import (
    ContainerRuntime,
    kind,
    kubectl,
    load_image_archive,
)

log = logging.getLogger("kind-tpu-sim-torch")

KIND_CONFIG_FILE = "kind-config.yaml"


def worker_order_key(node_name: str) -> tuple:
    """Sort key matching the C++ plugin's WorkerIdFromNodeName: the
    numeric suffix after '-worker' ('' counts as 1)."""
    marker = "-worker"
    pos = node_name.rfind(marker)
    if pos < 0:
        return (node_name, 0)
    prefix = node_name[:pos]
    suffix = node_name[pos + len(marker):]
    if suffix == "":
        return (prefix, 1)
    if suffix.isdigit():
        return (prefix, int(suffix))
    return (node_name, 0)


class ClusterManager:
    def __init__(self, cfg: SimConfig, runtime: ContainerRuntime,
                 registry: LocalRegistry):
        self.cfg = cfg
        self.rt = runtime
        self.registry = registry
        self.ex = runtime.executor

    # -- create ---------------------------------------------------------

    def write_kind_config(self, path: str = KIND_CONFIG_FILE) -> str:
        content = manifests.kind_cluster_config(self.cfg)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(content)
        return path

    def create(self) -> None:
        config_path = self.write_kind_config()
        kind(
            self.ex, "create", "cluster",
            "--name", self.cfg.cluster_name,
            "--config", config_path,
        )
        self.registry.connect_to_kind_network()
        self.prepare_worker_nodes()
        self.configure_node_registry_mirrors()
        self.apply_registry_configmap()

    def worker_nodes(self) -> List[str]:
        out = kubectl(
            self.ex, "get", "nodes", "-o",
            "jsonpath={range .items[*]}{.metadata.name}{\"\\n\"}{end}",
        ).stdout
        workers = [
            n for n in out.splitlines()
            if n.strip() and "control-plane" not in n
        ]
        # Natural order by kind's worker numbering (worker, worker2,
        # worker3, ...) so enumerate() agrees with the plugin's
        # NODE_NAME-derived worker id (device_plugin.cc
        # WorkerIdFromNodeName) even past 10 workers, where plain
        # lexicographic sort would interleave worker10 before worker2.
        return sorted(workers, key=worker_order_key)

    def prepare_worker_nodes(self) -> None:
        """Label/taint workers and (optionally) patch fake capacity."""
        workers = self.worker_nodes()
        if self.cfg.vendor == "tpu":
            self._prepare_tpu_workers(workers)
        else:
            self._prepare_gpu_workers(workers)

    def _label(self, node: str, key: str, value: str) -> None:
        kubectl(self.ex, "label", "node", node,
                f"{key}={value}", "--overwrite")

    def _patch_capacity(self, node: str, resource: str, count: int) -> None:
        # JSON-Patch paths escape '/' as '~1' (kind-gpu-sim.sh:113,116).
        escaped = resource.replace("~", "~0").replace("/", "~1")
        patch = (
            f'[{{"op": "add", "path": "/status/capacity/{escaped}", '
            f'"value": "{count}"}}]'
        )
        kubectl(self.ex, "patch", "node", node, "--type=json",
                f"-p={patch}", "--subresource=status")

    def _prepare_tpu_workers(self, workers: List[str]) -> None:
        s = self.cfg.slice
        ms = self.cfg.multislice
        if len(workers) != ms.num_hosts:
            raise RuntimeError(
                f"cluster has {len(workers)} workers but "
                f"{ms.num_slices}x {s.accelerator_type} needs "
                f"{ms.num_hosts}"
            )
        for global_id, node in enumerate(workers):
            # Row-major: slice 0's hosts first, then slice 1's, ...
            slice_id, worker_id = divmod(global_id, s.num_hosts)
            for key, value in ms.node_labels(slice_id,
                                             worker_id).items():
                self._label(node, key, value)
            self._label(node, "node-role.kubernetes.io/worker", "")
            kubectl(
                self.ex, "taint", "node", node,
                f"{topo.TAINT_KEY}={topo.TAINT_VALUE}:{topo.TAINT_EFFECT}",
                "--overwrite",
            )
            if self.cfg.capacity_mode == "patch":
                self._patch_capacity(
                    node, RESOURCE_BY_VENDOR["tpu"], s.chips_per_host
                )

    def _prepare_gpu_workers(self, workers: List[str]) -> None:
        """rocm/nvidia parity prep (kind-gpu-sim.sh:107-118)."""
        vendor = self.cfg.vendor
        present_label = {
            "rocm": "rocm.amd.com/gpu.present",
            "nvidia": "nvidia.com/gpu.present",
        }[vendor]
        for node in workers:
            self._label(node, topo.LABEL_HARDWARE_TYPE, "gpu")
            self._label(node, "node-role.kubernetes.io/worker", "")
            kubectl(self.ex, "taint", "node", node,
                    "gpu=true:NoSchedule", "--overwrite")
            self._label(node, present_label, "true")
            # The real vendor plugins find no hardware on kind nodes, so
            # capacity always comes from the status patch for GPUs.
            self._patch_capacity(
                node, RESOURCE_BY_VENDOR[vendor], self.cfg.gpus_per_node
            )

    def configure_node_registry_mirrors(self) -> None:
        """Write containerd hosts.toml into every node (sh:120-127)."""
        nodes = kind(
            self.ex, "get", "nodes", "--name", self.cfg.cluster_name
        ).stdout.split()
        hosts_dir = f"/etc/containerd/certs.d/localhost:{self.cfg.registry_port}"
        for node in nodes:
            self.rt.run("exec", node, "mkdir", "-p", hosts_dir)
            self.rt.run(
                "exec", "-i", node, "tee", f"{hosts_dir}/hosts.toml",
                input_text=manifests.containerd_hosts_toml(self.cfg),
            )
            # -x: exact comm match — a bare "containerd" pattern would
            # also SIGHUP every containerd-shim, killing pod sandboxes.
            reload = self.rt.try_run(
                "exec", node, "pkill", "-x", "-HUP", "containerd"
            )
            if not reload.ok:
                log.warning("could not reload containerd on %s", node)

    def apply_registry_configmap(self) -> None:
        kubectl(self.ex, "apply", "-f", "-",
                input_text=manifests.registry_configmap(self.cfg))

    # -- delete / load --------------------------------------------------

    def exists(self) -> bool:
        res = kind(self.ex, "get", "clusters", check=False)
        return res.ok and self.cfg.cluster_name in res.stdout.split()

    def delete(self) -> None:
        if self.exists():
            log.info("deleting kind cluster %r", self.cfg.cluster_name)
            kind(self.ex, "delete", "cluster",
                 "--name", self.cfg.cluster_name)
        else:
            log.info("kind cluster %r does not exist; skipping",
                     self.cfg.cluster_name)

    def load_image(self, image: str) -> None:
        """Side-load an image into the node containers (sh:369-378)."""
        if not image:
            raise ValueError("no image name given (use --image-name=...)")
        if self.rt.is_podman:
            load_image_archive(self.rt, self.ex, image,
                               "kind-tpu-sim-image.tar",
                               self.cfg.cluster_name)
        else:
            kind(self.ex, "load", "docker-image", image,
                 "--name", self.cfg.cluster_name)
