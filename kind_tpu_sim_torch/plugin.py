"""Device-plugin image build and deployment (layer L4; the port's copy
of ``kind_tpu_sim/plugin.py``).

Three vendors, two build strategies:

* ``tpu`` — the in-repo native C++ plugin under ``plugin/`` (this repo's
  equivalent of the external Go plugins the reference clones; see
  SURVEY.md §2 "native components").  Built locally from source with no
  network access needed.
* ``rocm`` / ``nvidia`` — behavioral parity with the reference
  (kind-gpu-sim.sh:180-228): clone the real vendor plugin repo, rewrite
  its base images to rate-limit-free mirrors, build, and deliver.

Delivery follows the source system's two paths: registry push for
docker, ``save`` + ``kind load image-archive`` for podman
(sh:195-198,203). Under the fake runtime every command, the vendor
clones included, is only recorded.
"""

from __future__ import annotations

import logging
import os
import pathlib
from typing import Tuple

from kind_tpu_sim_torch import manifests
from kind_tpu_sim_torch.cluster import ClusterManager
from kind_tpu_sim_torch.config import SimConfig
from kind_tpu_sim_torch.registry import LocalRegistry
from kind_tpu_sim_torch.runtime import (
    ContainerRuntime,
    kubectl,
    load_image_archive,
)

log = logging.getLogger("kind-tpu-sim-torch")

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

NVIDIA_PLUGIN_REPO = "https://github.com/NVIDIA/k8s-device-plugin.git"
NVIDIA_PLUGIN_TAG = "v0.18.2"   # pin kept from kind-gpu-sim.sh:187
ROCM_PLUGIN_REPO = (
    "https://github.com/RadeonOpenCompute/k8s-device-plugin.git"
)

# base-image rewrites for the cloned vendor Dockerfiles
# (kind-gpu-sim.sh:145-178, reimplemented as literal line rewrites)
FROM_REWRITES = {
    "FROM redhat/ubi9-minimal":
        "FROM registry.access.redhat.com/ubi9/ubi-minimal",
    "FROM public.ecr.aws/ubi9/ubi-minimal":
        "FROM registry.access.redhat.com/ubi9/ubi-minimal",
    "FROM registry.access.redhat.com/ubi9/ubi9-minimal":
        "FROM registry.access.redhat.com/ubi9/ubi-minimal",
    "FROM alpine:":
        "FROM public.ecr.aws/docker/library/alpine:",
    "FROM docker.io/golang:":
        "FROM public.ecr.aws/docker/library/golang:",
    "FROM golang:":
        "FROM public.ecr.aws/docker/library/golang:",
}


def rewrite_base_images(dockerfile: pathlib.Path) -> bool:
    """Rewrite FROM lines to mirror registries; returns True if changed.

    No-op when the Dockerfile is absent (e.g. fake-runtime dry runs where
    the git clone was only recorded, not executed).
    """
    if not dockerfile.exists():
        return False
    text = dockerfile.read_text(encoding="utf-8")
    lines = text.splitlines(keepends=True)
    changed = False
    for i, line in enumerate(lines):
        for old, new in FROM_REWRITES.items():
            if line.startswith(old):
                lines[i] = new + line[len(old):]
                changed = True
                break
    if changed:
        dockerfile.write_text("".join(lines), encoding="utf-8")
    return changed


class PluginManager:
    def __init__(self, cfg: SimConfig, runtime: ContainerRuntime,
                 registry: LocalRegistry, cluster: ClusterManager):
        self.cfg = cfg
        self.rt = runtime
        self.registry = registry
        self.cluster = cluster
        self.ex = runtime.executor

    # -- image naming ---------------------------------------------------

    def image_for(self, vendor: str) -> Tuple[str, str]:
        """(buildable registry ref, in-cluster ref) for a vendor image.

        Podman-built images are delivered by archive under ``localhost/``
        (kind-gpu-sim.sh:195,222,245,288); docker images resolve through
        the local registry mirror.
        """
        short = {
            "tpu": "tpu-device-plugin",
            "rocm": "amdgpu-dp",
            "nvidia": "nvidia-device-plugin",
        }[vendor]
        build_ref = self.registry.image_ref(short)
        cluster_ref = (
            f"localhost/{short}:dev" if self.rt.is_podman else build_ref
        )
        return build_ref, cluster_ref

    # -- build ----------------------------------------------------------

    def build(self, vendor: str) -> str:
        """Build the vendor's plugin image; returns the in-cluster ref."""
        build_ref, cluster_ref = self.image_for(vendor)
        if vendor == "tpu":
            context = str(REPO_ROOT / "plugin")
            dockerfile = os.path.join(context, "Dockerfile")
        elif vendor == "nvidia":
            context = self._clone(
                NVIDIA_PLUGIN_REPO, "k8s-device-plugin-nvidia",
                tag=NVIDIA_PLUGIN_TAG,
            )
            dockerfile = os.path.join(
                context, "deployments", "container", "Dockerfile"
            )
            rewrite_base_images(pathlib.Path(dockerfile))
        elif vendor == "rocm":
            context = self._clone(ROCM_PLUGIN_REPO, "k8s-device-plugin-rocm")
            dockerfile = os.path.join(context, "Dockerfile")
            rewrite_base_images(pathlib.Path(dockerfile))
        else:
            raise ValueError(f"unknown vendor {vendor!r}")

        log.info("building %s device plugin image %s", vendor, build_ref)
        # podman: force docker image format for kind compatibility (sh:192)
        env = {"BUILDAH_FORMAT": "docker"} if self.rt.is_podman else None
        self.ex.run(
            [self.rt.name, "build", "-t", build_ref,
             "-f", dockerfile, context],
            env=env,
        )
        self._deliver(build_ref, cluster_ref)
        return cluster_ref

    def _clone(self, url: str, dirname: str, tag: str | None = None) -> str:
        dest = str(REPO_ROOT / dirname)
        if not os.path.isdir(dest):
            self.ex.run(["git", "clone", url, dest])
        if tag:
            self.ex.run(["git", "-C", dest, "checkout", tag])
        return dest

    def _deliver(self, build_ref: str, cluster_ref: str) -> None:
        if self.rt.is_podman:
            self.rt.run("tag", build_ref, cluster_ref)
            load_image_archive(self.rt, self.ex, cluster_ref,
                               "kind-tpu-sim-plugin.tar",
                               self.cfg.cluster_name)
        else:
            self.rt.run("push", build_ref)

    # -- deploy ---------------------------------------------------------

    def deploy(self, vendor: str, image: str) -> None:
        """Apply the plugin DaemonSet and block until it is rolled out.

        The reference sleeps 5s then waits on pod readiness
        (kind-gpu-sim.sh:278-283); ``rollout status`` subsumes both
        without the fixed sleep.
        """
        if vendor == "tpu":
            ds_yaml = manifests.tpu_plugin_daemonset(self.cfg, image)
            ds_name = "tpu-sim-device-plugin"
        else:
            ds_yaml = manifests.gpu_plugin_daemonset(self.cfg, vendor, image)
            ds_name = {
                "rocm": "amdgpu-device-plugin-daemonset",
                "nvidia": "nvidia-device-plugin-daemonset",
            }[vendor]
        kubectl(self.ex, "apply", "-f", "-", input_text=ds_yaml)
        res = kubectl(
            self.ex, "-n", manifests.PLUGIN_NAMESPACE,
            "rollout", "status", f"daemonset/{ds_name}",
            f"--timeout={self.cfg.plugin_ready_timeout_s}s",
            check=False,
        )
        if not res.ok:
            raise RuntimeError(
                f"{vendor} device plugin DaemonSet not ready within "
                f"{self.cfg.plugin_ready_timeout_s}s: "
                f"{res.stderr.strip() or res.stdout.strip()}"
            )

    def build_and_deploy(self, vendor: str) -> None:
        image = self.build(vendor)
        self.deploy(vendor, image)
