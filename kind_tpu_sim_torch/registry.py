"""Local image registry lifecycle (layer L2; the port's copy of
``kind_tpu_sim/registry.py``).

Behavioral parity with kind-gpu-sim.sh:71-82 (start, idempotent via
running-state inspect, connect to the kind network) and :347-361
(stop/remove with warnings instead of hard failures).
"""

from __future__ import annotations

import logging

from kind_tpu_sim_torch.config import SimConfig
from kind_tpu_sim_torch.runtime import ContainerRuntime

log = logging.getLogger("kind-tpu-sim-torch")


class LocalRegistry:
    def __init__(self, cfg: SimConfig, runtime: ContainerRuntime):
        self.cfg = cfg
        self.rt = runtime

    @property
    def name(self) -> str:
        return self.cfg.registry_name

    def is_running(self) -> bool:
        res = self.rt.try_run(
            "inspect", "-f", "{{.State.Running}}", self.name
        )
        return res.ok and res.stdout.strip() == "true"

    def start(self) -> None:
        log.info("starting local registry on port %d", self.cfg.registry_port)
        if self.is_running():
            log.info("registry %r already running", self.name)
        else:
            self.rt.run(
                "run", "-d", "--restart=always",
                "-p", f"{self.cfg.registry_port}:5000",
                "--name", self.name,
                self.cfg.registry_image,
            )
        self.connect_to_kind_network()

    def connect_to_kind_network(self) -> None:
        # may fail before the kind network exists; harmless (sh:81)
        self.rt.try_run("network", "connect", "kind", self.name)

    def delete(self) -> None:
        log.info("stopping registry %r (if running)", self.name)
        stop = self.rt.try_run("stop", self.name)
        if not stop.ok:
            log.warning("could not stop %r: %s", self.name,
                        stop.stderr.strip() or "not running")
        rm = self.rt.try_run("rm", self.name)
        if not rm.ok:
            log.warning("could not remove %r: %s", self.name,
                        rm.stderr.strip() or "no such container")

    def image_ref(self, image: str, tag: str = "dev") -> str:
        """Registry-qualified image reference for locally-built images."""
        return f"localhost:{self.cfg.registry_port}/{image}:{tag}"
