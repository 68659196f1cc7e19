"""Container-runtime shim (layer L1; the port's copy of
``kind_tpu_sim/runtime.py``).

Reimplements the source system's environment detection
(kind-gpu-sim.sh:45-66): podman preferred over docker, with the podman
socket + kind provider env wiring.  Differences from the reference:

* the runtime is an object wrapping an :class:`Executor`, not a global
  shell function, so everything is unit-testable without a daemon;
* a ``fake`` runtime exists for tests and for machines with no container
  daemon at all (it records the command stream instead of executing).

The macOS/sed shims (kind-gpu-sim.sh:8-29) have no equivalent here:
nothing in this implementation shells out to ``sed`` or ``pidof``
(containerd reload uses ``pkill -HUP`` which is portable).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import List, Optional, Sequence

from kind_tpu_sim_torch.utils.shell import (
    ExecResult,
    Executor,
    FakeExecutor,
    RetryPolicy,
    run_with_retry,
)

log = logging.getLogger("kind-tpu-sim-torch")


class ContainerRuntime:
    """A detected docker or podman runtime bound to an executor.

    Every command goes through the classified retry policy
    (shell.run_with_retry): transient daemon/socket failures back off
    and retry, deterministic errors surface immediately. Pass
    ``retry=RetryPolicy(max_retries=0)`` to opt out.
    """

    def __init__(self, name: str, executor: Executor,
                 retry: Optional[RetryPolicy] = None):
        if name not in ("docker", "podman"):
            raise ValueError(f"unsupported container runtime {name!r}")
        self.name = name
        self.executor = executor
        self.retry = retry or RetryPolicy.from_env()

    # the `cr` equivalent (kind-gpu-sim.sh:64-66)
    def run(
        self,
        *args: str,
        input_text: Optional[str] = None,
        check: bool = True,
    ) -> ExecResult:
        return run_with_retry(
            self.executor, [self.name, *args], policy=self.retry,
            input_text=input_text, check=check
        )

    def try_run(self, *args: str, input_text: Optional[str] = None) -> ExecResult:
        return self.run(*args, input_text=input_text, check=False)

    @property
    def is_podman(self) -> bool:
        return self.name == "podman"

    def configure_environment(self) -> None:
        """Export the env kind needs for this runtime.

        Mirrors kind-gpu-sim.sh:49-54 (podman provider + user socket).
        """
        if self.is_podman:
            os.environ["KIND_EXPERIMENTAL_PROVIDER"] = "podman"
            uid = os.getuid()
            os.environ.setdefault(
                "DOCKER_HOST", f"unix:///run/user/{uid}/podman/podman.sock"
            )
            self.executor.try_run(
                ["systemctl", "--user", "enable", "--now", "podman.socket"]
            )


def detect_runtime(
    executor: Executor, prefer: str = "auto"
) -> ContainerRuntime:
    """Pick podman over docker, like the reference (kind-gpu-sim.sh:46-62).

    ``prefer='fake'`` returns a docker-shaped runtime over a
    :class:`FakeExecutor` so every layer above can run with no daemon.
    """
    if prefer == "fake":
        fake = executor if isinstance(executor, FakeExecutor) else FakeExecutor()
        return ContainerRuntime("docker", fake)
    if prefer in ("docker", "podman"):
        if not executor.have(prefer):
            raise RuntimeError(f"requested runtime {prefer!r} not on PATH")
        rt = ContainerRuntime(prefer, executor)
    elif executor.have("podman"):
        rt = ContainerRuntime("podman", executor)
    elif executor.have("docker"):
        rt = ContainerRuntime("docker", executor)
    else:
        raise RuntimeError("neither docker nor podman is installed")
    log.info("using %s as container runtime", rt.name)
    return rt


def kubectl(executor: Executor, *args: str,
            input_text: Optional[str] = None,
            check: bool = True,
            retry: Optional[RetryPolicy] = None) -> ExecResult:
    """kubectl with the classified retry policy: apiserver blips and
    etcd leader changes retry with backoff; NotFound/Forbidden/
    invalid-flag errors surface immediately."""
    return run_with_retry(executor, ["kubectl", *args], policy=retry,
                          input_text=input_text, check=check)


def kind(executor: Executor, *args: str, check: bool = True,
         retry: Optional[RetryPolicy] = None) -> ExecResult:
    return run_with_retry(executor, ["kind", *args], policy=retry,
                          check=check)


def load_image_archive(rt: ContainerRuntime, executor: Executor,
                       image: str, tar_name: str, cluster_name: str) -> None:
    """Side-load ``image`` through a saved archive (podman, whose images
    kind cannot read from a daemon): ``<runtime> save`` to ``tar_name``
    in a directory of its own under the temporary root, ``kind load
    image-archive``, then remove the directory. The reference saves to
    a fixed name in ``/tmp``, which two checkouts on one host share."""
    tmp = tempfile.mkdtemp(prefix="kind-tpu-sim-")
    tar = os.path.join(tmp, tar_name)
    try:
        rt.run("save", image, "-o", tar)
        kind(executor, "load", "image-archive", tar,
             "--name", cluster_name)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kubectl_lines(executor: Executor, *args: str) -> List[str]:
    out = kubectl(executor, *args).stdout
    return [line for line in out.splitlines() if line.strip()]


def required_binaries(runtime: str) -> Sequence[str]:
    if runtime == "fake":
        return ()
    return ("kind", "kubectl")
