"""Dry-run executor: a simulated control plane for ``--runtime=fake``
(the port's copy of ``kind_tpu_sim/fakes.py``).

Lets every layer of the orchestrator run with no docker/kind/kubectl
installed: external commands are recorded, and the handful of *queries*
the pipeline depends on (node listings, cluster existence) are answered
consistently with the requested configuration.  Used by the tests and
by ``python -m kind_tpu_sim_torch create --runtime=fake`` as a
what-would-run inspection mode.
"""

from __future__ import annotations

import json

from kind_tpu_sim_torch.config import SimConfig
from kind_tpu_sim_torch.utils.shell import ExecResult, FakeExecutor


def node_names(cfg: SimConfig) -> list:
    """kind's node-container naming: worker, worker2, worker3, ..."""
    names = [f"{cfg.cluster_name}-control-plane"]
    for i in range(cfg.workers):
        suffix = "" if i == 0 else str(i + 1)
        names.append(f"{cfg.cluster_name}-worker{suffix}")
    return names


def dry_run_executor(cfg: SimConfig) -> FakeExecutor:
    names = node_names(cfg)
    node_list = "\n".join(names) + "\n"
    nodes_json = json.dumps({
        "items": [
            {
                "metadata": {"name": n, "labels": {}},
                "status": {"capacity": {}},
            }
            for n in names
        ]
    }, sort_keys=True)
    pods_json = json.dumps({"items": []}, sort_keys=True)
    return FakeExecutor(rules={
        "kubectl get nodes -o jsonpath": ExecResult(0, node_list),
        "kubectl get nodes -o json": ExecResult(0, nodes_json),
        "kubectl get pods -A -o json": ExecResult(0, pods_json),
        "kind get nodes": ExecResult(0, node_list),
        "kind get clusters": ExecResult(0, f"{cfg.cluster_name}\n"),
        "docker inspect -f {{.State.Running}}":
            ExecResult(1, "", "no such container"),
    })
