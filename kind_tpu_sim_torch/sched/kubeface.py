"""Kubernetes manifest face of the scheduler simulator.

The port's copy of ``kind_tpu_sim/sched/kubeface.py``. It reads and
writes YAML with the port's own :mod:`kind_tpu_sim_torch.yamlsubset`
(no PyYAML): the documents it reads are ``yaml.safe_load_all``'s, and
:func:`to_pod_manifest` gives ``yaml.safe_dump(doc, sort_keys=False)``'s
bytes.

The same PodSpec YAML the kind cluster consumes drives the sim:
:func:`slice_requests_from_yaml` parses real manifests (Pod,
Deployment, StatefulSet — including ``pods/tpu-serving-deployment.yaml``)
into :class:`~kind_tpu_sim_torch.sched.scheduler.SliceRequest` gangs, and
:func:`k8s_event` renders a scheduler decision as a kubernetes
``Event`` object (``FailedScheduling`` warnings with kube-scheduler
message shapes), so traces read like ``kubectl get events``.

Mapping rules (the scheduling-relevant subset, deliberately small):

* ``resources.limits["google.com/tpu"]`` — chips per pod. A pod
  requesting <= one host's chips is a single-host request; the slice
  topology is taken from the ``cloud.google.com/gke-tpu-topology``
  nodeSelector when present, else synthesized as ``1xN``.
* **Deployment** — ``replicas`` INDEPENDENT single-pod gangs (each
  pod schedules alone, like the real Deployment controller).
* **StatefulSet** — ONE gang of ``replicas`` pods (all-or-nothing):
  the repo's multi-host JAX workers (``pods/jax-multihost.yaml``)
  are a jax.distributed world that deadlocks unless every worker
  lands, which is exactly gang semantics.
* ``priorityClassName`` maps through :data:`PRIORITY_CLASSES`;
  the ``kind-tpu-sim.dev/priority`` annotation (an integer)
  overrides it.

:func:`to_pod_manifest` is the inverse — a SliceRequest rendered
back to a schedulable Pod YAML — and round-trips:
``slice_requests_from_yaml(to_pod_manifest(req)) == [req]``.
"""

from __future__ import annotations

from typing import List, Optional

from kind_tpu_sim_torch import topology as topo
from kind_tpu_sim_torch import yamlsubset
from kind_tpu_sim_torch.sched.inventory import LABEL_ZONE
from kind_tpu_sim_torch.sched.scheduler import SliceRequest

ANNOTATION_PRIORITY = "kind-tpu-sim.dev/priority"
ANNOTATION_HOLD = "kind-tpu-sim.dev/hold-s"

# The kubernetes convention: bigger evicts smaller. Names follow the
# GKE autopilot tiers plus the repo's own batch tier.
PRIORITY_CLASSES = {
    "system-node-critical": 1000,
    "system-cluster-critical": 900,
    "high": 100,
    "default": 0,
    "batch": -10,
    "low": -10,
}

TPU_RESOURCE = "google.com/tpu"


def _pod_spec(doc: dict) -> Optional[dict]:
    kind = doc.get("kind")
    if kind == "Pod":
        return doc.get("spec", {})
    if kind in ("Deployment", "StatefulSet", "Job", "DaemonSet"):
        return (doc.get("spec", {}).get("template", {})
                .get("spec", {}))
    return None


def _pod_meta(doc: dict) -> dict:
    if doc.get("kind") == "Pod":
        return doc.get("metadata", {}) or {}
    return (doc.get("spec", {}).get("template", {})
            .get("metadata", {}) or {})


def _tpu_chips(spec: dict) -> int:
    total = 0
    for c in spec.get("containers", []) or []:
        limits = (c.get("resources", {}) or {}).get("limits", {}) or {}
        if TPU_RESOURCE in limits:
            total += int(str(limits[TPU_RESOURCE]))
    return total


def _priority(doc: dict, spec: dict) -> int:
    meta = _pod_meta(doc)
    annotations = meta.get("annotations", {}) or {}
    top_ann = (doc.get("metadata", {}) or {}).get(
        "annotations", {}) or {}
    for source in (annotations, top_ann):
        if ANNOTATION_PRIORITY in source:
            return int(str(source[ANNOTATION_PRIORITY]))
    cls = spec.get("priorityClassName")
    if cls is not None:
        if cls not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priorityClassName {cls!r}; known: "
                f"{', '.join(sorted(PRIORITY_CLASSES))}")
        return PRIORITY_CLASSES[cls]
    return 0


def _hold_s(doc: dict) -> float:
    meta = _pod_meta(doc)
    for source in (meta.get("annotations", {}) or {},
                   (doc.get("metadata", {}) or {}).get(
                       "annotations", {}) or {}):
        if ANNOTATION_HOLD in source:
            return float(str(source[ANNOTATION_HOLD]))
    return 0.0


def _accelerator_and_topology(
        spec: dict, chips: int, replicas: int) -> tuple:
    """(accelerator, topology) for a gang of ``replicas`` pods each
    wanting ``chips`` chips. The gke-tpu nodeSelector wins when
    present (that IS the GKE contract); otherwise single-host
    requests synthesize a flat shape from the chip count."""
    selector = spec.get("nodeSelector", {}) or {}
    acc = selector.get(topo.LABEL_ACCELERATOR,
                       topo.DEFAULT_ACCELERATOR)
    if acc not in topo.ACCELERATORS:
        raise ValueError(f"unknown accelerator {acc!r}")
    aspec = topo.ACCELERATORS[acc]
    if topo.LABEL_TOPOLOGY in selector:
        topology = selector[topo.LABEL_TOPOLOGY]
        s = topo.make_slice(acc, topology)
        want = chips * replicas
        if s.num_chips != want:
            raise ValueError(
                f"topology {topology} is {s.num_chips} chips but "
                f"{replicas} pod(s) x {chips} request {want}")
        return acc, topology
    if replicas > 1:
        # no explicit topology: synthesize the smallest slice whose
        # host tiling is `replicas` hosts along the first axis —
        # each pod must then own exactly one host's chips (the
        # jax-multihost StatefulSet shape)
        if chips != aspec.chips_per_host:
            raise ValueError(
                f"multi-pod gang without a {topo.LABEL_TOPOLOGY} "
                f"nodeSelector needs {aspec.chips_per_host} chips "
                f"per pod (one {acc} host), got {chips}")
        dims = ((aspec.host_bounds[0] * replicas,)
                + aspec.host_bounds[1:])
        return acc, topo.format_topology(dims)
    if chips > aspec.chips_per_host:
        raise ValueError(
            f"{chips} chips exceed one {acc} host "
            f"({aspec.chips_per_host}) and no topology selector "
            "names the slice shape")
    # flat sub-host shape: 1xN (2-D) or 1x1xN (3-D)
    dims = (1,) * (aspec.ndims - 1) + (chips,)
    return acc, topo.format_topology(dims)


def slice_requests_from_yaml(text: str) -> List[SliceRequest]:
    """Parse every TPU-consuming workload in a (possibly multi-doc)
    manifest into SliceRequests. Non-TPU docs (Services, ConfigMaps,
    pods without a google.com/tpu limit) are skipped."""
    out: List[SliceRequest] = []
    for doc in yamlsubset.load_all(text):
        if not isinstance(doc, dict):
            continue
        spec = _pod_spec(doc)
        if spec is None:
            continue
        chips = _tpu_chips(spec)
        if chips <= 0:
            continue
        name = (doc.get("metadata", {}) or {}).get("name", "unnamed")
        kind = doc.get("kind")
        replicas = int(doc.get("spec", {}).get("replicas", 1) or 1)
        priority = _priority(doc, spec)
        hold_s = _hold_s(doc)
        selector = spec.get("nodeSelector", {}) or {}
        pool = selector.get("kind-tpu-sim.dev/pool")
        # a topology.kubernetes.io/zone nodeSelector pins the gang
        # to that zone's inventory; a topologySpreadConstraints
        # entry on the same key leaves zone=None (any zone) and is
        # honored by scheduling the replicas under the `spread`
        # policy over a multi-zone inventory (docs/GLOBE.md)
        zone = selector.get(LABEL_ZONE)
        if kind == "StatefulSet":
            # one gang of `replicas` hosts, all-or-nothing
            acc, topology = _accelerator_and_topology(
                spec, chips, replicas)
            out.append(SliceRequest(
                name=name, accelerator=acc, topology=topology,
                priority=priority, hold_s=hold_s, pool=pool,
                zone=zone))
            continue
        acc, topology = _accelerator_and_topology(spec, chips, 1)
        if kind == "Deployment" and replicas > 1:
            for i in range(replicas):
                out.append(SliceRequest(
                    name=f"{name}-{i}", accelerator=acc,
                    topology=topology, priority=priority,
                    hold_s=hold_s, pool=pool, zone=zone))
        else:
            out.append(SliceRequest(
                name=name, accelerator=acc, topology=topology,
                priority=priority, hold_s=hold_s, pool=pool,
                zone=zone))
    return out


def to_pod_manifest(req: SliceRequest) -> str:
    """Render a SliceRequest back to a schedulable Pod manifest —
    the round-trip inverse of :func:`slice_requests_from_yaml` for
    single-host requests (multi-host gangs render as StatefulSets)."""
    s = req.slice_topo
    selector = {
        topo.LABEL_HARDWARE_TYPE: "tpu",
        topo.LABEL_ACCELERATOR: req.accelerator,
        topo.LABEL_TOPOLOGY: req.topology,
    }
    if req.pool:
        selector["kind-tpu-sim.dev/pool"] = req.pool
    if req.zone:
        selector[LABEL_ZONE] = req.zone
    annotations = {ANNOTATION_PRIORITY: str(req.priority)}
    if req.hold_s:
        annotations[ANNOTATION_HOLD] = str(req.hold_s)
    pod_spec = {
        "nodeSelector": selector,
        "tolerations": [{
            "key": topo.TAINT_KEY,
            "operator": "Equal",
            "value": topo.TAINT_VALUE,
            "effect": topo.TAINT_EFFECT,
        }],
        "containers": [{
            "name": "tpu-workload",
            "image": "public.ecr.aws/docker/library/busybox:stable",
            "command": ["sleep", "infinity"],
            "resources": {"limits": {
                TPU_RESOURCE: str(s.chips_per_host)}},
        }],
    }
    if s.num_hosts > 1:
        doc = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {"name": req.name},
            "spec": {
                "serviceName": req.name,
                "replicas": s.num_hosts,
                "podManagementPolicy": "Parallel",
                "selector": {"matchLabels": {"app": req.name}},
                "template": {
                    "metadata": {"labels": {"app": req.name},
                                 "annotations": annotations},
                    "spec": pod_spec,
                },
            },
        }
    else:
        doc = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": req.name,
                         "annotations": annotations},
            "spec": pod_spec,
        }
    return yamlsubset.dump(doc)


# ---------------------------------------------------------------------
# kubernetes Event rendering

_EVENT_TYPES = {
    "FailedScheduling": "Warning",
    "Preempted": "Warning",
    "NodeDrained": "Warning",
    "NodeFailed": "Warning",
}


def k8s_event(sched_event: dict,
              namespace: str = "default") -> dict:
    """One scheduler event as a kubernetes ``Event`` object — the
    ``kubectl get events`` face of the sim's decision log."""
    etype = sched_event["type"]
    return {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {
            "name": (f"{sched_event['gang']}."
                     f"{int(sched_event['at_s'] * 1e6):016x}"),
            "namespace": namespace,
        },
        "type": _EVENT_TYPES.get(etype, "Normal"),
        "reason": etype,
        "message": sched_event["message"],
        "source": {"component": "kind-tpu-sim-scheduler"},
        "involvedObject": {
            "kind": "Pod",
            "name": sched_event["gang"],
            "namespace": namespace,
        },
        "firstTimestamp": sched_event["at_s"],
    }
