"""The topology-aware cluster scheduler the engine fleet places its
gangs with.

The port's copy of ``kind_tpu_sim/sched/``: the node inventory
(``inventory``), the virtual-clock gang scheduler with its node and link
chaos, its seeded workload and the ``sched run`` loop (``scheduler``),
and the kube manifest face (``kubeface``: manifests to gangs, gangs to
Pod manifests, decisions as kubernetes Events).

Knob: KIND_TPU_SIM_SCHED_SEED (``scheduler.resolve_seed``).
"""

from kind_tpu_sim_torch.sched.inventory import (  # noqa: F401
    LABEL_AVOID,
    IciDomain,
    Inventory,
    Node,
    Placement,
    build_inventory,
)
from kind_tpu_sim_torch.sched.kubeface import (  # noqa: F401
    PRIORITY_CLASSES,
    k8s_event,
    slice_requests_from_yaml,
    to_pod_manifest,
)
from kind_tpu_sim_torch.sched.scheduler import (  # noqa: F401
    POLICIES,
    BoundGang,
    ClusterScheduler,
    SchedConfig,
    SchedSimConfig,
    SchedWorkloadSpec,
    SliceRequest,
    apply_link_event,
    apply_node_event,
    generate_gangs,
    resolve_seed,
    run_sched_sim,
)
