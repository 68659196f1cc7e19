"""The topology-aware cluster scheduler the engine fleet places its
gangs with.

The port's copy of ``kind_tpu_sim/sched/`` as the scheduler-backed
fleet needs it: the node inventory (``inventory``) and the virtual-clock
gang scheduler with its node and link chaos (``scheduler``). The
analytic ``sched run`` loop, its seeded workload and the kube manifest
face are not ported (they drive no engine).

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
from kind_tpu_sim_torch.sched.scheduler import (  # noqa: F401
    POLICIES,
    BoundGang,
    ClusterScheduler,
    SchedConfig,
    SliceRequest,
    apply_link_event,
    apply_node_event,
    resolve_seed,
)
