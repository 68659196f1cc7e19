"""The multi-cell, multi-zone fleet-of-fleets simulator: the port's copy
of ``kind_tpu_sim/globe/``.

The layer above the fleet: zones group cells (each cell one scheduler
inventory and one ``FleetSim``) into correlated failure domains behind a
global anycast-style front door (latency- and capacity-aware admission,
bounded cross-cell spill, sticky prefix affinity), with a global
capacity planner trading a spot-replica budget across zones above the
per-cell autoscalers, and blast-radius chaos: zone loss, DCN brown-out,
thundering-herd failover, cell drain. The same seed and config give the
same report, byte for byte, and the reference's report for the same
calibration and generation registry (analytic cells are priced from the
H100's calibration, ``fleet/costmodel.py``).

Knobs: ``KIND_TPU_SIM_GLOBE_SEED`` (``sim.resolve_seed``), plus every
fleet, scheduler and health knob the embedded cells inherit.

Not ported yet: the sharded driver (``CellProxy``, ``ShardedGlobeSim``,
``resolve_shards``), which runs the cells in cold pool workers.
"""

from kind_tpu_sim_torch.fleet.overload import (  # noqa: F401
    OverloadConfig,
    OverloadState,
)
from kind_tpu_sim_torch.globe.cell import (  # noqa: F401
    Cell,
    CellConfig,
)
from kind_tpu_sim_torch.globe.frontdoor import (  # noqa: F401
    FrontDoor,
    FrontDoorConfig,
)
from kind_tpu_sim_torch.globe.planner import (  # noqa: F401
    GlobalPlanner,
    PlannerConfig,
)
from kind_tpu_sim_torch.globe.sim import (  # noqa: F401
    GLOBE_CHAOS_ACTIONS,
    GLOBE_SEED_ENV,
    GlobeChaosEvent,
    GlobeConfig,
    GlobeSim,
    GlobeWorkloadSpec,
    attainment_over,
    fleet_config_for,
    generate_globe_traces,
    load_globe_trace,
    resolve_seed,
    save_globe_trace,
    zone_seed,
)
