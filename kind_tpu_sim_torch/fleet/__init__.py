"""The serving fleet over the port's real engines.

The port's copy of the engine-backed path of ``kind_tpu_sim/fleet/``:
seeded open-loop traces (``loadgen``), SLO accounting (``slo``), the
router and the engine replica (``router``), the autoscaler
(``autoscaler``), overload containment (``overload``), multi-tenancy
(``tenancy``), the gray-failure detector (``kind_tpu_sim_torch.health``)
and the virtual-clock loop (``sim``) with its integrity audit lane. The
same seed and config give the reference's report when the engines carry
the same weights.

Knob: KIND_TPU_SIM_FLEET_SEED (``loadgen.resolve_seed``). The tick
width and the replica warm-up take the reference's defaults where a
config leaves them unset (``sim.TICK_S``, ``autoscaler.WARMUP_S``).
"""

from kind_tpu_sim_torch.health import (  # noqa: F401
    DetectorConfig,
    FailureDetector,
)
from kind_tpu_sim_torch.fleet.autoscaler import (  # noqa: F401
    Autoscaler,
    AutoscalerConfig,
    ScaleEvent,
    resolve_warmup_s,
)
from kind_tpu_sim_torch.fleet.loadgen import (  # noqa: F401
    TraceRequest,
    VirtualClock,
    WorkloadSpec,
    generate_trace,
    load_trace,
    resolve_seed,
    save_trace,
)
from kind_tpu_sim_torch.fleet.overload import (  # noqa: F401
    BrownoutController,
    CircuitBreaker,
    LatencyQuantile,
    OverloadConfig,
    OverloadState,
    TokenBucket,
    request_tier,
    resolve_breaker_window,
    resolve_brownout,
    resolve_hedge_quantile,
    resolve_retry_budget,
    surge_trace,
)
from kind_tpu_sim_torch.fleet.router import (  # noqa: F401
    POLICIES,
    EngineReplica,
    ReplicaCompletion,
    Router,
)
from kind_tpu_sim_torch.fleet.sim import (  # noqa: F401
    ChaosEvent,
    FleetConfig,
    FleetSim,
    SimReplicaConfig,
    attainment_over,
    engine_fleet,
    resolve_tick_s,
)
from kind_tpu_sim_torch.fleet.tenancy import (  # noqa: F401
    QOS_TIERS,
    RateBucket,
    TenancyConfig,
    TenancyState,
    TenantSpec,
    default_tenancy,
    generate_tenant_trace,
    resolve_drr_quantum,
    resolve_isolation,
    tenant_of,
    tenant_surge_trace,
)
from kind_tpu_sim_torch.fleet.slo import (  # noqa: F401
    FixedBucketHistogram,
    SloPolicy,
    SloTracker,
)
