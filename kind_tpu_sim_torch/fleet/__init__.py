"""The serving fleet: analytic replicas and the port's real engines.

The port's copy of ``kind_tpu_sim/fleet/``: seeded open-loop traces
(``loadgen``), SLO accounting (``slo``), the router with the analytic
``SimReplica`` and the engine replica (``router``), the cost model
priced from the H100's calibration (``costmodel``), disaggregated
prefill/decode pools (``disagg``), the autoscaler (``autoscaler``),
overload containment (``overload``), multi-tenancy (``tenancy``), the
gray-failure detector (``kind_tpu_sim_torch.health``), the training
tenancy (``training``), the event heap (``events``) and the
virtual-clock loop (``sim``) with its integrity audit lane, its
scheduler-backed placement (``kind_tpu_sim_torch.sched``), the model zoo
and per-generation pricing (``zoo``, the generation registry in
``costmodel``) and the columnar mirror of analytic fleets
(``columnar``). The same seed
and config give the reference's report (for engine fleets, when the
engines carry the same weights).

Knobs (``knobs``): KIND_TPU_SIM_FLEET_SEED (``loadgen.resolve_seed``),
KIND_TPU_SIM_FLEET_TICK_S (``sim.resolve_tick_s``),
KIND_TPU_SIM_FLEET_WARMUP_S (``autoscaler.resolve_warmup_s``),
KIND_TPU_SIM_FLEET_FF (``sim.resolve_fast_forward``),
KIND_TPU_SIM_FLEET_EVENT_CORE (``events.resolve_event_core``),
KIND_TPU_SIM_TRAIN_* (the training tenancy), KIND_TPU_SIM_SDC_* (the
audit lane and chip defects), KIND_TPU_SIM_CALIBRATION
(``costmodel.load_calibration``) and KIND_TPU_SIM_DISAGG_TIER /
KIND_TPU_SIM_DISAGG_DTYPE (``disagg.resolve_tier`` / ``resolve_dtype``),
KIND_TPU_SIM_GENERATION, KIND_TPU_SIM_ZOO_MODELS and
KIND_TPU_SIM_ZOO_SWAP_FACTOR (``zoo``), KIND_TPU_SIM_FLEET_COLUMNAR
(``columnar.resolve_columnar``), KIND_TPU_SIM_OVERLOAD_* (``overload``'s
``resolve_*``), KIND_TPU_SIM_TENANT_ISOLATION /
KIND_TPU_SIM_TENANT_DRR_QUANTUM (``tenancy``) and KIND_TPU_SIM_HEALTH_*
(``health.DetectorConfig.from_env``).
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
from kind_tpu_sim_torch.fleet.columnar import (  # noqa: F401
    COLUMNAR_MIN_REPLICAS,
    FleetColumns,
    resolve_columnar,
)
from kind_tpu_sim_torch.fleet.costmodel import (  # noqa: F401
    CALIBRATION_SCHEMA,
    DEFAULT_CALIBRATION,
    DEFAULT_GENERATION,
    GENERATION_FACTS,
    GENERATIONS,
    CostModel,
    RequestCost,
    calibrate,
    derive_generation,
    generation_of_accelerator,
    kv_bytes_per_token,
    load_calibration,
    load_generation,
    parse_geometry,
)
from kind_tpu_sim_torch.fleet.disagg import (  # noqa: F401
    DisaggConfig,
    KvHandoff,
    calibrated_sim_config,
    kv_transfer_s,
    resolve_dtype,
    resolve_tier,
)
from kind_tpu_sim_torch.fleet.events import (  # noqa: F401
    LANE_MODEL_SWAP,
    DueSet,
    EventHeap,
    resolve_event_core,
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
    SimReplica,
    SimReplicaConfig,
)
from kind_tpu_sim_torch.fleet.sim import (  # noqa: F401
    ChaosEvent,
    FleetConfig,
    FleetSchedConfig,
    FleetSim,
    attainment_over,
    engine_fleet,
    resolve_audit_frac,
    resolve_fast_forward,
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
from kind_tpu_sim_torch.fleet.training import (  # noqa: F401
    TRAIN_KINDS,
    TrainingConfig,
    TrainingGang,
    TrainingGangConfig,
    TrainingTenant,
    expected_overhead,
    gang_mesh,
    gangs_from_manifest,
    grow_topology,
    ising_gang,
    optimal_cadence_steps,
    shrink_topology,
    step_time_s,
    to_manifest,
    verify_ledger,
)
from kind_tpu_sim_torch.fleet.zoo import (  # noqa: F401
    ModelSpec,
    SwapEvent,
    ZooConfig,
    default_zoo,
    fits,
    model_sim_config,
    placements,
    resolve_generation,
    stamp_models,
    swap_s,
    zoo_config_from_dict,
)
from kind_tpu_sim_torch.fleet.slo import (  # noqa: F401
    FixedBucketHistogram,
    SloPolicy,
    SloTracker,
    brute_force_percentile,
)
