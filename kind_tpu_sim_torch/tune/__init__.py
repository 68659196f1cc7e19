"""Deterministic fleet-design search: the port's copy of
``kind_tpu_sim/tune/`` (the reference's docs/TUNE.md describes it).

The simulator as an optimizer: a seeded :class:`TuneSpace` of typed
design dimensions, successive-halving evaluation of drawn candidates
against a trace + SLO policy on the worker pool, an exact Pareto
front of chip-second cost vs goodput/attainment with a knee-point
winner, and a chaos-aware mode that re-scores finalists under
fuzzer-drawn fault schedules. Same seed => byte-identical search
trace, across runs AND across worker-pool sizes.

Knobs: KIND_TPU_SIM_TUNE_SEED, KIND_TPU_SIM_TUNE_BUDGET,
KIND_TPU_SIM_TUNE_CHAOS_BUDGET (analysis/knobs.py). The package
imports without torch: a candidate is an analytic fleet or globe, and
the cold workers that score candidates stay light.
"""

from kind_tpu_sim_torch.tune.driver import (  # noqa: F401
    CHAOS_ATTAINMENT,
    FLEET_CHAOS_KINDS,
    GLOBE_CHAOS_KINDS,
    SDC_FLEET_CHAOS_KINDS,
    draw_fault_schedule,
    evaluate,
    evaluate_candidates,
    replay,
    resolve_budget,
    resolve_chaos_budget,
    resolve_seed,
    survivors_of,
    tune,
    winner_spec_text,
)
from kind_tpu_sim_torch.tune.pareto import (  # noqa: F401
    dominates,
    knee_point,
    pareto_front,
)
from kind_tpu_sim_torch.tune.space import (  # noqa: F401
    SPOT_PRICE,
    TuneDim,
    TuneSpace,
    candidate_replicas,
    candidate_spec,
    default_fleet_space,
    default_globe_space,
    generation_cost_factor,
    price_factor,
    ratio_space,
    render_fleet,
    render_globe,
    sdc_space,
    zoo_space,
)
