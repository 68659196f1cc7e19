"""The environment knobs the port reads: one table of every
``KIND_TPU_SIM_*`` variable, with its name, type and default.

The JAX package declares its knobs in one registry
(``kind_tpu_sim/analysis/knobs.py``); the port keeps copies of the ones
its layers read, with the same names, types and defaults. An unset or
unparseable value reads as the default; a bool reads ``""``, ``"0"``,
``"false"`` and ``"no"`` (any case) as off and anything else as on.

The lowest layers read this module (``utils/shell.py``, the worker
pool's cold child, ``tune/``), so it imports the standard library alone
and nothing of the port's packages: loading it loads neither torch nor
the fleet.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

FLEET_SEED = "KIND_TPU_SIM_FLEET_SEED"
CHAOS_SEED = "KIND_TPU_SIM_CHAOS_SEED"
CHAOS_FAULT = "KIND_TPU_SIM_CHAOS_FAULT"
POOL_WARM = "KIND_TPU_SIM_POOL_WARM"
POOL_SHM = "KIND_TPU_SIM_POOL_SHM"
POOL_SHM_SEGS = "KIND_TPU_SIM_POOL_SHM_SEGS"
FUZZ_BUDGET = "KIND_TPU_SIM_FUZZ_BUDGET"
FUZZ_SEED = "KIND_TPU_SIM_FUZZ_SEED"
FUZZ_MAX_FAULTS = "KIND_TPU_SIM_FUZZ_MAX_FAULTS"
GLOBE_SEED = "KIND_TPU_SIM_GLOBE_SEED"
GLOBE_SHARDS = "KIND_TPU_SIM_GLOBE_SHARDS"
FLEET_TICK_S = "KIND_TPU_SIM_FLEET_TICK_S"
FLEET_FF = "KIND_TPU_SIM_FLEET_FF"
FLEET_WARMUP_S = "KIND_TPU_SIM_FLEET_WARMUP_S"
FLEET_EVENT_CORE = "KIND_TPU_SIM_FLEET_EVENT_CORE"
SCHED_SEED = "KIND_TPU_SIM_SCHED_SEED"
TRAIN_CKPT_EVERY = "KIND_TPU_SIM_TRAIN_CKPT_EVERY"
TRAIN_CKPT_WRITE_S = "KIND_TPU_SIM_TRAIN_CKPT_WRITE_S"
TRAIN_RESTART_S = "KIND_TPU_SIM_TRAIN_RESTART_S"
TRAIN_MTBF_S = "KIND_TPU_SIM_TRAIN_MTBF_S"
TRAIN_ELASTIC = "KIND_TPU_SIM_TRAIN_ELASTIC"
SDC_RATE = "KIND_TPU_SIM_SDC_RATE"
SDC_AUDIT_FRAC = "KIND_TPU_SIM_SDC_AUDIT_FRAC"
DISAGG_TIER = "KIND_TPU_SIM_DISAGG_TIER"
DISAGG_DTYPE = "KIND_TPU_SIM_DISAGG_DTYPE"
CALIBRATION = "KIND_TPU_SIM_CALIBRATION"
FLEET_COLUMNAR = "KIND_TPU_SIM_FLEET_COLUMNAR"
GENERATION = "KIND_TPU_SIM_GENERATION"
ZOO_MODELS = "KIND_TPU_SIM_ZOO_MODELS"
ZOO_SWAP_FACTOR = "KIND_TPU_SIM_ZOO_SWAP_FACTOR"
OVERLOAD_RETRY_BUDGET = "KIND_TPU_SIM_OVERLOAD_RETRY_BUDGET"
OVERLOAD_HEDGE_QUANTILE = "KIND_TPU_SIM_OVERLOAD_HEDGE_QUANTILE"
OVERLOAD_BREAKER_WINDOW = "KIND_TPU_SIM_OVERLOAD_BREAKER_WINDOW"
OVERLOAD_BROWNOUT = "KIND_TPU_SIM_OVERLOAD_BROWNOUT"
TENANT_ISOLATION = "KIND_TPU_SIM_TENANT_ISOLATION"
TENANT_DRR_QUANTUM = "KIND_TPU_SIM_TENANT_DRR_QUANTUM"
HEALTH_ALPHA = "KIND_TPU_SIM_HEALTH_ALPHA"
HEALTH_SUSPECT_PHI = "KIND_TPU_SIM_HEALTH_SUSPECT_PHI"
HEALTH_QUARANTINE_PHI = "KIND_TPU_SIM_HEALTH_QUARANTINE_PHI"
HEALTH_QUARANTINE_EVALS = "KIND_TPU_SIM_HEALTH_QUARANTINE_EVALS"
HEALTH_PROBE_OK = "KIND_TPU_SIM_HEALTH_PROBE_OK"
HEALTH_PROBE_INTERVAL_S = "KIND_TPU_SIM_HEALTH_PROBE_INTERVAL_S"
HEALTH_MIN_SAMPLES = "KIND_TPU_SIM_HEALTH_MIN_SAMPLES"
HEALTH_SIGMA_FRAC = "KIND_TPU_SIM_HEALTH_SIGMA_FRAC"
HEALTH_SIGMA_ABS = "KIND_TPU_SIM_HEALTH_SIGMA_ABS"
HEALTH_PROBE_TIMEOUT_S = "KIND_TPU_SIM_HEALTH_PROBE_TIMEOUT_S"
HEALTH_SPEC_RATIO = "KIND_TPU_SIM_HEALTH_SPEC_RATIO"
MAX_RETRIES = "KIND_TPU_SIM_MAX_RETRIES"
RETRY_BASE_MS = "KIND_TPU_SIM_RETRY_BASE_MS"
CMD_TIMEOUT_S = "KIND_TPU_SIM_CMD_TIMEOUT_S"
TUNE_SEED = "KIND_TPU_SIM_TUNE_SEED"
TUNE_BUDGET = "KIND_TPU_SIM_TUNE_BUDGET"
TUNE_CHAOS_BUDGET = "KIND_TPU_SIM_TUNE_CHAOS_BUDGET"

# values a bool knob reads as off
FALSE_VALUES = ("", "0", "false", "no")

# name -> (default, type)
KNOBS: Dict[str, Tuple[object, str]] = {
    FLEET_SEED: (0, "int"),
    CHAOS_SEED: (0, "int"),
    # a worker's injected fault: crash@N, hang@N:S, slow@N:S, flaky@K:S
    CHAOS_FAULT: (None, "str"),
    POOL_WARM: (False, "bool"),
    # the pool's bulk transport over shared-memory segments, and the
    # segments' names a parent hands its worker (never set by hand)
    POOL_SHM: (True, "bool"),
    POOL_SHM_SEGS: ("", "str"),
    GLOBE_SEED: (0, "int"),
    GLOBE_SHARDS: (0, "int"),
    FUZZ_BUDGET: (25, "int"),
    FUZZ_SEED: (0, "int"),
    FUZZ_MAX_FAULTS: (4, "int"),
    FLEET_TICK_S: (0.01, "float"),
    FLEET_FF: (True, "bool"),
    FLEET_WARMUP_S: (0.55, "float"),
    FLEET_EVENT_CORE: (True, "bool"),
    SCHED_SEED: (0, "int"),
    TRAIN_CKPT_EVERY: (0, "int"),
    TRAIN_CKPT_WRITE_S: (0.05, "float"),
    TRAIN_RESTART_S: (0.2, "float"),
    TRAIN_MTBF_S: (60.0, "float"),
    TRAIN_ELASTIC: (True, "bool"),
    SDC_RATE: (0.4, "float"),
    SDC_AUDIT_FRAC: (0.0, "float"),
    DISAGG_TIER: ("ici", "str"),
    DISAGG_DTYPE: ("bf16", "str"),
    CALIBRATION: (None, "str"),
    FLEET_COLUMNAR: (True, "bool"),
    # the port's generation registry holds one name, the H100's
    GENERATION: ("h100", "str"),
    ZOO_MODELS: (3, "int"),
    ZOO_SWAP_FACTOR: (1.0, "float"),
    OVERLOAD_RETRY_BUDGET: (0.1, "float"),
    OVERLOAD_HEDGE_QUANTILE: (0.95, "float"),
    OVERLOAD_BREAKER_WINDOW: (16, "int"),
    OVERLOAD_BROWNOUT: (True, "bool"),
    TENANT_ISOLATION: (True, "bool"),
    TENANT_DRR_QUANTUM: (4.0, "float"),
    HEALTH_ALPHA: (0.25, "float"),
    HEALTH_SUSPECT_PHI: (2.0, "float"),
    HEALTH_QUARANTINE_PHI: (8.0, "float"),
    HEALTH_QUARANTINE_EVALS: (3, "int"),
    HEALTH_PROBE_OK: (2, "int"),
    HEALTH_PROBE_INTERVAL_S: (0.25, "float"),
    HEALTH_MIN_SAMPLES: (4, "int"),
    HEALTH_SIGMA_FRAC: (0.1, "float"),
    HEALTH_SIGMA_ABS: (1e-4, "float"),
    HEALTH_PROBE_TIMEOUT_S: (2.0, "float"),
    HEALTH_SPEC_RATIO: (3.0, "float"),
    # the classified retry of external commands (``utils/shell.py``);
    # an unset deadline is no cap
    MAX_RETRIES: (3, "int"),
    RETRY_BASE_MS: (50.0, "float"),
    CMD_TIMEOUT_S: (None, "float"),
    # the tuner's search stream, candidate budget and chaos budget
    TUNE_SEED: (0, "int"),
    TUNE_BUDGET: (16, "int"),
    TUNE_CHAOS_BUDGET: (0, "int"),
}


def get_raw(name: str,
            environ: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """The raw string of knob ``name`` in ``environ`` (default: the
    process's environment), or None when unset. A name the table lacks
    raises KeyError."""
    if name not in KNOBS:
        raise KeyError(f"unregistered knob {name!r}; declare it in "
                       "kind_tpu_sim_torch/analysis/knobs.py")
    return (os.environ if environ is None else environ).get(name)


def get(name: str, environ: Optional[Mapping[str, str]] = None) -> object:
    """The value of knob ``name``: the environment's, parsed as the
    knob's type, else the default."""
    default, kind = KNOBS[name]
    raw = get_raw(name, environ)
    if raw is None:
        return default
    if kind == "bool":
        return raw.lower() not in FALSE_VALUES
    if kind == "str":
        return raw
    try:
        return int(raw) if kind == "int" else float(raw)
    except ValueError:
        return default
