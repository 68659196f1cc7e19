"""The environment knobs the fleet, scheduler, training, chaos, cost
model and model-zoo layers read.

The JAX package declares its knobs in one registry
(``kind_tpu_sim/analysis/knobs.py``); the port keeps copies of the ones
its layers read, with the same names, types and defaults. An unset or
unparseable value reads as the default; a bool reads ``""``, ``"0"``,
``"false"`` and ``"no"`` (any case) as off and anything else as on.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

FLEET_SEED = "KIND_TPU_SIM_FLEET_SEED"
CHAOS_SEED = "KIND_TPU_SIM_CHAOS_SEED"
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

# values a bool knob reads as off
FALSE_VALUES = ("", "0", "false", "no")

# name -> (default, type)
KNOBS: Dict[str, Tuple[object, str]] = {
    FLEET_SEED: (0, "int"),
    CHAOS_SEED: (0, "int"),
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
}


def get(name: str) -> object:
    """The value of knob ``name``: the environment's, parsed as the
    knob's type, else the default."""
    default, kind = KNOBS[name]
    raw = os.environ.get(name)
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
