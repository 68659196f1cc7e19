"""The environment knobs the fleet and chaos layers read: the trace
seed and the chaos seed.

The JAX package declares its knobs in one registry
(``kind_tpu_sim/analysis/knobs.py``); the port keeps copies of these
two, with the same names and defaults. An unset or unparseable
value reads as the default.
"""

from __future__ import annotations

import os
from typing import Dict

FLEET_SEED = "KIND_TPU_SIM_FLEET_SEED"
CHAOS_SEED = "KIND_TPU_SIM_CHAOS_SEED"

# name -> default
KNOBS: Dict[str, int] = {FLEET_SEED: 0, CHAOS_SEED: 0}


def get(name: str) -> int:
    """The value of knob ``name``: the environment's, else the
    default."""
    raw = os.environ.get(name)
    try:
        return KNOBS[name] if raw is None else int(raw)
    except ValueError:
        return KNOBS[name]
