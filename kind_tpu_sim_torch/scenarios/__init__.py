"""Scenario compiler + seeded chaos fuzzer (the port's copy of
``kind_tpu_sim/scenarios/``).

The declarative scenario layer: :class:`ScenarioSpec` names one
chaos experiment as data (workload x topology x fault schedule x
invariant set), the registry re-expresses every hand-written
``chaos.py`` scenario in it (same names, byte-identical reports),
the invariant catalog gives every scenario assertion a name, and
the fuzzer composes multi-layer fault schedules, checks the
universal invariants on every run, and auto-shrinks violations to
minimal pinned repros under ``tests/repros/``. Every run prices from
the H100's calibration and generation registry.
"""

from kind_tpu_sim_torch.scenarios.spec import (FaultWindow, ScenarioSpec,
                                               TopologySpec, WorkloadDims,
                                               run_spec, spec_problems)
from kind_tpu_sim_torch.scenarios.invariants import (CATALOG, Invariant,
                                                     UNIVERSAL, check)

__all__ = [
    "CATALOG",
    "FaultWindow",
    "Invariant",
    "ScenarioSpec",
    "TopologySpec",
    "UNIVERSAL",
    "WorkloadDims",
    "check",
    "run_spec",
    "spec_problems",
]
