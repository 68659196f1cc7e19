"""Determinism tooling: the machine-checked replay contract (the port's
counterpart of ``kind_tpu_sim/analysis/``).

Every simulator layer (chaos, fleet, scheduler, health, globe) stakes
its correctness on one invariant: the same seed gives the same event log
and report, byte for byte.
:mod:`~kind_tpu_sim_torch.analysis.replaycheck` checks it at run time:
it runs a target twice under one seed, hashes the event stream
incrementally and bisects a mismatch to the first divergent event.

CLI: ``python -m kind_tpu_sim_torch analysis replay``.
:mod:`~kind_tpu_sim_torch.analysis.knobs` is the port's table of every
``KIND_TPU_SIM_*`` knob (the standard library alone). The reference's
static linters (``detlint``, ``contractlint``) and the commands
``analysis lint|contract|knobs`` are not ported yet.

``replaycheck`` loads lazily, so the runtime's imports do not pay for
the tooling (it builds its targets from the scenario registry, which
loads the chaos scenarios and torch).
"""

from __future__ import annotations

import importlib

_LAZY = ("replaycheck",)


def __getattr__(name: str):
    if name in _LAZY:
        return importlib.import_module(
            f"kind_tpu_sim_torch.analysis.{name}")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
