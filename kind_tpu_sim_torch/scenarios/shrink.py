"""Auto-shrinker: violation -> minimal pinned repro (the port's copy of
``kind_tpu_sim/scenarios/shrink.py``).

Given a spec that violates some invariants, greedily minimize it
while the violation persists, in a FIXED mutation order (no
randomness), so two shrinks of the same violation produce the
byte-identical repro:

1. **Drop faults** one at a time, to fixpoint — the repro keeps
   only the faults that actually interact.
2. **Narrow windows** — each surviving fault's window is halved
   toward its start, a bounded number of binary steps.
3. **Shrink the trace** — halve ``n_requests`` (floor 20) while
   the violation still reproduces.

The predicate re-runs the spec and re-checks ONLY the originally
violated invariant names (rerun-needing ones get a rerun hook, so a
replay or event-core divergence keeps bisecting via the replaycheck
machinery while it shrinks). The result is emitted as a repro dict
that `chaos fuzz --emit-repros` pins under ``tests/repros/`` — a
spec file the test suite re-runs forever.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from kind_tpu_sim_torch.scenarios import invariants
from kind_tpu_sim_torch.scenarios.spec import (FaultWindow, ScenarioSpec,
                                               run_spec)

_MAX_WINDOW_STEPS = 4
_MIN_REQUESTS = 20


def _violated(spec: ScenarioSpec,
              names: Tuple[str, ...]) -> List[str]:
    """Which of ``names`` still fail on a fresh run of ``spec``
    (empty = the candidate lost the violation)."""
    try:
        report = run_spec(spec)
        found = invariants.check(
            spec, report,
            rerun=lambda ec, s=spec: run_spec(s, event_core=ec),
            names=names)
    except Exception:
        # a mutation that cannot even run is not a repro
        return []
    return [v["invariant"] for v in found]


def _with_faults(spec: ScenarioSpec, faults) -> ScenarioSpec:
    return dataclasses.replace(spec, faults=tuple(faults))


def shrink(spec: ScenarioSpec, violated: Tuple[str, ...],
           ) -> Dict[str, object]:
    """Minimize ``spec`` while any of ``violated`` still fails.
    Deterministic: fixed mutation order, no randomness — the
    contract the shrinker-minimality tests pin."""
    current = spec
    steps = 0       # accepted mutations
    attempts = 0    # candidate runs tried

    # 1. drop faults to fixpoint
    changed = True
    while changed:
        changed = False
        for i in range(len(current.faults)):
            cand = _with_faults(
                current, current.faults[:i] + current.faults[i + 1:])
            attempts += 1
            if _violated(cand, violated):
                current = cand
                steps += 1
                changed = True
                break

    # 2. narrow each surviving window toward its start
    for i in range(len(current.faults)):
        for _ in range(_MAX_WINDOW_STEPS):
            f = current.faults[i]
            width = f.end_frac - f.start_frac
            if width <= 0.02:
                break
            cand_fault = FaultWindow(
                kind=f.kind, start_frac=f.start_frac,
                end_frac=round(f.start_frac + width / 2, 4),
                target=f.target, param=f.param)
            cand = _with_faults(
                current, current.faults[:i] + (cand_fault,)
                + current.faults[i + 1:])
            attempts += 1
            if not _violated(cand, violated):
                break
            current = cand
            steps += 1

    # 3. halve the trace
    while current.workload.n_requests > _MIN_REQUESTS:
        half = max(_MIN_REQUESTS,
                   current.workload.n_requests // 2)
        cand = dataclasses.replace(
            current, workload=dataclasses.replace(
                current.workload, n_requests=half))
        attempts += 1
        if not _violated(cand, violated):
            break
        current = cand
        steps += 1

    final = dataclasses.replace(
        current,
        name=f"{spec.name}-min",
        description=(f"auto-shrunk repro of {spec.name} "
                     f"(violated: {', '.join(violated)})"))
    return {
        "spec": final.as_dict(),
        "violated": list(_violated(final, violated)),
        "shrink_steps": steps,
        "attempts": attempts,
        "source": spec.name,
    }
