"""Seeded chaos fuzzer (the port's copy of
``kind_tpu_sim/scenarios/fuzz.py``).

``fuzz(budget, seed)`` draws ``budget`` composed scenarios — 2-4
concurrent fault kinds with jittered overlap windows, mixed serving
and training tenants, fleet and globe topologies — runs each under
the full universal invariant set (including the replay and
event-core rerun checks), and auto-shrinks every violation to a
minimal repro spec (scenarios/shrink.py).

Everything is a pure function of ``(budget, seed, max_faults)``:
every random draw comes from ``random.Random(zlib.crc32(...))``
streams, so the same seed produces the byte-identical fuzz report —
the property `chaos fuzz` CI runs pin. Wall-clock timings are only
added when the caller passes a ``timer`` (the CLI does not), keeping
the canonical report timer-free. The reports equal the reference's
when both price from the same calibration and generation registry;
on the port's (the H100's), seed 1 finds two ``recovery`` violations
by the numbers.
"""

from __future__ import annotations

import dataclasses
import random
import zlib
from typing import Dict, List, Optional

from kind_tpu_sim_torch.chaos import FAULT_SCHEMAS, draw_param
from kind_tpu_sim_torch.scenarios import invariants, shrink
from kind_tpu_sim_torch.scenarios.spec import (FaultWindow, ScenarioSpec,
                                               TopologySpec, WorkloadDims,
                                               run_spec, spec_problems)

# Fault windows live inside [START_LO, END_CAP] of the trace span:
# starts jittered over the first half so 2-4 windows overlap often,
# everything healed by 75% so the recovery invariant (breakers
# closed, brownout released) has quiesce room before the sim drains.
_START = (0.15, 0.5)
_DURATION = (0.1, 0.25)
_END_CAP = 0.75

_PROCESSES = ("poisson", "bursty", "diurnal")


def _eligible_kinds(topo: TopologySpec, training_gangs: int,
                    overload: bool) -> List[str]:
    """The fault kinds a drawn topology can legally compose
    (mirrors spec_problems — the fuzzer emits valid specs by
    construction)."""
    out = []
    for kind in sorted(FAULT_SCHEMAS):
        schema = FAULT_SCHEMAS[kind]
        if not schema.fuzzable or topo.kind not in schema.scopes:
            continue
        if "sched" in schema.needs and (topo.kind == "fleet"
                                        and not topo.sched):
            continue
        if "training" in schema.needs and training_gangs <= 0:
            continue
        if "overload" in schema.needs and not overload:
            continue
        if "disagg" in schema.needs and not getattr(
                topo, "disagg", False):
            continue
        if "tenancy" in schema.needs and not getattr(
                topo, "tenancy", False):
            continue
        if "zoo" in schema.needs:
            # zoo kinds never enter the shared pool: draw_spec adds
            # them from the dedicated zoo stream, so the base kind
            # draws — and every pre-zoo fuzz report, zoo-flavored
            # or not — keep their bytes
            continue
        if "sdc" in schema.needs:
            # SDC kinds ride their own dedicated stream too (the
            # zoo precedent): the shared pool never sees them, so
            # every pre-SDC fuzz report keeps its bytes
            continue
        out.append(kind)
    return out


def draw_spec(seed: int, index: int,
              max_faults: int = 4) -> ScenarioSpec:
    """Draw composed scenario ``index`` of the fuzz stream ``seed``
    — a pure function of its arguments."""
    rng = random.Random(zlib.crc32(
        f"fuzz:{seed}:{index}:{max_faults}".encode()))
    if rng.random() < 0.7:
        topo = TopologySpec(kind="fleet",
                            replicas=rng.randint(2, 3),
                            sched=rng.random() < 0.6)
    else:
        topo = TopologySpec(kind="globe",
                            replicas=2,
                            zones=rng.randint(2, 3),
                            cells_per_zone=rng.randint(1, 2))
    # disagg comes from a SEPARATE stream so every existing draw
    # (and thus every pre-disagg fuzz report for non-disagg specs)
    # stays byte-identical — pulling this bit from `rng` would
    # shift all downstream draws
    if topo.kind == "fleet" and not topo.sched:
        disagg_rng = random.Random(zlib.crc32(
            f"fuzz:disagg:{seed}:{index}".encode()))
        if disagg_rng.random() < 0.4:
            topo = dataclasses.replace(topo, disagg=True)
    # tenancy rides its own stream too (the disagg precedent): the
    # shared `rng` draw sequence — and with it every pre-tenancy
    # fuzz report for untenanted specs — stays byte-identical
    if topo.kind == "fleet":
        tenant_rng = random.Random(zlib.crc32(
            f"fuzz:tenant:{seed}:{index}".encode()))
        if tenant_rng.random() < 0.35:
            topo = dataclasses.replace(topo, tenancy=True)
    # the model zoo rides its own stream as well (the disagg /
    # tenancy precedent): every pre-zoo fuzz report for unzooed
    # specs keeps its bytes. Zoo fleets are analytic (spec fleets
    # pin generations directly; sched x zoo is a FleetConfig-level
    # combination) and unified (no disagg).
    zoo_rng = None
    if not topo.disagg and not (topo.kind == "fleet" and topo.sched):
        zoo_rng = random.Random(zlib.crc32(
            f"fuzz:zoo:{seed}:{index}".encode()))
        if zoo_rng.random() < 0.3:
            topo = dataclasses.replace(topo, zoo=True)
    overload = rng.random() < 0.7
    training_gangs = 0
    if topo.kind == "fleet" and topo.sched:
        training_gangs = rng.randint(0, 1)
    workload = WorkloadDims(
        process=rng.choice(_PROCESSES),
        rps=round(rng.uniform(20.0, 45.0), 1),
        n_requests=rng.randint(80, 160))

    pool = _eligible_kinds(topo, training_gangs, overload)
    n_faults = rng.randint(2, max(2, min(max_faults, len(pool))))
    kinds: List[str] = []
    for _ in range(min(n_faults, len(pool))):
        kind = rng.choice(pool)
        kinds.append(kind)
        if FAULT_SCHEMAS[kind].exclusive:
            pool = [k for k in pool
                    if not FAULT_SCHEMAS[k].exclusive]
        else:
            pool = [k for k in pool if k != kind]
        if not pool:
            break

    faults = []
    for kind in kinds:
        start = round(rng.uniform(*_START), 3)
        end = round(min(_END_CAP,
                        start + rng.uniform(*_DURATION)), 3)
        faults.append(FaultWindow(
            kind=kind, start_frac=start, end_frac=end,
            target=rng.randint(0, 7),
            param=draw_param(kind, rng)))
    # zoo faults ride the zoo stream end to end (window, target,
    # and magnitude included): the shared `rng` never sees them,
    # so the base fault draws above are byte-identical whether the
    # topology is zoo-flavored or not
    if topo.zoo and zoo_rng is not None:
        has_exclusive = any(FAULT_SCHEMAS[f.kind].exclusive
                            for f in faults)
        for kind in sorted(FAULT_SCHEMAS):
            schema = FAULT_SCHEMAS[kind]
            if "zoo" not in schema.needs or not schema.fuzzable:
                continue
            if topo.kind not in schema.scopes:
                continue
            if schema.exclusive and has_exclusive:
                continue
            if zoo_rng.random() < 0.5:
                start = round(zoo_rng.uniform(*_START), 3)
                end = round(min(_END_CAP,
                                start + zoo_rng.uniform(*_DURATION)),
                            3)
                faults.append(FaultWindow(
                    kind=kind, start_frac=start, end_frac=end,
                    target=zoo_rng.randint(0, 7),
                    param=draw_param(kind, zoo_rng)))
                if schema.exclusive:
                    has_exclusive = True
    # SDC faults ride a dedicated stream as well: the
    # shared `rng` never sees them, so every pre-SDC fuzz report —
    # corruption-flavored or not — keeps its bytes. Defective chips
    # live on unified, un-zooed fleets (the audit lane needs
    # same-model duplicate compute); correlated domain faults
    # additionally need the rack-aware scheduler.
    if topo.kind == "fleet" and not topo.disagg and not topo.zoo:
        sdc_rng = random.Random(zlib.crc32(
            f"fuzz:sdc:{seed}:{index}".encode()))
        if sdc_rng.random() < 0.5:
            has_exclusive = any(FAULT_SCHEMAS[f.kind].exclusive
                                for f in faults)
            drew_sdc_chip = False
            for kind in sorted(FAULT_SCHEMAS):
                schema = FAULT_SCHEMAS[kind]
                if "sdc" not in schema.needs or not schema.fuzzable:
                    continue
                if "sched" in schema.needs and not topo.sched:
                    continue
                if schema.exclusive and has_exclusive:
                    continue
                if sdc_rng.random() < 0.7:
                    start = round(sdc_rng.uniform(*_START), 3)
                    end = round(min(_END_CAP,
                                    start
                                    + sdc_rng.uniform(*_DURATION)),
                                3)
                    faults.append(FaultWindow(
                        kind=kind, start_frac=start, end_frac=end,
                        target=sdc_rng.randint(0, 7),
                        param=draw_param(kind, sdc_rng)))
                    if schema.exclusive:
                        has_exclusive = True
                    if kind == "sdc_chip":
                        drew_sdc_chip = True
            # a corruption-flavored draw sometimes buys the audit
            # lane too, so the fuzzer exercises both detection
            # (audits on) and tolerated escape (audits off) under
            # the no-corruption-escapes invariant
            if drew_sdc_chip and sdc_rng.random() < 0.5:
                topo = dataclasses.replace(
                    topo,
                    audit_frac=round(sdc_rng.uniform(0.2, 0.6), 3))
    # window order is part of the drawn identity; sort for a stable
    # spec no matter the draw order
    faults.sort(key=lambda f: (f.start_frac, f.kind, f.target))

    return ScenarioSpec(
        name=f"fuzz-{seed}-{index}",
        description="fuzzer-composed scenario",
        kind="spec",
        seed=rng.randint(0, 10**6),
        topology=topo,
        workload=workload,
        faults=tuple(faults),
        training_gangs=training_gangs,
        overload=overload)


def fuzz(budget: int, seed: int, max_faults: int = 4,
         inject_bug: bool = False, emit_specs: bool = False,
         timer=None) -> Dict[str, object]:
    """Run the fuzz campaign: ``budget`` drawn scenarios, each
    checked against the universal invariant set (plus the planted
    ``fuzz-selftest-bug`` when ``inject_bug`` — the self-test that
    proves the find-and-shrink loop works). Violations are shrunk
    to minimal repro specs in ``report["shrunk"]``."""
    names = tuple(invariants.UNIVERSAL)
    if inject_bug:
        names = names + ("fuzz-selftest-bug",)
    runs: List[dict] = []
    shrunk: List[dict] = []
    t0 = timer() if timer is not None else 0.0
    check_s = 0.0
    for index in range(budget):
        spec = draw_spec(seed, index, max_faults=max_faults)
        problems = spec_problems(spec)
        if problems:   # unreachable by construction; belt-and-braces
            runs.append({"index": index, "name": spec.name,
                         "ok": False, "violations": [],
                         "invalid": problems})
            continue
        report = run_spec(spec)
        c0 = timer() if timer is not None else 0.0
        violations = invariants.check(
            spec, report,
            rerun=lambda ec, s=spec: run_spec(s, event_core=ec),
            names=names)
        if timer is not None:
            check_s += timer() - c0
        entry = {
            "index": index,
            "name": spec.name,
            "topology": spec.topology.kind,
            "fault_kinds": list(spec.all_fault_kinds()),
            "ok": not violations,
            "violations": violations,
        }
        if emit_specs or violations:
            entry["spec"] = spec.as_dict()
        runs.append(entry)
        if violations:
            shrunk.append(shrink.shrink(
                spec, tuple(v["invariant"] for v in violations)))
    n_violating = sum(1 for r in runs if not r["ok"])
    found_planted = any(
        v["invariant"] == "fuzz-selftest-bug"
        for r in runs for v in r["violations"])
    other = sum(1 for r in runs for v in r["violations"]
                if v["invariant"] != "fuzz-selftest-bug")
    report: Dict[str, object] = {
        "budget": budget,
        "seed": seed,
        "max_faults": max_faults,
        "inject_bug": inject_bug,
        "runs": runs,
        "violating_runs": n_violating,
        "shrunk": shrunk,
        # plain campaign: green means nothing violated. self-test
        # campaign: green means the planted bug WAS found (and
        # nothing real was): the fuzzer proves it can find and
        # shrink before CI trusts its silence
        "ok": ((other == 0 and found_planted) if inject_bug
               else n_violating == 0),
    }
    if inject_bug:
        report["selftest_found"] = found_planted
    if timer is not None:
        elapsed = max(1e-9, timer() - t0)
        report["timings"] = {
            "elapsed_s": round(elapsed, 3),
            "invariant_s": round(check_s, 3),
            "invariant_frac": round(check_s / elapsed, 4),
            "runs_per_s": round(budget / elapsed, 3),
        }
    return report
