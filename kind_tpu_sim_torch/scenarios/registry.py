"""The scenario registry — single source of truth for every named
scenario (the port's copy of ``kind_tpu_sim/scenarios/registry.py``).

Replaces the hand-maintained scenario lists: `chaos run`'s listing,
`chaos soak`'s pick pool, and `analysis replay`'s REPLAY_TARGETS all
derive from here, so a newly added scenario cannot be silently
missing from any of them (registry_problems() is the machine check).

Every scenario in ``chaos.SCENARIOS`` is re-expressed as a
:class:`ScenarioSpec`: the ``_LEGACY`` table declares its fault
kinds, its named invariants (the bespoke assertions, as catalog
entries), and whether its report is a pure function of (config,
seed) (``replayable`` — what replaycheck targets). The original
scenario functions stay the executors, so every legacy name keeps
its byte-identical report; purely declarative specs (the fuzzer's
output, pinned repros) run through :func:`spec.run_spec`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from kind_tpu_sim_torch.scenarios.spec import ScenarioSpec, run_spec

# Declarative metadata of the hand-written scenarios in chaos.py:
# name -> (fault kinds exercised, named invariants their bespoke
# assertions map onto, replayable). device (the wire key needs_jax)
# and slow stay declared on the chaos.Scenario and are copied into the
# spec at build time — one owner per fact.
_VERDICT = ("verdict-ok",)
_FLEETV = ("verdict-ok", "no-lost-work")
_LEGACY: Dict[str, tuple] = {
    "flaky-exec": (("cmd_transient",), _VERDICT, True),
    "worker-crash-grid": (("worker_crash",), _VERDICT, False),
    "worker-hang-grid": (("worker_hang",), _VERDICT, False),
    "device-flap": (("device_flap",), _VERDICT, True),
    "node-flap": (("node_kill", "node_restart"), _VERDICT, True),
    "preempt-train": (("preempt_sigterm",), _VERDICT, False),
    "serving-slot-failure": (("slot_failure",), _VERDICT, False),
    "fleet-flaky-replica": (("replica_flap",), _FLEETV, True),
    "fleet-preemption": (("replica_preempt",), _VERDICT, False),
    "sched-node-drain": (("node_drain",), _FLEETV, True),
    "sched-preemption-priority": ((), _FLEETV, True),
    "gray-straggler-grid": (("straggler_worker",), _VERDICT, False),
    "gray-slow-replica": (("slow_replica",), _FLEETV, True),
    "gray-degraded-ici": (("degraded_link",), _FLEETV, True),
    "globe-zone-loss": (("zone_loss",), _FLEETV, True),
    "globe-herd-failover": (("herd_failover",), _FLEETV, True),
    "globe-dcn-degrade": (("dcn_degrade", "cell_drain"), _FLEETV,
                          True),
    "overload-surge": (
        ("demand_surge",),
        ("verdict-ok", "no-lost-work", "containment"), True),
    "retry-storm": (
        ("retry_storm", "replica_preempt"),
        ("verdict-ok", "no-lost-work", "containment"), True),
    "train-preempt-economics": (
        ("train_preempt", "train_kill"),
        ("verdict-ok", "ledger-clean"), True),
    "train-mixed-soak": (
        ("node_drain", "node_fail", "replica_preempt"),
        ("verdict-ok", "no-lost-work", "ledger-clean"), True),
    "train-globe-spot": (
        ("zone_loss",),
        ("verdict-ok", "no-lost-work", "ledger-clean"), True),
    "disagg-pool-loss": (
        ("prefill_pool_loss", "kv_transfer_degrade"), _FLEETV, True),
    "tenant-noisy-neighbor": (
        ("noisy_neighbor",), _FLEETV, True),
    "zoo-swap-storm": (
        ("model_swap_storm",), _FLEETV, True),
    "sdc-training-bisect": (
        ("sdc_chip",),
        ("verdict-ok", "ledger-clean", "no-corruption-escapes"),
        True),
    "sdc-serving-audit": (
        ("sdc_chip",),
        ("verdict-ok", "no-corruption-escapes"), True),
    "correlated-rack-loss": (
        ("correlated_domain_fault",), _FLEETV, True),
}

_SPECS: Optional[Dict[str, ScenarioSpec]] = None


def _build() -> Dict[str, ScenarioSpec]:
    from kind_tpu_sim_torch import chaos

    specs: Dict[str, ScenarioSpec] = {}
    for name in sorted(chaos.SCENARIOS):
        scn = chaos.SCENARIOS[name]
        kinds, invs, replayable = _LEGACY.get(
            name, ((), _VERDICT, False))
        specs[name] = ScenarioSpec(
            name=name,
            description=scn.description,
            kind="legacy",
            fault_kinds=tuple(kinds),
            invariants=tuple(invs),
            needs_jax=scn.device,
            slow=scn.slow,
            replayable=bool(replayable and not scn.slow),
        )
    return specs


def specs() -> Dict[str, ScenarioSpec]:
    """Every registered scenario, by name (cached)."""
    global _SPECS
    if _SPECS is None:
        _SPECS = _build()
    return _SPECS


def get(name: str) -> ScenarioSpec:
    table = specs()
    if name not in table:
        raise ValueError(
            f"unknown scenario {name!r}; known: "
            f"{', '.join(sorted(table))}")
    return table[name]


def names(include_slow: bool = True) -> List[str]:
    return sorted(n for n, s in specs().items()
                  if include_slow or not s.slow)


def soak_names(include_slow: bool = False) -> List[str]:
    """The `chaos soak` pick pool — sorted so the seeded iteration
    stream is a pure function of the registry contents."""
    return names(include_slow=include_slow)


def replayable_names() -> List[str]:
    """The scenario names replaycheck targets (reports that are
    pure functions of (config, seed))."""
    return sorted(n for n, s in specs().items() if s.replayable)


def executor(name: str) -> Callable[[int], dict]:
    """The callable that runs scenario ``name`` at a seed: the
    original chaos.py function for legacy entries, the spec
    compiler for declarative ones."""
    spec = get(name)
    if spec.kind == "legacy":
        from kind_tpu_sim_torch import chaos

        return chaos.SCENARIOS[name].fn
    return lambda seed: run_spec(spec, seed=seed)


def evaluate(name_or_spec, report: dict) -> List[dict]:
    """Check a scenario's declared invariants against one of its
    reports (no reruns — the rerun-needing invariants pass
    vacuously here; the fuzzer checks those live)."""
    from kind_tpu_sim_torch.scenarios import invariants

    spec = (name_or_spec if isinstance(name_or_spec, ScenarioSpec)
            else get(name_or_spec))
    return invariants.check(spec, report,
                            names=tuple(spec.invariants))


def listing() -> List[dict]:
    """The `chaos run --list` surface: every scenario's declarative
    row, sorted by name (JSON-stable)."""
    return [
        {
            "name": s.name,
            "description": s.description,
            "kind": s.kind,
            "fault_kinds": list(s.all_fault_kinds()),
            "invariants": list(s.invariants),
            "needs_jax": s.needs_jax,
            "slow": s.slow,
            "replayable": s.replayable,
        }
        for _, s in sorted(specs().items())
    ]


def registry_problems() -> List[str]:
    """Cross-checks keeping the registry honest (the reference wires
    them into `analysis lint`; here the tests): every chaos.SCENARIOS
    entry must carry declarative metadata, every metadata row must
    name a real scenario, and every declared invariant must exist in
    the catalog."""
    from kind_tpu_sim_torch import chaos
    from kind_tpu_sim_torch.scenarios import invariants

    problems: List[str] = []
    for name in sorted(chaos.SCENARIOS):
        if name not in _LEGACY:
            problems.append(
                f"scenario {name!r} has no registry metadata "
                "(kind_tpu_sim_torch/scenarios/registry.py _LEGACY)")
    for name in sorted(_LEGACY):
        if name not in chaos.SCENARIOS:
            problems.append(
                f"registry metadata names unknown scenario "
                f"{name!r}")
        kinds, invs, _ = _LEGACY[name]
        for kind in kinds:
            if kind not in chaos.FAULT_KINDS:
                problems.append(
                    f"scenario {name!r} metadata names unknown "
                    f"fault kind {kind!r}")
        for inv in invs:
            if inv not in invariants.CATALOG:
                problems.append(
                    f"scenario {name!r} declares unknown "
                    f"invariant {inv!r}")
    return problems
