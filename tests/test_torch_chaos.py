"""PyTorch port parity: seeded fault plans and the engine chaos scenarios.

The port's ``kind_tpu_sim_torch/chaos.py`` against the JAX package's
``kind_tpu_sim/chaos.py``: the fault vocabulary and schemas, the
magnitude draws and ``ChaosSchedule`` plans for several seeds, kinds and
shapes; then the two serving scenarios, ``serving-slot-failure`` and
``fleet-preemption``, run on the CPU against the reference scenario of
the same seed. The port draws its weights from ``torch.Generator`` and
the reference from ``jax.random``, so the streams differ; every field
that does not depend on the weights must be equal, and each side must
meet its own bar (``ok``). Then ``chaos run`` against the same reports.
(``preempt-train`` is in ``test_torch_chaos_train.py``.)
"""

import json
import random

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SEEDS = (0, 7)
# the fields of each scenario's result that do not depend on the weights
WEIGHT_FREE = {
    "serving-slot-failure": ("plan", "requests", "slot_failures",
                             "requeues", "streams_identical", "ok",
                             "scenario", "seed", "recovery_events"),
    "fleet-preemption": ("plan", "requests", "preempted_replica",
                         "preempt_at_s", "requeues", "streams_identical",
                         "tail_attainment_clean", "tail_attainment_faulted",
                         "ok", "scenario", "seed", "recovery_events"),
}


@pytest.fixture(scope="module")
def reference():
    """The reference scenarios' reports, by (name, seed)."""
    return {(name, seed): jchaos.run_scenario(name, seed=seed)
            for name in WEIGHT_FREE for seed in SEEDS}


def test_fault_vocabulary_matches_the_reference():
    assert pchaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert pchaos.FAULT_LAYERS == jchaos.FAULT_LAYERS
    assert list(pchaos.FAULT_SCHEMAS) == list(jchaos.FAULT_SCHEMAS)
    for kind, schema in jchaos.FAULT_SCHEMAS.items():
        assert pchaos.FAULT_SCHEMAS[kind].as_dict() == schema.as_dict()


@pytest.mark.parametrize("kind", sorted(jchaos.FAULT_KINDS))
def test_param_draws_match_the_reference(kind):
    want_rng, got_rng = random.Random(kind), random.Random(kind)
    for _ in range(5):
        assert (pchaos.draw_param(kind, got_rng)
                == jchaos.draw_param(kind, want_rng))
    assert got_rng.random() == want_rng.random()


PLANS = [
    (("worker_crash",), 1, 8, 2),
    (("preempt_sigterm",), 1, 5, 1),
    (("slot_failure",), 1, 2, 2),
    (("replica_preempt",), 1, 4, 2),
    (("slow_replica", "degraded_link", "worker_hang"), 6, 20, 5),
    (("demand_surge", "retry_storm", "sdc_chip", "replica_flap"), 9, 50, 7),
    (tuple(sorted(jchaos.FAULT_KINDS)), 12, 100, 16),
]


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", PLANS, ids=lambda s: "+".join(s[0])[:40])
def test_plans_match_the_reference(seed, shape):
    kinds, n, horizon, targets = shape
    want = jchaos.ChaosSchedule(seed).plan(kinds=kinds, n_faults=n,
                                           horizon=horizon, targets=targets)
    got = pchaos.ChaosSchedule(seed).plan(kinds=kinds, n_faults=n,
                                          horizon=horizon, targets=targets)
    assert got.as_dict() == want.as_dict()
    assert [e.as_dict() for e in got.for_kind(kinds[0])] == [
        e.as_dict() for e in want.for_kind(kinds[0])]


def test_plan_seed_and_kinds_are_checked(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_CHAOS_SEED", "42")
    assert pchaos.ChaosSchedule().seed == jchaos.ChaosSchedule().seed == 42
    with pytest.raises(ValueError, match="unknown fault kind"):
        pchaos.ChaosSchedule(0).plan(kinds=("cosmic_ray",))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(WEIGHT_FREE))
def test_scenario_matches_the_reference(reference, name, seed):
    want = reference[(name, seed)]
    got = pchaos.run_scenario(name, seed=seed, device="cpu")
    assert got["ok"] and want["ok"], (got, want)
    for key in WEIGHT_FREE[name]:
        assert got[key] == want[key], key
    assert got["streams_identical"]


def test_scenarios_run_on_the_card_unless_asked():
    # the analytic disagg-pool-loss does no device work
    for name in (n for n, s in pchaos.SCENARIOS.items() if s.device):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pchaos.run_scenario(name, seed=0)
    with pytest.raises(ValueError, match="unknown scenario"):
        pchaos.run_scenario("node-kill", seed=0, device="cpu")


def test_chaos_command_matches_the_reference(reference, capsys):
    assert pcli.main(["chaos", "run", "--scenario", "fleet-preemption",
                      "--seed", "7", "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = reference[("fleet-preemption", 7)]
    for key in WEIGHT_FREE["fleet-preemption"]:
        assert got[key] == want[key], key
    # zoo-swap-storm fails its p99 bound on the H100's calibration at
    # seed 0 (test_torch_zoo.py), so 'all' exits 1; every other scenario
    # passes
    assert pcli.main(["chaos", "run", "--scenario", "all", "--include-slow",
                      "--json", "--device", "cpu"]) == 1
    everything = json.loads(capsys.readouterr().out)
    assert not everything["ok"]
    by_name = {r["scenario"]: r for r in everything["scenarios"]}
    assert sorted(by_name) == sorted(pchaos.SCENARIOS)
    assert [n for n, r in by_name.items() if not r["ok"]] == [
        "zoo-swap-storm"]
    for name, keys in WEIGHT_FREE.items():
        for key in keys:
            assert by_name[name][key] == reference[(name, 0)][key], key
    plan = jchaos.ChaosSchedule(0).plan(kinds=("preempt_sigterm",),
                                        n_faults=1, horizon=5, targets=1)
    train = by_name["preempt-train"]
    assert train["plan"] == plan.as_dict()
    assert train["preempted_at_step"] == plan.events[0].at + 2
    assert train["resume_max_loss_drift"] == 0.0


def test_chaos_command_lists_and_refuses(capsys):
    assert pcli.main(["chaos", "run"]) == 0
    listing = capsys.readouterr().out
    for name in pchaos.SCENARIOS:
        assert name in listing
    assert pcli.main(["chaos", "run", "--list", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["name"] for r in rows] == sorted(pchaos.SCENARIOS)
    analytic = sorted([
        "correlated-rack-loss", "disagg-pool-loss", "fleet-flaky-replica",
        "gray-degraded-ici", "gray-slow-replica", "overload-surge",
        "retry-storm", "sched-node-drain", "sched-preemption-priority",
        "sdc-serving-audit", "sdc-training-bisect",
        "tenant-noisy-neighbor", "train-mixed-soak",
        "train-preempt-economics", "zoo-swap-storm"])
    assert [r["name"] for r in rows if not r["slow"]] == analytic
    # the device scenarios are slow, as in the reference: 'all' without
    # --include-slow runs the 15 analytic ones alone, and exits 1 on
    # zoo-swap-storm's verdict alone
    assert pcli.main(["chaos", "run", "--scenario", "all", "--json",
                      "--device", "cpu"]) == 1
    fast = json.loads(capsys.readouterr().out)
    assert [(r["scenario"], r["ok"]) for r in fast["scenarios"]] == [
        (name, name != "zoo-swap-storm") for name in analytic]
    with pytest.raises(SystemExit, match="kind_tpu_sim chaos run"):
        pcli.main(["chaos", "run", "--scenario", "exec-transient",
                   "--device", "cpu"])
