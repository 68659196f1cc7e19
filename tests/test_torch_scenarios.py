"""PyTorch port parity: the scenario compiler, the registry, the invariant
catalog, the shrinker and the seeded fuzzer.

The port's ``scenarios/`` against the JAX package's, on the CPU host,
both sides on the H100's calibration and generation registry
(``torch_parity.h100_registry``: the reference's spec compiler cycles
the port's one generation, as the port's does):

* the registry covers every ported scenario; its listing is the
  reference's without the three rows of the cluster layer (``flaky-exec``,
  ``device-flap``, ``node-flap``: ROADMAP Queue A item 7);
* ``draw_spec`` equals the reference's for seeds 0-5, indices 0-63 and
  ``max_faults`` 2 and 4, and every draw is valid;
* spec runs, their JSON round trip and the universal invariants equal
  the reference's; so do the invariant checks on canned reports;
* the campaigns ``fuzz(12, 0)`` and ``fuzz(25, 1)`` and the self-test are
  byte-equal to the reference's; seed 1 finds the two ``recovery``
  violations of the H100's numbers, shrunk as the reference shrinks them;
* the shrinker's minimality and the pinned repro under ``tests/repros/``
  reproduce through the port's ``run_spec``;
* ``chaos fuzz``, ``chaos run --list`` print what the reference's print,
  and ``chaos soak`` is refused.
"""

import dataclasses
import json
import pathlib
import random

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim import cli as jcli
from kind_tpu_sim.analysis import knobs as jknobs
from kind_tpu_sim.scenarios import fuzz as jfuzz
from kind_tpu_sim.scenarios import invariants as jinv
from kind_tpu_sim.scenarios import registry as jreg
from kind_tpu_sim.scenarios import shrink as jshrink
from kind_tpu_sim.scenarios import spec as jspec
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch.analysis import knobs as pknobs
from kind_tpu_sim_torch.scenarios import fuzz as pfuzz
from kind_tpu_sim_torch.scenarios import invariants as pinv
from kind_tpu_sim_torch.scenarios import registry as preg
from kind_tpu_sim_torch.scenarios import shrink as pshrink
from kind_tpu_sim_torch.scenarios import spec as pspec
from torch_parity import (  # noqa: F401
    h100_registry,
    shared_registry,
    torch_one_thread,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread", "h100_registry")

REPROS = pathlib.Path(__file__).parent / "repros"
SPECS = {"port": pspec, "reference": jspec}


def _dumps(obj):
    return json.dumps(obj, sort_keys=True, default=str)


# -- the registry --------------------------------------------------------


def test_registry_covers_every_scenario():
    assert preg.registry_problems() == []
    assert sorted(preg.specs()) == sorted(pchaos.SCENARIOS)
    assert sorted(preg.specs()) == sorted(jreg.specs())


def test_listing_equals_the_reference():
    """Row for row the reference's, the cluster layer's three rows
    included; ``needs_jax`` is the port's ``Scenario.device``, and
    zoo-swap-storm describes the port's generations."""
    want = [dict(r, description=pchaos.SCENARIOS[r["name"]].description)
            for r in jreg.listing()]
    rows = preg.listing()
    assert rows == want
    assert [r["name"] for r in rows if r["description"] != next(
        j["description"] for j in jreg.listing()
        if j["name"] == r["name"])] == ["zoo-swap-storm"]
    assert [r["name"] for r in rows if r["needs_jax"]] == sorted(
        n for n, s in pchaos.SCENARIOS.items() if s.device)
    assert json.loads(json.dumps(rows, sort_keys=True)) == rows


def test_soak_pool_and_replayable_names_derive_from_registry():
    assert preg.soak_names() == sorted(
        n for n, s in pchaos.SCENARIOS.items() if not s.slow)
    assert preg.soak_names(include_slow=True) == sorted(pchaos.SCENARIOS)
    assert preg.replayable_names() == jreg.replayable_names()
    assert preg.soak_names() == jreg.soak_names()


def test_legacy_executors_are_the_original_functions():
    for name in preg.names():
        assert preg.executor(name) is pchaos.SCENARIOS[name].fn
    with pytest.raises(ValueError, match="unknown scenario"):
        preg.get("no-such-scenario")


def test_declared_invariants_hold_on_a_scenario_report():
    report = pchaos.run_scenario("globe-dcn-degrade", seed=0)
    assert preg.evaluate("globe-dcn-degrade", report) == jreg.evaluate(
        "globe-dcn-degrade", report) == []


# -- fault schemas and draws --------------------------------------------


def test_fault_schemas_and_params_equal_the_reference():
    assert pchaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert {k: dataclasses.asdict(s) for k, s in pchaos.FAULT_SCHEMAS.items()
            } == {k: dataclasses.asdict(s)
                  for k, s in jchaos.FAULT_SCHEMAS.items()}
    ours, theirs = random.Random(0), random.Random(0)
    for kind in sorted(pchaos.FAULT_SCHEMAS):
        for _ in range(8):
            assert (pchaos.draw_param(kind, ours)
                    == jchaos.draw_param(kind, theirs))


@pytest.mark.parametrize("max_faults", [2, 4])
@pytest.mark.parametrize("seed", range(6))
def test_draws_equal_the_reference(seed, max_faults):
    for index in range(64):
        spec = pfuzz.draw_spec(seed, index, max_faults)
        assert spec.as_dict() == jfuzz.draw_spec(
            seed, index, max_faults).as_dict()
        assert pspec.spec_problems(spec) == [] and spec.faults


def test_the_spec_generations_are_the_registry_s():
    assert pspec._SPEC_GENERATIONS == ("h100",)


# -- specs ---------------------------------------------------------------


def _small_spec(specmod, **kw):
    base = dict(
        name="t-spec",
        topology=specmod.TopologySpec(kind="fleet", replicas=2, sched=True),
        workload=specmod.WorkloadDims(rps=30.0, n_requests=40),
        faults=(specmod.FaultWindow("replica_preempt", 0.2, 0.4, target=1),
                specmod.FaultWindow("slow_replica", 0.3, 0.5, target=0,
                                    param=3.0)),
        overload=True, seed=3)
    base.update(kw)
    return specmod.ScenarioSpec(**base)


BAD_SPECS = {
    "sched fault on a plain fleet": dict(
        topology=dict(kind="fleet", sched=False),
        faults=[("node_drain", 0.2, 0.4)]),
    "two exclusive kinds": dict(
        topology=dict(kind="globe", zones=3),
        faults=[("zone_loss", 0.2, 0.4), ("herd_failover", 0.3, 0.5)]),
    "zone fault on one zone": dict(
        topology=dict(kind="globe", zones=1),
        faults=[("generation_cell_drain", 0.2, 0.4)]),
    "tenancy on a globe, disagg with sched": dict(
        topology=dict(kind="globe", tenancy=True, disagg=True, sched=True,
                      audit_frac=1.5),
        faults=[]),
    "training on a plain fleet": dict(
        topology=dict(kind="fleet"), training_gangs=1,
        faults=[("train_kill", 0.2, 0.3)]),
}


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_spec_problems_equal_the_reference(name):
    def build(specmod):
        d = BAD_SPECS[name]
        return specmod.ScenarioSpec(
            name=name, topology=specmod.TopologySpec(**d["topology"]),
            faults=tuple(specmod.FaultWindow(*f) for f in d["faults"]),
            training_gangs=d.get("training_gangs", 0))

    problems = pspec.spec_problems(build(pspec))
    assert problems and problems == jspec.spec_problems(build(jspec))


def test_spec_constructors_refuse_as_the_reference():
    with pytest.raises(ValueError, match="unknown fault kind"):
        pspec.FaultWindow("not-a-kind", 0.1, 0.2)
    with pytest.raises(ValueError, match="must satisfy"):
        pspec.FaultWindow("node_drain", 0.4, 0.2)
    with pytest.raises(ValueError, match="legacy scenario"):
        pspec.run_spec(preg.get("retry-storm"))
    with pytest.raises(ValueError, match="unknown invariant"):
        pinv.check(_small_spec(pspec), {}, names=("nope",))


SPEC_CASES = {
    "composed fleet": {},
    "globe with zone faults": dict(
        topology=dict(kind="globe", replicas=2, zones=3, cells_per_zone=2),
        faults=[("zone_loss", 0.2, 0.4, 1), ("dcn_degrade", 0.3, 0.5, 0, 0.3),
                ("cell_drain", 0.25, 0.45, 2)]),
    "zoo globe, generation_cell_drain": dict(
        topology=dict(kind="globe", replicas=2, zones=2, cells_per_zone=2,
                      zoo=True),
        faults=[("generation_cell_drain", 0.2, 0.5, 0)]),
    "disaggregated tenants": dict(
        topology=dict(kind="fleet", replicas=3, disagg=True, tenancy=True),
        faults=[("kv_transfer_degrade", 0.2, 0.35, 0, 0.3),
                ("noisy_neighbor", 0.3, 0.5, 0, 3.0)]),
    "training and sdc on a rack": dict(
        topology=dict(kind="fleet", replicas=2, sched=True),
        training_gangs=1,
        faults=[("train_preempt", 0.2, 0.3),
                ("correlated_domain_fault", 0.3, 0.45, 1),
                ("sdc_chip", 0.25, 0.3, 0, 0.4)]),
}


def _case_spec(specmod, name):
    d = SPEC_CASES[name]
    kw = {}
    if "topology" in d:
        kw["topology"] = specmod.TopologySpec(**d["topology"])
        kw["faults"] = tuple(specmod.FaultWindow(*f) for f in d["faults"])
        kw["training_gangs"] = d.get("training_gangs", 0)
        kw["overload"] = False
    return _small_spec(specmod, **kw)


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_spec_runs_equal_the_reference(name):
    """The compiled run, its JSON round trip and the universal invariants
    (replay and event core included) equal the reference's."""
    spec = _case_spec(pspec, name)
    assert spec.as_dict() == _case_spec(jspec, name).as_dict()
    clone = pspec.ScenarioSpec.from_dict(
        json.loads(json.dumps(spec.as_dict(), sort_keys=True)))
    assert clone == spec
    report = pspec.run_spec(spec)
    assert _dumps(report) == _dumps(pspec.run_spec(clone))
    jspec_ = jspec.ScenarioSpec.from_dict(spec.as_dict())
    want = jspec.run_spec(jspec_)
    assert _dumps(report) == _dumps(want)
    got = pinv.check(spec, report,
                     rerun=lambda ec: pspec.run_spec(spec, event_core=ec))
    assert got == jinv.check(
        jspec_, want, rerun=lambda ec: jspec.run_spec(jspec_, event_core=ec))


# -- the invariant catalog ----------------------------------------------

CANNED = {
    "duplicates": {"ok": True, "requests": 2, "completions": [
        {"request_id": "a"}, {"request_id": "a"}]},
    "lost work": {"ok": True, "requests": 3, "completions": [
        {"request_id": "a"}, {"request_id": "b"}]},
    "retried": {"ok": True, "requests": 2, "completions": [
        {"request_id": "a"}, {"request_id": "a~r1"}, {"request_id": "b"}]},
    "verdict": {"ok": False},
    "stuck controls": {"ok": True, "overload": {
        "brownout": {"enabled": True, "level": 2},
        "breakers": {"replica-0": {"state": "open"}}}},
    "lossy ledger": {"ok": True, "training": {
        "ledger_ok": True, "lost_steps": 3}},
    "overspent bucket": {"ok": True, "overload": {
        "config": {"retry_budget_burst": 2, "hedge_budget_burst": 1},
        "retry_budget": {"zone-a": {"ratio": 0.1, "earned": 10,
                                    "spent": 5, "suppressed": 0}},
        "counters": {"retries_scheduled": 5}}},
    "escaped corruption": {"ok": True, "requests": 1, "integrity": {
        "detections": [{"replica": 0, "at_s": 1.0}]}, "completions": [
        {"request_id": "a", "corrupted": True, "replica": 0,
         "finish_s": 2.0}]},
}


@pytest.mark.parametrize("name", sorted(CANNED))
def test_invariant_checks_equal_the_reference(name):
    names = tuple(pinv.CATALOG)
    assert tuple(jinv.CATALOG) == names
    assert pinv.UNIVERSAL == jinv.UNIVERSAL
    found = []
    for kw in ({}, {"training_gangs": 1, "faults": (
            pspec.FaultWindow("train_kill", 0.2, 0.3),)}):
        spec = _small_spec(pspec, **kw)
        got = pinv.check(spec, CANNED[name], names=names)
        want = jinv.check(jspec.ScenarioSpec.from_dict(spec.as_dict()),
                          CANNED[name], names=names)
        assert got == want
        found += got
    assert found


# -- the fuzzer ----------------------------------------------------------


def test_campaign_seed_0_equals_the_reference():
    got = pfuzz.fuzz(budget=12, seed=0)
    assert got["ok"] and got["violating_runs"] == 0
    assert _dumps(got) == _dumps(jfuzz.fuzz(budget=12, seed=0))
    assert _dumps(got) == _dumps(pfuzz.fuzz(budget=12, seed=0))


def test_campaign_seed_1_finds_the_h100_s_recovery_violations():
    """The H100's pricing, not a port fault: the same two violations and
    the same shrunk repros as the reference's on the same registry."""
    got = pfuzz.fuzz(budget=25, seed=1)
    assert _dumps(got) == _dumps(jfuzz.fuzz(budget=25, seed=1))
    assert not got["ok"] and got["violating_runs"] == 2
    bad = {r["name"]: [v["invariant"] for v in r["violations"]]
           for r in got["runs"] if not r["ok"]}
    assert bad == {"fuzz-1-18": ["recovery"], "fuzz-1-19": ["recovery"]}
    shrunk = {r["source"]: r for r in got["shrunk"]}
    assert [f["kind"] for f in shrunk["fuzz-1-18"]["spec"]["faults"]] == [
        "generation_cell_drain"]
    assert shrunk["fuzz-1-19"]["spec"]["faults"] == []
    assert all(r["violated"] == ["recovery"] for r in got["shrunk"])


def test_the_self_test_finds_and_shrinks_as_the_reference():
    got = pfuzz.fuzz(budget=1, seed=0, inject_bug=True)
    assert _dumps(got) == _dumps(jfuzz.fuzz(budget=1, seed=0,
                                            inject_bug=True))
    assert got["selftest_found"] and got["ok"] and len(got["shrunk"]) == 1
    repro = got["shrunk"][0]
    assert repro["violated"] == ["fuzz-selftest-bug"]
    assert sorted(f["kind"] for f in repro["spec"]["faults"]) == [
        "replica_preempt", "slow_replica"]
    # 1-minimal: dropping either fault loses the violation
    spec = pspec.ScenarioSpec.from_dict(repro["spec"])
    names = ("fuzz-selftest-bug",)
    assert pinv.check(spec, {}, names=names)
    for i in range(len(spec.faults)):
        less = dataclasses.replace(
            spec, faults=spec.faults[:i] + spec.faults[i + 1:])
        assert pinv.check(less, {}, names=names) == []


@pytest.mark.parametrize("flavor", ["planted", "sdc-planted"])
def test_the_shrinker_equals_the_reference(flavor):
    def build(specmod):
        if flavor == "planted":
            return _small_spec(specmod, name=flavor)
        fw = specmod.FaultWindow
        return _small_spec(specmod, name=flavor, faults=(
            fw("node_drain", 0.2, 0.35, target=0),
            fw("sdc_chip", 0.3, 0.45, target=0, param=0.4),
            fw("replica_preempt", 0.5, 0.6, target=1),
            fw("slow_replica", 0.62, 0.7, target=0, param=3.0)))

    got = pshrink.shrink(build(pspec), ("fuzz-selftest-bug",))
    assert _dumps(got) == _dumps(jshrink.shrink(build(jspec),
                                                ("fuzz-selftest-bug",)))
    assert got["violated"] == ["fuzz-selftest-bug"]
    assert sorted(f["kind"] for f in got["spec"]["faults"]) == sorted(
        ["replica_preempt", "slow_replica" if flavor == "planted"
         else "sdc_chip"])


def test_the_pinned_repro_reproduces_through_the_port():
    paths = sorted(REPROS.glob("*.json"))
    assert paths
    for path in paths:
        repro = json.loads(path.read_text(encoding="utf-8"))
        spec = pspec.ScenarioSpec.from_dict(repro["spec"])
        assert spec == pspec.ScenarioSpec.from_dict(spec.as_dict())
        assert pspec.spec_problems(spec) == []
        report = pspec.run_spec(spec)
        assert pinv.check(
            spec, report,
            rerun=lambda ec, s=spec: pspec.run_spec(s, event_core=ec)) == []
        still = pinv.check(spec, report, names=tuple(repro["violated"]))
        assert [v["invariant"] for v in still] == repro["violated"]


def test_fuzz_knobs_are_the_reference_s(monkeypatch):
    for name in ("KIND_TPU_SIM_FUZZ_BUDGET", "KIND_TPU_SIM_FUZZ_SEED",
                 "KIND_TPU_SIM_FUZZ_MAX_FAULTS"):
        ref = jknobs.REGISTRY[name]
        assert pknobs.KNOBS[name] == (ref.default, ref.kind)
        assert ref.layer == "fuzz"
    monkeypatch.setenv("KIND_TPU_SIM_FUZZ_MAX_FAULTS", "3")
    assert pknobs.get(pknobs.FUZZ_MAX_FAULTS) == 3
    assert pknobs.get(pknobs.FUZZ_BUDGET) == 25


# -- the command ---------------------------------------------------------


def _both(argv, capsys):
    rc = pcli.main(list(argv))
    ours = capsys.readouterr()
    want_rc = jcli.main(list(argv))
    theirs = capsys.readouterr()
    assert (rc, ours.out) == (want_rc, theirs.out)
    return rc, ours


@pytest.mark.parametrize("argv", [
    ("chaos", "fuzz", "--budget", "3", "--json"),
    ("chaos", "fuzz", "--budget", "4", "--seed", "2", "--max-faults", "2"),
    ("chaos", "fuzz", "--budget", "1", "--inject-invariant-bug"),
], ids=["json", "text", "self-test"])
def test_the_fuzz_command_prints_what_the_reference_prints(argv, capsys):
    rc, out = _both(argv, capsys)
    assert rc == 0 and out.out.strip()


def test_the_fuzz_command_reads_its_knobs_and_pins_repros(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("KIND_TPU_SIM_FUZZ_BUDGET", "1")
    monkeypatch.setenv("KIND_TPU_SIM_FUZZ_SEED", "0")
    outs = {}
    for name, cli in (("ours", pcli), ("theirs", jcli)):
        assert cli.main(["chaos", "fuzz", "--inject-invariant-bug", "--json",
                         "--emit-repros", str(tmp_path / name)]) == 0
        outs[name] = capsys.readouterr()
    assert outs["ours"].out == outs["theirs"].out
    assert json.loads(outs["ours"].out)["budget"] == 1
    pinned = tmp_path / "ours" / "fuzz-0-0-min.json"
    assert outs["ours"].err == f"pinned repro: {pinned}\n"
    assert pinned.read_bytes() == (
        tmp_path / "theirs" / "fuzz-0-0-min.json").read_bytes()
    spec = json.loads(pinned.read_text())["spec"]
    assert sorted(f["kind"] for f in spec["faults"]) == [
        "replica_preempt", "slow_replica"]


def test_the_list_and_soak_commands(capsys):
    assert pcli.main(["chaos", "run", "--list", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows == preg.listing()
    assert pcli.main(["chaos", "run", "--list"]) == 0
    text = capsys.readouterr().out.splitlines()
    assert len(text) == len(rows)
    tagged = {line.split()[0]: line for line in text}
    assert tagged["preempt-train"].endswith(" [slow] [device]")
    assert tagged["globe-zone-loss"].endswith(" [replay]")
    assert pcli.main(["chaos", "run"]) == 0
    assert "available scenarios" in capsys.readouterr().out
    # soak seed 5 draws flaky-exec, train-mixed-soak, correlated-rack-loss
    argv = ["chaos", "soak", "--iterations", "3", "--seed", "5"]
    assert pcli.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert ours == capsys.readouterr().out
    assert ours.splitlines()[0].split()[0] == "flaky-exec"
    assert ours.endswith("CHAOS SOAK (3 runs, seed 5) OK\n")
