"""PyTorch port parity: the cluster layer's chaos (``chaos.py``'s
``FlakyExecutor``, ``ChaosManager``, the scenarios ``flaky-exec``,
``device-flap`` and ``node-flap``, and ``soak``).

The three scenarios run over the fake runtime's recorded command stream
(no cluster, no daemon). Their reports and recovery-log deltas must
equal the reference's at seeds 0-2, the manual levers must record the
reference's commands, ``chaos soak`` must draw the reference's
(scenario, seed) stream, and the registry's rows and replay targets
must be the reference's whole lists. Nothing here touches a device.
"""

import json

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim import cli as jcli
from kind_tpu_sim.analysis import replaycheck as jrc
from kind_tpu_sim.scenarios import registry as jreg
from kind_tpu_sim.utils import shell as jshell
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch.analysis import replaycheck as prc
from kind_tpu_sim_torch.scenarios import registry as preg
from kind_tpu_sim_torch.utils import shell as pshell
from torch_parity import (  # noqa: F401
    h100_registry,
    torch_one_thread,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread", "h100_registry")

CLUSTER_SCENARIOS = ("flaky-exec", "device-flap", "node-flap")


@pytest.fixture(autouse=True)
def no_chaos_seed(monkeypatch):
    monkeypatch.delenv("KIND_TPU_SIM_CHAOS_SEED", raising=False)


def _dumps(obj):
    return json.dumps(obj, sort_keys=True)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", CLUSTER_SCENARIOS)
def test_scenario_report_equals_the_reference(name, seed):
    got = pchaos.run_scenario(name, seed=seed)
    want = jchaos.run_scenario(name, seed=seed)
    assert _dumps(got) == _dumps(want)
    assert got["ok"] and got["recovery_events"]
    assert not pchaos.SCENARIOS[name].device
    assert not pchaos.SCENARIOS[name].slow


@pytest.mark.parametrize("num_slices", [1, 2])
def test_the_levers_record_the_reference_s_commands(num_slices):
    streams = {}
    for side, chaos in (("port", pchaos), ("reference", jchaos)):
        mgr = chaos._fake_chaos_manager(num_slices=num_slices)
        last = mgr.resolve_node(None, mgr.cluster.cfg.workers - 1)
        mgr.fail_devices(last, [])
        mgr.fail_devices(mgr.resolve_node("kind-tpu-sim-worker", None),
                         ["tpu-0-1", "tpu-0-2"])
        mgr.heal(last)
        mgr.kill_node(last)
        mgr.start_node(last)
        for bad in ((None, None), (None, 99)):
            with pytest.raises(ValueError) as err:
                mgr.resolve_node(*bad)
            streams.setdefault(side + "-errors", []).append(str(err.value))
        streams[side] = mgr.rt.executor.calls
    assert streams["port"] == streams["reference"]
    assert streams["port-errors"] == streams["reference-errors"]
    writes = [stdin for argv, stdin in streams["port"] if stdin]
    assert writes[0].count("\n") == 8 and writes[1] == "tpu-0-1\ntpu-0-2\n"


def test_the_flaky_executor_fails_then_recovers():
    runs = {}
    for side, (chaos, shell) in (("port", (pchaos, pshell)),
                                 ("reference", (jchaos, jshell))):
        fake = chaos.FlakyExecutor(fail_attempts=2)
        first = fake.run(["kubectl", "get", "nodes"], check=False)
        with pytest.raises(shell.CommandError) as err:
            fake.run(["kubectl", "get", "nodes"])
        third = fake.run(["kubectl", "get", "nodes"])
        other = fake.run(["docker", "ps"])
        runs[side] = (first.returncode, first.stderr, str(err.value),
                      third.ok, other.ok, fake.injected_failures,
                      fake.commands())
    assert runs["port"] == runs["reference"]
    assert runs["port"][3:6] == (True, True, 2)


def _stub_soak(chaos, monkeypatch, seed, include_slow):
    picks = []

    def run_scenario(name, seed=None, **_):
        picks.append((name, seed))
        return {"ok": not name.startswith("zoo")}

    monkeypatch.setattr(chaos, "run_scenario", run_scenario)
    report = chaos.soak(iterations=12, seed=seed, include_slow=include_slow)
    return report, picks


@pytest.mark.parametrize("include_slow", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_soak_draws_the_reference_s_stream(seed, include_slow, monkeypatch):
    """The (scenario, seed) stream of a soak, each run stubbed: the pick
    pool is the registry's, the same on both sides."""
    got = _stub_soak(pchaos, monkeypatch, seed, include_slow)
    want = _stub_soak(jchaos, monkeypatch, seed, include_slow)
    assert got[1] == want[1]
    assert [(r["scenario"], r["seed"], r["ok"]) for r in got[0]["runs"]] \
        == [(r["scenario"], r["seed"], r["ok"]) for r in want[0]["runs"]]
    assert (got[0]["failures"], got[0]["ok"]) == (
        want[0]["failures"], want[0]["ok"])
    assert {n for n, _ in got[1]} <= set(
        preg.soak_names(include_slow=include_slow))


def test_a_short_soak_command_matches_the_reference(capsys):
    """Soak seed 2 draws train-preempt-economics and sdc-training-bisect:
    two analytic runs on the port's scenarios and the reference's."""
    argv = ["chaos", "soak", "--iterations", "2", "--seed", "2", "--json"]
    assert pcli.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out)
    got = json.loads(ours)
    assert got["runs"] == theirs["runs"]
    assert [r["scenario"] for r in got["runs"]] == [
        "train-preempt-economics", "sdc-training-bisect"]
    assert got["ok"] and got["failures"] == 0


@pytest.mark.parametrize("name", CLUSTER_SCENARIOS)
def test_chaos_run_command_matches_the_reference(name, capsys):
    argv = ["chaos", "run", "--scenario", name, "--seed", "1"]
    assert pcli.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert ours == capsys.readouterr().out
    assert ours.endswith("CHAOS RUN OK\n")


def test_the_registry_and_replay_targets_are_the_reference_s_whole():
    assert preg.registry_problems() == []
    assert preg._LEGACY == jreg._LEGACY
    assert list(preg._LEGACY) == list(jreg._LEGACY)
    assert preg.names() == jreg.names()
    assert preg.soak_names() == jreg.soak_names()
    assert preg.replayable_names() == jreg.replayable_names()
    rows = {r["name"]: r for r in preg.listing()}
    for ref in jreg.listing():
        if ref["name"] != "zoo-swap-storm":
            assert rows[ref["name"]] == ref
    assert prc.list_targets() == jrc.list_targets()
    for name in CLUSTER_SCENARIOS:
        assert rows[name]["replayable"] and not rows[name]["needs_jax"]


@pytest.mark.parametrize("name", CLUSTER_SCENARIOS)
def test_replay_of_a_cluster_scenario_matches_the_reference(name):
    got = prc.replay(name, seed=2)
    assert got == jrc.replay(name, seed=2)
    assert got["ok"]
