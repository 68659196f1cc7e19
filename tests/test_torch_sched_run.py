"""PyTorch port parity: the scheduler's own simulation loop and the
``sched`` command.

``sched/scheduler.py``'s seeded gang workload (``generate_gangs``) and
``run_sched_sim`` against the reference's, for each placement policy at
two seeds, with and without node events (its clock adds ``cycle_s`` with
``round(now + cycle_s, 9)``, so ``virtual_s`` and every time to routable
must equal the reference's to the last digit), then ``sched run`` and
``sched trace`` through ``cli.main`` against the reference's output,
byte for byte. Nothing here touches a device.
"""

import json

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import sched as jsched
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import sched as psched

NODE_EVENTS = ((1.5, "node_drain", "tpu-node-0-1"),
               (2.0, "node_fail", "tpu-node-1-2"),
               (6.0, "node_restore", "tpu-node-0-1"),
               (9.0, "node_restore", "tpu-node-1-2"))


def _dumps(obj):
    return json.dumps(obj, sort_keys=True)


def test_the_exports_are_the_references():
    names = [n for n in dir(jsched) if not n.startswith("_")
             and n not in ("inventory", "kubeface", "scheduler")]
    assert [n for n in names if not hasattr(psched, n)] == []


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("spec", [
    {}, dict(n_gangs=40, gangs_per_s=5.0, priorities=(0, 5),
             hold_s=(1.0, 3.0))], ids=["default", "dense"])
def test_generate_gangs_matches_the_reference(seed, spec):
    want = jsched.generate_gangs(jsched.SchedWorkloadSpec(**spec), seed)
    got = psched.generate_gangs(psched.SchedWorkloadSpec(**spec), seed)
    assert [g.as_dict() for g in got] == [g.as_dict() for g in want]


@pytest.mark.parametrize("events", [(), NODE_EVENTS],
                         ids=["no events", "node events"])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("policy", ["binpack", "spread", "ici"])
def test_run_sched_sim_matches_the_reference(policy, seed, events):
    kw = dict(node_events=events)
    want = jsched.run_sched_sim(jsched.SchedSimConfig(
        sched=jsched.SchedConfig(policy=policy), **kw), seed)
    got = psched.run_sched_sim(psched.SchedSimConfig(
        sched=psched.SchedConfig(policy=policy), **kw), seed)
    assert _dumps(got) == _dumps(want)
    assert got["ok"] and got["scheduled"] == got["gangs"] == 24
    if events:
        assert got["event_counts"]["NodeDrained"] == 1
        assert got["event_counts"]["NodeFailed"] == 1


def test_run_sched_sim_without_preemption_or_defrag():
    pods = (("tpu-v5-lite-podslice", "4x8"),)
    for preemption in (True, False):
        for defrag in (True, False):
            want = jsched.run_sched_sim(jsched.SchedSimConfig(
                pods=pods, sched=jsched.SchedConfig(
                    policy="ici", preemption=preemption, defrag=defrag),
                workload=jsched.SchedWorkloadSpec(n_gangs=12)), 2)
            got = psched.run_sched_sim(psched.SchedSimConfig(
                pods=pods, sched=psched.SchedConfig(
                    policy="ici", preemption=preemption, defrag=defrag),
                workload=psched.SchedWorkloadSpec(n_gangs=12)), 2)
            assert _dumps(got) == _dumps(want)


@pytest.mark.parametrize("argv", [
    ["sched", "run", "--json"],
    ["sched", "run", "--gangs", "12"],
    ["sched", "trace"],
    ["sched", "run", "--manifest", "pods/tpu-serving-deployment.yaml",
     "--json"],
    ["sched", "run", "--manifest", "pods/tpu-batch-train-job.yaml",
     "--policy", "ici"],
    ["sched", "run", "--events", "--policy", "binpack,spread"],
    ["sched", "run", "--policy", "ici", "--gangs", "30", "--no-preemption",
     "--no-defrag", "--seed", "3", "--pods",
     "tpu-v5-lite-podslice:4x8,tpu-v4-podslice:2x2x4", "--json"],
], ids=["run json", "run text", "trace", "manifest json", "manifest text",
        "events", "options"])
def test_the_sched_command_matches_the_reference(argv, capsys):
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if argv[1] == "run" and "--json" not in argv and "--events" not in argv:
        assert got.rstrip().endswith("OK")


def test_sched_run_writes_its_report(tmp_path, capsys):
    out = tmp_path / "sched.json"
    assert pcli.main(["sched", "run", "--policy", "ici", "--gangs", "6",
                      "--out", str(out)]) == 0
    assert f"report -> {out}" in capsys.readouterr().out
    report = json.loads(out.read_text())
    assert report["ok"] and list(report["policies"]) == ["ici"]


def test_a_malformed_pods_entry_is_refused():
    with pytest.raises(ValueError, match="malformed --pods entry"):
        pcli.main(["sched", "run", "--pods", "tpu-v5-lite-podslice"])
