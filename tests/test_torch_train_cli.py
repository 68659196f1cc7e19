"""PyTorch port parity: the ``train`` and ``health`` commands.

``train run`` (training gangs co-scheduled under a serving fleet:
synthesized, from a kubernetes manifest, with an Ising sweep and
elastic gangs, on the plain per-tick loop) and ``train plan`` (the
checkpoint-cadence table), then ``health knobs`` and ``health demo``
(the detector's resolved knobs and its seeded straggler run), each
through ``cli.main`` against the reference's output, byte for byte, in
JSON and in text. Nothing here touches a device.
"""

import json

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import health as jhealth
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import health as phealth


def _both(argv, capsys, rc=0):
    assert jcli.main(argv) == rc
    want = capsys.readouterr().out
    assert pcli.main(argv) == rc
    got = capsys.readouterr().out
    assert got == want
    return got


@pytest.mark.parametrize("argv", [
    ["train", "run"],
    ["train", "run", "--manifest", "pods/tpu-batch-train-job.yaml"],
    ["train", "run", "--ising", "1", "--elastic"],
    ["train", "run", "--no-event-core", "--gangs", "2", "--steps", "40"],
    ["train", "run", "--cadence", "5", "--mtbf-s", "30", "--seed", "4"],
    ["train", "run", "--manifest", "pods/tpu-serving-multizone.yaml",
     "--replicas", "1", "--serving-rps", "20", "--requests", "60"],
    ["train", "plan"],
    ["train", "plan", "--mtbf-s", "30", "--step-s", "0.02", "--steps",
     "50"],
], ids=["run", "manifest", "ising elastic", "no event core", "cadence",
        "multizone manifest", "plan", "plan options"])
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_the_train_command_matches_the_reference(argv, as_json, capsys):
    got = _both(argv + (["--json"] if as_json else []), capsys)
    if as_json:
        report = json.loads(got)
        if argv[1] == "run":
            assert report["ok"] and report["training"]["ledger_ok"]
        else:
            assert str(report["optimal_cadence_steps"]) in report[
                "cadences"]
    elif argv[1] == "run":
        assert got.rstrip().endswith("TRAIN RUN OK")


def test_the_train_plan_under_its_knobs(monkeypatch, capsys):
    monkeypatch.setenv("KIND_TPU_SIM_TRAIN_CKPT_WRITE_S", "0.2")
    monkeypatch.setenv("KIND_TPU_SIM_TRAIN_MTBF_S", "12.5")
    _both(["train", "plan", "--json"], capsys)


def test_train_run_writes_its_report(tmp_path, capsys):
    out = tmp_path / "train.json"
    _both(["train", "run", "--out", str(out)], capsys)
    assert json.loads(out.read_text())["training"]["all_done"]


def test_a_manifest_without_tpu_workloads_is_refused(capsys):
    argv = ["train", "run", "--manifest", "pods/vllm-cpu-pod.yaml"]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        pcli.main(argv)
    assert str(got.value) == str(want.value)
    assert "no TPU training workloads found" in str(got.value)


@pytest.mark.parametrize("argv", [
    ["health", "knobs"],
    ["health", "demo"],
    ["health", "demo", "--seed", "4", "--components", "6", "--samples",
     "200"],
], ids=["knobs", "demo", "demo options"])
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_the_health_command_matches_the_reference(argv, as_json, capsys):
    got = _both(argv + (["--json"] if as_json else []), capsys)
    if argv[1] == "demo" and not as_json:
        assert got.rstrip().endswith("HEALTH DEMO OK")


def test_the_health_command_reads_the_knobs(monkeypatch, capsys):
    monkeypatch.setenv("KIND_TPU_SIM_HEALTH_QUARANTINE_EVALS", "1")
    monkeypatch.setenv("KIND_TPU_SIM_HEALTH_PROBE_OK", "4")
    monkeypatch.setenv("KIND_TPU_SIM_CHAOS_SEED", "3")
    knobs = json.loads(_both(["health", "knobs", "--json"], capsys))
    assert (knobs["quarantine_evals"], knobs["probe_ok_required"]) == (1, 4)
    demo = json.loads(_both(["health", "demo", "--json"], capsys))
    assert demo["seed"] == 3 and demo["config"] == knobs


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_detection_demo_matches_the_reference(seed):
    want = jhealth.detection_demo(seed=seed)
    got = phealth.detection_demo(seed=seed)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["ok"]
