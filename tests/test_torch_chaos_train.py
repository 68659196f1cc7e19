"""PyTorch port parity: the ``preempt-train`` chaos scenario.

A SIGTERM arrives mid-step (the port's ``checkpoint.preemption_guard``
turns it into a flag), a checkpoint is written at that step, and the
resumed loss trajectory must equal the uninterrupted one exactly
(``drift == 0.0``). The port's scenario runs on the CPU against the
reference scenario of the same seed: the plan, the step it was
preempted at, the drift, the verdict and the recovery events must be
equal (the losses themselves come from other weights). The scenario's
``cfg`` keyword (what ``chip_smoke.py`` uses for the flagship) is held
to the same bar on a flash GQA config.
"""

import json

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import metrics as pmetrics
from kind_tpu_sim_torch.models import transformer as ptf
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

KEYS = ("plan", "preempted_at_step", "resume_max_loss_drift", "ok",
        "scenario", "seed", "recovery_events")


@pytest.mark.parametrize("seed", [0])
def test_preempt_train_matches_the_reference(seed):
    want = jchaos.run_scenario("preempt-train", seed=seed)
    got = pchaos.run_scenario("preempt-train", seed=seed, device="cpu")
    for key in KEYS:
        assert got[key] == want[key], key
    assert got["ok"] and got["resume_max_loss_drift"] == 0.0
    assert got["recovery_events"] == {"preemption_checkpoint": 1}


def test_preempt_train_on_another_config():
    cfg = ptf.ModelConfig(vocab_size=96, d_model=32, n_heads=4, n_kv_heads=2,
                          n_layers=1, d_ff=64, max_seq=24, dtype="float32",
                          flash=True)
    before = pmetrics.recovery_log().counts()
    got = pchaos.run_scenario("preempt-train", seed=2, device="cpu", cfg=cfg)
    assert got["ok"], got
    plan = jchaos.ChaosSchedule(2).plan(kinds=("preempt_sigterm",),
                                        n_faults=1, horizon=5, targets=1)
    assert got["preempted_at_step"] == plan.events[0].at + 2
    assert pmetrics.recovery_log().snapshot_since(before) == {
        "preemption_checkpoint": 1}


def test_chaos_command_runs_preempt_train(capsys):
    want = jchaos.ChaosSchedule(5).plan(kinds=("preempt_sigterm",),
                                        n_faults=1, horizon=5, targets=1)
    assert pcli.main(["chaos", "run", "--scenario", "preempt-train",
                      "--seed", "5", "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["ok"] and got["plan"] == want.as_dict()
    assert got["preempted_at_step"] == want.events[0].at + 2
    assert pcli.main(["chaos", "run", "--scenario", "preempt-train",
                      "--seed", "5", "--device", "cpu"]) == 0
    assert "CHAOS RUN OK" in capsys.readouterr().out
