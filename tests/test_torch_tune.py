"""PyTorch port parity: the simulator's tuner (``kind_tpu_sim_torch/tune/``).

The port's Pareto front, knee point, design spaces, candidate renderers
and search driver are held to the reference's (``kind_tpu_sim/tune/``)
on the same inputs: seeded point sets, every space's draw stream at tune
seeds 0-2, and whole search reports, byte for byte as sorted-key JSON,
with both packages on the H100's calibration and generation registry
(``torch_parity.h100_registry``). The zoo search runs on a registry with
a test-only second generation, both packages searching the port's space
(the reference's ``zoo_space`` names TPU generations). The port's
search sharded over cold workers gives the in-process report, and the
workers load no torch. Nothing here touches a device.
"""

import dataclasses
import json
import pathlib
import random
import subprocess
import sys
import time

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim import globe as jglobe
from kind_tpu_sim import tune as jtune
from kind_tpu_sim.analysis import knobs as jknobs
from kind_tpu_sim.analysis import replaycheck as jrc
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch import globe as pglobe
from kind_tpu_sim_torch import tune as ptune
from kind_tpu_sim_torch.analysis import knobs as pknobs
from kind_tpu_sim_torch.analysis import replaycheck as prc
from kind_tpu_sim_torch.utils import worker_pool as pwp
from torch_parity import (  # noqa: F401
    h100_registry,
    shared_registry,
    torch_one_thread,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread", "h100_registry")

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
# a test-only second generation: half the H100's compute and bandwidth
# at half its chip-second price
HALF = {"half": {"compute_ratio": 0.5, "bandwidth_ratio": 0.5,
                 "hbm_gib": 16.0, "chip_second_cost": 0.5}}
PKGS = {"port": (ptune, pfleet, pglobe), "reference": (jtune, jfleet, jglobe)}


def _dumps(obj):
    return json.dumps(obj, sort_keys=True)


def _points(seed, n=24):
    """Seeded objective triples: coarse values so ties and duplicates
    occur, and a missing coordinate now and then."""
    rng = random.Random(seed)
    pts = []
    for i in range(n):
        p = {"index": i,
             "cost_chip_s": float(rng.randint(1, 6)),
             "goodput_tok_s": float(rng.randint(1, 6)) * 100.0,
             "attainment": rng.choice([0.5, 0.75, 1.0])}
        if rng.random() < 0.1:
            p["attainment"] = None
        pts.append(p)
    return pts


# -- the Pareto front and the knee ---------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_pareto_front_and_knee_match_the_reference(seed):
    pts = _points(seed)
    front = ptune.pareto_front(pts)
    assert front == jtune.pareto_front(pts)
    assert ptune.knee_point(front) == jtune.knee_point(front)
    assert all(not any(ptune.dominates(q, p) for q in pts) for p in front)
    assert [ptune.dominates(a, b) for a in pts[:6] for b in pts[:6]] == [
        jtune.dominates(a, b) for a in pts[:6] for b in pts[:6]]


def test_knee_of_nothing_and_of_one_point():
    assert ptune.knee_point([]) is None
    one = [{"index": 3, "cost_chip_s": 1.0, "goodput_tok_s": 2.0,
            "attainment": 1.0}]
    assert ptune.knee_point(one) == jtune.knee_point(one) == one[0]


@pytest.mark.parametrize("seed", range(3))
def test_survivors_match_and_keep_every_dominator(seed):
    """The screen rung's survivors equal the reference's, and halving
    never drops a candidate that dominates a survivor."""
    rng = random.Random(100 + seed)
    screen = [dict(p, e2e_p50_s=round(rng.uniform(0.05, 0.5), 3))
              for p in _points(seed, n=16)]
    kept = ptune.survivors_of(screen)
    assert kept == jtune.survivors_of(screen)
    rows = {m["index"]: m for m in screen}
    for m in screen:
        if m["index"] not in kept:
            assert not any(ptune.dominates(m, rows[s]) for s in kept)


# -- the spaces ------------------------------------------------------------


def _spaces(pkg):
    tune = pkg[0]
    return {
        "fleet": tune.default_fleet_space(),
        "globe": tune.default_globe_space(),
        "sdc": tune.sdc_space(),
        "ratio": tune.ratio_space(("1:3", "2:2", "3:1")),
    }


def _render(pkg, space, cand):
    tune, fleet, globe = pkg
    slo = fleet.SloPolicy(ttft_s=0.5, e2e_s=2.0)
    if space.target == "globe":
        cfg = tune.render_globe(cand, slo, globe.GlobeWorkloadSpec())
    else:
        cfg = tune.render_fleet(cand, slo, tenancy=fleet.default_tenancy())
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", ["fleet", "globe", "sdc", "ratio"])
def test_space_draws_and_renders_match_the_reference(name, seed):
    port, ref = _spaces(PKGS["port"])[name], _spaces(PKGS["reference"])[name]
    assert port.as_dict() == ref.as_dict()
    assert ptune.TuneSpace.from_dict(port.as_dict()) == port
    for i in range(16):
        cand = port.draw(seed, i)
        assert cand == ref.draw(seed, i)
        assert (_render(PKGS["port"], port, cand)
                == _render(PKGS["reference"], ref, cand))
        assert ptune.price_factor(cand) == jtune.price_factor(cand)
        assert ptune.candidate_replicas(cand) == jtune.candidate_replicas(
            cand)


@pytest.mark.parametrize("seed", range(3))
def test_zoo_space_draws_from_the_port_s_registry(seed):
    """On the one-generation registry each generation dim is ``h100``
    alone and every candidate's generation cost factor is 1.0; the
    reference's space object, built from the port's, draws the same
    stream."""
    space = ptune.zoo_space()
    dims = {d.name: d for d in space.dims}
    assert dims["generation_split"].choices == ("h100",)
    assert dims["large_model_gen"].choices == ("h100",)
    ref = jtune.TuneSpace.from_dict(space.as_dict())
    for i in range(16):
        cand = space.draw(seed, i)
        assert cand == ref.draw(seed, i)
        assert ptune.generation_cost_factor(cand) == 1.0
        assert (_render(PKGS["port"], space, cand)
                == _render(PKGS["reference"], ref, cand))


def test_zoo_space_mixes_registered_generations(monkeypatch, tmp_path):
    shared_registry(monkeypatch, tmp_path, extra=HALF)
    dims = {d.name: d for d in ptune.zoo_space().dims}
    assert dims["generation_split"].choices == ("h100", "half", "h100+half")
    assert dims["large_model_gen"].choices == ("h100", "half")
    for split in ("h100", "half", "h100+half"):
        for replicas in (3, 4, 5):
            cand = {"generation_split": split, "replicas": replicas}
            assert (ptune.generation_cost_factor(cand)
                    == jtune.generation_cost_factor(cand))
    assert ptune.generation_cost_factor(
        {"generation_split": "h100+half", "replicas": 4}) == 0.75


# -- the search --------------------------------------------------------------


def _search(pkg, kind, workers=0):
    tune, fleet, globe = pkg
    if kind == "globe":
        space = tune.default_globe_space()
        workload = globe.GlobeWorkloadSpec(n_per_zone=30)
        return tune.tune(space, workload, globe.GlobeConfig().slo, seed=1,
                         budget=4, chaos_budget=1, workers=workers)
    slo = fleet.SloPolicy(ttft_s=0.5, e2e_s=2.0)
    workload = fleet.WorkloadSpec(n_requests=60, rps=100.0)
    if kind == "fleet":
        return tune.tune(tune.default_fleet_space(), workload, slo, seed=0,
                         budget=8, workers=workers)
    if kind == "ratio":
        return tune.tune(tune.ratio_space(("1:3", "2:2", "3:1")), workload,
                         slo, seed=2, budget=3, chaos_budget=1,
                         workers=workers)
    return tune.tune(tune.sdc_space(), workload, slo, seed=0, budget=4,
                     chaos_budget=2, workers=workers)


@pytest.mark.parametrize("kind", ["fleet", "globe", "ratio", "sdc"])
def test_search_report_equals_the_reference(kind):
    got = _search(PKGS["port"], kind)
    assert _dumps(got) == _dumps(_search(PKGS["reference"], kind))
    assert got["winner"] is not None and got["evaluations"] > got["budget"]
    if kind != "fleet":
        assert got["chaos"]["budget"] >= 1
    assert _dumps(ptune.replay(got["winner"]["spec"])) == _dumps(
        got["winner"]["metrics"])


def test_zoo_search_on_a_mixed_registry_equals_the_reference(
        monkeypatch, tmp_path):
    shared_registry(monkeypatch, tmp_path, extra=HALF)
    space = ptune.zoo_space()
    reports = {}
    for side, (tune, fleet, _) in PKGS.items():
        workload = fleet.WorkloadSpec(n_requests=40, rps=60.0,
                                      zoo=fleet.default_zoo())
        reports[side] = _dumps(tune.tune(
            space, workload, fleet.SloPolicy(ttft_s=1.0, e2e_s=4.0),
            seed=0, budget=4))
    assert reports["port"] == reports["reference"]
    rows = [r["metrics"] for r in json.loads(reports["port"])["runs"]]
    assert any(m.get("generation_cost_factor", 1.0) != 1.0 for m in rows)


def test_cold_workers_give_the_in_process_report():
    got = _search(PKGS["port"], "ratio", workers=2)
    assert _dumps(got) == _dumps(_search(PKGS["port"], "ratio"))


def test_a_tune_worker_never_loads_torch():
    """A cold worker scores a chaos-mode candidate (the scenario
    compiler's path included) and has loaded no torch."""
    space = ptune.ratio_space(("2:2",))
    spec = ptune.candidate_spec(
        space, space.draw(0, 0), 0, 0, pfleet.WorkloadSpec(n_requests=20),
        pfleet.SloPolicy(ttft_s=0.5, e2e_s=2.0))
    spec.update(fidelity=1.0, chaos_index=0)
    env = pwp._pool_child_env(dict(PYTHONPATH=str(TESTS)), warm=False)
    proc = pwp._WorkerProc(env)
    try:
        deadline = time.monotonic() + 60.0
        proc.ensure_ready(deadline)
        row = proc.request({"id": 1, "job": "call", "kwargs": {
            "target": "kind_tpu_sim_torch.tune.driver:_eval_batch",
            "kwargs": {"evals": [spec]}}}, deadline)
        assert row["ok"], row.get("traceback")
        assert row["result"] == [ptune.evaluate(dict(spec))]
        seen = proc.request({"id": 2, "job": "call", "kwargs": {
            "target": "torch_grid_cells:loaded"}}, deadline)
        assert seen["result"]["torch"] is False
    finally:
        proc.kill()


# -- the commands ------------------------------------------------------------


def _both(argv, capsys):
    rc = pcli.main(list(argv))
    ours = capsys.readouterr().out
    want_rc = jcli.main(list(argv))
    theirs = capsys.readouterr().out
    assert (rc, ours) == (want_rc, theirs)
    return rc, ours


@pytest.mark.parametrize("argv", [
    ("fleet", "tune", "--budget", "4", "--requests", "60", "--json"),
    ("fleet", "tune", "--budget", "4", "--requests", "60"),
    ("fleet", "tune", "--ratios", "1:3,3:1", "--policy",
     "least-outstanding", "--chaos-budget", "1", "--requests", "40"),
    ("fleet", "tune", "--sdc", "--budget", "3", "--requests", "40",
     "--tune-seed", "2", "--json"),
    ("fleet", "tune", "--tenancy", "--budget", "3", "--requests", "40",
     "--seed", "3", "--json"),
    ("globe", "tune", "--budget", "3", "--requests", "20",
     "--chaos-budget", "1"),
], ids=["fleet-json", "fleet-text", "ratios-chaos", "sdc", "tenancy",
        "globe-chaos"])
def test_tune_command_matches_the_reference(argv, capsys):
    rc, out = _both(argv, capsys)
    assert rc == 0 and ("TUNE OK" in out or json.loads(out)["ok"])


def test_tune_workers_and_the_winner_spec_round_trip(tmp_path, capsys):
    base = ["fleet", "tune", "--budget", "4", "--requests", "40"]
    assert pcli.main(base + ["--json"]) == 0
    in_process = capsys.readouterr().out
    spec = tmp_path / "winner.json"
    out = tmp_path / "report.json"
    assert pcli.main(base + ["--json", "--tune-workers", "2", "--spec-out",
                             str(spec), "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert text == f"winner spec -> {spec}\n" + in_process
    assert out.read_text() == in_process
    report = json.loads(in_process)
    assert json.loads(spec.read_text()) == report["winner"]["spec"]
    assert spec.read_text() == ptune.winner_spec_text(report) + "\n"
    assert pcli.main(["fleet", "tune", "--replay-spec", str(spec)]) == 0
    assert capsys.readouterr().out == _dumps(
        report["winner"]["metrics"]) + "\n"
    with pytest.raises(SystemExit, match="drop --device"):
        pcli.main(base + ["--device", "cpu"])


def test_the_tune_replay_target_matches_the_reference_digest():
    got = prc.replay("tune", seed=0)
    assert got == jrc.replay("tune", seed=0)
    assert got["ok"] and got["events"] > 1


# -- the knobs and the light imports ----------------------------------------


TUNE_KNOBS = ["KIND_TPU_SIM_TUNE_SEED", "KIND_TPU_SIM_TUNE_BUDGET",
              "KIND_TPU_SIM_TUNE_CHAOS_BUDGET"]


@pytest.mark.parametrize("name", TUNE_KNOBS)
def test_tune_knob_is_the_reference_s(name, monkeypatch):
    ref = jknobs.REGISTRY[name]
    assert pknobs.KNOBS[name] == (ref.default, ref.kind)
    for raw in (None, "", "3", "3.0", "-1", "abc"):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        assert pknobs.get(name) == jknobs.get(name), raw


def test_the_tune_knobs_drive_the_search(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_TUNE_SEED", "2")
    monkeypatch.setenv("KIND_TPU_SIM_TUNE_BUDGET", "3")
    monkeypatch.setenv("KIND_TPU_SIM_TUNE_CHAOS_BUDGET", "1")
    assert (ptune.resolve_seed(), ptune.resolve_budget(),
            ptune.resolve_chaos_budget()) == (2, 3, 1)
    assert ptune.resolve_budget(5) == 5
    space = ptune.ratio_space(("1:3", "2:2", "3:1"))
    workload = pfleet.WorkloadSpec(n_requests=30)
    slo = pfleet.SloPolicy()
    got = ptune.tune(space, workload, slo)
    assert (got["seed"], got["budget"], got["chaos"]["budget"]) == (2, 3, 1)
    assert _dumps(got) == _dumps(jtune.tune(
        jtune.ratio_space(("1:3", "2:2", "3:1")),
        jfleet.WorkloadSpec(n_requests=30), jfleet.SloPolicy()))
    with pytest.raises(ValueError, match="budget >= 2"):
        ptune.tune(space, workload, slo, budget=1)


@pytest.mark.parametrize("module", [
    "kind_tpu_sim_torch.utils.shell", "kind_tpu_sim_torch.analysis.knobs",
    "kind_tpu_sim_torch.tune"])
def test_the_light_layers_import_neither_torch_nor_the_fleet(module):
    code = (f"import sys, {module}; "
            "print(sorted(m for m in ('torch', 'kind_tpu_sim_torch.fleet') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
