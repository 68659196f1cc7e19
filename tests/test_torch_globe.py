"""PyTorch port parity: the single-process globe.

The port's ``globe/`` (cells, the front door, the planner, ``GlobeSim``),
the four globe chaos scenarios and ``globe run | trace`` against the JAX
package's, on the CPU host, both sides priced from the H100's
calibration (``KIND_TPU_SIM_CALIBRATION``) and, where generations enter,
from one registry (``torch_parity.shared_registry``):

* per-zone traces are equal, and a saved trace's bytes and its reload;
* ``GlobeSim`` reports equal the reference's as sorted-key JSON for the
  default config, scheduler-less cells, autoscaling under the planner's
  spot budget, overload containment, tenancy, training cells, a zoo on
  two generations, ``generation_cell_drain``'s drains, zone loss with
  prefix cohorts, and with fast-forward or the event core off (those
  two also equal the default run's report);
* a cell of a disaggregated fleet cancels, and on failure displaces,
  the requests on its KV lane as the reference's does;
* the scenarios at seeds 0-2 equal the reference's reports and
  recovery-log deltas byte for byte;
* the command prints what the reference's prints; ``globe tune`` is
  refused, and more than one shard runs the sharded driver.
"""

import json

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim import cli as jcli
from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim import globe as jglobe
from kind_tpu_sim import metrics as jmetrics
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch import globe as pglobe
from torch_parity import (  # noqa: F401
    H100_CALIBRATION,
    shared_registry,
    torch_one_thread,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread", "h100")

PACKAGES = {"port": (pglobe, pfleet), "reference": (jglobe, jfleet)}
# the test-only second generation: half the H100's rates, 16 GiB
HALF = {"half": {"compute_ratio": 0.5, "bandwidth_ratio": 0.5,
                 "hbm_gib": 16.0, "chip_second_cost": 0.5}}
THREE_DOMAINS = (("tpu-v5-lite-podslice", "4x8"),) * 3


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", H100_CALIBRATION)


@pytest.fixture
def mixed(monkeypatch, tmp_path):
    return shared_registry(monkeypatch, tmp_path, extra=HALF)


def _dumps(obj):
    return json.dumps(obj, sort_keys=True)


def _config(globe, fleet, spec):
    """A GlobeConfig of ``globe`` from plain fields; ``planner``,
    ``workload``, ``frontdoor`` and ``training`` (one gang's fields) as
    dicts, ``overload`` / ``tenancy`` / ``zoo`` True for the defaults."""
    kw = dict(spec)
    if "planner" in kw:
        kw["planner"] = globe.PlannerConfig(**kw["planner"])
    if "workload" in kw:
        kw["workload"] = globe.GlobeWorkloadSpec(**kw["workload"])
    if "frontdoor" in kw:
        kw["frontdoor"] = globe.FrontDoorConfig(**kw["frontdoor"])
    if kw.get("overload"):
        kw["overload"] = globe.OverloadConfig()
    if kw.get("tenancy"):
        kw["tenancy"] = fleet.default_tenancy()
    if kw.get("zoo"):
        kw["zoo"] = fleet.default_zoo()
    if "training" in kw:
        kw["training"] = fleet.TrainingConfig(gangs=(
            fleet.TrainingGangConfig(**kw["training"]),))
    return globe.GlobeConfig(**kw)


def _run(which, spec, events=(), seed=0):
    globe, fleet = PACKAGES[which]
    cfg = _config(globe, fleet, spec)
    return globe.GlobeSim(cfg, seed=seed, chaos_events=[
        globe.GlobeChaosEvent(*ev) for ev in events]).run()


def _pair(spec, events=(), seed=0):
    got = _run("port", spec, events, seed)
    want = _run("reference", spec, events, seed)
    assert _dumps(got) == _dumps(want)
    return got


# -- traces --------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    {}, {"workload": {"process": "diurnal", "rps": 60.0, "n_per_zone": 90,
                      "shared_prefix_frac": 0.4}},
    {"zones": ("zone-a", "zone-b"), "tenancy": True,
     "workload": {"process": "bursty", "n_per_zone": 80}},
    {"zoo": True, "workload": {"n_per_zone": 60}},
], ids=["default", "diurnal cohorts", "tenants", "zoo"])
def test_traces_equal_the_reference(spec, tmp_path):
    ours = pglobe.generate_globe_traces(_config(pglobe, pfleet, spec), 5)
    theirs = jglobe.generate_globe_traces(_config(jglobe, jfleet, spec), 5)
    assert {z: [r.as_dict() for r in reqs] for z, reqs in ours.items()} == {
        z: [r.as_dict() for r in reqs] for z, reqs in theirs.items()}
    pglobe.save_globe_trace(str(tmp_path / "ours.jsonl"), ours)
    jglobe.save_globe_trace(str(tmp_path / "theirs.jsonl"), theirs)
    raw = (tmp_path / "ours.jsonl").read_bytes()
    assert raw == (tmp_path / "theirs.jsonl").read_bytes()
    assert pglobe.load_globe_trace(str(tmp_path / "ours.jsonl")) == ours
    assert pglobe.zone_seed(5, "zone-b") == jglobe.zone_seed(5, "zone-b")


# -- the simulator -------------------------------------------------------

CONFIGS = {
    "default": {},
    "sched off": {"sched": False},
    "autoscale, planner, spot budget": {
        "autoscale": True,
        "planner": {"spot_budget": 3, "eval_every_s": 0.5},
        "workload": {"process": "diurnal", "rps": 90.0, "n_per_zone": 240,
                     "diurnal_period_s": 4.0}},
    "overload": {
        "replicas_per_cell": 1, "overload": True,
        "workload": {"process": "bursty", "rps": 120.0, "n_per_zone": 240,
                     "deadline_s": 0.6}},
    "tenancy": {"tenancy": True, "overload": True,
                "workload": {"rps": 90.0, "n_per_zone": 200}},
    "training cells": {
        "zones": ("zone-a", "zone-b"), "autoscale": True,
        "cell_pods": THREE_DOMAINS,
        "planner": {"spot_budget": 2, "eval_every_s": 0.25},
        "training": {"name": "llm0", "total_steps": 120,
                     "checkpoint_every": 10, "elastic": True,
                     "max_topology": "4x8"},
        "training_cells": ("zone-a/c0", "zone-b/c0"),
        "workload": {"rps": 25.0, "n_per_zone": 120}},
    "event core off": {"event_core": False},
    "fast-forward off": {"event_core": False, "fast_forward": False},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_globe_equals_the_reference(name):
    report = _pair(CONFIGS[name])
    assert report["ok"] and report["completed"] >= report["requests"]
    if name in ("event core off", "fast-forward off"):
        # an execution strategy, not a config: the default run's bytes
        assert _dumps(report) == _dumps(_run("port", {}))


@pytest.mark.parametrize("core,ff,skips", [
    (None, None, "ev_skipped"), (False, None, "ff_skipped"),
    (False, False, None)])
def test_the_loop_skips_idle_ticks_as_its_mode_says(core, ff, skips):
    sim = pglobe.GlobeSim(pglobe.GlobeConfig(
        event_core=core, fast_forward=ff,
        workload=pglobe.GlobeWorkloadSpec(rps=5.0, n_per_zone=20)))
    sim.run()
    assert {k: getattr(sim, k) > 0 for k in ("ev_skipped", "ff_skipped")} \
        == {k: k == skips for k in ("ev_skipped", "ff_skipped")}


def test_zone_loss_with_prefix_cohorts_equals_the_reference():
    spec = {"cells_per_zone": 2, "frontdoor": {"affinity_spill": 4},
            "workload": {"rps": 60.0, "n_per_zone": 150,
                         "shared_prefix_frac": 0.6, "prefix_groups": 6}}
    events = [(0.8, "zone_loss", "zone-b"), (1.2, "dcn_degrade", "zone-c",
                                             0.2),
              (2.0, "zone_restore", "zone-b"), (2.2, "dcn_restore",
                                                "zone-c"),
              (2.5, "cell_drain", "zone-a/c1"), (3.0, "cell_undrain",
                                                 "zone-a/c1")]
    report = _pair(spec, events)
    assert report["frontdoor"]["readmitted"] >= 1
    assert report["globe_counters"]["zone_losses"] == 1


ZOO_SPEC = {"sched": False, "zoo": True, "generations": ("h100", "half"),
            "cells_per_zone": 2,
            "workload": {"rps": 50.0, "n_per_zone": 120}}


def _generation_drain(cells, gens, gen, t0, t1):
    """``generation_cell_drain`` as the scenario compiler lowers it:
    every cell of generation ``gen`` drains over [t0, t1), cell 0
    spared."""
    events = []
    for i, cell in enumerate(cells):
        if i == 0 or gens[i % len(gens)] != gen:
            continue
        events += [(t0, "cell_drain", cell), (t1, "cell_undrain", cell)]
    return events


@pytest.mark.parametrize("drain", [False, True],
                         ids=["zoo on two generations",
                              "generation_cell_drain"])
def test_the_zoo_globe_equals_the_reference(mixed, drain):
    cells = _config(pglobe, pfleet, ZOO_SPEC).cell_names()
    events = (_generation_drain(cells, ZOO_SPEC["generations"], "half",
                                0.5, 1.5) if drain else ())
    report = _pair(ZOO_SPEC, events)
    assert report["zoo"]["counters"]
    if drain:
        assert report["globe_counters"]["cell_drains"] == 3


def test_a_cell_displaces_and_cancels_its_kv_lane_as_the_reference():
    """A globe cell of disaggregated pools: requests cancelled while
    queued or on the KV wire, then the cell failed mid-run; what it
    cancels, displaces and completes equals the reference's."""
    def run(which):
        globe, fleet = PACKAGES[which]
        clock = fleet.VirtualClock()
        fc = fleet.FleetConfig(
            replicas=4, policy="least-outstanding", tick_s=0.01,
            disagg=fleet.DisaggConfig(prefill_replicas=2,
                                      decode_replicas=2))
        log = []
        cell = globe.Cell(globe.CellConfig("zone-a/c0", "zone-a", fc),
                          clock, on_complete=lambda e, c: log.append(e))
        trace = fleet.generate_trace(fleet.WorkloadSpec(
            rps=300.0, n_requests=120, max_new=(16, 48)), 4)
        for req in trace:
            cell.admit(req, req.arrival_s + 0.001)
        cancels = []
        for tick in range(40):
            now = clock.now()
            cell.deliver_due(now)
            cell.step(now, 0.01)
            if tick % 6 == 5:
                wire = sorted(e[3].request.request_id
                              for e in cell.sim._kv_heap._heap)
                queued = [h.request.request_id
                          for h in cell.sim.router.kv_queue]
                for rid in wire[:1] + queued[:1]:
                    cancels.append((rid, cell.cancel(rid)))
            clock.advance(0.01)
        # one transfer cancelled on the wire just before the failure: it
        # stays dropped, not displaced
        wire = sorted(e[3].request.request_id
                      for e in cell.sim._kv_heap._heap)
        cancels.append((wire[0], cell.cancel(wire[0])))
        displaced = [r.request_id for r in cell.fail(clock.now())]
        return cancels, displaced, log, cell.report()

    got, want = run("port"), run("reference")
    assert _dumps(got) == _dumps(want)
    cancels, displaced, _, _ = got
    assert cancels and all(ok for _, ok in cancels) and displaced
    assert cancels[-1][0] not in displaced


# -- the scenarios -------------------------------------------------------


def _reference_report(name, seed):
    before = jmetrics.recovery_log().counts()
    report = jchaos.SCENARIOS[name].fn(seed)
    report.update(scenario=name, seed=seed,
                  recovery_events=jmetrics.recovery_log().snapshot_since(
                      before))
    return report


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["globe-zone-loss", "globe-herd-failover",
                                  "globe-dcn-degrade", "train-globe-spot"])
def test_the_globe_scenario_equals_the_reference(name, seed):
    got = pchaos.run_scenario(name, seed)
    assert _dumps(got) == _dumps(_reference_report(name, seed))
    assert got["ok"] and got["replay_identical"]
    assert not pchaos.SCENARIOS[name].device


# -- the command ---------------------------------------------------------


def _both(argv, capsys):
    rc = pcli.main(list(argv))
    ours = capsys.readouterr().out
    want_rc = jcli.main(list(argv))
    theirs = capsys.readouterr().out
    assert (rc, ours) == (want_rc, theirs)
    return ours


@pytest.mark.parametrize("argv", [
    ("globe", "run", "--requests", "60"),
    ("globe", "run", "--requests", "60", "--json"),
    ("globe", "run", "--zones", "2", "--cells-per-zone", "2",
     "--process", "diurnal", "--spot-budget", "2", "--overload",
     "--tenancy", "--requests", "80", "--seed", "3"),
    ("globe", "run", "--no-sched", "--no-event-core", "--replicas", "1",
     "--rps", "90", "--requests", "60", "--spill-headroom", "0.25",
     "--policy", "round-robin", "--shards", "1", "--json"),
    ("globe", "trace", "--requests", "20", "--process", "bursty"),
], ids=["run", "json", "layers", "plain loop", "trace"])
def test_the_command_prints_what_the_reference_prints(argv, capsys):
    out = _both(argv, capsys)
    assert out.strip()


def test_saved_and_replayed_traces_print_as_the_reference(tmp_path, capsys):
    path = tmp_path / "globe.jsonl"
    out = _both(("globe", "trace", "--requests", "30", "--save-trace",
                 str(path)), capsys)
    assert out == f"wrote 90 requests (3 zones) to {path}\n"
    saved = path.read_bytes()
    report = tmp_path / "report.json"
    _both(("globe", "run", "--trace-file", str(path), "--json"), capsys)
    assert pcli.main(["globe", "run", "--trace-file", str(path), "--out",
                      str(report)]) == 0
    assert f"  report -> {report}" in capsys.readouterr().out
    assert json.loads(report.read_text())["requests"] == 90
    assert path.read_bytes() == saved


def test_tune_and_shards_are_refused(monkeypatch, capsys):
    """``globe tune`` is refused, naming its queue item. More than one
    shard, refused until the sharded driver came, now runs it and prints
    the single-process run's report (tests/test_torch_globe_shard.py
    holds it to the reference)."""
    with pytest.raises(SystemExit, match="Queue A item 5"):
        pcli.main(["globe", "tune"])
    argv = ["globe", "run", "--requests", "5", "--json"]
    assert pcli.main(argv) == 0
    single = capsys.readouterr().out
    assert pcli.main(argv + ["--shards", "2"]) == 0
    assert capsys.readouterr().out == single
    monkeypatch.setenv("KIND_TPU_SIM_GLOBE_SHARDS", "3")
    assert pcli.main(argv) == 0
    assert capsys.readouterr().out == single
