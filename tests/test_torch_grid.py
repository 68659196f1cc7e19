"""PyTorch port parity: the cold worker grids.

The port's ``utils/worker_pool.py`` cold workers (``run_grid``,
``run_cells``, injected faults, the pool heartbeat) and
``parallel/multihost.py``'s ``grid_cell_probe`` / ``scatter_grid_cells``
against the reference's, on the CPU host with real subprocess workers:

* the knobs and the fault specs read as the reference's;
* a grid's results equal the reference's for the same cells, and a
  faulted run's (a crash, a hang past the cell deadline, a crash with no
  respawn budget, ``run_grid`` with and without one) equal the clean
  run's; a cell that raises fails the run; batching is position-equal;
* a cold worker loads no torch and sees no card; the multihost module
  imports without torch;
* the warm pool's heartbeat starts a killed idle worker again;
* ``worker-crash-grid`` and ``worker-hang-grid`` at seeds 0-2 equal the
  reference's reports and recovery-log deltas byte for byte.

``gray-straggler-grid``, whose verdict times the host, is in
``test_torch_grid_straggler.py``.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim import metrics as jmetrics
from kind_tpu_sim.analysis import knobs as jknobs
from kind_tpu_sim.parallel import multihost as jmh
from kind_tpu_sim.utils import worker_pool as jwp
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import health as phealth
from kind_tpu_sim_torch import metrics as pmetrics
from kind_tpu_sim_torch.analysis import knobs as pknobs
from kind_tpu_sim_torch.parallel import multihost as pmh
from kind_tpu_sim_torch.utils import worker_pool as pwp

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent
PROBE = "kind_tpu_sim_torch.parallel.multihost:grid_cell_probe"
CELLS = [{"cell": i, "payload": 5, "spin": i} for i in range(6)]


@pytest.fixture(scope="module")
def clean():
    results, stats = pmh.scatter_grid_cells(CELLS, workers=2)
    assert stats["requeues"] == stats["respawns"] == 0
    return results


@pytest.mark.parametrize("name", ["CHAOS_FAULT", "POOL_WARM", "GLOBE_SEED",
                                  "GLOBE_SHARDS"])
def test_the_knob_is_the_reference_registrys(name):
    knob = getattr(pknobs, name)
    assert knob == getattr(jknobs, name)
    ref = jknobs.REGISTRY[knob]
    assert pknobs.KNOBS[knob] == (ref.default, ref.kind)
    # the worker reads its two knobs by these names, importing no fleet
    assert pwp.CHAOS_FAULT_ENV == pknobs.CHAOS_FAULT == jwp.CHAOS_FAULT_ENV
    assert pwp.WARM_ENV == pknobs.POOL_WARM == jwp.WARM_ENV


@pytest.mark.parametrize("spec", [None, "", "crash@2", "hang@1:30",
                                  "slow@1:0.5", "flaky@3:0.25", "crash",
                                  "hang@x:1", "slow@2:y", "crash@3:7"])
def test_fault_specs_parse_as_the_reference(spec):
    assert pwp._parse_fault(spec) == jwp._parse_fault(spec)


def test_grid_results_equal_the_reference(clean):
    want, _ = jmh.scatter_grid_cells(CELLS, workers=2)
    assert clean == want
    assert [pmh.grid_cell_probe(**c) for c in CELLS] == want
    assert (pmh.grid_cell_probe(cell=3, payload=9, spin=40, sleep_s=0.01)
            == jmh.grid_cell_probe(cell=3, payload=9, spin=40))


@pytest.mark.parametrize("fault,kw,counts", [
    (("crash", 2), {}, {"requeues": 1, "respawns": 1}),
    (("hang", 1, 30.0), {"cell_timeout": 2.0},
     {"requeues": 1, "respawns": 1}),
    (("crash", 4), {"max_respawns": 0}, {"requeues": 1, "respawns": 0}),
], ids=["crash", "hang", "crash without a respawn budget"])
def test_a_faulted_grid_equals_the_clean_grid(clean, fault, kw, counts):
    before = pmetrics.recovery_log().counts()
    results, stats = pmh.scatter_grid_cells(CELLS, workers=2, fault=fault,
                                            **kw)
    assert results == clean
    assert stats["faults_injected"] == 1
    assert {k: stats[k] for k in counts} == counts
    events = pmetrics.recovery_log().snapshot_since(before)
    assert events.get("fault_injected") == 1
    assert events.get("cell_requeued") == 1
    assert events.get("cell_worker_respawn", 0) == counts["respawns"]


@pytest.mark.parametrize("budget", [0, 1])
def test_run_grid_heals_a_crashed_worker_within_its_budget(budget):
    envs = [{}, {pwp.CHAOS_FAULT_ENV: "crash@1"}]
    kwargs = [{"cell": 0, "payload": 1}, {"cell": 1, "payload": 1}]
    want = [pmh.grid_cell_probe(**kw) for kw in kwargs]
    before = pmetrics.recovery_log().counts()
    if budget == 0:
        with pytest.raises(RuntimeError, match="slice worker 1 crashed"):
            pwp.run_grid(envs, PROBE, 60.0, kwargs_list=kwargs)
        return
    assert pwp.run_grid(envs, PROBE, 60.0, kwargs_list=kwargs,
                        max_respawns=budget) == want
    events = pmetrics.recovery_log().snapshot_since(before)
    assert events == {"grid_worker_respawn": 1}
    # a clean grid, and the reference's the same
    assert pwp.run_grid([{}, {}], PROBE, 60.0, kwargs_list=kwargs) == want
    assert jwp.run_grid([{}, {}], "kind_tpu_sim.parallel.multihost:"
                        "grid_cell_probe", 60.0, kwargs_list=kwargs) == want


def test_a_cell_that_raises_fails_the_run():
    cells = [{"cell": 0}, {"cell": 1, "no_such_argument": 1}]
    with pytest.raises(RuntimeError, match="cell 1 failed.*TypeError"):
        pwp.run_cells([{}], PROBE, cells, timeout=60.0)
    with pytest.raises(RuntimeError, match=r"cells \[0, 1\] failed"):
        pwp.run_cells([{}], PROBE, cells, timeout=60.0, batch=2)


@pytest.mark.parametrize("batch", [2, 4])
def test_batched_cells_are_position_equal(clean, batch):
    envs = [pwp.simulated_slice_env(1) for _ in range(2)]
    got, stats = pwp.run_cells(envs, PROBE, CELLS, timeout=60.0,
                               batch=batch)
    assert got == clean
    want, _ = jwp.run_cells([{}, {}], "kind_tpu_sim.parallel.multihost:"
                            "grid_cell_probe", CELLS, timeout=60.0,
                            batch=batch)
    assert got == want
    assert stats["requeues"] == 0


def test_a_cold_worker_loads_no_torch_and_sees_no_card():
    env = pwp._pool_child_env(
        dict(pwp.simulated_slice_env(8), PYTHONPATH=str(TESTS)), warm=False)
    proc = pwp._WorkerProc(env)
    try:
        deadline = time.monotonic() + 60.0
        hello = proc.ensure_ready(deadline)
        assert hello == {"hello": True, "pid": proc.pid}
        cell = proc.request({"id": 1, "job": "call", "kwargs": {
            "target": PROBE, "kwargs": {"cell": 2}}}, deadline)
        assert cell["ok"] and cell["result"] == pmh.grid_cell_probe(cell=2)
        seen = proc.request({"id": 2, "job": "call", "kwargs": {
            "target": "torch_grid_cells:loaded"}}, deadline)
        assert seen["result"] == {"torch": False,
                                  "cuda_visible_devices": ""}
        # a rank job needs the world a cold worker does not have
        rank = proc.request({"id": 3, "job": "collectives_suite"}, deadline)
        assert not rank["ok"] and "a cold worker has none" in rank["error"]
    finally:
        proc.kill()
    out = subprocess.run(
        [sys.executable, "-c", "import sys; import kind_tpu_sim_torch."
         "parallel.multihost; print('torch' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "False", out.stderr[-2000:]


def test_the_heartbeat_starts_a_killed_idle_worker_again():
    detector = phealth.FailureDetector(phealth.DetectorConfig())
    before = pmetrics.recovery_log().counts()
    with pwp.WorkerPool(world=1, backend="gloo", device="cpu",
                        health=detector) as pool:
        pid = pool.bringup()["pid"]
        assert pool.check_health() == [{
            "slot": 0, "pid": pid, "alive": True, "busy": False,
            "uptime_s": pool.check_health()[0]["uptime_s"]}]
        os.kill(pid, signal.SIGKILL)
        pool.start_heartbeat(interval_s=0.05)
        deadline = time.monotonic() + 60.0
        while pool.respawns == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        pool.stop_heartbeat()
        (row,) = pool.check_health()
        assert pool.respawns == 1 and row["alive"] and row["pid"] != pid
        assert pool.submit("ping") == {"pid": row["pid"]}
    assert pmetrics.recovery_log().snapshot_since(before) == {
        "worker_respawn": 1, "health_quarantine": 1, "health_restore": 1}
    assert [(e["component"], e["transition"]) for e in detector.events] == [
        ("pool-0", "quarantined"), ("pool-0", "restored")]


def _reference_report(name, seed):
    """The reference scenario's report as its ``run_scenario`` builds it
    (the recovery-log delta of its own run), without its registry."""
    before = jmetrics.recovery_log().counts()
    report = jchaos.SCENARIOS[name].fn(seed)
    report.update(scenario=name, seed=seed,
                  recovery_events=jmetrics.recovery_log().snapshot_since(
                      before))
    return report


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["worker-crash-grid", "worker-hang-grid"])
def test_the_grid_scenario_equals_the_reference(name, seed):
    got = pchaos.run_scenario(name, seed)
    want = _reference_report(name, seed)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["ok"] and got["results_identical"]
    assert not pchaos.SCENARIOS[name].slow
    assert not pchaos.SCENARIOS[name].device
