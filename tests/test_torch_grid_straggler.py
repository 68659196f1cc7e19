"""PyTorch port parity: ``gray-straggler-grid`` without timing a loaded
host.

The scenario's verdict compares wall-clock makespans of real subprocess
grids; under the test run's parallel workers a healthy worker can miss
its 0.8 s probe (the reference's own test of it fails so). Here:

* ``derive_straggler_bounds`` equals the reference's over a grid of
  inputs;
* both packages' scenario functions run with ``scatter_grid_cells``
  replaced, in the test alone, by one canned stand-in
  (``torch_parity.CannedGrid``): their calls' arguments and their
  reports are equal, in the ok case and in each way ``ok`` turns false
  (a fault-free quarantine, the detection-on run past ``on_limit_s``,
  the detection-off run under ``off_floor_s``, no detection);
* one real faulted grid at the reference's test size (4 workers, 18
  cells of 0.05 s, a 1.5 s straggler) is held only to what no host load
  changes: results equal to the clean run's, one injected fault, and a
  quarantine or a speculative copy.

The wall-clock verdict itself is held by ``chip_smoke.py``, which runs
``chaos run --scenario gray-straggler-grid`` with nothing beside it.
"""

import dataclasses
import json

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim.parallel import multihost as jmh
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import health as phealth
from kind_tpu_sim_torch.parallel import multihost as pmh
from torch_parity import STRAGGLER_STATS, CannedGrid


@pytest.mark.parametrize("stall", [0.0, 1.6, 1.858, 2.4])
@pytest.mark.parametrize("clean", [(0.5, 0.5), (0.62, 0.655), (0.9, 0.4),
                                   (0.0, 0.0), (3.25, 1e-12)])
def test_bounds_equal_the_reference(clean, stall):
    got = pchaos.derive_straggler_bounds(*clean, stall)
    want = jchaos.derive_straggler_bounds(*clean, stall)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _stats(case):
    """STRAGGLER_STATS changed so that the verdict fails one way."""
    clean, clean2, on, off = (dict(s) for s in STRAGGLER_STATS)
    if case == "fault-free quarantine":
        clean2.update(quarantines=1, respawns=1)
    elif case == "on past its limit":
        on["makespan_s"] = 4.9
    elif case == "off under its floor":
        off["makespan_s"] = 0.9
    elif case == "undetected":
        on.update(quarantines=0, respawns=0, detection=[])
    return clean, clean2, on, off


@pytest.mark.parametrize("seed,case", [
    (0, "ok"), (1, "ok"), (2, "ok"), (0, "fault-free quarantine"),
    (1, "on past its limit"), (2, "off under its floor"), (0, "undetected")])
def test_the_scenario_equals_the_reference_on_canned_grids(monkeypatch, seed,
                                                          case):
    stats = _stats(case)
    ours = CannedGrid(pmh.scatter_grid_cells, pmh.grid_cell_probe, stats)
    theirs = CannedGrid(jmh.scatter_grid_cells, jmh.grid_cell_probe, stats)
    monkeypatch.setattr(pmh, "scatter_grid_cells", ours)
    monkeypatch.setattr(jmh, "scatter_grid_cells", theirs)
    got = pchaos.SCENARIOS["gray-straggler-grid"].fn(seed)
    want = jchaos.SCENARIOS["gray-straggler-grid"].fn(seed)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["ok"] == (case == "ok")
    assert len(ours.calls) == len(theirs.calls) == 4
    for a, b in zip(ours.calls, theirs.calls):
        a, b = dict(a), dict(b)
        ha, hb = a.pop("health_cfg", None), b.pop("health_cfg", None)
        assert (ha is None) == (hb is None)
        if ha is not None:
            assert ha.as_dict() == hb.as_dict()
            assert ha.probe_timeout_s == 0.8
        assert a == b


def test_a_real_straggler_grid_returns_the_clean_results():
    cells = [{"cell": i, "payload": 11, "sleep_s": 0.05} for i in range(18)]
    hcfg = dataclasses.replace(phealth.DetectorConfig.from_env(),
                               probe_timeout_s=0.8)
    clean, _ = pmh.scatter_grid_cells(cells, workers=4, timeout=120.0)
    faulted, stats = pmh.scatter_grid_cells(
        cells, workers=4, timeout=120.0, detect=True, health_cfg=hcfg,
        fault=("straggler", 1, 1.5), max_respawns=1)
    assert faulted == clean
    assert stats["faults_injected"] == 1
    assert stats["quarantines"] + stats["speculative"] >= 1
