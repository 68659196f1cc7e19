"""PyTorch port parity: the simulator's virtual-clock chaos scenarios.

The thirteen analytic scenarios of ``kind_tpu_sim_torch/chaos.py`` that
drive the fleet's control layers, the scheduler and the training tenancy
(no device work), each against the reference's function at seeds 0, 1
and 2: the scenario's own report (the dict ``fn(seed)`` returns) and the
recovery-log delta of the run, each from its own package, as JSON with
sorted keys, byte for byte; every verdict ``ok``.

Two cases depart, and are pinned: at ``retry-storm`` seed 0 the
reference's stale hedge timer queues a duplicate of a request on the
replica already holding it (ROADMAP C-17), and at seed 2 it requeues a
preempted request onto the replica holding its hedge copy (C-19); the
port does neither, and its report departs in the retry counters (and
at seed 2 the requeue count) alone.
"""

import json

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim import cli as jcli
from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim import metrics as jmetrics
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import fleet as pfleet

NAMES = ["fleet-flaky-replica", "tenant-noisy-neighbor", "sched-node-drain",
         "sched-preemption-priority", "gray-slow-replica",
         "gray-degraded-ici", "overload-surge", "retry-storm",
         "train-preempt-economics", "train-mixed-soak",
         "sdc-training-bisect", "sdc-serving-audit", "correlated-rack-loss"]
SEEDS = [0, 1, 2]
# (scenario, seed) pairs whose report departs from the reference's
DEPARTING = {("retry-storm", 0), ("retry-storm", 2)}
CASES = [(n, s) for n in NAMES for s in SEEDS if (n, s) not in DEPARTING]


def _dumps(obj):
    return json.dumps(obj, sort_keys=True)


def _reference(name, seed):
    """The reference's scenario report and its recovery-log delta."""
    before = jmetrics.recovery_log().counts()
    report = jchaos.SCENARIOS[name].fn(seed)
    return report, jmetrics.recovery_log().snapshot_since(before)


def _port(name, seed):
    got = pchaos.run_scenario(name, seed=seed)
    assert (got.pop("scenario"), got.pop("seed")) == (name, seed)
    return got, got.pop("recovery_events")


def test_the_scenarios_are_registered_analytic_and_fast():
    for name in NAMES:
        scenario = pchaos.SCENARIOS[name]
        assert not scenario.slow and not scenario.device
        assert scenario.description == jchaos.SCENARIOS[name].description
    assert set(NAMES) <= set(pchaos.scenario_names())


@pytest.mark.parametrize("name,seed", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_the_scenario_matches_the_reference(name, seed):
    want, want_events = _reference(name, seed)
    got, got_events = _port(name, seed)
    assert _dumps(got) == _dumps(want)
    assert got_events == want_events
    assert got["ok"] is True


def _spied(fleet, chaos, name, seed, monkeypatch):
    """``name`` at ``seed`` with every analytic submit watched: the
    (request id, time) of each submit to a replica that already holds
    the request, each fleet run's report in order, and the scenario's."""
    twice, runs = [], []
    submit, run = fleet.SimReplica.submit, fleet.FleetSim.run

    def spy(self, req, now):
        rid = req.request_id
        if any(r.request_id == rid for r in self.queue) or any(
                s is not None and s["req"].request_id == rid
                for s in self._slots):
            twice.append((rid, now))
        return submit(self, req, now)

    def keep(self):
        rep = run(self)
        runs.append(rep)
        return rep

    with monkeypatch.context() as m:
        m.setattr(fleet.SimReplica, "submit", spy)
        m.setattr(fleet.FleetSim, "run", keep)
        report = chaos.SCENARIOS[name].fn(seed)
    return twice, runs, report


def test_retry_storm_at_seed_0_departs_at_the_stale_hedge(monkeypatch):
    """C-17 in ``retry-storm``: the scenario runs its fleet four times
    (clean, on, replay, off). In the on-run (and its replay) the
    reference's stale hedge timers offer f00203 and f00205 to the replica
    that holds them; each duplicate finishes first as a hedge "win" and
    the live copy's completion is dropped late. The port offers neither,
    so from 1.73 s on its on-run departs: 20 hedges against 22, and the
    retry budget suppresses 176 retries against 183."""
    twice, want_runs, want = _spied(jfleet, jchaos, "retry-storm", 0,
                                    monkeypatch)
    assert [rid for rid, _ in twice] == ["f00203", "f00205"] * 2
    counters = want_runs[1]["overload"]["counters"]
    assert (counters["hedges_issued"], counters["hedge_wins"],
            counters["hedge_late_drops"]) == (22, 2, 2)
    got_twice, got_runs, got = _spied(pfleet, pchaos, "retry-storm", 0,
                                      monkeypatch)
    assert got_twice == []
    counters = got_runs[1]["overload"]["counters"]
    assert counters["hedges_issued"] == 20
    assert "hedge_wins" not in counters
    assert "hedge_late_drops" not in counters
    # the clean and controls-off runs never hedge onto a holder: equal
    for k in (0, 3):
        assert _dumps(got_runs[k]) == _dumps(want_runs[k])
    # the on-run's completions before the first duplicate are equal
    first = min(t for _, t in twice)

    def before(rep):
        return [e for e in rep["completions"] if e["finish_s"] < first]

    assert len(before(got_runs[1])) == 204
    assert _dumps(before(got_runs[1])) == _dumps(before(want_runs[1]))
    # the report departs in the two retry counters alone
    departed = {k for k in want if _dumps(want[k]) != _dumps(got.get(k))}
    assert departed == {"retries_suppressed", "retries_on"}
    assert (want["retries_suppressed"], got["retries_suppressed"]) == (183,
                                                                       176)
    assert (want["retries_on"], got["retries_on"]) == (34, 33)
    assert want["ok"] is True and got["ok"] is True


def test_retry_storm_at_seed_2_never_requeues_onto_the_hedge_copy(
        monkeypatch):
    """C-19 in ``retry-storm``: at seed 2 the outage preempts the
    replica running f00183 at 1.63 s while its hedge copy waits on the
    other replica; the reference requeues the displaced copy and the
    router places it on that replica, a second copy of the id (an engine
    would refuse it). The port drops the displaced copy and the hedge
    copy finishes as the request: from there its on-run departs."""
    twice, want_runs, want = _spied(jfleet, jchaos, "retry-storm", 2,
                                    monkeypatch)
    assert twice == [("f00183", 1.6300000000000012)] * 2
    got_twice, got_runs, got = _spied(pfleet, pchaos, "retry-storm", 2,
                                      monkeypatch)
    assert got_twice == []
    for k in (0, 3):
        assert _dumps(got_runs[k]) == _dumps(want_runs[k])
    first = twice[0][1]

    def before(rep):
        return [e for e in rep["completions"] if e["finish_s"] < first]

    assert len(before(got_runs[1])) == 183
    assert _dumps(before(got_runs[1])) == _dumps(before(want_runs[1]))
    want_ov = want_runs[1]["overload"]["counters"]
    got_ov = got_runs[1]["overload"]["counters"]
    assert (want_ov["hedge_wins"], want_ov["hedge_late_drops"]) == (1, 1)
    assert "hedge_wins" not in got_ov and "hedge_late_drops" not in got_ov
    assert got_ov["hedges_issued"] == want_ov["hedges_issued"] == 20
    departed = {k for k in want if _dumps(want[k]) != _dumps(got.get(k))}
    assert departed == {"retries_suppressed", "retries_on", "requeues"}
    assert (want["retries_suppressed"], got["retries_suppressed"]) == (233,
                                                                       237)
    assert (want["retries_on"], got["retries_on"]) == (37, 36)
    assert (want["requeues"], got["requeues"]) == (7, 6)
    assert want["ok"] is True and got["ok"] is True


@pytest.mark.parametrize("argv", [
    ["chaos", "run", "--scenario", "gray-degraded-ici", "--seed", "1"],
    ["chaos", "run", "--scenario", "train-mixed-soak"],
    ["chaos", "run", "--scenario", "sched-preemption-priority", "--seed",
     "2"],
], ids=["gray-degraded-ici", "train-mixed-soak", "sched-preemption"])
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_chaos_run_matches_the_reference(argv, as_json, capsys):
    argv = argv + (["--json"] if as_json else [])
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv) == 0
    assert capsys.readouterr().out == want
