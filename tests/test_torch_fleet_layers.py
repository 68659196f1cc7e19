"""PyTorch port parity: the engine fleet's overload and audit layers.

The port's ``FleetSim`` over ``EngineReplica``s against the JAX
package's engine fleet with the same config, trace, chaos events and
weights (the reference's init crossed through numpy; the fleet command's
tiny model in fp32, so greedy streams have no near-ties), three replicas
(``torch_parity.fleet_layers_run``):

* overload containment with a replica slowed x6: hedges win, losers
  are cancelled while queued or dropped when they finish late;
* overload containment under a deadline burst: expiries, budgeted
  retries, hedges;
* the integrity audit lane at 0.3;
* all four layers at once (the detector, overload, tenancy, audits)
  with a slowed and then a preempted replica: the fleet that
  ``chip_smoke.py`` phase 14 (f) runs at the flagship.

The report's sections are compared whole: equal. (The detector's and
tenancy's own fleets are in ``test_torch_health.py`` and
``test_torch_tenancy.py``.) Then ``EngineReplica.cancel`` on both
engines, and what a withdrawn request leaves behind in the port's
engine: nothing. Last, two faults of the reference the port does not
copy (ROADMAP Queue C): a stale hedge timer that offers the request to
the replica holding it (C-17), and a probe logged as user traffic
(C-14).
"""

import pytest

from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch.models import serving as pserving

from torch_parity import (FLEET_CFG, FLEET_SERVING, fleet_layers_pair,
                          fleet_layers_run, jax_cfg, make_params, one_thread)

BASE = dict(process="poisson", rps=150.0, n_requests=80, max_new=(12, 24))
# chip_smoke phase 14 (f): the stock tenants' trace of seed 0 (its span
# 0.644 s), replica 1 slowed x6 over 10-50% of it, replica 2 preempted
# over 60-80%
FLAGSHIP_EVENTS = [dict(at_s=0.0644, action="slow", target=1, param=6.0),
                   dict(at_s=0.322, action="unslow", target=1),
                   dict(at_s=0.3864, action="preempt", target=2),
                   dict(at_s=0.5152, action="restore", target=2)]


@pytest.fixture(scope="module")
def params():
    with one_thread():
        yield make_params(FLEET_CFG)


def test_hedges_on_a_slowed_replica_match_the_reference(params):
    got = fleet_layers_pair(
        params, dict(BASE, n_requests=50), overload=True,
        events=[dict(at_s=0.05, action="slow", target=1, param=6.0)])
    ov = got["overload"]["counters"]
    assert ov["hedges_issued"] and ov["hedge_wins"]
    assert ov["hedge_cancels"] and ov["hedge_late_drops"]


def test_retries_under_deadlines_match_the_reference(params):
    got = fleet_layers_pair(
        params, dict(BASE, n_requests=60, rps=600.0, deadline_s=0.025),
        overload=True)
    ov = got["overload"]["counters"]
    assert ov["hedge_cancels"] and ov["retries_scheduled"]
    assert ov["retries_suppressed"] and got["slo"]["deadline_exceeded"]


def test_audit_lane_matches_the_reference(params):
    got = fleet_layers_pair(params, dict(BASE, n_requests=40),
                            audit_frac=0.3)
    audits = got["integrity"]["counters"]
    assert audits["audit_copies"] and "audit_mismatches" not in audits
    assert got["integrity"]["detections"] == []


def test_all_four_layers_match_the_reference(params):
    got = fleet_layers_pair(
        params, dict(BASE, tenancy=True), seed=0, events=FLAGSHIP_EVENTS,
        health=True, overload=True, tenancy=True, audit_frac=0.3)
    # what chip_smoke's (f) holds the card to
    ov = got["overload"]["counters"]
    health = got["health"]["counters"]
    audits = got["integrity"]["counters"]
    assert got["completed"] == 80 and got["preemptions"] == 1
    assert ov["hedge_cancels"] and ov["hedge_late_drops"]
    assert health["quarantines"] and health["restores"]
    assert audits["audit_copies"] and "audit_mismatches" not in audits
    assert got["integrity"]["detections"] == []


def _cancel_probe(fleet, serving, params, cfg, **kw):
    """Six requests on an engine of four slots; after one round four hold
    slots and two wait. Cancels a waiting one, one in a slot and an
    unknown id, then drains."""
    eng = serving.ServingEngine(params, cfg, serving.ServingConfig(
        **FLEET_SERVING), clock=lambda: 0.0, **kw)
    replica = fleet.EngineReplica(0, eng)
    for i in range(6):
        assert replica.submit(fleet.TraceRequest(
            f"c{i}", 0.0, tuple(range(1, 4 + i)), 10, i), 0.0)
    replica.tick(0.0, 0.01)
    out = (replica.cancel("c5"), replica.cancel("c0"), replica.cancel("zz"))
    done = []
    while not replica.idle():
        done += [(c.request.request_id, c.tokens, c.tokens_crc)
                 for c in replica.tick(0.0, 0.01)]
    return out, sorted(done), replica


def test_cancel_matches_the_reference_and_leaves_nothing(params):
    want = _cancel_probe(jfleet, jserving, params[0], jax_cfg(FLEET_CFG))
    got = _cancel_probe(pfleet, pserving, params[1], FLEET_CFG,
                        device="cpu")
    assert got[:2] == want[:2]
    assert got[0] == (True, False, False)
    assert [rid for rid, _, _ in got[1]] == ["c0", "c1", "c2", "c3", "c4"]
    replica = got[2]
    eng = replica.engine
    assert not replica._dispatched and not replica._dispatch_s
    assert not eng.queue and not eng._req_clock and not eng._pending
    assert eng.outstanding() == 0 and not eng.finished
    assert all(r is None for r in eng.slot_req)
    # the withdrawn id is free again on this engine
    assert replica.submit(pfleet.TraceRequest("c5", 0.0, (1, 2), 2, 0), 0.0)


class HeldReplica:
    """A replica without an engine: what it holds finishes on its next
    tick, four tokens over 0.05 s."""

    slowdown = 1.0

    def __init__(self, fleet, rid):
        self.fleet = fleet
        self.replica_id = rid
        self.healthy = True
        self.held = []

    def outstanding(self):
        return len(self.held)

    def idle(self):
        return not self.held

    def submit(self, req, now):
        self.held.append(req)
        return True

    def tick(self, now, dt):
        out = [self.fleet.ReplicaCompletion(
            request=r, dispatch_s=now, first_s=now, finish_s=now + 0.05,
            tokens=4, tokens_crc=0, finish_reason="length")
            for r in self.held]
        self.held = []
        return out

    def report(self):
        return {}


def _drained_probe(fleet):
    """A fleet with the detector whose replica 1 drains (a scale-down)
    while a probe is on it; one step. Returns (the log's ids, the
    detector's sample count)."""
    sim = fleet.FleetSim(
        fleet.FleetConfig(replicas=2, health=fleet.DetectorConfig()),
        [fleet.TraceRequest("f00000", 1.0, (1, 2), 2, 0)],
        replica_factory=lambda rid: HeldReplica(fleet, rid))
    victim = sim.replicas.pop(1)
    sim.router.replicas.remove(victim)
    sim._draining.append(victim)
    victim.submit(fleet.TraceRequest("__probe-1-0", 0.0, (1,) * 8, 4, 0),
                  0.0)
    sim.step(0.0, 0.01)
    return [e["request_id"] for e in sim.log], sim.health.report()["samples"]


def test_a_probe_on_a_draining_replica_stays_out_of_the_log():
    """ROADMAP C-14: the reference's loop sends a draining replica's
    completions to the SLO log without setting probes apart, so a probe
    that finishes there is logged as user traffic. The port feeds it to
    the detector alone, as the loop does for every other replica."""
    assert _drained_probe(jfleet) == (["__probe-1-0"], 1)
    assert _drained_probe(pfleet) == ([], 1)


C17_SPEC = dict(process="poisson", rps=600.0, n_requests=60,
                max_new=(12, 24))
C17_EVENTS = [dict(at_s=0.02, action="preempt", target=0),
              dict(at_s=0.2, action="restore", target=0)]


@pytest.mark.parametrize("replicas", [2, 3])
def test_a_stale_hedge_timer_skips_the_replica_holding_the_request(
        params, replicas):
    """ROADMAP C-17: replica 0's requests carry hedge timers when it is
    preempted; they requeue onto the others, and a timer that fires
    then offers its request to the replica that now holds it. The
    reference's engine refuses the duplicate id and the run raises. The
    port skips that replica, makes the holder the pair's primary, and
    completes every request once; with three replicas each hedge's
    loser is the other live copy, cancelled while it waits."""
    with pytest.raises(ValueError, match="already queued or in flight"):
        with one_thread():
            fleet_layers_run(jfleet, jserving, params[0], jax_cfg(FLEET_CFG),
                             C17_SPEC, events=C17_EVENTS, overload=True,
                             fleet_kw=dict(replicas=replicas))
    sims = []
    with one_thread():
        got = fleet_layers_run(pfleet, pserving, params[1], FLEET_CFG,
                               C17_SPEC, events=C17_EVENTS, overload=True,
                               fleet_kw=dict(replicas=replicas), sims=sims,
                               device="cpu")
    ids = [e["request_id"] for e in got["completions"]]
    assert got["ok"] and got["completed"] == 60 and len(set(ids)) == 60
    assert got["preemptions"] == 1 and got["router"]["requeues"] >= 1
    assert all(e["finish_reason"] == "length" for e in got["completions"])
    sim = sims[0]
    assert not sim._hedges and not sim._hedge_dropped
    ov = got["overload"]["counters"]
    if replicas == 3:
        assert ov["hedges_issued"] == ov["hedge_cancels"] == 6
        assert "hedge_late_drops" not in ov


@pytest.mark.parametrize("at", [0.17, 0.18])
def test_a_requeued_copy_never_lands_on_its_hedge_holder(params, at):
    """ROADMAP C-19: replica 0 is preempted while one of its requests
    (f00046) has a hedge copy waiting on replica 1. The reference
    requeues the displaced copy, the router places it on replica 1, and
    its engine refuses the duplicate id. The port drops the displaced
    copy, dissolves the pair, and completes every request once."""
    events = [dict(at_s=at, action="preempt", target=0),
              dict(at_s=round(at + 0.2, 3), action="restore", target=0)]
    with pytest.raises(ValueError, match="'f00046' is already queued"):
        with one_thread():
            fleet_layers_run(jfleet, jserving, params[0], jax_cfg(FLEET_CFG),
                             C17_SPEC, events=events, overload=True,
                             fleet_kw=dict(replicas=2))
    sims = []
    with one_thread():
        got = fleet_layers_run(pfleet, pserving, params[1], FLEET_CFG,
                               C17_SPEC, events=events, overload=True,
                               fleet_kw=dict(replicas=2), sims=sims,
                               device="cpu")
    ids = [e["request_id"] for e in got["completions"]]
    assert got["ok"] and got["completed"] == 60 and len(set(ids)) == 60
    assert got["preemptions"] == 1
    assert not sims[0]._hedges and not sims[0]._hedge_dropped
    ov = got["overload"]["counters"]
    # one pair dissolved: its loser was the displaced copy
    assert ov["hedges_issued"] == ov["hedge_cancels"] + 1


def _held_twice(fleet, monkeypatch):
    """The analytic fleet under C-17's traffic and chaos (two replicas,
    overload on): the submits that offered a replica a request it
    already held, and the report."""
    twice = []
    submit = fleet.SimReplica.submit

    def spy(self, req, now):
        if any(r.request_id == req.request_id for r in self.queue) or any(
                s is not None and s["req"].request_id == req.request_id
                for s in self._slots):
            twice.append(req.request_id)
        return submit(self, req, now)

    monkeypatch.setattr(fleet.SimReplica, "submit", spy)
    trace = fleet.generate_trace(fleet.WorkloadSpec(**C17_SPEC), 3)
    rep = fleet.FleetSim(
        fleet.FleetConfig(replicas=2, policy="least-outstanding",
                          overload=fleet.OverloadConfig()),
        trace, chaos_events=[fleet.ChaosEvent(**e)
                             for e in C17_EVENTS]).run()
    return twice, rep


def test_a_stale_hedge_timer_skips_the_holder_on_analytic_replicas(
        monkeypatch):
    """C-17 on analytic replicas: the reference's ``SimReplica`` takes
    the duplicate, so the stale timer queues a second copy of a request
    on the replica already running it, and the run completes. The
    port's fleet skips the holder there too; its report departs from
    the reference's from that hedge on, and every request completes
    once."""
    twice, want = _held_twice(jfleet, monkeypatch)
    # each duplicate finishes first on its own replica: a "win"
    assert twice and want["ok"]
    assert want["overload"]["counters"]["hedge_wins"] == len(twice)
    twice, got = _held_twice(pfleet, monkeypatch)
    assert twice == [] and got["ok"] and got["completed"] == 60
    assert "hedge_wins" not in got["overload"]["counters"]
