"""PyTorch port parity: the analytic replica and the fleets built of it.

The port's ``fleet/router.py:SimReplica`` (the closed-form
continuous-batching replica: prefill then decode timelines, a prefix
cache, slowdown, chip corruption, cancel, fail and restore; the
cross-cell ``warm_prefix`` comes with the globe) against the
JAX package's on one scripted sequence of operations, and whole
``FleetSim`` runs without a replica factory, where every replica is a
``SimReplica`` of ``FleetConfig.sim``: the plain fleet under each
policy, the autoscaler, the detector under slow chaos, overload
containment, tenancy (with per-tenant prefix-cache budgets), the
integrity audit lane with a defective chip, preemption, and the
scheduler with one training gang. Each fleet runs under the event core
and under the plain per-tick loop. Nothing here touches a device, so
the tolerance is exact: the reports, as JSON with sorted keys, are
equal (``torch_parity.sim_fleet_pair``).
"""

import dataclasses
import json

import pytest

from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim_torch import fleet as pfleet

from torch_parity import sim_fleet_pair, sim_fleet_run

BASE = dict(process="poisson", rps=150.0, n_requests=120, max_new=(4, 24))

CASES = {
    "round-robin": (dict(policy="round-robin"), BASE, []),
    "least-outstanding": (dict(), dict(BASE, rps=400.0), []),
    "prefix-affinity": (
        dict(policy="prefix-affinity"),
        dict(BASE, shared_prefix_frac=0.6, prefix_groups=5, prefix_len=6),
        []),
    "deadlines": (dict(sim=dict(max_slots=2, max_queue=4)),
                  dict(BASE, rps=500.0, deadline_s=0.15), []),
    "preempt and restore": (
        dict(), dict(BASE, rps=300.0),
        [dict(at_s=0.1, action="preempt", target=1),
         dict(at_s=0.3, action="restore", target=1)]),
    "autoscaler": (
        dict(replicas=1, autoscale=True, eval_every_s=0.05,
             autoscaler=dict(min_replicas=1, max_replicas=4,
                             up_backlog=2.0, breach_evals=2,
                             cooldown_s=0.1, warmup_s=0.1)),
        dict(BASE, rps=500.0, n_requests=200), []),
    "health, slow chaos": (
        dict(health=True), dict(BASE, rps=300.0, n_requests=200),
        [dict(at_s=0.05, action="slow", target=2, param=6.0),
         dict(at_s=0.5, action="unslow", target=2)]),
    "overload": (
        dict(overload=True), dict(BASE, rps=600.0, deadline_s=0.08),
        [dict(at_s=0.05, action="slow", target=1, param=6.0)]),
    "tenancy": (dict(tenancy=True), dict(BASE, tenancy=True), []),
    "tenancy, prefix budgets": (
        dict(tenancy={"bronze": 0.25, "silver": 0.5},
             sim=dict(prefix_cache_entries=4)),
        dict(BASE, tenancy=True, n_requests=160, shared_prefix_frac=0.7),
        []),
    "tenancy off": (dict(tenancy=False), dict(BASE, tenancy=True), []),
    "sdc chip, audits": (
        dict(audit_frac=0.5), BASE,
        [dict(at_s=0.1, action="sdc_chip", target=1, param=0.5)]),
    "sched, one training gang": (
        dict(replicas=2, sched={},
             training=[dict(name="llm0", topology="2x8", total_steps=80)]),
        BASE,
        # replica 1's rebind onto node 2 preempts the gang; the second
        # failure moves it back and makes the gang's row whole again
        [dict(at_s=0.05, action="link_degrade", target=0, param=0.25),
         dict(at_s=0.08, action="node_fail", target=1),
         dict(at_s=0.2, action="node_restore", target=1),
         dict(at_s=0.25, action="link_restore", target=0),
         dict(at_s=0.3, action="node_fail", target=2),
         dict(at_s=0.45, action="node_restore", target=2)]),
}


@pytest.mark.parametrize("event_core", [None, False],
                         ids=["event core", "plain loop"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_analytic_fleet_matches_the_reference(name, event_core):
    fc, spec, events = CASES[name]
    got = sim_fleet_pair(spec, events, event_core=event_core, **fc)
    assert got["ok"]
    assert all(r["kind"] == "sim" for r in got["replicas"].values())
    if name == "autoscaler":
        assert got["autoscaler"]["scale_ups"] >= 1
    if name == "health, slow chaos":
        assert got["health"]["counters"].get("quarantines")
    if name == "overload":
        assert got["overload"]["counters"].get("hedges_issued")
    if name == "tenancy, prefix budgets":
        hits = [r.get("prefix", {}) for r in got["replicas"].values()]
        assert any(h.get("hits") for h in hits)
    if name == "sdc chip, audits":
        counters = got["integrity"]["counters"]
        assert counters["audit_mismatches"] and got["integrity"]["detections"]
        assert counters["corrupted_produced"]
    if name == "sched, one training gang":
        assert got["training"]["all_done"] and got["scheduler"]["events"]


def test_the_plain_loop_and_the_event_core_agree():
    """The two loops of the port give one report (an analytic replica's
    next events are closed form, so the event core may skip
    boundaries)."""
    fc, spec, events = CASES["preempt and restore"]
    reports = [json.dumps(sim_fleet_run(pfleet, spec, events,
                                        event_core=event_core, **fc),
                          sort_keys=True)
               for event_core in (True, False)]
    assert reports[0] == reports[1]


def _script(fleet, phase="unified"):
    """One SimReplica driven through every operation; returns what each
    call answered."""
    cfg = fleet.SimReplicaConfig(max_slots=2, max_queue=3,
                                 prefix_cache_entries=2)
    rep = fleet.SimReplica(7, cfg, phase=phase)
    out = []

    def req(i, **kw):
        return fleet.TraceRequest(f"r{i}", 0.001 * i, tuple(range(3 + i)),
                                  4 + i, i, **kw)

    def tick(now, dt=0.01):
        out.append([dataclasses.astuple(c)[1:] + (c.request.request_id,)
                    for c in rep.tick(now, dt)])
        out.append(rep.next_due())

    for i in range(5):
        out.append(rep.submit(req(i, prefix_group=i % 2), 0.0))
    out.append(rep.next_due())
    tick(0.0)
    rep.set_slowdown(3.0)
    tick(0.01, 0.05)
    out.append((rep.cancel("r3"), rep.cancel("r0"), rep.cancel("zz")))
    rep.set_corrupt(1.0)
    out.append(rep.submit(req(9, deadline_s=0.02), 0.06))
    for k in range(8):
        tick(0.06 + 0.03 * k, 0.03)
    out.append([r.request_id for r in rep.fail(0.3)])
    out.append((rep.submit(req(10), 0.3), rep.next_due()))
    rep.restore(0.31)
    rep.set_slowdown(1.0)
    out.append(rep.submit(req(11, prefix_group=1), 0.31))
    for k in range(6):
        tick(0.31 + 0.02 * k, 0.02)
    out.append((rep.outstanding(), rep.idle(), rep.report()))
    return out


@pytest.mark.parametrize("phase", ["unified", "prefill", "decode"])
def test_sim_replica_answers_like_the_reference(phase):
    assert _script(pfleet, phase) == _script(jfleet, phase)


def test_sim_replica_config_is_the_reference():
    names = [f.name for f in dataclasses.fields(pfleet.SimReplicaConfig)]
    assert names == [f.name for f in
                     dataclasses.fields(jfleet.SimReplicaConfig)]
    assert pfleet.SimReplicaConfig() == pfleet.SimReplicaConfig(
        *dataclasses.astuple(jfleet.SimReplicaConfig()))
    assert (pfleet.SimReplicaConfig().as_dict()
            == jfleet.SimReplicaConfig().as_dict())
    with pytest.raises(ValueError, match="unknown replica phase"):
        pfleet.SimReplica(0, phase="both")
    # per-model prices (the model zoo) are ported: a replica of them
    # answers like the reference's
    cfg = dict(max_slots=2, max_queue=4, model_tpot_s=(("m", 0.01),),
               model_prefill_per_tok_s=(("m", 0.002),),
               model_swap_s=(("m", 0.3),), resident_model="")
    assert (pfleet.SimReplicaConfig(**cfg).as_dict()
            == jfleet.SimReplicaConfig(**cfg).as_dict())
    assert _zoo_script(pfleet, cfg) == _zoo_script(jfleet, cfg)


def _zoo_script(fleet, cfg):
    """A replica with per-model prices driven through admissions of its
    model, of no model and of a model it cannot hold, a slowed swap, a
    decode-pool handoff and a failure; returns what each call answered
    and the swaps it reported."""
    swaps = []
    out = []
    for phase in ("unified", "decode"):
        rep = fleet.SimReplica(3, fleet.SimReplicaConfig(**cfg),
                               phase=phase)
        rep.on_swap = lambda ev: swaps.append(ev.as_dict())

        def req(i, model):
            return fleet.TraceRequest(f"{phase}{i}", 0.001 * i,
                                      tuple(range(4 + i)), 5, i,
                                      model=model)

        def tick(now, dt=0.02):
            out.append([dataclasses.astuple(c)[1:] + (c.request.request_id,)
                        for c in rep.tick(now, dt)])
            out.append((rep.next_due(), rep.resident_model))

        if phase == "decode":
            handoff = fleet.KvHandoff(request=req(0, "m"), dispatch_s=0.0,
                                      first_s=0.01, tokens=1, kv_bytes=64,
                                      from_replica=0)
            out.append(rep.submit(handoff, 0.0))
            for k in range(6):
                tick(0.02 * k)
            out.append(rep.report())
            continue
        out.append([rep.submit(req(i, model), 0.0) for i, model in
                    enumerate(("m", "", "x", "m"))])
        out.append((rep.can_serve("m"), rep.can_serve(""),
                    rep.can_serve("x")))
        tick(0.0)
        rep.set_slowdown(2.0)
        for k in range(1, 12):
            tick(0.02 * k)
        out.append(rep.submit(req(5, "m"), 0.3))
        out.append([r.request_id for r in rep.fail(0.31)])
        rep.restore(0.32)
        out.append((rep.resident_model, rep.report()))
    out.append(swaps)
    return out
