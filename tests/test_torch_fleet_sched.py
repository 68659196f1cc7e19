"""PyTorch port parity: the scheduler-backed engine fleet.

The port's ``FleetSim`` with ``FleetConfig.sched`` (and ``training``)
over ``EngineReplica``s against the JAX package's, with the same config,
trace, chaos events and weights (the reference's init crossed through
numpy; the fleet command's tiny model in fp32, so greedy streams have no
near-ties), through ``torch_parity.fleet_layers_run``:

1. a ``node_fail`` that evicts a serving gang, then ``node_restore``;
2. the rebind preempting a training gang, which still reaches its
   ``total_steps`` with a clean ledger;
3. ``link_degrade`` / ``link_restore`` slowing the engines on a domain;
4. the detector's quarantine and the gray migration of the gang;
5. a ``domain_fault`` over ``rack_pods`` racks, and its restore;
6. an audit conviction (one replica on other weights, a defective
   chip's stand-in) that quarantines a chip and rebinds the gang;
7. ``sdc_train_chip`` and the training gang's bisection;
8. an autoscaler scale-up bound through the scheduler.

Every compared section is equal, the stream crcs included
(``FLEET_COMPARED``: ``scheduler`` and ``training`` too). Then the loop
choices (the event core on and off, the fast-forward off) give the same
report byte for byte, and ``fleet run --sched --train 1`` equals the
reference's command but for the weight-dependent crcs, its
``--profile`` section carrying the reference's keys.
"""

import json

import numpy as np
import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim import profiling as jprofiling
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.weights import params_from_numpy

from torch_parity import (FLEET_CFG, FLEET_COMPARED, fleet_layers_pair,
                          fleet_layers_run, jax_cfg, make_params,
                          one_thread)

BASE = dict(process="poisson", rps=150.0, n_requests=40, max_new=(12, 24))
LLM0 = [dict(name="llm0", topology="2x8", total_steps=80)]
# two serving replicas bind tpu-node-0-0 and -0-1 (sorted node indices 0
# and 1); the training gang takes the other row, tpu-node-0-2 and -0-3.
# Node 1 fails: replica-1 rebinds on node 2, preempting the training gang.
# Node 1 heals, node 2 fails: replica-1 rebinds on node 1. Node 2 heals:
# the row is whole again and the training gang rebinds.
TWO = dict(replicas=2)
SHUFFLE = [dict(at_s=0.08, action="node_fail", target=1),
           dict(at_s=0.2, action="node_restore", target=1),
           dict(at_s=0.3, action="node_fail", target=2),
           dict(at_s=0.45, action="node_restore", target=2)]


@pytest.fixture(scope="module")
def params():
    with one_thread():
        yield make_params(FLEET_CFG)


def _kinds(rep):
    return rep["scheduler"]["event_counts"]


def _ttr_floor(rep):
    s = rep["scheduler"]
    return round(s["bind_s"] + s["flat_warmup_s"], 6)


def test_node_fail_evicts_a_serving_gang_like_the_reference(params):
    sims = []
    got = fleet_layers_pair(
        params, BASE, sched={}, fleet_kw=TWO, sims=sims,
        events=[dict(at_s=0.08, action="node_fail", target=0),
                dict(at_s=0.3, action="node_restore", target=0)])
    assert _kinds(got)["Preempted"] == 1 and _kinds(got)["NodeFailed"] == 1
    assert got["preemptions"] == 1
    ttr = got["scheduler"]["time_to_routable"]
    assert ttr["count"] == 1 and ttr["max_s"] >= _ttr_floor(got)
    # the rebound replica is the evicted engine, healed: no new engine
    port = sims[1]
    assert [r.replica_id for r in port.replicas] == [0, 1]
    assert port.replicas[0].healthy
    assert got["replicas"]["0"]["engine"]["chaos"]["slot_failures"] >= 1


def test_a_rebind_preempts_the_training_gang_like_the_reference(params):
    got = fleet_layers_pair(
        params, BASE, sched={}, fleet_kw=TWO, training=LLM0,
        events=SHUFFLE)
    preempted = [e["gang"] for e in got["scheduler"]["events"]
                 if e["type"] == "Preempted"]
    assert preempted == ["replica-1", "train-llm0", "replica-1"]
    assert got["scheduler"]["time_to_routable"]["count"] == 2
    tr = got["training"]
    gang = tr["gangs"]["llm0"]
    assert tr["all_done"] and tr["ledger_ok"] and tr["lost_steps"] == 0
    assert gang["steps_done"] == 80 and gang["evictions"] == 1
    assert gang["ledger_verify"]["violations"] == []


def test_a_degraded_link_slows_the_engines_like_the_reference(params):
    got = fleet_layers_pair(
        params, BASE, sched={}, fleet_kw=TWO, training=LLM0,
        events=[dict(at_s=0.05, action="link_degrade", target=0,
                     param=0.25),
                dict(at_s=0.25, action="link_restore", target=0)])
    assert _kinds(got)["LinkDegraded"] == 1
    assert _kinds(got)["LinkRestored"] == 1
    assert got["training"]["all_done"]


def test_gray_migration_matches_the_reference(params):
    got = fleet_layers_pair(
        params, dict(BASE, n_requests=80), sched={}, health=True,
        events=[dict(at_s=0.03, action="slow", target=1, param=6.0)])
    assert got["health"]["counters"]["gray_migrations"] >= 1
    assert _kinds(got)["Preempted"] >= 1
    assert got["scheduler"]["time_to_routable"]["count"] >= 1


def test_a_rack_fault_matches_the_reference(params):
    pods = (("tpu-v5-lite-podslice", "4x8"),) * 2
    got = fleet_layers_pair(
        params, BASE, fleet_kw=TWO,
        sched=dict(pods=pods, rack_pods=1),
        events=[dict(at_s=0.08, action="domain_fault", target=0),
                dict(at_s=0.5, action="domain_restore", target=0)])
    assert _kinds(got)["NodeFailed"] == 4
    assert _kinds(got)["Preempted"] == 2
    assert got["integrity"]["counters"] == {"domain_faults": 1,
                                            "domain_restores": 1}


def _defective(params, rid):
    """(JAX, port) weights for replica ``rid``: replica 1's embedding
    rows are reversed, a defective chip's stand-in, so its streams
    differ."""
    import jax

    if rid != 1:
        return params
    tree = jax.tree_util.tree_map(np.asarray, params[0])
    tree["embed"] = tree["embed"][::-1].copy()
    return (jax.tree_util.tree_map(jax.numpy.asarray, tree),
            params_from_numpy(tree, FLEET_CFG, device="cpu"))


def test_an_audit_conviction_rebinds_off_the_chip(params):
    cache = {rid: _defective(params, rid) for rid in range(3)}
    layers = dict(sched={}, audit_frac=0.5)
    want = fleet_layers_run(jfleet, jserving, lambda r: cache[r][0],
                            jax_cfg(FLEET_CFG), BASE, **layers)
    got = fleet_layers_run(pfleet, pserving, lambda r: cache[r][1],
                           FLEET_CFG, BASE, device="cpu", **layers)
    for key in FLEET_COMPARED:
        assert got.get(key) == want.get(key), key
    assert [d["replica"] for d in got["integrity"]["detections"]] == [1]
    assert got["integrity"]["counters"]["chips_quarantined"] == 1
    sdc = [e for e in got["scheduler"]["events"]
           if e["type"] == "Preempted" and e["gang"] == "replica-1"]
    assert len(sdc) == 1 and sdc[0]["message"].startswith("sdc:")


def test_training_chip_bisection_matches_the_reference(params):
    got = fleet_layers_pair(
        params, dict(BASE, n_requests=20), sched={}, fleet_kw=TWO,
        training=LLM0, health=True,
        events=[dict(at_s=0.05, action="sdc_train_chip", target=0,
                     param=1.0)])
    counters = got["integrity"]["counters"]
    assert counters["chips_quarantined"] == 1
    assert counters["bisection_steps"] >= 1
    assert got["training"]["all_done"] and got["training"]["ledger_ok"]


def test_a_scale_up_binds_through_the_scheduler(params):
    sims = []
    layers = dict(sched={}, fleet_kw=dict(
        replicas=1, autoscale=True, eval_every_s=0.05,
        autoscaler=dict(min_replicas=1, max_replicas=3, up_backlog=2.0,
                        breach_evals=2, cooldown_s=0.1)))
    spec = dict(BASE, n_requests=60, rps=400.0)
    want = fleet_layers_run(jfleet, jserving, params[0], jax_cfg(FLEET_CFG),
                            spec, **layers)
    got = fleet_layers_run(pfleet, pserving, params[1], FLEET_CFG, spec,
                           device="cpu", sims=sims, **layers)
    for key in FLEET_COMPARED:
        assert got.get(key) == want.get(key), key
    assert got["autoscaler"]["scale_ups"] >= 1
    assert (got["scheduler"]["time_to_routable"]["count"]
            == got["autoscaler"]["scale_ups"])
    # each new engine is a new object, routable bind_s + warm-up after
    # its request at the earliest
    assert min(sims[0].time_to_routable) >= _ttr_floor(got)
    assert len({id(r) for r in sims[0].replicas}) == len(sims[0].replicas)


@pytest.mark.parametrize("mode", [dict(event_core=False),
                                  dict(event_core=False, fast_forward=False)])
def test_the_loop_choices_give_one_report(params, mode):
    """The event core (the default), the per-tick loop with its
    fast-forward, and the per-tick loop without: the same bytes."""
    layers = dict(sched={}, training=LLM0, health=True, events=SHUFFLE + [
        dict(at_s=0.05, action="link_degrade", target=0, param=0.25),
        dict(at_s=0.25, action="link_restore", target=0),
        dict(at_s=0.9, action="train_preempt", target=0)])
    runs = [fleet_layers_run(pfleet, pserving, params[1], FLEET_CFG,
                             BASE, device="cpu",
                             fleet_kw=dict(TWO, **kw), **layers)
            for kw in ({}, mode)]
    for rep in runs:
        rep["config"].pop("fast_forward", None)
    assert (json.dumps(runs[0], sort_keys=True)
            == json.dumps(runs[1], sort_keys=True))
    assert runs[0]["training"]["gangs"]["llm0"]["evictions"] == 2


def test_the_sched_command_matches_the_reference(capsys):
    argv = ["fleet", "run", "--seed", "4", "--requests", "24", "--sched",
            "--train", "1", "--json"]
    assert jcli.main(argv + ["--engine", "serving"]) == 0
    want = json.loads(capsys.readouterr().out)
    with one_thread():
        assert pcli.main(argv + ["--device", "cpu", "--profile"]) == 0
    got = json.loads(capsys.readouterr().out)
    profile = got.pop("profile")
    for rep in (want, got):
        for entry in rep["completions"]:
            entry.pop("tokens_crc")
    for key in FLEET_COMPARED + ("seed", "engine"):
        assert got.get(key) == want.get(key), key
    assert got["ok"] and got["training"]["all_done"]
    # the reference's profile_fleet_run raises before it returns
    # (ROADMAP C-15): its keys are read from its source
    assert sorted(profile) == ["events_per_s", "lanes", "top_functions",
                               "wall_s"]
    assert set(profile["lanes"]) == set(jprofiling._FLEET_LANE_FNS) | {
        "arrival", "completion", "chaos", "health_probe", "autoscaler",
        "planner", "kv_transfer"}
    assert profile["lanes"]["arrival"]["events"] == 24
    with pytest.raises(SystemExit, match="--train needs --sched"):
        pcli.main(["fleet", "run", "--train", "1", "--device", "cpu"])


@pytest.mark.parametrize("raw", [None, "0", "false", "No", "", "1", "0.5",
                                 "7", "garbage"])
def test_knobs_read_like_the_reference(monkeypatch, raw):
    from kind_tpu_sim.analysis import knobs as jknobs
    from kind_tpu_sim.fleet import autoscaler as jauto
    from kind_tpu_sim.fleet import events as jevents
    from kind_tpu_sim.fleet import sim as jsim
    from kind_tpu_sim_torch.analysis import knobs as pknobs

    for name in pknobs.KNOBS:
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        if name == pknobs.GENERATION:
            # the default is the port's one registered generation, the
            # H100's (the reference's is its TPU v5e); a set value reads
            # the same
            assert pknobs.KNOBS[name][0] == "h100"
            assert pknobs.get(name) == (
                "h100" if raw is None else jknobs.get(name)), raw
            continue
        assert pknobs.get(name) == jknobs.get(name), (name, raw)
        assert pknobs.KNOBS[name][0] == jknobs.REGISTRY[name].default
    for fn, ref in ((pfleet.resolve_tick_s, jsim.resolve_tick_s),
                    (pfleet.resolve_fast_forward, jsim.resolve_fast_forward),
                    (pfleet.resolve_audit_frac, jsim.resolve_audit_frac),
                    (pfleet.resolve_event_core, jevents.resolve_event_core),
                    (pfleet.resolve_warmup_s, jauto.resolve_warmup_s)):
        try:
            want = ref()
        except ValueError:
            with pytest.raises(ValueError):
                fn()
            continue
        assert fn() == want, fn.__name__
