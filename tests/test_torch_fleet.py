"""PyTorch port parity: the serving fleet over real engines.

The port's ``kind_tpu_sim_torch/fleet/`` against the JAX package's
``kind_tpu_sim/fleet/``: seeded traces field for field, SLO accounting,
the router's placements under each policy, and whole engine fleets
(``FleetSim`` over ``EngineReplica``s) with the same config, trace,
chaos events and weights (JAX init, crossed through numpy) on both
sides: fault-free, with a preempt/restore pair, with prefix affinity,
deadlines and a slowed replica, and with the autoscaler. The report's
``requests``, ``completed``, ``virtual_s``, ``slo``, ``router``,
``completions`` (stream crcs included), ``ok``, ``config`` and
``fleet_counters`` must be equal. The model is the reference scenarios'
tiny config in fp32, so greedy streams have no near-ties. Then the
features the port refuses (the scheduler-backed fleet and the loop
choices are held to the reference in ``test_torch_fleet_sched.py``; the
analytic and disaggregated fleets in ``test_torch_sim_replica.py`` and
``test_torch_disagg.py``; the zoo in ``test_torch_zoo.py``), and the
``fleet`` command against the reference's ``fleet --engine serving``;
where a refused flag or field has been ported since (``--engine sim``,
``--disagg``, ``--calibration``, ``--bench``, ``--zoo``,
``--generations``, ``FleetConfig.disagg``, ``.zoo`` and
``.generations``, ``WorkloadSpec.zoo``, ``model_swap_evict``, a fleet
without a factory), its case holds the port's answer to the
reference's, byte for byte (the zoo's on the reference's registry
patched to the port's, ``torch_parity.shared_registry``).
"""

import dataclasses
import json
import pathlib
import random

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch.fleet import sim as psim
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptf

from torch_parity import jax_cfg, make_params, shared_registry, sim_fleet_pair
from torch_parity import torch_one_thread  # noqa: F401

CALIBRATION = pathlib.Path(pfleet.DEFAULT_CALIBRATION)
BENCH_H100 = CALIBRATION.parent / "bench_h100.json"

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq=64, dtype="float32")
SERVING = dict(max_slots=2, max_len=48, chunk=4)

SPECS = {
    "poisson": dict(process="poisson", rps=150.0, n_requests=30),
    "bursty": dict(process="bursty", rps=40.0, n_requests=25,
                   burst_factor=3.0, burst_period_s=0.5),
    "diurnal": dict(process="diurnal", rps=20.0, n_requests=25,
                    diurnal_period_s=3.0, phase_s=0.7),
    "shared prefixes": dict(process="poisson", rps=80.0, n_requests=40,
                            shared_prefix_frac=0.6, prefix_groups=3,
                            prefix_len=5, prompt_len=(3, 12)),
    "deadlines": dict(process="poisson", rps=300.0, n_requests=20,
                      deadline_s=0.25, max_new=(2, 30)),
}


def _traces(spec, seed):
    return (jfleet.generate_trace(jfleet.WorkloadSpec(**spec), seed),
            pfleet.generate_trace(pfleet.WorkloadSpec(**spec), seed))


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_trace_matches_the_reference(name, seed):
    want, got = _traces(SPECS[name], seed)
    assert [r.as_dict() for r in got] == [r.as_dict() for r in want]


def test_trace_files_cross_between_the_packages(tmp_path):
    want, got = _traces(SPECS["shared prefixes"], 3)
    pfleet.save_trace(str(tmp_path / "port.jsonl"), got)
    jfleet.save_trace(str(tmp_path / "ref.jsonl"), want)
    assert ((tmp_path / "port.jsonl").read_bytes()
            == (tmp_path / "ref.jsonl").read_bytes())
    assert jfleet.load_trace(str(tmp_path / "port.jsonl")) == want
    assert ([r.as_dict() for r in
             pfleet.load_trace(str(tmp_path / "ref.jsonl"))]
            == [r.as_dict() for r in got])


def test_seed_falls_back_to_the_environment(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_FLEET_SEED", "11")
    assert pfleet.resolve_seed() == jfleet.resolve_seed() == 11
    assert pfleet.resolve_seed(3) == 3


def test_slo_tracker_matches_the_reference():
    rng = random.Random(5)
    policy = dict(ttft_s=0.2, tpot_s=0.02, e2e_s=1.0)
    want = jfleet.SloTracker(jfleet.SloPolicy(**policy))
    got = pfleet.SloTracker(pfleet.SloPolicy(**policy))
    for _ in range(300):
        arrival = rng.uniform(0, 10)
        first = arrival + rng.expovariate(8.0)
        obs = dict(arrival_s=arrival,
                   first_s=None if rng.random() < 0.05 else first,
                   finish_s=first + rng.expovariate(1.5),
                   tokens=rng.randint(0, 40),
                   shed=rng.random() < 0.05,
                   deadline_exceeded=rng.random() < 0.05)
        assert got.observe(**obs) == want.observe(**obs)
    assert got.report(span_s=12.5) == want.report(span_s=12.5)
    assert got.report() == want.report()


class StubReplica:
    """A replica without an engine: takes up to ``cap`` requests."""

    def __init__(self, rid, cap):
        self.replica_id = rid
        self.healthy = True
        self.cap = cap
        self.held = []

    def outstanding(self):
        return len(self.held)

    def submit(self, req, now):
        if not self.healthy or len(self.held) >= self.cap:
            return False
        self.held.append(req)
        return True


def _route(mod, policy, trace):
    """Drive a router of ``mod`` over four stub replicas: arrivals each
    step, a dispatch pass, seeded completions, one replica failing and
    coming back. Returns the placements, the router outcomes and the
    report."""
    reps = [StubReplica(i, cap=2 + i % 2) for i in range(4)]
    router = mod.Router(reps, policy=policy, max_queue=12, affinity_spill=1)
    rng = random.Random(9)
    placed, outcomes = [], []
    pending = list(trace)
    failed_at = None
    for step in range(200):
        now = step * 0.01
        while pending and pending[0].arrival_s <= now:
            shed = router.offer(pending.pop(0), now)
            if shed is not None:
                outcomes.append((shed.request.request_id, "shed"))
        before = {r.replica_id: len(r.held) for r in reps}
        for comp in router.dispatch(now):
            outcomes.append((comp.request.request_id, comp.finish_reason,
                             comp.finish_s))
        for r in reps:
            for req in r.held[before[r.replica_id]:]:
                placed.append((req.request_id, r.replica_id))
        for r in reps:
            if r.held and rng.random() < 0.5:
                r.held.pop(0)
        if failed_at is None and step >= 20 and reps[1].held:
            failed_at = step
            reps[1].healthy = False
            router.requeue_front(reps[1].held)
            reps[1].held = []
        if failed_at is not None and step == failed_at + 30:
            reps[1].healthy = True
    return placed, outcomes, router.report()


@pytest.mark.parametrize("policy", ["round-robin", "least-outstanding",
                                    "prefix-affinity"])
def test_router_places_like_the_reference(policy):
    spec = dict(SPECS["shared prefixes"], rps=60.0, deadline_s=0.3)
    want_trace, got_trace = _traces(spec, 1)
    want = _route(jfleet, policy, want_trace)
    got = _route(pfleet, policy, got_trace)
    assert got == want
    assert got[2]["requeues"] > 0 and got[2]["routed"] > 30


# -- engine fleets ------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return make_params(CFG)


def _fleet_case(name):
    """(fleet config kwargs, workload spec, chaos events, serving
    config kwargs) of one engine-fleet case."""
    spec = dict(process="poisson", rps=150.0, n_requests=14,
                prompt_len=(3, 8), max_new=(6, 12), vocab=64)
    fc = dict(replicas=2, policy="round-robin", tick_s=0.05,
              slo=dict(ttft_s=1.0, e2e_s=5.0))
    serving = dict(SERVING)
    events = []
    if name == "preempt and restore":
        events = [dict(at_s=0.075, action="preempt", target=1),
                  dict(at_s=0.275, action="restore", target=1)]
    elif name == "affinity, deadlines, a slowed replica":
        spec.update(n_requests=18, shared_prefix_frac=0.5, prefix_groups=2,
                    prefix_len=3, deadline_s=0.6)
        fc.update(policy="prefix-affinity", slo=dict(ttft_s=0.3, e2e_s=0.5))
        serving.update(prefix_cache_entries=2)
        events = [dict(at_s=0.1, action="slow", target=0, param=3.0),
                  dict(at_s=0.4, action="unslow", target=0)]
    elif name == "autoscaler":
        spec.update(n_requests=30, rps=400.0, max_new=(8, 16))
        fc.update(policy="least-outstanding", autoscale=True, max_queue=20,
                  eval_every_s=0.1,
                  autoscaler=dict(min_replicas=1, max_replicas=3,
                                  up_backlog=2.0, breach_evals=2,
                                  cooldown_s=0.2, warmup_s=0.15))
        fc["replicas"] = 1
        serving.update(max_queue=3)
    return fc, spec, events, serving


def _run_fleet(mod, serving_mod, params, cfg, case, device=None):
    fc, spec, events, serving = case
    fc = dict(fc, slo=mod.SloPolicy(**fc["slo"]))
    if "autoscaler" in fc:
        fc["autoscaler"] = mod.AutoscalerConfig(**fc["autoscaler"])
    trace = mod.generate_trace(mod.WorkloadSpec(**spec), 3)
    clock = mod.VirtualClock()
    kw = {} if device is None else {"device": device}

    def factory(rid):
        return mod.EngineReplica(rid, serving_mod.ServingEngine(
            params, cfg, serving_mod.ServingConfig(**serving),
            clock=clock.now, **kw))

    return mod.FleetSim(mod.FleetConfig(**fc), trace,
                        replica_factory=factory,
                        chaos_events=[mod.ChaosEvent(**e) for e in events],
                        clock=clock).run()


COMPARED = ("requests", "completed", "virtual_s", "slo", "router",
            "completions", "ok", "config", "fleet_counters")


@pytest.mark.parametrize("name", [
    "fault-free", "preempt and restore",
    "affinity, deadlines, a slowed replica", "autoscaler"])
def test_engine_fleet_matches_the_reference(params, name):
    jparams, pparams = params
    case = _fleet_case(name)
    want = _run_fleet(jfleet, jserving, jparams, jax_cfg(CFG), case)
    got = _run_fleet(pfleet, pserving, pparams, CFG, case, device="cpu")
    for key in COMPARED:
        assert got[key] == want[key], key
    assert got.get("preemptions") == want.get("preemptions")
    assert got.get("autoscaler") == want.get("autoscaler")
    assert got["ok"]
    if name == "preempt and restore":
        assert got["preemptions"] == 1 and got["router"]["requeues"] >= 1
    if name == "affinity, deadlines, a slowed replica":
        reasons = {e["finish_reason"] for e in got["completions"]}
        assert "deadline_exceeded" in reasons
        assert got["router"]["affinity"]["hits"] > 0
    if name == "autoscaler":
        assert got["autoscaler"]["scale_ups"] >= 1


def test_attainment_over_matches_the_reference():
    log = [{"arrival_s": 0.01 * i, "slo_ok": i % 3 != 0} for i in range(50)]
    for window in [(0.0,), (0.1, 0.3), (0.25,), (1.0,)]:
        assert (pfleet.attainment_over(log, *window)
                == jfleet.attainment_over(log, *window))


# -- refusals -----------------------------------------------------------


def _factory(rid):
    raise AssertionError("no replica is built for a refused config")


def _dumps(report):
    return json.dumps(report, sort_keys=True)


@pytest.mark.parametrize("field", ["disagg", "zoo", "generations"])
def test_refused_fleet_features_raise_naming_them(field, monkeypatch,
                                                  tmp_path):
    # disaggregated pools, the model zoo and per-generation pricing are
    # ported: a replica factory is refused as the reference refuses it,
    # and the fleet's report is the reference's under the same
    # calibration (the zoo and generations: the same registry)
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", str(CALIBRATION))
    shared_registry(monkeypatch, tmp_path)
    reports = []
    for mod in (jfleet, pfleet):
        layer = {"disagg": mod.DisaggConfig(), "zoo": mod.default_zoo(),
                 "generations": ("h100",)}[field]
        cfg = mod.FleetConfig(replicas=2, **{field: layer})
        with pytest.raises(ValueError, match="replica_factory"):
            mod.FleetSim(cfg, [], replica_factory=_factory)
        trace = mod.generate_trace(mod.WorkloadSpec(
            n_requests=40, zoo=layer if field == "zoo" else None), 3)
        reports.append(mod.FleetSim(cfg, trace).run())
    assert _dumps(reports[1]) == _dumps(reports[0])
    assert reports[1]["ok"]
    if field == "disagg":
        assert reports[1]["disagg"]["kv"]["handoffs"] == 40
    else:
        assert reports[1]["generations"] == {"0": "h100", "1": "h100"}
        assert ("zoo" in reports[1]) is (field == "zoo")


def test_the_event_core_audit_lane_and_analytic_replicas_raise():
    # the loop choices run (test_torch_fleet_sched.py holds their
    # reports equal); training without a scheduler still raises, and
    # analytic replicas and the zoo's trace are the reference's
    with pytest.raises(ValueError, match="FleetConfig.sched"):
        pfleet.FleetSim(pfleet.FleetConfig(
            training=pfleet.TrainingConfig()), [],
            replica_factory=lambda rid: StubReplica(rid, 1))
    # a fleet without a factory is the reference's analytic fleet
    got, want = (mod.FleetSim(mod.FleetConfig(), mod.generate_trace(
        mod.WorkloadSpec(n_requests=30), 1)).run()
        for mod in (pfleet, jfleet))
    assert _dumps(got) == _dumps(want) and got["ok"]
    # a zoo's trace is the reference's, models stamped
    got, want = ([r.as_dict() for r in mod.generate_trace(
        mod.WorkloadSpec(zoo=mod.default_zoo()), 0)]
        for mod in (pfleet, jfleet))
    assert got == want and all(r["model"] for r in got)


@pytest.mark.parametrize("action", ["node_drain", "link_degrade",
                                    "train_preempt", "kv_degrade",
                                    "model_swap_evict", "domain_fault"])
def test_chaos_actions_of_unported_layers_raise(action, monkeypatch,
                                                tmp_path):
    if action == "model_swap_evict":
        # the zoo is ported: without one the action raises as the
        # reference's does; a zoo fleet under it reports the reference's
        shared_registry(monkeypatch, tmp_path)
        for mod in (pfleet, jfleet):
            sim = mod.FleetSim(mod.FleetConfig(replicas=1), [], chaos_events=[
                mod.ChaosEvent(at_s=0.0, action=action, target=0)])
            with pytest.raises(ValueError, match="needs a model zoo"):
                sim.run()
        got = sim_fleet_pair(
            dict(n_requests=60, zoo=True), [
                dict(at_s=0.2, action=action, target=0),
                dict(at_s=0.4, action=action, target=0)],
            zoo=True, generations=("h100",))
        assert got["ok"] and got["zoo"]["swaps"]["completed"]
        assert got["zoo"]["swaps"]["completed"] == len(
            got["zoo"]["swaps"]["log"])
        return
    replicas = [StubReplica(0, 1)]
    sim = pfleet.FleetSim(
        pfleet.FleetConfig(replicas=1), [],
        replica_factory=lambda rid: replicas[rid],
        chaos_events=[pfleet.ChaosEvent(at_s=0.0, action=action,
                                        target=0)])
    with pytest.raises(ValueError, match=action):
        sim.run()


def test_engine_fleet_runs_on_the_card_unless_asked(params):
    _, pparams = params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psim.engine_fleet(pfleet.FleetConfig(), [], pparams, CFG,
                          pserving.ServingConfig())


# -- the command --------------------------------------------------------

FLEET_ARGV = ["fleet", "run", "--seed", "5", "--requests", "16", "--rps",
              "150", "--policy", "least-outstanding", "--deadline-s", "0.5",
              "--json"]


def test_fleet_command_matches_the_reference_but_for_the_weights(capsys):
    """The reference's command draws its weights from jax.random and the
    port's from torch.Generator, so the streams' crcs differ; every
    field that does not depend on the weights is the reference's."""
    assert jcli.main(FLEET_ARGV + ["--engine", "serving"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert pcli.main(FLEET_ARGV + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    for rep in (want, got):
        for entry in rep["completions"]:
            entry.pop("tokens_crc")
    for key in COMPARED + ("seed", "engine"):
        assert got[key] == want[key], key
    assert got["engine"] == "serving" and got["ok"]


def test_fleet_trace_command_matches_the_reference(capsys, tmp_path):
    argv = ["fleet", "trace", "--seed", "2", "--requests", "12",
            "--shared-prefix-frac", "0.5", "--process", "bursty"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv) == 0
    assert capsys.readouterr().out == want
    assert pcli.main(argv + ["--save-trace", str(tmp_path / "t.jsonl")]) == 0
    assert "wrote 12 requests" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--engine", "sim"], ["--zoo"],
    ["--disagg", "1:1"], ["--disagg", "2:2", "--disagg-tier", "dcn"],
    ["--generations", "v5e"], ["--disagg", "1:1", "--calibration", "CAL"],
    ["--bench", "BENCH"]])
def test_fleet_command_refuses_the_simulators_layers(extra, capsys,
                                                     monkeypatch, tmp_path,
                                                     caplog):
    argv = ["fleet", "run", "--engine", "sim", "--requests", "60", "--json"]
    if extra[0] in ("--zoo", "--generations"):
        # the zoo is ported (sim engine only); on the same registry its
        # report is the reference's, whose --zoo alone buys TPU
        # generations (the port's buys its one, h100). v5e is no
        # generation of the port's: the reference's "unknown generation"
        shared_registry(monkeypatch, tmp_path)
        if extra == ["--generations", "v5e"]:
            assert jcli.main(argv + extra) == 1
            assert "unknown generation 'v5e'; registered: h100" in (
                caplog.text)
            with pytest.raises(SystemExit,
                               match="unknown generation 'v5e'; "
                                     "registered: h100"):
                pcli.main(argv + extra)
            return
        assert jcli.main(argv + extra + ["--generations", "h100"]) == 0
        want = capsys.readouterr().out
        assert pcli.main(argv + extra) == 0
        assert capsys.readouterr().out == want
        with pytest.raises(SystemExit, match="analytic sim engine"):
            pcli.main(["fleet", "run", "--device", "cpu"] + extra)
        return
    # ported since: the reference's answer, byte for byte, under the
    # same calibration (the reference's --calibration sets the knob)
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", str(CALIBRATION))
    if extra[0] == "--bench":
        outs = []
        for main, name in ((jcli.main, "ref.json"), (pcli.main, "port.json")):
            out = tmp_path / name
            # prefill's error is 0.243129, over the 0.15 bar: exit 1
            assert main(["fleet", "calibrate", "--bench", str(BENCH_H100),
                         "--out", str(out)]) == 1
            outs.append(capsys.readouterr().out.replace(str(out), "OUT"))
            assert out.read_text() == CALIBRATION.read_text()
        assert outs[1] == outs[0]
        return
    extra = [str(CALIBRATION) if a == "CAL" else a for a in extra]
    assert jcli.main(argv + extra) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv + extra) == 0
    assert capsys.readouterr().out == want
    with pytest.raises(SystemExit, match="no device work"):
        pcli.main(argv + extra + ["--device", "cpu"])


def test_fleet_command_refuses_a_trace_outside_the_envelope(tmp_path):
    path = tmp_path / "wide.jsonl"
    pfleet.save_trace(str(path), pfleet.generate_trace(
        pfleet.WorkloadSpec(n_requests=3, vocab=500), 0))
    with pytest.raises(SystemExit, match="envelope"):
        pcli.main(["fleet", "run", "--device", "cpu", "--trace-file",
                   str(path)])
