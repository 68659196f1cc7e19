"""PyTorch port parity: the model zoo and the generation registry.

The port's ``fleet/zoo.py``, the generation registry of
``fleet/costmodel.py``, the zoo's paths through ``SimReplica``, the
router and ``FleetSim``, ``fleet run --zoo --generations`` and the
``zoo-swap-storm`` scenario, against the JAX package's.

The reference prices generations from TPU files; the port registers one
generation, ``h100``, whose file is the H100's calibration plus the
generation's metadata. Each parity case patches the reference's registry
to the port's for the test alone (``torch_parity.shared_registry``:
``GENERATIONS``, ``CALIBRATION_DIR``, ``GENERATION_FACTS["h100"]``,
``ACCELERATOR_GENERATIONS`` and KIND_TPU_SIM_GENERATION), and a
mixed-generation case registers a second generation, ``half``, on both
sides (``HALF``'s facts; its file derived by the port's
``derive_generation``), which exists only in the test. The reports, as
JSON with sorted keys, are equal, under the event core and the plain
loop, with the columnar mirror on and off. The one departure is ROADMAP
C-17, pinned as ``test_fleet_layers.py`` pins it: under overload a
preempted replica's stale hedge timer makes the reference queue a
duplicate on the replica that holds the request, and the port skips it.
"""

import dataclasses
import json
import pathlib

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim import cli as jcli
from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim.fleet import costmodel as jcost
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch import topology as ptopo
from kind_tpu_sim_torch.fleet import costmodel as pcost

from torch_parity import shared_registry, sim_fleet_pair, sim_fleet_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
CALIBRATION = ROOT / "kind_tpu_sim_torch" / "calibration"

# the test-only second generation: half the H100's rates, 16 GiB
HALF = {"half": {"compute_ratio": 0.5, "bandwidth_ratio": 0.5,
                 "hbm_gib": 16.0, "chip_second_cost": 0.5}}

ZOO_SPEC = dict(process="poisson", rps=60.0, n_requests=240,
                prompt_len=(4, 16), max_new=(8, 24), zoo=True)

# total_memory of an NVIDIA H100 80GB HBM3, as torch reports it
H100_TOTAL_MEMORY = 85_017_493_504


def _dumps(report):
    return json.dumps(report, sort_keys=True)


@pytest.fixture
def registry(monkeypatch, tmp_path):
    """The reference priced from the port's registry."""
    return shared_registry(monkeypatch, tmp_path)


@pytest.fixture
def mixed(monkeypatch, tmp_path):
    """The port's registry plus the test-only ``half``, on both sides."""
    return shared_registry(monkeypatch, tmp_path, extra=HALF)


# -- the registry ------------------------------------------------------


def test_the_port_registers_the_h100_alone():
    assert pcost.GENERATIONS == ("h100",)
    assert pcost.DEFAULT_GENERATION == "h100"
    assert sorted(pcost.GENERATION_FACTS) == ["h100"]
    facts = pcost.GENERATION_FACTS["h100"]
    assert facts == {"compute_ratio": 1.0, "bandwidth_ratio": 1.0,
                     "hbm_gib": round(H100_TOTAL_MEMORY / 2**30, 2),
                     "chip_second_cost": 1.0}
    files = sorted(p.name for p in pcost.CALIBRATION_DIR.iterdir())
    assert files == ["h100.json"]
    assert pcost.generation_path("h100") == (
        CALIBRATION / "generations" / "h100.json")


def test_the_generation_file_is_the_default_calibration_plus_metadata():
    gen = json.loads(pcost.generation_path("h100").read_text())
    meta = {k: gen.pop(k) for k in ("generation", "hbm_gib",
                                    "chip_second_cost")}
    assert meta == {"generation": "h100", "hbm_gib": 79.18,
                    "chip_second_cost": 1.0}
    assert gen == json.loads((CALIBRATION / "h100.json").read_text())
    assert gen["backend"] == "gpu"
    cal = pfleet.load_generation("h100")
    assert cal["decode"]["bf16"]["achieved_gbps"] == 260.4
    # the file is what the registry would write for its anchor
    with open(pcost.generation_path("h100"), encoding="utf-8") as fh:
        text = fh.read()
    assert text == json.dumps(cal, indent=1, sort_keys=True) + "\n"


def test_every_port_label_prices_as_the_h100():
    assert sorted(pcost.ACCELERATOR_GENERATIONS) == sorted(
        ptopo.ACCELERATORS)
    for accel in ptopo.ACCELERATORS:
        assert pfleet.generation_of_accelerator(accel) == "h100"
        _, slice_topo = pcost.GENERATION_SCHED_TOPOLOGY[accel]
        sl = ptopo.make_slice(accel, slice_topo)
        assert sl.node_labels(0)[ptopo.LABEL_ACCELERATOR] == accel
    assert pcost.GENERATION_ACCELERATORS == {
        "h100": ptopo.DEFAULT_ACCELERATOR}
    assert pcost.GENERATION_SCHED_TOPOLOGY == jcost.GENERATION_SCHED_TOPOLOGY


def test_derivation_keeps_the_rule_and_the_errors(mixed):
    base = pfleet.load_generation("h100")
    got = pfleet.load_generation("half")
    assert got == pcost.derive_generation(base, "half")
    assert got == jcost.derive_generation(base, "half")
    assert got == jfleet.load_generation("half")
    assert got["prefill"]["analytic_tokens_per_s"] == round(
        base["prefill"]["analytic_tokens_per_s"] * 0.5, 3)
    assert got["prefill"]["error_frac"] == base["prefill"]["error_frac"]
    for dtype, d in got["decode"].items():
        assert d["achieved_gbps"] == round(
            base["decode"][dtype]["achieved_gbps"] * 0.5, 3)
        assert abs(d["error_frac"]
                   - base["decode"][dtype]["error_frac"]) < 1e-3
    assert (got["hbm_gib"], got["chip_second_cost"]) == (16.0, 0.5)


def test_unregistered_names_fail_loudly(registry, tmp_path):
    for mod in (pfleet, jfleet):
        with pytest.raises(ValueError,
                           match="unknown generation 'v5e'; registered: "
                                 "h100$"):
            mod.load_generation("v5e")
        with pytest.raises(ValueError, match="unknown generation 'v6'"):
            mod.resolve_generation("v6")
        with pytest.raises(ValueError, match="no registered generation"):
            mod.generation_of_accelerator("nvidia-h100")
        with pytest.raises(ValueError, match="unknown generation 'v5p'"):
            mod.FleetSim(mod.FleetConfig(generations=("h100", "v5p")), [])
    assert pfleet.resolve_generation() == jfleet.resolve_generation() == (
        "h100")


def test_a_file_that_names_another_generation_is_refused(monkeypatch,
                                                        tmp_path):
    cal = json.loads(pcost.generation_path("h100").read_text())
    cal["generation"] = "v5e"
    (tmp_path / "h100.json").write_text(json.dumps(cal))
    monkeypatch.setattr(pcost, "CALIBRATION_DIR", tmp_path)
    with pytest.raises(ValueError, match="declares generation 'v5e'"):
        pfleet.load_generation("h100")


def test_fits_reads_the_port_registry():
    """``h100.json`` carries no ``hbm_gib``: the fit check falls back to
    the registry's h100 (79.18 GiB), never to a TPU's 16 GiB, so every
    model of the default zoo fits the card."""
    zoo = pfleet.default_zoo()
    default = pfleet.load_calibration()
    assert "hbm_gib" not in default
    assert [pfleet.fits(m, default) for m in zoo.models] == [True] * 3
    assert [pfleet.fits(m, pfleet.load_generation("h100"))
            for m in zoo.models] == [True] * 3
    # a model over 80% of 79.18 GiB does not
    big = pfleet.ModelSpec("big", weight_mb=68_100.0)
    assert not pfleet.fits(big, default)
    assert pfleet.placements(zoo, ("h100",)) == ["large"]


# -- stamps and configs -------------------------------------------------


@pytest.mark.parametrize("tenancy", [False, True],
                         ids=["anonymous", "tenants"])
def test_model_stamps_ride_a_fresh_stream(tenancy):
    traces = []
    for mod in (pfleet, jfleet):
        kw = dict(process="poisson", rps=60.0, n_requests=200,
                  prompt_len=(4, 16), max_new=(8, 24))
        if tenancy:
            kw["tenancy"] = mod.default_tenancy()
        plain = mod.generate_trace(mod.WorkloadSpec(**kw), 7)
        zoo = mod.default_zoo()
        if tenancy:
            zoo = dataclasses.replace(zoo, tenant_mixes=(
                ("bronze", (("large", 1.0),)),))
        zooed = mod.generate_trace(mod.WorkloadSpec(zoo=zoo, **kw), 7)
        assert [dataclasses.replace(z, model="") for z in zooed] == plain
        assert all("model" not in r.as_dict() for r in plain)
        traces.append([r.as_dict() for r in zooed])
    assert traces[0] == traces[1]
    assert len({r["model"] for r in traces[0]}) == 3
    if tenancy:
        assert {r["model"] for r in traces[0]
                if r["tenant"] == "bronze"} == {"large"}


def test_zoo_configs_match_and_round_trip(monkeypatch):
    for n in (1, 2, 3, 7):
        got = pfleet.default_zoo(n)
        assert got.as_dict() == jfleet.default_zoo(n).as_dict()
        assert pfleet.zoo_config_from_dict(got.as_dict()) == got
    monkeypatch.setenv("KIND_TPU_SIM_ZOO_MODELS", "2")
    assert pfleet.default_zoo().names() == ["small", "medium"]
    zoo = pfleet.ZooConfig(
        models=(pfleet.ModelSpec("a", 1.0), pfleet.ModelSpec("b", 2.0, 3.0)),
        mix=(("a", 2.0),), tenant_mixes=(("gold", (("b", 1.0),)),))
    assert pfleet.zoo_config_from_dict(zoo.as_dict()) == zoo
    assert zoo.mix_for("gold") == (("b", 1.0),) and zoo.mix_for("x") == (
        ("a", 2.0),)
    for mod in (pfleet, jfleet):
        for bad, match in (
                (dict(models=()), "at least one model"),
                (dict(models=(mod.ModelSpec("a", 1.0),) * 2), "duplicate"),
                (dict(models=(mod.ModelSpec("a", 1.0),),
                      mix=(("z", 1.0),)), "unknown model 'z'")):
            with pytest.raises(ValueError, match=match):
                mod.ZooConfig(**bad)
        with pytest.raises(ValueError, match="weight_mb must be > 0"):
            mod.ModelSpec("a", 0.0)


def test_unzooed_wire_formats_carry_no_zoo_keys():
    spec = pfleet.WorkloadSpec(n_requests=40)
    cfg = pfleet.FleetConfig(replicas=2, policy="least-outstanding")
    assert not any("zoo" in k or "generation" in k for k in cfg.as_dict())
    rep = pfleet.FleetSim(cfg, pfleet.generate_trace(spec, 7)).run()
    assert "zoo" not in rep and "generations" not in rep
    assert "zoo" not in rep["router"]
    assert all("model" not in e for e in rep["completions"])
    assert all("zoo" not in r for r in rep["replicas"].values())


# -- prices -------------------------------------------------------------


@pytest.mark.parametrize("factor", [None, "0", "2.5"])
def test_prices_match_the_reference(mixed, monkeypatch, factor):
    if factor is not None:
        monkeypatch.setenv("KIND_TPU_SIM_ZOO_SWAP_FACTOR", factor)
    zoo_p, zoo_j = pfleet.default_zoo(), jfleet.default_zoo()
    for gen in mixed:
        cal = pfleet.load_generation(gen)
        for m_p, m_j in zip(zoo_p.models, zoo_j.models):
            assert pfleet.swap_s(m_p, cal) == jfleet.swap_s(m_j, cal)
            assert pfleet.fits(m_p, cal) == jfleet.fits(m_j, cal)
        got = pfleet.model_sim_config(zoo_p, cal, max_slots=4,
                                      resident_model="small")
        want = jfleet.model_sim_config(zoo_j, cal, max_slots=4,
                                       resident_model="small")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.as_dict() == want.as_dict()
    with pytest.raises(ValueError, match="'large' does not fit"):
        pfleet.model_sim_config(zoo_p, pfleet.load_generation("half"),
                                resident_model="large")
    half = pfleet.load_generation("half")
    assert [pfleet.fits(m, half) for m in zoo_p.models] == [
        True, False, False]
    for lmg in (None, "h100", "half"):
        gens = ("h100", "half", "h100")
        assert (pfleet.placements(zoo_p, gens, large_model_gen=lmg)
                == jfleet.placements(zoo_j, gens, large_model_gen=lmg))


def test_the_storm_verdict_is_the_decode_bandwidths_arithmetic():
    """On the H100's calibration decode reads at 260.4 GB/s: the 60 GB
    model decodes at about 29.6 ms a token across 8 slots and loads in
    about 1.84 s (at 0.125 of that rate)."""
    cal = pfleet.load_generation("h100")
    zoo = pfleet.default_zoo()
    rcfg = pfleet.model_sim_config(zoo, cal)
    tpot = dict(rcfg.model_tpot_s)
    assert abs(tpot["large"] - 0.0296) < 2e-4
    assert abs(pfleet.swap_s(zoo.model("large"), cal) - 1.843) < 1e-3
    assert pfleet.SwapEvent(1, "a", "b", 0.1234567891).as_dict() == {
        "replica_id": 1, "model": "a", "evicted": "b",
        "ready_s": 0.123456789}


# -- fleets -------------------------------------------------------------


ZOO_CASES = {
    "one generation": dict(zoo=True),
    "the default generation": dict(zoo=True, generations=None),
    "mixed": dict(zoo=True, generations=("h100", "half")),
    "mixed, large on h100": dict(zoo=True, generations=("half", "h100"),
                                 zoo_large_model_gen="h100"),
    "round-robin, prefixes": dict(zoo=True, policy="round-robin",
                                  spec=dict(shared_prefix_frac=0.5)),
    "generations alone": dict(generations=("half", "h100"), spec=dict(
        zoo=None)),
    "tenants": dict(zoo=True, tenancy=True, spec=dict(tenancy=True)),
    "autoscaler": dict(
        zoo=True, generations=("h100", "half"), replicas=2,
        autoscale=True, eval_every_s=0.05,
        autoscaler=dict(min_replicas=2, max_replicas=5, up_backlog=2.0,
                        breach_evals=2, cooldown_s=0.1, warmup_s=0.1),
        spec=dict(rps=200.0)),
    "health, slow chaos": dict(
        zoo=True, health=True, spec=dict(rps=120.0),
        events=[dict(at_s=0.5, action="slow", target=1, param=4.0),
                dict(at_s=2.0, action="unslow", target=1)]),
    "preempt, restore, swap evict": dict(
        zoo=True, generations=("h100", "half"), spec=dict(rps=120.0),
        events=[dict(at_s=0.5, action="preempt", target=0),
                dict(at_s=1.0, action="model_swap_evict", target=0),
                dict(at_s=1.5, action="restore", target=0),
                dict(at_s=2.5, action="model_swap_evict", target=0)]),
    "sched": dict(zoo=True, replicas=2, sched={}),
    "sdc, audits": dict(
        zoo=True, audit_frac=0.5,
        events=[dict(at_s=0.3, action="sdc_chip", target=1, param=0.5)]),
}


def _zoo_case(name):
    fc = dict(ZOO_CASES[name])
    spec = dict(ZOO_SPEC, **fc.pop("spec", {}))
    if spec.get("zoo") is None:
        spec.pop("zoo")
    events = fc.pop("events", [])
    fc.setdefault("replicas", 4)
    if "generations" not in fc:
        fc["generations"] = ("h100",)
    elif fc["generations"] is None:
        del fc["generations"]
    return spec, events, fc


@pytest.mark.parametrize("columnar", [False, True],
                         ids=["per-object", "columnar"])
@pytest.mark.parametrize("event_core", [None, False],
                         ids=["event core", "plain loop"])
@pytest.mark.parametrize("name", sorted(ZOO_CASES))
def test_zoo_fleet_matches_the_reference(mixed, name, event_core, columnar):
    spec, events, fc = _zoo_case(name)
    got = sim_fleet_pair(spec, events, event_core=event_core,
                         columnar=columnar, **fc)
    assert got["ok"]
    gens = fc.get("generations", ("h100",))
    if "sched" not in fc:
        assert got["generations"] == {
            rid: gens[int(rid) % len(gens)] for rid in got["replicas"]}
    if "zoo" not in fc:
        assert "zoo" not in got
        return
    zoo = got["zoo"]
    assert zoo["swaps"]["completed"] == len(zoo["swaps"]["log"])
    assert set(zoo["per_model_slo"]) <= {"small", "medium", "large"}
    routes = got["router"]["zoo"]
    assert routes["warm_routes"] + routes["cold_routes"] == (
        got["router"]["routed"])
    if name == "autoscaler":
        assert got["autoscaler"]["scale_ups"] >= 1
    if name.startswith("preempt"):
        assert got["preemptions"] == 1


def test_a_model_no_replica_fits_is_shed(mixed):
    """A fleet of ``half`` replicas (16 GiB) holds only the small model:
    requests for medium and large shed at the router, as the
    reference's do."""
    got = sim_fleet_pair(ZOO_SPEC, zoo=True, generations=("half",))
    shed = [e for e in got["completions"] if e["finish_reason"] == "shed"]
    assert shed and {e["model"] for e in shed} == {"medium", "large"}
    assert got["router"]["shed"] == len(shed)
    assert set(got["zoo"]["residents"].values()) == {"small"}


def test_the_swap_lane_replays(registry):
    spec, events, fc = _zoo_case("preempt, restore, swap evict")
    fc["generations"] = ("h100",)
    sims = []
    reports = [_dumps(sim_fleet_run(pfleet, spec, events, sims=sims,
                                    event_core=ec, **fc))
               for ec in (True, True, False)]
    assert reports[0] == reports[1] == reports[2]
    rep = json.loads(reports[0])
    log = rep["zoo"]["swaps"]["log"]
    assert log == sorted(log, key=lambda e: e["ready_s"])
    assert rep["zoo"]["counters"]["model_swaps"] == len(log)
    assert rep["zoo"]["swaps"]["completed"] == sum(
        r["zoo"]["swaps"] for r in rep["replicas"].values())
    assert not sims[0]._swap_heap


def test_warm_beats_cold_ttft(registry):
    """One replica, one model twice: the first admission pays the
    model's load, the second is warm."""
    reports = []
    for mod in (pfleet, jfleet):
        spec = mod.WorkloadSpec(process="poisson", rps=0.2, n_requests=2,
                                prompt_len=(8, 8), max_new=(4, 4))
        trace = [dataclasses.replace(r, model="medium")
                 for r in mod.generate_trace(spec, 3)]
        cfg = mod.FleetConfig(replicas=1, policy="least-outstanding",
                              zoo=mod.default_zoo(), generations=("h100",))
        reports.append(mod.FleetSim(cfg, trace).run())
    got, want = reports
    assert _dumps(got) == _dumps(want)
    assert got["zoo"]["swaps"]["completed"] == 1
    assert got["zoo"]["residents"] == {"0": "medium"}
    cold, warm = sorted(got["completions"], key=lambda e: e["arrival_s"])
    swap = pfleet.swap_s(pfleet.default_zoo().model("medium"),
                         pfleet.load_generation("h100"))
    gap = ((cold["first_s"] - cold["arrival_s"])
           - (warm["first_s"] - warm["arrival_s"]))
    assert gap >= 0.9 * swap


def test_a_zoo_refuses_a_factory_and_disagg(registry):
    for mod in (pfleet, jfleet):
        with pytest.raises(ValueError, match="replica_factory"):
            mod.FleetSim(mod.FleetConfig(zoo=mod.default_zoo()), [],
                         replica_factory=lambda rid: None)
        with pytest.raises(ValueError, match="do not compose"):
            mod.FleetSim(mod.FleetConfig(
                replicas=2, generations=("h100",),
                disagg=mod.DisaggConfig()), [])


def test_a_stale_hedge_timer_skips_the_holder_in_a_zoo(registry,
                                                      monkeypatch):
    """C-17 in a zoo fleet (overload on, replica 0 preempted and
    restored): the reference queues a duplicate on the replica running
    the request and its report departs from the port's from that hedge
    on; the port skips the holder, and every request completes once."""
    outcomes = []
    for mod in (jfleet, pfleet):
        twice = []
        submit = mod.SimReplica.submit

        def spy(self, req, now, submit=submit, twice=twice):
            rid = req.request_id
            if (any(r.request_id == rid for r in self.queue)
                    or any(s is not None and s["req"].request_id == rid
                           for s in self._slots)):
                twice.append(rid)
            return submit(self, req, now)

        monkeypatch.setattr(mod.SimReplica, "submit", spy)
        rep = sim_fleet_run(
            mod, dict(process="poisson", rps=600.0, n_requests=60,
                      max_new=(12, 24), zoo=True),
            [dict(at_s=0.02, action="preempt", target=0),
             dict(at_s=0.2, action="restore", target=0)],
            replicas=2, overload=True, zoo=True, generations=("h100",))
        outcomes.append((twice, rep))
    (twice, want), (none, got) = outcomes
    assert twice and want["ok"]
    assert want["overload"]["counters"]["hedge_wins"] == len(twice)
    assert none == [] and got["ok"] and got["completed"] == 60
    assert "hedge_wins" not in got["overload"]["counters"]


# -- zoo-swap-storm -------------------------------------------------------


@pytest.fixture
def storm_registry(registry, monkeypatch):
    """The reference's scenario buys ("v5e", "v5p"); on the shared
    registry it runs on the port's generations instead, with every other
    field of its config as it builds it."""
    real = jfleet.FleetConfig

    def config(**kw):
        if kw.get("generations") == ("v5e", "v5p"):
            kw["generations"] = tuple(pcost.GENERATIONS)
        return real(**kw)

    monkeypatch.setattr(jfleet, "FleetConfig", config)
    return registry


@pytest.mark.parametrize("seed", [0, 7])
def test_zoo_swap_storm_matches_the_reference(storm_registry, seed):
    want = jchaos.run_scenario("zoo-swap-storm", seed=seed)
    got = pchaos.run_scenario("zoo-swap-storm", seed=seed)
    assert _dumps(got) == _dumps(want)
    assert got["generations"] == ["h100"] and got["replay_identical"]
    assert got["swaps_storm"] >= got["swaps_steady"]
    if seed == 0:
        # six H100 replicas fail the 1.25 bound: the decode bandwidth's
        # arithmetic, recorded and not tuned away
        assert got["ok"] is False
        assert (got["p99_steady_s"], got["p99_storm_s"], got["p99_ratio"],
                got["swaps_steady"], got["swaps_storm"]) == (
            6.658344, 11.734277, 1.762342, 63, 313)


def test_the_storm_command_matches_the_reference(storm_registry, capsys):
    argv = ["chaos", "run", "--scenario", "zoo-swap-storm", "--seed", "0"]
    for extra in (["--json"], []):
        assert jcli.main(argv + extra) == 1
        want = capsys.readouterr().out
        assert pcli.main(argv + extra) == 1
        assert capsys.readouterr().out == want
    assert want.rstrip().endswith("CHAOS RUN FAILED")


# -- the command ----------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--zoo"], ["--zoo", "--generations", "half,h100"],
    ["--zoo", "--policy", "least-outstanding", "--no-event-core"],
    ["--generations", "h100", "--replicas", "3"]])
def test_fleet_run_zoo_matches_the_reference(mixed, extra, capsys):
    argv = ["fleet", "run", "--engine", "sim", "--requests", "120",
            "--json"] + extra
    # the reference's --zoo alone buys ("v5e", "v5p"): name the port's
    want_argv = argv + (["--generations", "h100"]
                        if extra == ["--zoo"] or "--policy" in extra
                        else [])
    assert jcli.main(want_argv) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    rep = json.loads(got)
    assert rep["ok"] and rep["config"]["generations"]


def test_fleet_run_zoo_refusals(capsys):
    base = ["fleet", "run", "--requests", "8"]
    with pytest.raises(SystemExit, match="analytic sim engine"):
        pcli.main(base + ["--zoo", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--disagg"):
        pcli.main(base + ["--engine", "sim", "--zoo", "--disagg", "1:1"])
    with pytest.raises(SystemExit, match="drop --device"):
        pcli.main(["fleet", "tune", "--zoo", "--device", "cpu"])
    assert pcli.main(["fleet", "trace", "--zoo", "--requests", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and all('"model"' in ln for ln in lines)
