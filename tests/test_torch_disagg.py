"""PyTorch port parity: disaggregated prefill/decode pools.

The port's ``fleet/disagg.py`` and the disaggregated branch of
``fleet/sim.py`` (phase pools, the KV-transfer lane, pool chaos, pool
autoscaling, tenancy's decode-pool KV budgets, displacement mid-decode)
against the JAX package's, priced from the same calibration on both
sides: the H100's, selected through the reference's knob
(KIND_TPU_SIM_CALIBRATION; the reference's own default is a TPU file).
Nothing here touches a device, so the tolerance is exact: reports, as
JSON with sorted keys, are equal. Then the ``disagg-pool-loss`` chaos
scenario and the ``fleet run --engine sim --disagg`` and ``chaos run``
commands against the reference's output.
"""

import json
import re

import pytest

from kind_tpu_sim import chaos as jchaos
from kind_tpu_sim import cli as jcli
from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim_torch import chaos as pchaos
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import fleet as pfleet

from torch_parity import H100_CALIBRATION, sim_fleet_pair


@pytest.fixture(autouse=True)
def h100_calibration(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", H100_CALIBRATION)


BASE = dict(process="poisson", rps=200.0, n_requests=150, max_new=(4, 24))


def _pools(p, d, **kw):
    return dict(replicas=p + d,
                disagg=dict(prefill_replicas=p, decode_replicas=d, **kw))


CASES = {
    "2:2": (_pools(2, 2), BASE, []),
    "1:3": (_pools(1, 3), dict(BASE, rps=400.0), []),
    "2:2 ici int8": (_pools(2, 2, dtype="int8"), BASE, []),
    "2:2 dcn bf16": (_pools(2, 2, tier="dcn"), BASE, []),
    "2:2 dcn int8": (_pools(2, 2, tier="dcn", dtype="int8"), BASE, []),
    "uncalibrated": (_pools(2, 2, calibrated=False), BASE, []),
    "prefill pool loss, kv degrade": (
        _pools(2, 2), dict(BASE, rps=300.0),
        [dict(at_s=0.1, action="prefill_pool_loss", target=0),
         dict(at_s=0.2, action="prefill_pool_restore", target=0),
         dict(at_s=0.15, action="kv_degrade", target=0, param=0.01),
         dict(at_s=0.35, action="kv_restore", target=0)]),
    "displacement mid-decode": (
        _pools(2, 2), dict(BASE, rps=400.0, max_new=(20, 40)),
        [dict(at_s=0.1, action="preempt", target=3),
         dict(at_s=0.25, action="restore", target=3)]),
    "tenancy, kv budgets": (
        dict(_pools(2, 1), tenancy={"bronze": 0.25, "silver": 0.5}),
        dict(BASE, tenancy=True, rps=600.0, n_requests=200), []),
    "autoscaled pools": (
        dict(_pools(1, 1), autoscale=True, eval_every_s=0.05,
             slo=dict(ttft_s=0.3, e2e_s=0.6, itl_s=0.004),
             autoscaler=dict(min_replicas=2, max_replicas=6,
                             up_backlog=2.0, breach_evals=2,
                             cooldown_s=0.1, warmup_s=0.1)),
        dict(BASE, rps=600.0, n_requests=250), []),
    "deadlines": (dict(_pools(2, 1), sim=dict(max_slots=2)),
                  dict(BASE, rps=600.0, deadline_s=0.2), []),
    "overload": (dict(_pools(2, 2), overload=True),
                 dict(BASE, rps=800.0), []),
    "health, a slowed decode replica": (
        dict(_pools(2, 2), health=True), dict(BASE, rps=400.0),
        [dict(at_s=0.05, action="slow", target=2, param=6.0),
         dict(at_s=0.4, action="unslow", target=2)]),
}


@pytest.mark.parametrize("event_core", [None, False],
                         ids=["event core", "plain loop"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_disaggregated_fleet_matches_the_reference(name, event_core):
    fc, spec, events = CASES[name]
    got = sim_fleet_pair(spec, events, event_core=event_core, **fc)
    assert got["ok"]
    dis = got["disagg"]
    served = [e for e in got["completions"] if e["finish_reason"] == "length"]
    assert served and dis["kv"]["handoffs"] >= len(served)
    assert dis["calibration_errors"]["prefill"] == 0.243129
    assert "itl" in got["slo"]
    phases = {r["phase"] for r in got["replicas"].values()}
    assert phases == {"prefill", "decode"}
    if name == "prefill pool loss, kv degrade":
        assert got["preemptions"] == 2
        assert dis["counters"]["prefill_pool_losses"] == 1
    if name == "displacement mid-decode":
        assert got["router"]["requeues"] >= 1
        assert dis["kv"]["handoffs"] > len(served)
    if name == "tenancy, kv budgets":
        assert got["router"]["kv"]["deferred"]
        assert got["tenancy"]["tenants"]["bronze"]["kv_deferred"]
    if name == "autoscaled pools":
        assert dis["counters"].get("decode_scale_ups")
    if name == "deadlines":
        assert got["slo"]["deadline_exceeded"]


def test_pools_and_their_transfer_are_the_reference():
    for spec in ("2:2", "1:3"):
        for tier in (None, "ici", "dcn"):
            for dtype in (None, "bf16", "int8"):
                got = pfleet.DisaggConfig.parse(spec, tier=tier, dtype=dtype)
                want = jfleet.DisaggConfig.parse(spec, tier=tier,
                                                 dtype=dtype)
                assert got.as_dict() == want.as_dict()
    for bad in ("2", "a:b", "0:2"):
        with pytest.raises(ValueError) as want:
            jfleet.DisaggConfig.parse(bad)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            pfleet.DisaggConfig.parse(bad)
    from kind_tpu_sim.fleet import disagg as jdisagg
    from kind_tpu_sim_torch.fleet import disagg as pdisagg

    assert pdisagg.KV_TIERS == jdisagg.KV_TIERS
    for tier in pdisagg.KV_TIERS:
        for factor in (1.0, 0.2, 1e-3):
            for kv in (0, 1, 65536 * 24, 10 ** 9):
                assert (pdisagg.kv_transfer_s(kv, tier, factor)
                        == jdisagg.kv_transfer_s(kv, tier, factor))
    for bad in ("pcie",):
        with pytest.raises(ValueError, match="unknown KV-transfer tier"):
            pdisagg.kv_transfer_s(1, bad)
        with pytest.raises(ValueError, match="unknown KV-transfer tier"):
            pdisagg.resolve_tier(bad)
    with pytest.raises(ValueError, match="unknown serving dtype"):
        pdisagg.resolve_dtype("fp8")
    cal = pfleet.load_calibration()
    for dtype in ("bf16", "int8"):
        for slots in (1, 4, 8):
            assert (pfleet.calibrated_sim_config(cal, dtype, max_slots=slots)
                    .as_dict()
                    == jfleet.calibrated_sim_config(cal, dtype,
                                                    max_slots=slots)
                    .as_dict())


def test_the_knobs_pick_the_tier_and_the_dtype(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_DISAGG_TIER", "dcn")
    monkeypatch.setenv("KIND_TPU_SIM_DISAGG_DTYPE", "int8")
    from kind_tpu_sim.fleet import disagg as jdisagg
    from kind_tpu_sim_torch.fleet import disagg as pdisagg

    assert (pdisagg.resolve_tier(), pdisagg.resolve_dtype()) == (
        jdisagg.resolve_tier(), jdisagg.resolve_dtype()) == ("dcn", "int8")
    assert (pfleet.DisaggConfig.parse("1:1").as_dict()
            == jfleet.DisaggConfig.parse("1:1").as_dict())


def test_a_handoff_reads_as_its_request():
    req = pfleet.TraceRequest("r1", 0.5, (1, 2, 3), 7, 11, prefix_group=2,
                              deadline_s=1.5, tenant="gold", user_id=4)
    h = pfleet.KvHandoff(request=req, dispatch_s=0.6, first_s=0.7,
                         tokens=1, kv_bytes=96, from_replica=0)
    for name in ("request_id", "arrival_s", "deadline_s", "prefix_group",
                 "prompt", "max_new", "seed", "tenant", "user_id", "model"):
        assert getattr(h, name) == getattr(req, name)
    assert h.is_kv_handoff


@pytest.mark.parametrize("change, match", [
    (dict(sched=pfleet.FleetSchedConfig()), "scheduler-backed"),
    (dict(replicas=3), "pool sum"),
    (dict(audit_frac=0.2), "audit_frac"),
])
def test_a_disaggregated_fleet_refuses_what_the_reference_refuses(
        change, match):
    import dataclasses

    cfg = dataclasses.replace(pfleet.FleetConfig(
        replicas=2, disagg=pfleet.DisaggConfig()), **change)
    with pytest.raises(ValueError, match=match):
        pfleet.FleetSim(cfg, [])
    jchange = dict(change)
    if "sched" in jchange:
        jchange["sched"] = jfleet.FleetSchedConfig()
    jcfg = dataclasses.replace(jfleet.FleetConfig(
        replicas=2, disagg=jfleet.DisaggConfig()), **jchange)
    with pytest.raises(ValueError, match=match):
        jfleet.FleetSim(jcfg, [])


@pytest.mark.parametrize("seed", [0, 7])
def test_disagg_pool_loss_matches_the_reference(seed):
    want = jchaos.run_scenario("disagg-pool-loss", seed=seed)
    got = pchaos.run_scenario("disagg-pool-loss", seed=seed)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["ok"] and got["decode_survivors"] > 0


@pytest.mark.parametrize("argv", [
    ["fleet", "run", "--engine", "sim", "--disagg", "2:2", "--requests",
     "200", "--calibration", H100_CALIBRATION],
    ["fleet", "run", "--engine", "sim", "--disagg", "1:3", "--disagg-tier",
     "dcn", "--disagg-dtype", "int8", "--autoscale", "--itl-slo", "0.004",
     "--requests", "200", "--rps", "400"],
    ["chaos", "run", "--scenario", "disagg-pool-loss", "--seed", "3"],
], ids=["fleet run 2:2", "fleet run 1:3 dcn int8 autoscaled",
        "chaos run disagg-pool-loss"])
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_the_commands_match_the_reference(argv, as_json, capsys):
    argv = argv + (["--json"] if as_json else [])
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if not as_json:
        assert got.rstrip().endswith(("FLEET RUN OK", "CHAOS RUN OK"))
