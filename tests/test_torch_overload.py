"""PyTorch port parity: overload containment.

The port's ``kind_tpu_sim_torch/fleet/overload.py`` against the JAX
package's ``kind_tpu_sim/fleet/overload.py``: the config with every
field in order and its defaults, the low-tier hash, and each control
(``TokenBucket``, ``LatencyQuantile``, ``CircuitBreaker``,
``BrownoutController``, ``OverloadState``) driven through the same
seeded event sequence on both sides, their state and reports equal
after every event; then ``surge_trace`` item for item. All host logic:
exact equality. Then the ``fleet`` command with the control layers'
flags (``--health --overload --tenancy --audit-frac``, and ``--tenancy
--no-tenant-isolation``) against the reference's ``fleet --engine
serving``: every field that does not depend on the weights equal.
"""

import dataclasses
import json
import random

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim.fleet import loadgen as jloadgen
from kind_tpu_sim.fleet import overload as jov
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch.fleet import loadgen as ploadgen
from kind_tpu_sim_torch.fleet import overload as pov

from torch_parity import FLEET_COMPARED, one_thread

SEEDS = (0, 7, 12345)


def test_config_fields_and_defaults_match_the_reference():
    want = [(f.name, f.default) for f in dataclasses.fields(
        jov.OverloadConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(
        pov.OverloadConfig)] == want
    assert pov.OverloadConfig().as_dict() == jov.OverloadConfig().as_dict()
    assert (pov.OverloadConfig.uncontrolled(5, 0.1).as_dict()
            == jov.OverloadConfig.uncontrolled(5, 0.1).as_dict())
    custom = dict(retry_budget_ratio=0.3, hedge_quantile=0.9,
                  breaker_window=5, brownout=False)
    assert (pov.OverloadConfig(**custom).as_dict()
            == jov.OverloadConfig(**custom).as_dict())


def test_resolvers_take_the_reference_defaults(monkeypatch):
    for name in ("RETRY_BUDGET", "HEDGE_QUANTILE", "BREAKER_WINDOW",
                 "BROWNOUT"):
        monkeypatch.delenv(f"KIND_TPU_SIM_OVERLOAD_{name}", raising=False)
    for fn in ("resolve_retry_budget", "resolve_hedge_quantile",
               "resolve_breaker_window", "resolve_brownout"):
        assert getattr(pov, fn)() == getattr(jov, fn)()
        assert getattr(pov, fn)(3) == getattr(jov, fn)(3)


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25, 0.5, 1.0])
def test_request_tier_matches_the_reference(frac):
    ids = [f"f{i:05d}" for i in range(300)] + [
        f"f{i:05d}~r{k}" for i in range(20) for k in (1, 2)]
    assert ([pov.request_tier(i, frac) for i in ids]
            == [jov.request_tier(i, frac) for i in ids])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ratio,burst", [(0.1, 10.0), (0.5, 2.0),
                                         (0.0, 4.0)])
def test_token_bucket_matches_the_reference(seed, ratio, burst):
    rng = random.Random(seed)
    want, got = jov.TokenBucket(ratio, burst), pov.TokenBucket(ratio, burst)
    for _ in range(200):
        if rng.random() < 0.5:
            n = rng.randint(1, 3)
            want.earn(n)
            got.earn(n)
        else:
            assert got.spend() == want.spend()
        assert got.report() == want.report()
    assert got.disabled == want.disabled


@pytest.mark.parametrize("seed", SEEDS)
def test_latency_quantile_matches_the_reference(seed):
    rng = random.Random(seed)
    want = jov.LatencyQuantile(0.95, 0.02, 16)
    got = pov.LatencyQuantile(0.95, 0.02, 16)
    for _ in range(120):
        sample = rng.choice([-1.0, rng.expovariate(20.0),
                             rng.uniform(0.0, 3.0)])
        want.observe(sample)
        got.observe(sample)
        assert got.delay_s() == want.delay_s()


def _breaker_events(seed, n=300):
    rng = random.Random(seed)
    now = 0.0
    for _ in range(n):
        now = round(now + rng.expovariate(40.0), 6)
        yield rng.choice(["allow", "dispatch", "record"]), now, (
            rng.random() < 0.45)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", [dict(), dict(breaker_window=6,
                                             breaker_min_samples=4,
                                             breaker_probe_n=1)])
def test_circuit_breaker_matches_the_reference(seed, cfg):
    want = jov.CircuitBreaker(jov.OverloadConfig(**cfg), "replica-0")
    got = pov.CircuitBreaker(pov.OverloadConfig(**cfg), "replica-0")
    for action, now, ok in _breaker_events(seed):
        if action == "allow":
            assert got.allow(now) == want.allow(now)
        elif action == "dispatch":
            want.note_dispatch()
            got.note_dispatch()
        else:
            want.record(ok, now)
            got.record(ok, now)
        assert got.state == want.state
        assert got.half_open_inflight == want.half_open_inflight
    assert got.report() == want.report()
    assert want.opens > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("brownout", [None, False])
def test_brownout_ladder_matches_the_reference(seed, brownout):
    want = jov.BrownoutController(jov.OverloadConfig(brownout=brownout))
    got = pov.BrownoutController(pov.OverloadConfig(brownout=brownout))
    rng = random.Random(seed)
    for i in range(600):
        # a breach phase, a recovery phase, a breach phase
        p_ok = 0.2 if (i // 150) % 2 == 0 else 0.95
        ok = rng.random() < p_ok
        want.observe(ok)
        got.observe(ok)
        if i % 5 == 0:
            want.evaluate(i * 0.01)
            got.evaluate(i * 0.01)
        max_new = rng.randint(1, 30)
        assert got.cap_max_new(max_new) == want.cap_max_new(max_new)
        assert got.sheds_tier(i % 2) == want.sheds_tier(i % 2)
        assert got.hedging_allowed() == want.hedging_allowed()
    assert got.report() == want.report()
    if brownout is None:
        assert [t["direction"] for t in want.transitions][:2] == [
            "escalate", "escalate"]


@pytest.mark.parametrize("seed", SEEDS)
def test_overload_state_matches_the_reference(seed):
    cfg = dict(breaker_window=8, breaker_min_samples=4,
               retry_budget_burst=3.0, hedge_budget_burst=2.0)
    want = jov.OverloadState(jov.OverloadConfig(**cfg))
    got = pov.OverloadState(pov.OverloadConfig(**cfg))
    rng = random.Random(seed)
    tenants = ["", "", "gold", "bronze"]
    now = 0.0
    for _ in range(400):
        now = round(now + rng.expovariate(50.0), 6)
        tenant = rng.choice(tenants)
        target = f"replica-{rng.randrange(3)}"
        op = rng.randrange(7)
        if op == 0:
            want.earn_retry("local", tenant)
            got.earn_retry("local", tenant)
        elif op == 1:
            assert (got.spend_retry("local", tenant)
                    == want.spend_retry("local", tenant))
        elif op == 2:
            assert got.spend_hedge(tenant) == want.spend_hedge(tenant)
        elif op == 3:
            sample = rng.expovariate(10.0)
            want.observe_service(sample, tenant)
            got.observe_service(sample, tenant)
        elif op == 4:
            assert (got.breaker_allows(target, now)
                    == want.breaker_allows(target, now))
            want.breaker_dispatch(target)
            got.breaker_dispatch(target)
        elif op == 5:
            ok = rng.random() < 0.5
            want.breaker_record(target, ok, now)
            got.breaker_record(target, ok, now)
            want.brownout.observe(ok)
            got.brownout.observe(ok)
        else:
            want.brownout.evaluate(now)
            got.brownout.evaluate(now)
            want.incr("hedges_issued")
            got.incr("hedges_issued")
        assert got.hedge_delay_s() == want.hedge_delay_s()
        assert got.hedge_enabled() == want.hedge_enabled()
    assert got.report() == want.report()
    assert "hedge_budget_by_tenant" in got.report()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("window,mult", [((0.2, 0.6), 3.0),
                                         ((0.0, 1.5), 1.5),
                                         ((0.4, 0.5), 1.0)])
def test_surge_trace_matches_the_reference(seed, window, mult):
    spec = dict(process="poisson", rps=60.0, n_requests=40,
                shared_prefix_frac=0.3)
    want = jov.surge_trace(jloadgen.WorkloadSpec(**spec), seed, *window,
                           mult)
    got = pov.surge_trace(ploadgen.WorkloadSpec(**spec), seed, *window,
                          mult)
    assert [r.as_dict() for r in got] == [r.as_dict() for r in want]
    if mult > 1.0 and window[1] - window[0] > 0.2:
        assert any(r.request_id.startswith("s") for r in got)


# -- the fleet command ----------------------------------------------------

LAYER_ARGV = ["fleet", "run", "--seed", "5", "--requests", "24", "--rps",
              "150", "--policy", "least-outstanding", "--replicas", "3"]


@pytest.mark.parametrize("flags", [
    ["--health", "--overload", "--tenancy", "--audit-frac", "0.25"],
    ["--tenancy", "--no-tenant-isolation"]])
def test_fleet_command_layers_match_the_reference_but_for_the_weights(
        capsys, flags):
    """The reference's command draws its weights from jax.random and the
    port's from torch.Generator: the streams' crcs differ, every other
    field is the reference's."""
    assert jcli.main(LAYER_ARGV + flags + ["--json", "--engine",
                                           "serving"]) == 0
    want = json.loads(capsys.readouterr().out)
    with one_thread():
        assert pcli.main(LAYER_ARGV + flags + ["--json", "--device",
                                               "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    for rep in (want, got):
        for entry in rep["completions"]:
            entry.pop("tokens_crc")
    for key in FLEET_COMPARED + ("seed", "engine"):
        assert got.get(key) == want.get(key), key
    assert got["ok"] and "tenancy" in got
    if "--audit-frac" in flags:
        assert got["integrity"]["counters"]["audit_copies"]
        assert {"health", "overload"} <= set(got)


def test_fleet_command_prints_the_layers(capsys):
    with one_thread():
        assert pcli.main(LAYER_ARGV + ["--requests", "12", "--health",
                                       "--overload", "--tenancy",
                                       "--audit-frac", "0.5", "--device",
                                       "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("  overload: ", "  health: ", "  tenancy: 3 tenant(s)",
                 "    gold (interactive): ", "  integrity: audits ",
                 "FLEET RUN OK"):
        assert line in out


def test_fleet_trace_command_with_tenancy_matches_the_reference(capsys):
    argv = ["fleet", "trace", "--seed", "4", "--requests", "20",
            "--tenancy", "--shared-prefix-frac", "0.5"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv) == 0
    assert capsys.readouterr().out == want and '"tenant": ' in want


def test_unisolated_tenancy_needs_tenancy():
    with pytest.raises(SystemExit, match="needs --tenancy"):
        pcli.main(["fleet", "run", "--device", "cpu",
                   "--no-tenant-isolation"])
