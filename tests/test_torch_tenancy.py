"""PyTorch port parity: multi-tenancy.

The port's ``kind_tpu_sim_torch/fleet/tenancy.py`` against the JAX
package's ``kind_tpu_sim/fleet/tenancy.py``: the tenant dataclasses,
their checks and ``default_tenancy``; the tenant traces
(``generate_tenant_trace`` through ``generate_trace``, and
``tenant_surge_trace``) item for item for three seeds, and their trace
files read by either package; ``RateBucket``; ``TenancyState``'s quota
verdicts on a seeded arrival stream; and the router's deficit round
robin over stub replicas, placement for placement. Host logic: exact
equality. Then tenancy in the engine fleet
(``torch_parity.fleet_layers_run``), on a tenant trace at 400 rps with
and without isolation: the whole report equals the reference's engine
fleet's with the same weights.
"""

import dataclasses
import random

import pytest

from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim.fleet import tenancy as jten
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch.fleet import tenancy as pten

from torch_parity import FLEET_CFG, fleet_layers_pair, make_params, one_thread

SEEDS = (0, 7, 12345)
SPECS = {
    "poisson": dict(process="poisson", rps=120.0, n_requests=60),
    "bursty prefixes": dict(process="bursty", rps=80.0, n_requests=50,
                            burst_factor=3.0, shared_prefix_frac=0.5,
                            prefix_len=4, deadline_s=0.4),
    "diurnal": dict(process="diurnal", rps=40.0, n_requests=40,
                    diurnal_period_s=2.0, phase_s=0.3, max_new=(2, 9)),
}


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_dataclasses_match_the_reference():
    assert _fields(pten.TenantSpec) == _fields(jten.TenantSpec)
    assert _fields(pten.TenancyConfig) == _fields(jten.TenancyConfig)
    assert pten.QOS_TIERS == jten.QOS_TIERS
    assert (pten.default_tenancy().as_dict()
            == jten.default_tenancy().as_dict())
    assert pten.DEFAULT_TENANT.as_dict() == jten.DEFAULT_TENANT.as_dict()
    cfg = dict(isolation=False, drr_quantum=2.5)
    assert (dataclasses.replace(pten.default_tenancy(), **cfg).as_dict()
            == dataclasses.replace(jten.default_tenancy(), **cfg).as_dict())
    want, got = jten.default_tenancy(), pten.default_tenancy()
    assert got.signature() == want.signature()
    for name in ("gold", "silver", "bronze", "nobody"):
        assert got.qos_rank(name) == want.qos_rank(name)
        assert got.weight(name) == want.weight(name)
        assert got.tier(name) == want.tier(name)
        assert got.lookup(name).as_dict() == want.lookup(name).as_dict()


@pytest.mark.parametrize("bad", [
    dict(name="x", qos="premium"), dict(name="x", weight=0.0),
    dict(name="x", rps_share=-1.0), dict(name="x", users=0)])
def test_tenant_checks_match_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jten.TenantSpec(**bad)
    with pytest.raises(ValueError) as got:
        pten.TenantSpec(**bad)
    assert str(got.value) == str(want.value)


def test_config_checks_match_the_reference():
    for mod in (jten, pten):
        with pytest.raises(ValueError, match=">= 1 tenant"):
            mod.TenancyConfig()
        with pytest.raises(ValueError, match="duplicate"):
            mod.TenancyConfig(tenants=(mod.TenantSpec(name="a"),
                                       mod.TenantSpec(name="a")))


def test_tenant_of_matches_the_reference():
    reqs = [pfleet.TraceRequest("a", 0.0, (1,), 1, 0, tenant="gold"),
            pfleet.TraceRequest("b", 0.0, (1,), 1, 0), object()]
    assert [pten.tenant_of(r) for r in reqs] == [jten.tenant_of(r)
                                                 for r in reqs]


def _tenant_traces(spec, seed, isolation=None):
    return (jfleet.generate_trace(jfleet.WorkloadSpec(
                **spec, tenancy=dataclasses.replace(
                    jten.default_tenancy(), isolation=isolation)), seed),
            pfleet.generate_trace(pfleet.WorkloadSpec(
                **spec, tenancy=dataclasses.replace(
                    pten.default_tenancy(), isolation=isolation)), seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_tenant_trace_matches_the_reference(name, seed):
    want, got = _tenant_traces(SPECS[name], seed)
    assert [r.as_dict() for r in got] == [r.as_dict() for r in want]
    assert {r.tenant for r in got} == {"gold", "silver", "bronze"}
    # quotas and weights do not shape the traffic
    assert ([r.as_dict() for r in _tenant_traces(SPECS[name], seed,
                                                  False)[1]]
            == [r.as_dict() for r in got])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tenant,window,mult", [
    ("bronze", (0.1, 0.4), 4.0), ("gold", (0.0, 0.3), 2.0),
    ("nobody", (0.2, 0.5), 3.0)])
def test_tenant_surge_trace_matches_the_reference(seed, tenant, window,
                                                  mult):
    spec = SPECS["poisson"]
    want = jten.tenant_surge_trace(jfleet.WorkloadSpec(
        **spec, tenancy=jten.default_tenancy()), seed, *window, mult, tenant)
    got = pten.tenant_surge_trace(pfleet.WorkloadSpec(
        **spec, tenancy=pten.default_tenancy()), seed, *window, mult, tenant)
    assert [r.as_dict() for r in got] == [r.as_dict() for r in want]
    assert any(r.request_id.startswith("s") for r in got)


def test_tenant_trace_files_cross_between_the_packages(tmp_path):
    want, got = _tenant_traces(SPECS["bursty prefixes"], 3)
    pfleet.save_trace(str(tmp_path / "port.jsonl"), got)
    jfleet.save_trace(str(tmp_path / "ref.jsonl"), want)
    assert ((tmp_path / "port.jsonl").read_bytes()
            == (tmp_path / "ref.jsonl").read_bytes())
    assert jfleet.load_trace(str(tmp_path / "port.jsonl")) == want
    assert ([r.as_dict() for r in
             pfleet.load_trace(str(tmp_path / "ref.jsonl"))]
            == [r.as_dict() for r in got])


@pytest.mark.parametrize("rate,burst", [(40.0, 20.0), (3.5, 2.0),
                                        (0.0, 8.0)])
def test_rate_bucket_matches_the_reference(rate, burst):
    rng = random.Random(int(rate * 10))
    want, got = jten.RateBucket(rate, burst), pten.RateBucket(rate, burst)
    now = 0.0
    for _ in range(300):
        now = round(now + rng.expovariate(60.0), 6)
        cost = rng.choice([1.0, 0.5, 3.0])
        assert got.take(now, cost) == want.take(now, cost)
        assert got.report() == want.report()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("isolation", [None, False])
def test_quota_verdicts_match_the_reference(seed, isolation):
    tenants = [dict(name="gold", qos="interactive", weight=4.0),
               dict(name="bronze", qos="batch", quota_rps=30.0,
                    quota_burst=5.0),
               dict(name="meter", token_quota_per_s=400.0,
                    token_quota_burst=60.0)]
    want = jten.TenancyState(jten.TenancyConfig(
        tenants=tuple(jten.TenantSpec(**t) for t in tenants),
        isolation=isolation))
    got = pten.TenancyState(pten.TenancyConfig(
        tenants=tuple(pten.TenantSpec(**t) for t in tenants),
        isolation=isolation))
    rng = random.Random(seed)
    now = 0.0
    for i in range(400):
        now = round(now + rng.expovariate(200.0), 6)
        req = pfleet.TraceRequest(
            f"r{i}", now, tuple(range(rng.randint(1, 20))),
            rng.randint(1, 24), 0,
            tenant=rng.choice(["gold", "bronze", "meter", ""]))
        assert got.admit(req, now) == want.admit(req, now)
    assert got.report() == want.report()
    if isolation is None:
        rep = got.report()["tenants"]
        assert rep["bronze"]["quota_shed"] and rep["meter"]["token_shed"]


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
        if len(self.held) >= self.cap:
            return False
        self.held.append(req)
        return True


def _fair_queue(mod, ten_mod, trace, policy):
    """Offer ``trace`` to a deficit-round-robin router over three stub
    replicas; each step one held request of each replica finishes.
    Returns the placements in order and the router's report."""
    reps = [StubReplica(i, cap=2) for i in range(3)]
    router = mod.Router(reps, policy=policy, tenancy=ten_mod.TenancyState(
        ten_mod.TenancyConfig(tenants=(
            ten_mod.TenantSpec(name="gold", qos="interactive", weight=2.0),
            ten_mod.TenantSpec(name="silver", weight=3.0),
            ten_mod.TenantSpec(name="tin", weight=1.0),
            ten_mod.TenantSpec(name="bronze", qos="batch")),
            drr_quantum=1.5)))
    placed = []
    pending = list(trace)
    for step in range(300):
        now = step * 0.01
        while pending and pending[0].arrival_s <= now:
            router.offer(pending.pop(0), now)
        before = {r.replica_id: len(r.held) for r in reps}
        router.dispatch(now)
        for r in reps:
            placed += [(q.request_id, r.replica_id)
                       for q in r.held[before[r.replica_id]:]]
            if r.held and step % 2 == 0:
                r.held.pop(0)
    return placed, router.report()


@pytest.mark.parametrize("policy", ["round-robin", "least-outstanding"])
def test_deficit_round_robin_matches_the_reference(policy):
    rng = random.Random(4)
    trace = [pfleet.TraceRequest(
        f"q{i:03d}", round(i * 0.004, 6), (1, 2), 4, 0,
        tenant=rng.choice(["gold", "silver", "tin", "bronze", ""]))
        for i in range(150)]
    want = _fair_queue(jfleet, jten, trace, policy)
    got = _fair_queue(pfleet, pten, trace, policy)
    assert got == want
    assert got[1]["fair_queue"]["rounds"] > 0 and len(got[0]) == 150


@pytest.fixture(scope="module")
def fleet_params():
    with one_thread():
        yield make_params(FLEET_CFG)


@pytest.mark.parametrize("isolation", [True, False])
def test_engine_fleet_tenancy_matches_the_reference(fleet_params,
                                                    isolation):
    got = fleet_layers_pair(
        fleet_params, dict(process="poisson", rps=400.0, n_requests=80,
                           max_new=(12, 24), tenancy=True),
        tenancy=isolation)
    ten = got["tenancy"]
    assert ten["isolation"] is isolation
    assert ("fair_queue" in got["router"]) is isolation
    assert sorted(ten["slo"]) == ["bronze", "gold", "silver"]
    assert sum(t["admitted"] for t in ten["tenants"].values()) == 80
