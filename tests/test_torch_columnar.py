"""PyTorch port parity: the columnar mirror of analytic fleets.

``fleet/columnar.py`` keeps every ``SimReplica``'s wake bounds, queue
length, outstanding count and health in numpy columns, refreshed from a
dirty set that each of the replica's mutating methods marks
(``SimReplica._touch``). It is an execution strategy: a fleet's report,
as JSON with sorted keys, is the same with the mirror on and off, and
the reference's. A mutator that missed ``_touch`` would leave a stale
row, which shows only in a fleet large enough to engage the mirror and
busy with chaos, so the cases run 48 replicas under gray, preemption
and autoscaler chaos, the control layers (probes, hedges that cancel,
audits), disaggregated pools, the scheduler and the zoo; the last test
calls each mutator on its own and reads the dirty set.
"""

import json

import pytest

from kind_tpu_sim import fleet as jfleet
from kind_tpu_sim_torch import fleet as pfleet
from kind_tpu_sim_torch.fleet import columnar as pcol

from torch_parity import H100_CALIBRATION, shared_registry, sim_fleet_run

SPEC = dict(process="diurnal", rps=80.0, n_requests=600,
            shared_prefix_frac=0.25)

# gray (slow / unslow) and preemption chaos
CHAOS = [dict(at_s=1.0, action="preempt", target=3),
         dict(at_s=2.0, action="slow", target=1, param=2.0),
         dict(at_s=2.5, action="restore", target=3),
         dict(at_s=4.0, action="unslow", target=1)]

# an autoscaler quick enough to scale within the trace
SCALER = dict(up_backlog=2.0, breach_evals=2, cooldown_s=0.1, warmup_s=0.1)

CASES = {
    "least-outstanding": (dict(policy="least-outstanding"), SPEC, []),
    "round-robin": (dict(policy="round-robin"), SPEC, []),
    "prefix-affinity": (dict(policy="prefix-affinity"), SPEC, []),
    "gray and preemption chaos": (dict(), SPEC, CHAOS),
    "autoscaler under chaos": (
        dict(replicas=8, autoscale=True, eval_every_s=0.05,
             autoscaler=dict(SCALER, min_replicas=8, max_replicas=16)),
        dict(SPEC, rps=800.0), CHAOS),
    "detector, overload, audits": (
        dict(health=True, overload=True, audit_frac=0.3),
        dict(SPEC, deadline_s=1.0),
        CHAOS + [dict(at_s=1.5, action="sdc_chip", target=5, param=0.5)]),
    "tenancy": (dict(tenancy=True), dict(SPEC, tenancy=True), CHAOS),
    "disaggregated pools": (
        dict(replicas=8, disagg=dict(prefill_replicas=3, decode_replicas=5),
             autoscale=True, eval_every_s=0.05,
             autoscaler=dict(SCALER, min_replicas=8, max_replicas=14),
             slo=dict(ttft_s=0.5, e2e_s=2.0, itl_s=0.002)),
        dict(SPEC, rps=800.0, max_new=(16, 32)), []),
    "scheduler": (
        dict(replicas=2, sched={},
             training=[dict(name="llm0", topology="2x8", total_steps=80)]),
        dict(process="poisson", rps=150.0, n_requests=120,
             max_new=(4, 24)),
        # replica 1's rebind onto node 2 preempts the gang; the second
        # failure moves it back and makes the gang's row whole again
        [dict(at_s=0.05, action="link_degrade", target=0, param=0.25),
         dict(at_s=0.08, action="node_fail", target=1),
         dict(at_s=0.2, action="node_restore", target=1),
         dict(at_s=0.25, action="link_restore", target=0),
         dict(at_s=0.3, action="node_fail", target=2),
         dict(at_s=0.45, action="node_restore", target=2)]),
    "zoo": (dict(zoo=True, generations=("h100",)), dict(SPEC, zoo=True),
            CHAOS + [dict(at_s=3.0, action="model_swap_evict",
                          target=0)]),
}


def _run(fleet, name, columnar):
    fc, spec, events = CASES[name]
    fc = dict(dict(replicas=48, max_queue=4096,
                   slo=dict(ttft_s=0.5, e2e_s=2.0)), **fc)
    sims = []
    rep = sim_fleet_run(fleet, spec, events, seed=7, sims=sims,
                        columnar=columnar, **fc)
    assert (sims[0]._cols is not None) is bool(columnar)
    return json.dumps(rep, sort_keys=True), rep


@pytest.mark.parametrize("name", sorted(CASES))
def test_columnar_reports_are_the_per_object_ones_and_the_reference(
        monkeypatch, tmp_path, name):
    if name == "zoo":
        shared_registry(monkeypatch, tmp_path)
    # the port's default calibration, the H100's, on both sides
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", H100_CALIBRATION)
    on, rep = _run(pfleet, name, True)
    off, _ = _run(pfleet, name, False)
    want, _ = _run(jfleet, name, True)
    assert on == off == want
    assert rep["ok"]
    if name == "autoscaler under chaos":
        assert rep["autoscaler"]["scale_ups"] >= 1
        assert rep["autoscaler"]["scale_downs"] >= 1
    if name == "detector, overload, audits":
        assert rep["overload"]["counters"].get("hedges_issued")
        assert rep["integrity"]["counters"].get("audit_copies")
    if name == "scheduler":
        assert rep["training"]["all_done"] and rep["preemptions"]
    if name == "disaggregated pools":
        assert rep["disagg"]["kv"]["handoffs"] == SPEC["n_requests"]
        assert rep["disagg"]["autoscalers"]["decode"]["scale_ups"] >= 1


def test_the_mirror_engages_by_replica_count(monkeypatch):
    trace = pfleet.generate_trace(pfleet.WorkloadSpec(n_requests=20), 7)

    def cols(columnar, replicas):
        return pfleet.FleetSim(pfleet.FleetConfig(
            replicas=replicas, columnar=columnar), trace)._cols

    n = pfleet.COLUMNAR_MIN_REPLICAS
    assert n == 32
    assert cols(None, n) is not None and cols(None, n - 1) is None
    assert cols(True, 2) is not None and cols(False, n) is None
    monkeypatch.setenv("KIND_TPU_SIM_FLEET_COLUMNAR", "0")
    assert cols(None, n) is None and cols(True, 2) is not None
    # a fleet of engines keeps the per-object paths
    assert pfleet.FleetSim(pfleet.FleetConfig(replicas=1, columnar=True),
                           [], replica_factory=lambda rid: None)._cols is None


@pytest.mark.parametrize("raw,want", [(None, True), ("0", False),
                                      ("false", False), ("no", False),
                                      ("1", True), ("on", True)])
def test_resolve_columnar_reads_its_knob(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("KIND_TPU_SIM_FLEET_COLUMNAR", raising=False)
    else:
        monkeypatch.setenv("KIND_TPU_SIM_FLEET_COLUMNAR", raw)
    assert pcol.resolve_columnar() is want
    assert pcol.resolve_columnar(not want) is (not want)


def _req(i, **kw):
    return pfleet.TraceRequest(f"r{i}", 0.0, tuple(range(4)), 6, i, **kw)


def test_every_mutator_marks_its_row():
    """Each method that changes what the mirror holds (queue, slots,
    health, wake bounds) marks its replica's row dirty; a read does
    not; the mirror's answers then equal the replica's own."""
    zoo = pfleet.default_zoo()
    cal = pfleet.load_generation("h100")
    cfg = pfleet.model_sim_config(zoo, cal, max_slots=2,
                                  resident_model="small")
    reps = [pfleet.SimReplica(i, cfg) for i in range(3)]
    cols = pfleet.FleetColumns(reps)
    rep = reps[1]

    def marks(fn):
        cols.flush()
        assert not cols.dirty
        fn()
        marked = cols.dirty == {1}
        cols.flush()
        assert (cols.qlen[1], cols.out[1], bool(cols.healthy[1])) == (
            len(rep.queue), rep.outstanding(), rep.healthy)
        ge, cover = rep.next_due()
        assert cols.ge[1] == (float("inf") if ge is None else ge)
        assert cols.cover[1] == (float("inf") if cover is None else cover)
        return marked

    assert marks(lambda: rep.submit(_req(0, model="medium"), 0.0))
    assert marks(lambda: rep.submit(_req(1), 0.0))
    assert marks(lambda: rep.tick(0.0, 0.01))  # admits: swaps medium in
    assert rep.swaps == 1
    assert marks(lambda: rep.submit(_req(2), 0.01))
    assert marks(lambda: rep.set_slowdown(3.0))
    assert marks(lambda: rep.set_corrupt(0.5))
    assert marks(lambda: rep.cancel("r2"))
    assert marks(lambda: rep.cancel("r0"))
    assert marks(lambda: rep._swap_in("large", 0.02))
    assert marks(lambda: rep.fail(0.03))
    assert marks(lambda: rep.restore(0.04))
    # reads leave the mirror alone
    assert not marks(lambda: (rep.holds("r1"), rep.next_due(),
                              rep.outstanding(), rep.can_serve("large"),
                              rep.report()))
    # a rebuild (a scale event) drops the replicas that left
    cols.rebuild(reps[:1])
    assert reps[1]._cols is None and reps[0]._cols is cols
    assert cols.pick_least_outstanding() is reps[0]
