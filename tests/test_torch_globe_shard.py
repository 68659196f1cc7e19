"""PyTorch port parity: the sharded globe and the pool's shared-memory
transport.

The port's ``globe/shard.py`` (``ShardedGlobeSim``, ``CellProxy``,
``resolve_shards``) against the port's single-process ``GlobeSim`` and
the reference's, on the CPU host, both packages on the H100's
calibration: the reference's ``tests/test_globe_shard.py`` cases (seeds
7, 11 and 23 over 2 and 3 shards, chaos, the diurnal autoscaler, round
robin without the scheduler, a worker killed after its 5th and 2nd job,
a fuzzer-drawn schedule with a respawn) give byte-equal reports; the
refusals are the reference's; ``globe run --json --shards 3`` prints what
the single-process run prints; a shard worker never loads torch. The
worker pool's bulk transport: a payload of at least ``SHM_MIN_BYTES``
travels through a segment, ``KIND_TPU_SIM_POOL_SHM=0`` gives the same
answer in-band, and no segment outlives ``close`` or a kill mid-job.
"""

import dataclasses
import json
import os
import pathlib
import time

import pytest

from kind_tpu_sim import cli as jcli
from kind_tpu_sim import globe as jglobe
from kind_tpu_sim.scenarios import fuzz as jfuzz
from kind_tpu_sim_torch import cli as pcli
from kind_tpu_sim_torch import globe as pglobe
from kind_tpu_sim_torch import metrics as pmetrics
from kind_tpu_sim_torch.scenarios import spec as pspec
from kind_tpu_sim_torch.scenarios.fuzz import draw_spec
from kind_tpu_sim_torch.utils import worker_pool as pwp
from torch_parity import H100_CALIBRATION, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread", "h100")

TESTS = pathlib.Path(__file__).resolve().parent


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", H100_CALIBRATION)


def _base(globe):
    return dict(zones=("zone-a", "zone-b"), cells_per_zone=2,
                replicas_per_cell=2, max_virtual_s=120.0,
                workload=globe.GlobeWorkloadSpec(rps=25.0, n_per_zone=30))


def _chaos(globe):
    ev = globe.GlobeChaosEvent
    return (ev(2.0, "zone_loss", "zone-a"),
            ev(3.0, "dcn_degrade", "zone-b", 0.25),
            ev(4.0, "cell_drain", "zone-b/c0"),
            ev(6.0, "zone_restore", "zone-a"),
            ev(7.0, "cell_undrain", "zone-b/c0"),
            ev(8.0, "dcn_restore", "zone-b"))


def _run(globe, shards, seed, chaos=False, kill=None, **kw):
    cfg = globe.GlobeConfig(**(kw or _base(globe)))
    events = _chaos(globe) if chaos else ()
    if shards:
        sim = globe.ShardedGlobeSim(cfg, seed=seed, chaos_events=events,
                                    shards=shards, _test_kill=kill)
    else:
        sim = globe.GlobeSim(cfg, seed=seed, chaos_events=events)
    return json.dumps(sim.run(), sort_keys=True)


def _identity(shards, seed, chaos=False, kill=None, **kw):
    """The port's sharded report against its single-process one and the
    reference's; ``kw`` builds the config of each package from its own
    ``globe`` (a callable of the module)."""
    ours = {k: v(pglobe) if callable(v) else v for k, v in kw.items()}
    theirs = {k: v(jglobe) if callable(v) else v for k, v in kw.items()}
    want = _run(pglobe, 0, seed, chaos, **ours)
    assert want == _run(jglobe, 0, seed, chaos, **theirs)
    got = _run(pglobe, shards, seed, chaos, kill, **ours)
    assert got == want
    return got


@pytest.mark.parametrize("seed", [7, 11, 23])
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_identity_plain(seed, shards):
    _identity(shards, seed)


@pytest.mark.parametrize("seed", [7, 23])
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_identity_chaos(seed, shards):
    _identity(shards, seed, chaos=True)


def test_sharded_identity_autoscale_diurnal():
    _identity(2, 7, zones=("zone-a", "zone-b", "zone-c"), cells_per_zone=1,
              replicas_per_cell=2, autoscale=True, max_virtual_s=200.0,
              workload=lambda g: g.GlobeWorkloadSpec(
                  process="diurnal", rps=20.0, n_per_zone=40))


def test_sharded_identity_no_sched_round_robin():
    _identity(3, 11, zones=("zone-a", "zone-b"), cells_per_zone=3,
              replicas_per_cell=2, sched=False, policy="round-robin",
              max_virtual_s=120.0,
              workload=lambda g: g.GlobeWorkloadSpec(rps=30.0, n_per_zone=30))


@pytest.mark.parametrize("kill", [(1, 5), (0, 2)])
def test_worker_respawn_mid_window_identical(kill):
    """The shard's worker killed right after its nth job is sent: the
    journal's respawn and replay give the same report, and the recovery
    log has the respawn."""
    before = pmetrics.recovery_log().counts()
    _identity(2, 7, chaos=True, kill=kill)
    delta = pmetrics.recovery_log().snapshot_since(before)
    assert delta["globe_shard_respawn"] == 1
    respawn = [e for e in pmetrics.recovery_log().events()
               if e["event"] == "globe_shard_respawn"][-1]
    assert respawn["shard"] == kill[0] and respawn["jobs"] >= kill[1]


def test_fuzzer_drawn_schedule_identity_with_respawn():
    """The first globe topology of fuzz stream 5, compiled by the port's
    scenario compiler, through both drivers and the reference's, plus a
    worker kill mid-window."""
    drawn = next(s for s in (draw_spec(seed=5, index=i) for i in range(64))
                 if s.topology.kind == "globe" and s.faults)
    assert drawn.as_dict() == next(
        s for s in (jfuzz.draw_spec(seed=5, index=i) for i in range(64))
        if s.topology.kind == "globe" and s.faults).as_dict()
    # overload is front-door machinery the sharded driver refuses; the
    # drawn fault windows stay as drawn
    drawn = dataclasses.replace(drawn, overload=False)
    zones = tuple(f"zone-{chr(ord('a') + i)}"
                  for i in range(drawn.topology.zones))

    def reports(globe, sharded):
        cfg = globe.GlobeConfig(
            zones=zones, cells_per_zone=drawn.topology.cells_per_zone,
            replicas_per_cell=drawn.topology.replicas,
            workload=globe.GlobeWorkloadSpec(
                process=drawn.workload.process, rps=drawn.workload.rps,
                n_per_zone=drawn.workload.n_requests),
            max_virtual_s=drawn.max_virtual_s)
        traces = globe.generate_globe_traces(cfg, drawn.seed)
        span = max(pspec._trace_span(t) for t in traces.values())
        events = pspec._globe_events(drawn, span, list(zones),
                                     cfg.cell_names())
        if not sharded:
            return [json.dumps(globe.GlobeSim(
                cfg, traces=traces, seed=drawn.seed,
                chaos_events=events).run(), sort_keys=True)]
        return [json.dumps(globe.ShardedGlobeSim(
            cfg, traces=traces, seed=drawn.seed, chaos_events=events,
            shards=2, _test_kill=kill).run(), sort_keys=True)
            for kill in (None, (0, 3))]

    want = reports(jglobe, False)[0]
    assert reports(pglobe, False) == [want]
    assert reports(pglobe, True) == [want, want]


@pytest.mark.parametrize("field", ["overload", "planner", "training",
                                   "tenancy", "zoo", "generations"])
def test_sharded_refuses_as_the_reference(field):
    def cfg(globe, fleet):
        value = {"overload": lambda: globe.OverloadConfig(),
                 "planner": lambda: globe.PlannerConfig(spot_budget=2),
                 "training": lambda: fleet.TrainingConfig(gangs=(
                     fleet.TrainingGangConfig(name="llm0"),)),
                 "tenancy": lambda: fleet.default_tenancy(),
                 "zoo": lambda: fleet.default_zoo(),
                 "generations": lambda: ("h100",)}[field]()
        return globe.GlobeConfig(**{field: value})

    from kind_tpu_sim import fleet as jfleet
    from kind_tpu_sim_torch import fleet as pfleet

    with pytest.raises(ValueError) as ours:
        pglobe.ShardedGlobeSim(cfg(pglobe, pfleet), seed=7, shards=2)
    with pytest.raises(ValueError) as theirs:
        jglobe.ShardedGlobeSim(cfg(jglobe, jfleet), seed=7, shards=2)
    assert str(ours.value) == str(theirs.value)
    assert f"GlobeConfig.{field}" in str(ours.value)


def test_resolve_shards_env(monkeypatch):
    monkeypatch.setenv("KIND_TPU_SIM_GLOBE_SHARDS", "4")
    assert pglobe.resolve_shards() == 4
    assert pglobe.resolve_shards(2) == 2
    monkeypatch.delenv("KIND_TPU_SIM_GLOBE_SHARDS")
    assert pglobe.resolve_shards() == 0


def test_the_wire_config_round_trips():
    cfg = pglobe.GlobeConfig(**_base(pglobe), sched=False, autoscale=True,
                             cell_pods=(("tpu-v5-lite-podslice", "4x8"),))
    wire = json.dumps(pglobe.shard.config_to_wire(cfg), sort_keys=True)
    back = pglobe.shard.config_from_wire(json.loads(wire))
    assert json.dumps(pglobe.shard.config_to_wire(back),
                      sort_keys=True) == wire
    assert back.cell_names() == cfg.cell_names()
    theirs = jglobe.GlobeConfig(**_base(jglobe), sched=False, autoscale=True,
                                cell_pods=(("tpu-v5-lite-podslice", "4x8"),))
    assert wire == json.dumps(jglobe.shard.config_to_wire(theirs),
                              sort_keys=True)


def test_the_sharded_command_prints_the_single_process_run(
        monkeypatch, capsys):
    argv = ["globe", "run", "--json", "--requests", "60"]
    assert pcli.main(argv) == 0
    single = capsys.readouterr().out
    assert pcli.main(argv + ["--shards", "3"]) == 0
    assert capsys.readouterr().out == single
    monkeypatch.setenv("KIND_TPU_SIM_GLOBE_SHARDS", "2")
    assert pcli.main(argv[:2] + ["--requests", "60"]) == 0
    text = capsys.readouterr().out
    assert jcli.main(argv[:2] + ["--requests", "60"]) == 0
    assert capsys.readouterr().out == text
    assert json.loads(single)["ok"]


def test_a_shard_worker_never_loads_torch():
    """A cold worker that has served a shard's init and a window (its
    cells stepped) has no torch in ``sys.modules``."""
    cfg = pglobe.GlobeConfig(**_base(pglobe))
    names = cfg.cell_names()
    proc = pwp.PoolWorker(pwp.pool_child_env({"PYTHONPATH": str(TESTS)},
                                             warm=False))
    deadline = time.monotonic() + 120

    def call(target, **kwargs):
        resp = proc.request({"id": 1, "job": "call", "kwargs": {
            "target": target, "kwargs": kwargs}}, deadline)
        assert resp["ok"], resp.get("traceback")
        return resp["result"]

    try:
        init = call("kind_tpu_sim_torch.globe.shard:job_shard_init",
                    cfg=pglobe.shard.config_to_wire(cfg), names=names[:2],
                    indices=[0, 1], tick=0.01)
        assert [ci for ci, _ in init["cells"]] == [0, 1]
        window = call("kind_tpu_sim_torch.globe.shard:job_shard_window",
                      advance=3, ops=[], step=True)
        assert window["completions"] == []
        assert call("torch_grid_cells:loaded")["torch"] is False
    finally:
        proc.shutdown(grace_s=5)


# -- the pool's shared-memory transport ----------------------------------


def _segments(proc):
    return [seg.name for seg in (proc._shm_in, proc._shm_out)
            if seg is not None]


def _shm_exists(name):
    return os.path.exists(os.path.join("/dev/shm", name.lstrip("/")))


def _echo(proc, payload_bytes):
    """A ``call`` whose request and answer both carry ``payload_bytes``
    of data (``json.loads`` of a long string returns it)."""
    blob = json.dumps("x" * payload_bytes)
    return proc.request({"id": 7, "job": "call", "kwargs": {
        "target": "json:loads", "kwargs": {"s": blob}}},
        time.monotonic() + 60)


@pytest.mark.parametrize("shm", ["1", "0"], ids=["segments", "in-band"])
def test_bulk_payloads_travel_by_segment_or_in_band(monkeypatch, shm):
    monkeypatch.setenv("KIND_TPU_SIM_POOL_SHM", shm)
    proc = pwp.PoolWorker(pwp.pool_child_env(warm=False))
    sent = []
    real = pwp._send_payload

    def spy(stream, payload, segment):
        sent.append((len(payload), segment() is not None))
        return real(stream, payload, segment)

    monkeypatch.setattr(pwp, "_send_payload", spy)
    try:
        assert len(_segments(proc)) == (2 if shm == "1" else 0)
        for size in (100, pwp.SHM_MIN_BYTES, 3 * pwp.SHM_MIN_BYTES):
            resp = _echo(proc, size)
            assert resp["ok"] and resp["result"] == "x" * size
        # every request is spied on the parent's side; a bulk one went by
        # segment exactly when the transport is on
        assert [n >= pwp.SHM_MIN_BYTES for n, _ in sent] == [
            False, True, True]
        assert all(seg == (shm == "1") for _, seg in sent)
    finally:
        names = _segments(proc)
        proc.shutdown(grace_s=5)
    assert not any(_shm_exists(n) for n in names)


def test_a_worker_attaches_the_segments_at_its_first_bulk_payload():
    """A worker that carries only small frames (a grid cell's) never
    attaches the segments, so the transport adds nothing to its cold
    start; its first bulk payload attaches them."""
    proc = pwp.PoolWorker(pwp.pool_child_env({"PYTHONPATH": str(TESTS)},
                                             warm=False))

    def attached():
        resp = proc.request({"id": 3, "job": "call", "kwargs": {
            "target": "torch_grid_cells:segments_attached"}},
            time.monotonic() + 60)
        return resp["result"]

    try:
        assert len(_segments(proc)) == 2
        assert _echo(proc, 100)["ok"] and attached() is False
        assert _echo(proc, 3 * pwp.SHM_MIN_BYTES)["ok"] and attached() is True
    finally:
        proc.shutdown(grace_s=5)


def test_no_segment_outlives_a_kill_mid_job():
    proc = pwp.PoolWorker(pwp.pool_child_env(warm=False))
    names = _segments(proc)
    assert len(names) == 2 and all(_shm_exists(n) for n in names)
    proc.ensure_ready(time.monotonic() + 60)
    proc.send({"id": 1, "job": "hang", "kwargs": {"seconds": 60}})
    proc.kill()
    assert not proc.alive()
    assert not any(_shm_exists(n) for n in names)
    with pytest.raises(pwp.WorkerCrash):
        proc.read_frame(time.monotonic() + 5)
    with pytest.raises(pwp.WorkerCrash):
        proc.send({"id": 2, "job": "ping"})


def test_a_sharded_run_leaves_no_segment(monkeypatch):
    """Every segment of every shard worker, a respawned one's too, is
    gone when the run ends."""
    made = []

    class Recorded(pwp.PoolWorker):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.extend(_segments(self))

    monkeypatch.setattr(pwp, "PoolWorker", Recorded)
    assert _run(pglobe, 2, 7, kill=(1, 3)) == _run(pglobe, 0, 7)
    assert len(made) == 2 * 3
    assert not any(_shm_exists(n) for n in made)
