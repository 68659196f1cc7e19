"""PyTorch port parity: the multi-host slice (``parallel/multihost.py``,
the environment contract in ``parallel/mesh.py``, ``slice-smoke``)
against the JAX package.

Identity parsing, ``_chips_from_env`` and every worker and megascale
environment equal the reference's on the same inputs; the local
launchers stand up a slice of one host (2x2) and of two (2x2x2) on the
CPU with ``tests/test_multihost_slice.py``'s assertions (one process a
simulated host, one gloo rank a chip); the retry classifies failures as
the reference's does; ``slice-smoke --json --device cpu`` reports ok.
The 16-rank v5e-16 and multislice launches are ``slow``, as the
reference's are (``chip_smoke.py`` phase 12 runs them on the card).
"""

import json

import pytest

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.parallel import mesh as pmesh
from kind_tpu_sim_torch.parallel import multihost as pmh

ENVS = [
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0,h1"},
    {},
    {"TPU_WORKER_ID": "5", "TPU_WORKER_HOSTNAMES": "h0,h1"},
    {"TPU_WORKER_ID": "x", "TPU_WORKER_HOSTNAMES": "h0"},
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a,,b",
     "TPU_SIM_COORDINATOR_PORT": "9000"},
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a",
     "TPU_SIM_COORDINATOR_PORT": "nope"},
    {"TPU_WORKER_ID": "-1", "TPU_WORKER_HOSTNAMES": "a,b"},
    {"TPU_WORKER_HOSTNAMES": "a,b"},
]


@pytest.mark.parametrize("env", ENVS)
def test_identity_matches_the_reference(env):
    import dataclasses

    from kind_tpu_sim.parallel import multihost as jmh

    got, want = pmh.identity_from_env(env), jmh.identity_from_env(env)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_processes == want.num_processes
    assert got.coordinator_address == want.coordinator_address


@pytest.mark.parametrize("bounds", [None, "2,2,1", "2,4,1", "1,1,1", "4,4,4"])
def test_chips_from_env_matches_the_reference(bounds):
    from kind_tpu_sim.parallel import multihost as jmh

    env = {} if bounds is None else {"TPU_CHIPS_PER_HOST_BOUNDS": bounds}
    assert pmh._chips_from_env(env) == jmh._chips_from_env(env)


TOPOLOGIES = {
    "tpu-v5-lite-podslice": ["1x1", "2x2", "2x4", "4x4", "4x8", "8x8", "3x3",
                             "2x2x2"],
    "tpu-v4-podslice": ["2x2x1", "2x2x2", "2x2x4", "4x4x4", "2x4x4", "3x2x1",
                        "2x2"],
    "tpu-v5p-slice": ["2x2x1", "2x2x2", "4x4x8", "2x3x2"],
}


@pytest.mark.parametrize("accelerator", sorted(TOPOLOGIES))
def test_worker_and_megascale_envs_equal_the_reference(accelerator):
    """Every worker of every slice of 1-3 slice jobs over a grid of
    topologies: the same dict key for key, and the same refusals."""
    from kind_tpu_sim import topology as topo

    for top in TOPOLOGIES[accelerator]:
        try:
            want = topo.make_slice(accelerator, top)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                pmesh.make_slice(accelerator, top)
            assert str(got.value) == str(exc)
            continue
        got = pmesh.make_slice(accelerator, top)
        assert (got.num_hosts, got.chips_per_host, got.accelerator_type) == (
            want.num_hosts, want.chips_per_host, want.accelerator_type)
        for w in range(want.num_hosts):
            assert got.worker_env(w) == want.worker_env(w)
            names = [f"10.0.0.{i}" for i in range(want.num_hosts)]
            assert got.worker_env(w, names) == want.worker_env(w, names)
        with pytest.raises(ValueError, match="out of range"):
            got.worker_env(want.num_hosts)
        for n in (1, 2, 3):
            jms = topo.make_multislice(n, accelerator, top)
            pms = pmesh.make_multislice(n, accelerator, top)
            assert pms.hostnames() == jms.hostnames()
            for sid in range(n):
                assert pms.megascale_env(sid) == jms.megascale_env(sid)
                assert pms.megascale_env(sid, "c:1") == jms.megascale_env(
                    sid, "c:1")
                for w in range(want.num_hosts):
                    assert pms.worker_env(sid, w) == jms.worker_env(sid, w)
            with pytest.raises(ValueError, match="out of range"):
                pms.megascale_env(n)
    with pytest.raises(ValueError, match=">= 1"):
        pmesh.MultiSliceShape(pmesh.make_slice(), 0)


def test_local_slice_single_host():
    """tests/test_multihost_slice.py:43-53: a 1-host topology runs the
    same worker path with no cross-host rendezvous."""
    reports = pmh.launch_local_slice(topology="2x2",
                                     accelerator="tpu-v5-lite-podslice",
                                     timeout=120, device="cpu")
    assert len(reports) == 1
    rep = reports[0]
    assert rep["ok"], rep
    assert rep["process_count"] == 1
    assert rep["global_devices"] == rep["local_devices"] == 4
    assert rep["psum_total"] == rep["psum_expected"] == 4.0


def test_local_slice_v4_two_hosts():
    """tests/test_multihost_slice.py:16-26 on the CPU, with the
    long-context ring over all 8 ranks (k = 0, v[s] = s)."""
    reports = pmh.launch_local_slice(topology="2x2x2",
                                     accelerator="tpu-v4-podslice",
                                     timeout=120, ring_tokens=1024,
                                     device="cpu")
    assert len(reports) == 2
    for rank, rep in enumerate(reports):
        assert rep["ok"], rep
        assert rep["process_index"] == rank
        assert rep["process_count"] == 2
        assert rep["local_devices"] == 4
        assert rep["global_devices"] == 8
        assert rep["psum_total"] == 4 * (1 + 2)
        assert rep["ppermute_got"] == [float((rank - 1) % 2 + 1)]
        assert rep["ring_ok"] and rep["ring_devices"] == 8


@pytest.mark.slow
def test_north_star_v5e16():
    reports = pmh.launch_local_slice(topology="4x4",
                                     accelerator="tpu-v5-lite-podslice",
                                     timeout=300, device="cpu")
    assert len(reports) == 2
    for rep in reports:
        assert rep["ok"], rep
        assert rep["local_devices"] == 8
        assert rep["global_devices"] == 16
        assert rep["psum_total"] == 8 * (1 + 2)


@pytest.mark.slow
def test_local_multislice_isolated_worlds():
    per_slice = pmh.launch_local_multislice(
        num_slices=2, topology="2x2x2", accelerator="tpu-v4-podslice",
        timeout=300, device="cpu")
    assert len(per_slice) == 2
    for sid, reports in enumerate(per_slice):
        assert len(reports) == 2
        for rep in reports:
            assert rep["ok"], rep
            assert rep["process_count"] == 2
            assert rep["global_devices"] == 8
            assert rep["megascale_slice_id"] == str(sid)
            assert rep["megascale_num_slices"] == "2"


def test_the_launchers_run_on_the_card_unless_asked():
    """No card here: the default device raises before any process
    starts."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmh.launch_local_slice(topology="2x2",
                               accelerator="tpu-v5-lite-podslice")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmh.launch_local_multislice()


def test_launch_retry_classification():
    """tests/test_retry.py:188-212 on the port: a crashed worker and a
    rendezvous timeout relaunch (recorded as ``slice_relaunch``), a bind
    failure too; a job that failed does not."""
    before = metrics.recovery_log().counts()
    calls = {"n": 0}

    def crash_once():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("slice worker 1 crashed (rc=9):\n...")
        return "ok"

    assert pmh._with_launch_retry(crash_once, attempts=2) == "ok"
    assert calls["n"] == 2

    def job_failed():
        calls["n"] += 1
        raise RuntimeError("slice worker 0 job failed: ValueError")

    calls["n"] = 0
    with pytest.raises(RuntimeError, match="job failed"):
        pmh._with_launch_retry(job_failed, attempts=3)
    assert calls["n"] == 1

    def bind_then_ok():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("slice worker 0 job failed: RuntimeError: "
                               "errno 98 - Address already in use")
        if calls["n"] == 2:
            raise TimeoutError("slice workers [1] still running after 1 s")
        return "ok"

    calls["n"] = 0
    assert pmh._with_launch_retry(bind_then_ok, attempts=3) == "ok"
    with pytest.raises(TimeoutError):
        pmh._with_launch_retry(
            lambda: (_ for _ in ()).throw(TimeoutError("late")), attempts=1)
    delta = metrics.recovery_log().snapshot_since(before)
    assert delta == {"slice_relaunch": 3}


def test_the_launcher_reports_a_worker_that_raised_as_a_job_failure(
        monkeypatch):
    """A rank that raises fails its host's job (not retried); the
    message names the worker."""
    monkeypatch.setenv("TPU_SIM_RING_TOKENS", "7")  # 7 does not split
    with pytest.raises(RuntimeError, match="slice worker 0 job failed"):
        pmh.launch_local_slice(topology="2x2",
                               accelerator="tpu-v5-lite-podslice",
                               timeout=120, device="cpu", attempts=3)


def test_single_host_identity_skips_the_rendezvous():
    import torch.distributed as dist

    ident = pmh.initialize_from_env({})
    assert ident.worker_id == 0 and ident.num_processes == 1
    ident = pmh.initialize_from_env({"TPU_WORKER_ID": "0",
                                     "TPU_WORKER_HOSTNAMES": "only"})
    assert ident.hostnames == ["only"]
    assert not dist.is_initialized()
    assert pmh.rendezvous(pmh.identity_from_env(ENVS[0]), 4) == (
        "tcp://h0:8476", 4, 8)


def test_cli_slice_smoke_json_on_the_cpu(capsys):
    """tests/test_profiling.py:55-63's CLI check on the port's CLI, on a
    one-host 2x2 slice."""
    from kind_tpu_sim_torch.cli import main

    rc = main(["slice-smoke", "--topology", "2x2", "--accelerator",
               "tpu-v5-lite-podslice", "--json", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and len(out["workers"]) == 1
    with pytest.raises(ValueError, match="must be divisible"):
        main(["slice-smoke", "--topology", "2x2", "--accelerator",
              "tpu-v5-lite-podslice", "--ring-tokens", "6", "--device",
              "cpu"])
    with pytest.raises(SystemExit, match="single-slice"):
        main(["slice-smoke", "--num-slices", "2", "--ring-tokens", "8",
              "--device", "cpu"])
