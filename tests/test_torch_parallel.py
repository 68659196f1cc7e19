"""PyTorch port parity: meshes and the collective smokes
(``kind_tpu_sim_torch/parallel/``) against ``tests/test_collectives.py``.

The reference runs its meshes on the 8 virtual CPU devices the conftest
sets; the port runs one process per rank, 8 gloo ranks started by
``parallel.launch.spawn`` (one world for all the smokes, read by the
tests below). The reports must carry the reference's keys and values.
A rank that raises or dies must fail the spawn within its deadline.
"""

import time

import numpy as np
import pytest

from kind_tpu_sim.parallel import collectives as jcoll
from kind_tpu_sim_torch.parallel import collectives as pcoll
from kind_tpu_sim_torch.parallel import launch

import torch_parity


@pytest.fixture(scope="module")
def world():
    return launch.spawn(torch_parity.mesh_rank_smokes, 8, backend="gloo",
                        device="cpu", timeout_s=120)


def test_training_mesh_shapes(world):
    assert world["training"] == ((2, 4), ("data", "model"))
    assert world["training_seq"] == ("data", "model", "seq")
    assert "32 devices" in world["training_32"]


def test_slice_mesh_shape_matches_topology(world):
    assert world["slice_16"].startswith("RuntimeError")
    assert "need 16 devices" in world["slice_16"]
    assert world["slice_8"] == ((1, 8), ("host", "chip"))


def test_auto_training_mesh(world):
    assert world["auto"] == (4, 2)
    assert world["auto_seq"] == (4, 1, 2)


def test_psum_smoke(world):
    report = world["psum"]
    assert report["ok"], report
    assert report["devices"] == 8
    assert report["result"] == 36.0


def test_ring_permute_smoke(world):
    report = world["ppermute"]
    assert report["ok"], report
    assert report["ring_size"] == 8


def test_all_gather_smoke(world):
    assert world["all_gather"]["ok"], world["all_gather"]


def test_run_all_aggregates(world):
    report = world["run_all"]
    assert report["ok"]
    assert set(report) == {"psum", "ppermute", "all_gather", "ok"}


def test_collectives_on_2d_host_chip_mesh(world):
    psum, ring, gather = world["host_chip"]
    assert psum["ok"] and ring["ok"] and gather["ok"]
    assert ring["ring_size"] == 4
    assert gather["groups"] == 2


def test_reports_equal_the_reference():
    """The reference's smokes on its virtual devices give the port's
    reports, key for key (tests/test_collectives.py's meshes)."""
    import jax
    from jax.sharding import Mesh

    from kind_tpu_sim import topology as T
    from kind_tpu_sim.parallel import mesh as jmesh

    got = launch.spawn(torch_parity.mesh_rank_smokes, 8, backend="gloo",
                       device="cpu", timeout_s=120)
    s8 = jmesh.slice_mesh(T.make_slice(topology="2x4"))
    assert got["psum"] == jcoll.psum_smoke(s8)
    assert got["ppermute"] == jcoll.ring_permute_smoke(s8)
    assert got["all_gather"] == jcoll.all_gather_smoke(s8)
    assert got["run_all"] == jcoll.run_all(s8)
    hc = Mesh(np.array(jax.devices()).reshape(2, 4), ("host", "chip"))
    assert list(got["host_chip"]) == [jcoll.psum_smoke(hc),
                                      jcoll.ring_permute_smoke(hc),
                                      jcoll.all_gather_smoke(hc)]


def test_hierarchical_psum_matches_the_reference(world):
    """multislice_mesh(2, 2, 2): the ICI subtotals per slice and the
    global total, as the reference's smoke reports them."""
    from kind_tpu_sim.parallel import mesh as jmesh

    want = jcoll.hierarchical_psum_smoke(jmesh.multislice_mesh(2, 2, 2))
    assert world["hierarchical"] == want
    assert want["ok"] and want["ici_subtotals"] == [10.0, 26.0]
    assert "no 'dcn' axis" in world["no_dcn"]


@pytest.mark.parametrize("fn", ["ring_allreduce_s", "tier_slowdown",
                                "ici_slowdown", "dcn_slowdown"])
def test_cost_model_is_the_reference(fn):
    cases = {
        "ring_allreduce_s": [(1e9, 8), (1e6, 4, None, [0.5, 1.0]),
                             (2e8, 16, None, None, "dcn"), (5.0, 1)],
        "tier_slowdown": [(0.5,), (0.25, 0.2), (0.5, None, "dcn")],
        "ici_slowdown": [(0.5,), (1.0,), (0.1, 0.6)],
        "dcn_slowdown": [(0.5,), (0.3, 0.4)],
    }[fn]
    for args in cases:
        assert getattr(pcoll, fn)(*args) == getattr(jcoll, fn)(*args)
    with pytest.raises(ValueError):
        getattr(pcoll, fn)(0.0) if fn != "ring_allreduce_s" else \
            pcoll.ring_allreduce_s(1.0, 2, tier="nvlink")


def test_a_rank_that_raises_fails_the_spawn():
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 2 refuses") as info:
        launch.spawn(torch_parity.rank_raises, 4, 2, backend="gloo",
                     device="cpu", timeout_s=30)
    assert time.monotonic() - t0 < 30
    assert any("rank 2 of 4" in n for n in getattr(info.value,
                                                   "__notes__", []))


def test_a_rank_that_dies_fails_the_spawn_within_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 died"):
        launch.spawn(torch_parity.rank_dies, 3, 1, backend="gloo",
                     device="cpu", timeout_s=30)
    assert time.monotonic() - t0 < 30


def test_spawn_names_its_backend():
    with pytest.raises(ValueError, match="backend"):
        launch.spawn(torch_parity.rank_raises, 2, 0, backend="mpi",
                     device="cpu")


def test_spawn_names_its_device():
    """The caller names the device as it names the backend: a spawn
    without one is refused before any rank starts."""
    with pytest.raises(TypeError, match="device"):
        launch.spawn(torch_parity.rank_raises, 2, 0, backend="gloo")
