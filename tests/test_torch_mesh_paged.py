"""PyTorch port parity: the paged engines and int8 weights under a mesh
(``tests/test_serving.py:1026-1120`` on the port; the dense engines are
``tests/test_torch_mesh_serving.py``).

Two gloo ranks (``parallel.launch.spawn``) serve over ('model', 2):
the dense engine, the paged chunked and paged speculative engines on a
14-block pool (pools hold kv heads over 'model', the block axis is
global; the small pool preempts). Each stream must equal the unsharded
port engine's, the JAX engine's on the same virtual mesh and the JAX
dense engine's off it (fp32, greedy). The paged kernel tier is refused
under a mesh with the reference's message. int8 weights follow the
reference: under a 'model' axis of 2 the placement of a row-parallel
weight's (1, out) scale raises its error; on ('data', 2) they are
replicated and serve.
"""

import dataclasses

import pytest

from kind_tpu_sim_torch.parallel import launch

import torch_parity
from test_torch_mesh_serving import CFG, DENSE, PAGED, REQS

W8A8 = dataclasses.replace(CFG, int8_native=True)


@pytest.fixture(scope="module")
def weights():
    jparams, pparams = torch_parity.make_params(CFG, embed_scale=0.5,
                                                block_scale=2.0)
    return jparams, pparams, torch_parity.tree_numpy(jparams)


@pytest.fixture(scope="module")
def tp(weights):
    cases = [
        dict(engine="ServingEngine", knobs=DENSE, reqs=REQS),
        dict(engine="PagedServingEngine", knobs=dict(PAGED, chunk=8),
             reqs=REQS),
        dict(engine="PagedSpeculativeServingEngine",
             knobs=dict(PAGED, speculative_k=3), reqs=REQS),
        dict(engine="PagedServingEngine",
             knobs=dict(PAGED, chunk=8, paged_kernel=True), reqs=[]),
        dict(engine="ServingEngine", knobs=DENSE, reqs=[], cfg=W8A8,
             int8=True),
        dict(engine="ServingEngine", knobs=DENSE, reqs=REQS[:3], cfg=W8A8,
             int8=True, mesh=((2,), ("data",))),
    ]
    return launch.spawn(torch_parity.mesh_rank_serve, 2, weights[2], CFG,
                        (2,), ("model",), cases, backend="gloo",
                        timeout_s=150)


@pytest.fixture(scope="module")
def jax_plain(weights):
    return torch_parity.jax_serve(weights[0], CFG, "ServingEngine", DENSE,
                                  REQS)


def test_tp_dense_matches_unsharded(weights, tp, jax_plain):
    plain = torch_parity.serve_plain(weights[1], CFG, "ServingEngine",
                                     DENSE, REQS)
    assert tp[0][0] == plain == jax_plain
    assert tp[0][1] == {"axes": {"model": 2}, "backend": "gloo",
                        "rounds": "eager"}


@pytest.mark.parametrize("engine,knobs,i", [
    ("PagedServingEngine", dict(PAGED, chunk=8), 1),
    ("PagedSpeculativeServingEngine", dict(PAGED, speculative_k=3), 2)],
    ids=["paged_chunked", "paged_speculative"])
def test_mesh_serving_paged(weights, tp, jax_plain, engine, knobs, i):
    plain = torch_parity.serve_plain(weights[1], CFG, engine, knobs, REQS)
    assert tp[i][0] == plain == jax_plain
    assert tp[i][0] == torch_parity.jax_serve(
        weights[0], CFG, engine, knobs, REQS,
        torch_parity.jax_mesh((2,), ("model",)))


def test_paged_kernel_tier_is_refused_under_a_mesh(tp):
    kind, msg = tp[3]
    assert kind == "raise" and "kernel" in msg


def test_int8_weights_follow_the_reference_on_a_mesh(weights, tp):
    from kind_tpu_sim.models import quant as jquant

    jq = jquant.quantize_params(weights[0], torch_parity.jax_cfg(W8A8))
    with pytest.raises(ValueError) as want:
        torch_parity.jax_serve(jq, W8A8, "ServingEngine", DENSE, [],
                               torch_parity.jax_mesh((2,), ("model",)))
    kind, msg = tp[4]
    assert kind == "raise"
    tail = ("should be divisible by 2, but it is equal to 1 (full shape: "
            "(1, 32))")
    assert tail in str(want.value) and tail in msg
    served, report = tp[5]
    assert report["axes"] == {"data": 2}
    assert served == torch_parity.jax_serve(
        jq, W8A8, "ServingEngine", DENSE, REQS[:3],
        torch_parity.jax_mesh((2,), ("data",)))

