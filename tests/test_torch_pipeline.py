"""PyTorch port parity: pipeline parallelism (``parallel/pipeline.py``)
against the JAX package on its 8 virtual devices.

The cases of ``tests/test_pipeline.py`` at 2e-4: 2 and 4 stages (the
reference's slow case, run here), extra microbatches, a (data, stage)
mesh, a ragged batch and the stacked parameters' shapes, each held to
the reference's pipeline and to its plain forward. The port's ranks are
gloo worlds of 2, 4 and 8 (a mesh spans its world), started at once.

A 4-expert Switch-MoE config runs on the ('stage', 4) and ('data', 2,
'stage', 4) worlds, its router biased by 0 and by 3 (most tokens then
pick expert 0 and capacity drops tokens), held at 2e-4 to the
reference's pipeline alone: both pipelines route each microbatch by
itself, so neither equals the plain forward there (ROADMAP Queue C,
C-11).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.parallel import launch
from kind_tpu_sim_torch.parallel import pipeline as ppipe

import torch_parity

TOL = 2e-4
# tests/test_pipeline.py's cfg: fp32, 4 layers
CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=4,
                      d_ff=64, max_seq=16, dtype="float32")
MOE = dataclasses.replace(CFG, n_experts=4)
# router bias -> the MoE tree, the reference's init with it added
MOE_TREES = {bias: torch_parity.init_tree(MOE, router_bias=bias)
             for bias in (0.0, 3.0)}


def _tokens(seed, batch):
    rng = np.random.RandomState(seed)
    return ((rng.randint(0, CFG.vocab_size, (batch, 1))
             + np.arange(16)[None, :]) % CFG.vocab_size).astype(np.int64)


def _moe(bias):
    return (MOE_TREES[bias], MOE)


# world -> (mesh shape, names, [(name, tokens, n_microbatches[, (tree,
# cfg)])])
WORLDS = {
    2: ((2,), ("stage",), [("stages_2", _tokens(1, 4), None),
                           ("extra_microbatches", _tokens(2, 8), 4)]),
    4: ((4,), ("stage",), [("stages_4", _tokens(1, 8), None),
                           ("ragged", _tokens(4, 6), None),
                           ("moe_stages_4_bias_0", _tokens(5, 8), None,
                            _moe(0.0)),
                           ("moe_stages_4_bias_3", _tokens(5, 8), None,
                            _moe(3.0))]),
    8: ((2, 4), ("data", "stage"), [
        ("data_stage", _tokens(3, 8), None),
        ("moe_data_stage_bias_0", _tokens(6, 8), None, _moe(0.0)),
        ("moe_data_stage_bias_3", _tokens(6, 8), None, _moe(3.0))]),
}


@pytest.fixture(scope="module")
def tree():
    return torch_parity.init_tree(CFG)


@pytest.fixture(scope="module")
def results(tree):
    def run(world):
        shape, names, cases = WORLDS[world]
        return launch.spawn(torch_parity.mesh_rank_pipe, world, tree, CFG,
                            shape, names,
                            [(t, m, *own) for _, t, m, *own in cases],
                            backend="gloo", device="cpu", timeout_s=120)

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        outs = dict(zip(WORLDS, pool.map(run, WORLDS)))
    return {case[0]: got for world, (_, _, cases) in WORLDS.items()
            for case, got in zip(cases, outs[world])}


def _case(name):
    for shape, names, cases in WORLDS.values():
        for cname, tokens, n_micro, *own in cases:
            if cname == name:
                return shape, names, tokens, n_micro
    raise KeyError(name)


@pytest.mark.parametrize("name", ["stages_2", "stages_4",
                                  "extra_microbatches", "data_stage"])
def test_pipeline_matches_the_reference(results, tree, name):
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf
    from kind_tpu_sim.parallel import pipeline as jpipe

    shape, names, tokens, n_micro = _case(name)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = jnp.asarray(tokens, jnp.int32)
    got = results[name]
    want = np.asarray(jpipe.pipeline_forward(
        params, toks, torch_parity.jax_cfg(CFG),
        torch_parity.jax_mesh(shape, names), n_microbatches=n_micro))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    plain = np.asarray(jtf.forward(params, toks, torch_parity.jax_cfg(CFG)))
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["moe_stages_4_bias_0",
                                  "moe_stages_4_bias_3",
                                  "moe_data_stage_bias_0",
                                  "moe_data_stage_bias_3"])
def test_moe_pipeline_matches_the_reference(results, name):
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.parallel import pipeline as jpipe

    shape, names, tokens, n_micro = _case(name)
    bias = 3.0 if name.endswith("3") else 0.0
    params = jax.tree_util.tree_map(jnp.asarray, MOE_TREES[bias])
    want = np.asarray(jpipe.pipeline_forward(
        params, jnp.asarray(tokens, jnp.int32), torch_parity.jax_cfg(MOE),
        torch_parity.jax_mesh(shape, names), n_microbatches=n_micro))
    np.testing.assert_allclose(results[name], want, atol=TOL, rtol=TOL)


def test_pipeline_rejects_ragged_batch(results):
    assert "not divisible" in results["ragged"]
    assert results["ragged"] == "batch 6 not divisible into 4 microbatches"


def test_stack_stage_params_shapes(tree):
    from kind_tpu_sim.parallel import pipeline as jpipe

    params = torch_parity.params_from_numpy(tree, CFG, device="cpu")
    stacked = ppipe.stack_stage_params(params, 2)
    assert stacked["wqkv"].shape == (2, 2, CFG.d_model, 3 * CFG.d_model)
    want = jpipe.stack_stage_params(tree, 2)
    assert {k: tuple(v.shape) for k, v in stacked.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    np.testing.assert_array_equal(stacked["w_up"][1, 0].numpy(),
                                  tree["blocks"][2]["w_up"])
    with pytest.raises(ValueError, match="not divisible"):
        ppipe.stack_stage_params(params, 3)


def test_microbatch_over_data_must_divide():
    """The reference's second check: a microbatch that does not split
    over 'data' raises before any rank runs (the message names both)."""
    class FakeMesh:
        shape = {"data": 4, "stage": 2}

    params = {"embed": None}
    with pytest.raises(ValueError, match="not divisible over the 'data'"):
        ppipe.pipeline_forward(params, np.zeros((4, 16)), CFG, FakeMesh())
