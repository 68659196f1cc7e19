"""PyTorch port parity: the sharded model and train step
(``transformer.param_specs`` / ``shard_params``, ``forward`` /
``loss_fn`` / ``make_train_step`` with ``mesh``, ``moe`` over an expert
axis) against the JAX package on its 8 virtual devices.

The port's ranks are gloo processes (``parallel.launch.spawn``); the
JAX side runs ``make_train_step`` on a ``jax.sharding.Mesh`` of the
same shape and unsharded, from the same parameters on the same
batches. fp32 bars are ``tests/test_torch_training.py``'s (the sharded
sums differ from the unsharded ones in summation order only) and, for
the logits, ``tests/test_torch_transformer.py``'s 1e-4.
"""

import dataclasses

import numpy as np
import pytest

from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.parallel import launch

import torch_parity
from torch_parity import jax_cfg

FP32_TOL = torch_parity.FP32_TOL
GQA = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=64, max_seq=16, dtype="float32")
# tests/test_moe.py's moe_cfg
MOE = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq=16, dtype="float32", n_experts=4)
_tree = torch_parity.init_tree
_batches = torch_parity.ramp_batches
_jax_mesh = torch_parity.jax_mesh
_jax_train = torch_parity.jax_train
_leaves = torch_parity.leaves
_assert_train = torch_parity.assert_train


@pytest.mark.parametrize("cfg", [GQA, MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("shape,names", [
    ((2, 4), ("data", "model")), ((2,), ("model",)),
    ((2, 4), ("data", "expert")), ((2, 2, 2), ("dcn", "data", "model"))],
    ids=["data_model", "model", "data_expert", "multislice"])
def test_param_specs_have_the_reference_leaves(cfg, shape, names):
    from kind_tpu_sim.models import transformer as jtf

    mesh = _jax_mesh(shape, names)
    want = jtf.param_specs(jax_cfg(cfg), mesh)
    got = ptf.param_specs(cfg, mesh)
    assert [tuple(s) for s in _leaves(want)] == _leaves(got)
    assert tuple(jtf.batch_spec(mesh)) == ptf.batch_spec(mesh)
    assert ptf.param_specs(cfg, None)["embed"] == (None, None)


@pytest.fixture(scope="module")
def tp22():
    """The port at training_mesh(2, 2) (4 gloo ranks), GQA config."""
    return launch.spawn(torch_parity.mesh_rank_tp, 4, _tree(GQA), GQA,
                        (2, 2), ("data", "model"), _batches(GQA),
                        backend="gloo", device="cpu", timeout_s=120)


@pytest.fixture(scope="module")
def tp2():
    """The port at ('model', 2) (2 gloo ranks)."""
    return launch.spawn(torch_parity.mesh_rank_tp, 2, _tree(GQA), GQA,
                        (2,), ("model",), _batches(GQA)[:1],
                        backend="gloo", device="cpu", timeout_s=120)


def test_shard_then_gather_is_the_tree(tp22, tp2):
    assert tp22["roundtrip"] and tp2["roundtrip"]


@pytest.mark.parametrize("which", ["data_model", "model"])
def test_sharded_forward_matches_jax(tp22, tp2, which):
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    got = (tp22 if which == "data_model" else tp2)["logits"]
    tree = _tree(GQA)
    want = np.asarray(jtf.forward(
        __import__("jax").tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(_batches(GQA)[0], jnp.int32), jax_cfg(GQA)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_sharded_loss_matches_jax(tp22):
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    b = _batches(GQA)[0]
    rows = jnp.asarray(b[:4], jnp.int32)  # rank 0's data rows
    want = float(jtf.loss_fn(jax.tree_util.tree_map(jnp.asarray,
                                                    _tree(GQA)),
                             rows, jax_cfg(GQA)))
    np.testing.assert_allclose(tp22["loss"], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_optax", [True, False], ids=["adamw", "sgd"])
def test_meshed_train_steps_match_jax(tp22, use_optax):
    """3 steps at training_mesh(2, 2) against the reference's step on
    the same virtual mesh and unsharded."""
    got = tp22["adamw" if use_optax else "sgd"]
    tree, batches = _tree(GQA), _batches(GQA)
    on_mesh = _jax_train(GQA, tree, batches, use_optax,
                         _jax_mesh((2, 2), ("data", "model")))
    plain = _jax_train(GQA, tree, batches, use_optax)
    _assert_train(got, on_mesh, use_optax)
    _assert_train(got, plain, use_optax)
    assert got[0][-1] < got[0][0]


def test_a_seq_axis_raises_naming_ring_attention(tp22):
    """A 'seq' axis, once refused, is served: on training_mesh(1, 2, 2)
    (no ring: attention over the gathered sequence) the port's forward,
    loss and 3 AdamW steps equal the reference's. The steps are held to
    the reference's unsharded step: its GSPMD step on this mesh (model
    2 and seq 2, no ring) departs from it (parameters 0.058 apart after
    3 steps on the CPU backend), where its ring step on the mesh and its
    step on (1, 1, 2) or (2, 1, 2) agree with it within 4e-6."""
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    got = tp22["seq"]
    tree = _tree(GQA)
    cut = [b[:, :GQA.max_seq] for b in _batches(GQA)]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = jnp.asarray(cut[0], jnp.int32)
    np.testing.assert_allclose(
        got["logits"], np.asarray(jtf.forward(jparams, tokens, jax_cfg(GQA))),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got["loss"], float(jtf.loss_fn(jparams, tokens, jax_cfg(GQA))),
        atol=1e-5, rtol=0)
    _assert_train(got["adamw"], _jax_train(GQA, tree, cut, True), True)


def test_moe_over_an_expert_axis_matches_jax():
    """MoE at ('data', 2, 'expert', 2): one moe_mlp over a global batch
    whose routing is skewed past capacity, and 3 SGD steps, against
    the reference's dedicated-expert-axis step (tests/test_moe.py:75-92)
    and its unsharded step. Capacity is the global batch's: a rank
    routing only its rows keeps other tokens."""
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.models import moe as jmoe

    tree = _tree(MOE, router_bias=2.0)
    batches = _batches(MOE, n=2)
    x = np.random.RandomState(1).randn(8, 8, 32).astype(np.float32)
    (out, aux), trained = launch.spawn(
        torch_parity.mesh_rank_moe, 4, tree, MOE, (2, 2),
        ("data", "expert"), batches, x, backend="gloo", device="cpu",
        timeout_s=120)
    mp = jax.tree_util.tree_map(jnp.asarray, tree["blocks"][0]["moe"])
    want_out, want_aux = jmoe.moe_mlp(jnp.asarray(x), mp, jmoe.MoeConfig(4))
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux, float(want_aux), atol=1e-6, rtol=1e-5)
    # per-rank routing would keep other tokens: the skew binds capacity
    local = np.concatenate([np.asarray(jmoe.moe_mlp(
        jnp.asarray(x[i:i + 4]), mp, jmoe.MoeConfig(4))[0])
        for i in (0, 4)])
    assert np.abs(local - np.asarray(want_out)).max() > 1e-3
    on_mesh = _jax_train(MOE, tree, batches, False,
                         _jax_mesh((2, 2), ("data", "expert")))
    _assert_train(trained, on_mesh, False)
    _assert_train(trained, _jax_train(MOE, tree, batches, False), False)
