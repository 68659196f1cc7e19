"""PyTorch port parity: the model over a 'seq' axis (sequence
parallelism) against the JAX package on its 8 virtual devices.

``tests/test_ring_attention.py``'s model cases on the port: the
``seq_parallel`` forward on training_mesh(2, 1, 4) at 2e-4, and 3
AdamW steps on training_mesh(2, 2, 2) at the fp32 bars of
``tests/test_torch_training.py``; the dense config on the same mesh
(attention over the gathered sequence); the input pipeline and a
checkpoint restored across meshes with the axis present. The MoE over 'seq' is ``tests/test_torch_seq_moe.py``. The
port's ranks are one gloo world of 8.

The gathered path's steps are held to the reference's unsharded step:
the reference's own GSPMD step on a mesh with 'model' and 'seq' both 2
departs from it (tests/test_torch_tp_training.py), where its ring step
on the same mesh agrees with it.
"""

import dataclasses

import numpy as np
import pytest

from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.parallel import launch

import torch_parity
from torch_parity import jax_cfg

# tests/test_ring_attention.py's model (fp32, 2 layers, GQA 4/2) at
# max_seq 16; the batches are 16 tokens, which split over 'seq'
CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=64, max_seq=16, dtype="float32")
RING = dataclasses.replace(CFG, seq_parallel=True)
BATCHES = torch_parity.ramp_batches(CFG, batch=8, seq=16)


@pytest.fixture(scope="module")
def tree():
    return torch_parity.init_tree(CFG)


@pytest.fixture(scope="module")
def world(tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_checkpoint")
    return launch.spawn(torch_parity.mesh_rank_seq, 8, tree, CFG, BATCHES,
                        str(root), backend="gloo", device="cpu", timeout_s=120)


@pytest.fixture(scope="module")
def jax_plain(tree):
    """The reference's unsharded 3 AdamW steps."""
    return torch_parity.jax_train(CFG, tree, BATCHES, True)


def _jnp_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_seq_parallel_forward_matches_jax(world, tree):
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    mesh = torch_parity.jax_mesh((2, 1, 4), ("data", "model", "seq"))
    tokens = jnp.asarray(BATCHES[0], jnp.int32)
    want = np.asarray(jtf.forward(_jnp_tree(tree), tokens, jax_cfg(RING),
                                  mesh=mesh))
    np.testing.assert_allclose(world["forward"], want, atol=2e-4, rtol=2e-4)
    dense = np.asarray(jtf.forward(_jnp_tree(tree), tokens, jax_cfg(CFG)))
    np.testing.assert_allclose(world["forward"], dense, atol=2e-4, rtol=2e-4)


def test_ring_train_steps_match_jax_on_the_same_mesh(world, tree,
                                                     jax_plain):
    """3 AdamW steps with the ring on training_mesh(2, 2, 2) (data,
    model and seq all 2) against the reference's on the same virtual
    mesh and unsharded."""
    mesh = torch_parity.jax_mesh((2, 2, 2), ("data", "model", "seq"))
    on_mesh = torch_parity.jax_train(RING, tree, BATCHES, True, mesh)
    torch_parity.assert_train(world["ring"], on_mesh, True)
    torch_parity.assert_train(world["ring"], jax_plain, True)
    assert world["ring"][0][-1] < world["ring"][0][0]


def test_dense_config_on_a_seq_mesh_matches_jax(world, tree, jax_plain):
    """No ring on training_mesh(2, 2, 2): attention over the gathered
    sequence. Logits and loss equal the reference's forward; 3 AdamW
    steps its unsharded step."""
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    params = _jnp_tree(tree)
    tokens = jnp.asarray(BATCHES[0], jnp.int32)
    np.testing.assert_allclose(
        world["gathered_logits"],
        np.asarray(jtf.forward(params, tokens, jax_cfg(CFG))),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        world["gathered_loss"],
        float(jtf.loss_fn(params, tokens, jax_cfg(CFG))), atol=1e-5, rtol=0)
    torch_parity.assert_train(world["gathered"], jax_plain, True)


def test_input_pipeline_places_blocks_on_a_seq_mesh(world):
    """``data.input_pipeline(mesh=...)`` over training_mesh(2, 2, 2):
    each rank's block (its rows, its columns over 'seq'), gathered, is
    the reference's global batch."""
    from kind_tpu_sim import data as jdata

    want = list(jdata.input_pipeline(jax_cfg(CFG), batch=8, steps=2))
    assert len(world["pipeline"]) == len(want) == 2
    for got, w in zip(world["pipeline"], want):
        np.testing.assert_array_equal(got, np.asarray(w))


def test_checkpoint_restores_across_meshes_with_a_seq_axis(world):
    """A ring state of training_mesh(2, 2, 2) after one AdamW step,
    saved and restored onto training_mesh(4, 2): every parameter and
    moment, gathered whole, is the saved one."""
    (params_a, moments_a), (params_b, moments_b) = world["checkpoint"]
    assert len(params_a) == len(params_b) == len(moments_a)
    for a, b in zip(params_a, params_b):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(moments_a, moments_b):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
