"""PyTorch port parity: a Switch-MoE over a 'seq' axis against the JAX
package on its 8 virtual devices.

Over (data 2, seq 4) each rank holds a block of rows and columns, so
its tokens interleave with the other 'seq' ranks' row by row in the
reference's flattened (batch, seq) queue order. The router is skewed
past capacity (``torch_parity.init_tree``'s ``router_bias``), so that
order decides which tokens stay: one ``moe_mlp`` over the global batch,
2 SGD steps with the ring (every position routed, the final one too,
as the reference's ring loss does) against the reference's on the same
mesh, and the loss without the ring (the final position not routed, as
the reference's forward over ``tokens[:, :-1]``). One gloo world of 8.
"""

import dataclasses

import numpy as np
import pytest

from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.parallel import launch

import torch_parity
from torch_parity import jax_cfg

# tests/test_moe.py's moe_cfg at 16 tokens, which split over 'seq'
MOE = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq=16, dtype="float32", n_experts=4)
BATCHES = torch_parity.ramp_batches(MOE, n=2, batch=8, seq=16)
X = np.random.RandomState(1).randn(8, 16, 32).astype(np.float32)


@pytest.fixture(scope="module")
def tree():
    return torch_parity.init_tree(MOE, router_bias=2.0)


@pytest.fixture(scope="module")
def world(tree):
    return launch.spawn(torch_parity.mesh_rank_seq_moe, 8, tree, MOE,
                        BATCHES, X, backend="gloo", device="cpu",
                        timeout_s=120)


def _jnp_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_moe_over_seq_routes_the_global_batch(world, tree):
    """One moe_mlp over (data 2, seq 4): every rank routes its block of
    the global (8, 16) tokens, skewed past capacity; out and aux equal
    the reference's over the whole batch. Routing each rank's block, or
    each row, alone would keep other tokens."""
    import jax.numpy as jnp

    from kind_tpu_sim.models import moe as jmoe

    mp = _jnp_tree(tree["blocks"][0]["moe"])
    want_out, want_aux = jmoe.moe_mlp(jnp.asarray(X), mp, jmoe.MoeConfig(4))
    out, aux = world["moe"]
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux, float(want_aux), atol=1e-6, rtol=1e-5)
    rows = np.concatenate([np.asarray(jmoe.moe_mlp(
        jnp.asarray(X[:, i:i + 4]), mp, jmoe.MoeConfig(4))[0])
        for i in range(0, 16, 4)], axis=1)
    assert np.abs(rows - np.asarray(want_out)).max() > 1e-3


def test_moe_train_and_loss_over_seq_match_jax(world, tree):
    """The skewed MoE on (data 2, seq 4): 2 SGD steps with the ring
    against the reference's on the same mesh (every position routed,
    the final one too), and the loss without the ring against the
    reference's (the final position not routed)."""
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    ring = dataclasses.replace(MOE, seq_parallel=True)
    mesh = torch_parity.jax_mesh((2, 4), ("data", "seq"))
    on_mesh = torch_parity.jax_train(ring, tree, BATCHES, False, mesh)
    torch_parity.assert_train(world["ring"], on_mesh, False)
    want = float(jtf.loss_fn(_jnp_tree(tree),
                             jnp.asarray(BATCHES[0], jnp.int32),
                             jax_cfg(MOE)))
    np.testing.assert_allclose(world["loss"], want, atol=1e-5, rtol=0)
