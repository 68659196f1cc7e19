"""PyTorch port parity: the loss and the train step (models/transformer.py).

The JAX package's ``make_train_step`` and the port's run five steps
from the same initial parameters (JAX init, crossed through numpy) on
the same token batches (ramps mod vocab made with numpy), under AdamW
(``use_optax=True``) and plain SGD (``use_optax=False``). Losses and
final parameters must agree. With ``flash=True`` the JAX side runs the
Pallas flash kernels in interpret mode with their ``custom_vjp``
backward, and the port its plain flash backward.

Tolerances (fp32): both sides accumulate every product in fp32 and
differ only in summation order, so after five steps the losses (of
order 10-25) agree to 1e-4 and the parameters to 5e-5 under AdamW
(whose normalised update turns a relative gradient difference into an
absolute parameter one of up to lr x it) and 5e-6 under SGD.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import transformer as jtf
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.ops import flash_attention as fa
from kind_tpu_sim_torch.weights import params_from_numpy

from torch_parity import jax_cfg
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

STEPS = 5
# tests/test_model.py's config (there in bf16; fp32 first here)
MODEL = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                        d_ff=64, max_seq=16, dtype="float32")
# tests/test_pallas.py:301's flash config
PALLAS_FLASH = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                               n_layers=2, d_ff=64, max_seq=33,
                               dtype="float32", flash=True)
GQA_FLASH = dataclasses.replace(MODEL, n_heads=4, n_kv_heads=2, flash=True)
CONFIGS = {"model": MODEL, "pallas_flash": PALLAS_FLASH,
           "gqa_flash": GQA_FLASH}
FP32_TOL = {True: (1e-4, 5e-5), False: (1e-4, 5e-6)}  # use_optax: loss, params


def _tree(cfg, seed=0):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jtf.init_params(jax.random.PRNGKey(seed), jax_cfg(cfg)))


def _batches(cfg, batch=4, seed=0):
    """STEPS ramp batches of max_seq + 1 tokens (max_seq trained
    positions), as ``sample_batch`` makes them."""
    rng = np.random.RandomState(seed)
    seq = cfg.max_seq + 1
    return [((rng.randint(0, cfg.vocab_size, (batch, 1))
              + np.arange(seq)[None, :]) % cfg.vocab_size).astype(np.int32)
            for _ in range(STEPS)]


def _jax_run(cfg, tree, batches, use_optax):
    step, _ = jtf.make_train_step(jax_cfg(cfg), use_optax=use_optax)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = {"params": params, "opt": None}
    if use_optax:
        import optax

        state["opt"] = optax.adamw(1e-2).init(params)
    losses = []
    for tokens in batches:
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses, state["params"]


def _port_run(cfg, tree, batches, use_optax):
    step, init = ptf.make_train_step(cfg, use_optax=use_optax, device="cpu")
    state = init(params_from_numpy(tree, cfg, device="cpu"))
    losses = []
    for tokens in batches:
        state, loss = step(state, torch.as_tensor(tokens).long())
        assert not loss.requires_grad
        losses.append(float(loss))
    return losses, state["params"]


def _leaf_pairs(jparams, pparams):
    def block_leaves(node):  # ptf._leaves's order: keys sorted, nested too
        return [leaf for key in sorted(node) for leaf in (
            block_leaves(node[key]) if isinstance(node[key], dict)
            else [node[key]])]

    jleaves = ([jparams["embed"], jparams["final_norm"]]
               + [leaf for b in jparams["blocks"]
                  for leaf in block_leaves(b)])
    return [(np.asarray(j, np.float32), p.detach().float().numpy())
            for j, p in zip(jleaves, ptf._leaves(pparams))]


@pytest.mark.parametrize("use_optax", [True, False], ids=["adamw", "sgd"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_steps_match_jax(name, use_optax):
    cfg = CONFIGS[name]
    tree, batches = _tree(cfg), _batches(cfg)
    want_losses, want = _jax_run(cfg, tree, batches, use_optax)
    got_losses, got = _port_run(cfg, tree, batches, use_optax)
    loss_tol, param_tol = FP32_TOL[use_optax]
    np.testing.assert_allclose(got_losses, want_losses, atol=loss_tol,
                               rtol=0)
    for j, p in _leaf_pairs(want, got):
        np.testing.assert_allclose(p, j, atol=param_tol, rtol=0)
    assert got_losses[-1] < got_losses[0]


def test_bf16_activation_train_steps_match_jax():
    """tests/test_model.py's config as it stands (bf16 activations,
    fp32 parameters) with flash, under SGD. Every activation rounds to
    bf16 (2^-8 relative) on both sides at different places in the
    backward, so the bars are 2e-2 on the losses (of order 20) and
    1e-3 on the parameters. AdamW is left to the fp32 cases: its
    normalised update turns bf16 noise in near-zero gradients into
    steps of up to lr."""
    cfg = dataclasses.replace(MODEL, dtype="bfloat16", flash=True)
    tree, batches = _tree(cfg), _batches(cfg)
    want_losses, want = _jax_run(cfg, tree, batches, False)
    got_losses, got = _port_run(cfg, tree, batches, False)
    np.testing.assert_allclose(got_losses, want_losses, atol=2e-2, rtol=0)
    for j, p in _leaf_pairs(want, got):
        np.testing.assert_allclose(p, j, atol=1e-3, rtol=0)


def test_flash_and_dense_losses_agree():
    """test_pallas.py:294 on the port: one SGD step of the flash config
    and of the dense one from the same parameters, losses within 1e-3."""
    tree, batches = _tree(PALLAS_FLASH, seed=1), _batches(PALLAS_FLASH)
    dense = dataclasses.replace(PALLAS_FLASH, flash=False)
    losses = {cfg.flash: _port_run(cfg, tree, batches[:1], False)[0][0]
              for cfg in (PALLAS_FLASH, dense)}
    assert np.isfinite(losses[True])
    assert abs(losses[True] - losses[False]) < 1e-3, losses


def test_loss_fn_matches_jax():
    cfg = GQA_FLASH
    tree, (tokens, *_) = _tree(cfg), _batches(cfg)
    want = float(jtf.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(tokens), jax_cfg(cfg)))
    got = ptf.loss_fn(params_from_numpy(tree, cfg, device="cpu"),
                      torch.as_tensor(tokens).long(), cfg)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=0)


def test_train_step_on_cpu_launches_no_kernel_and_updates_in_place():
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    step, init = ptf.make_train_step(GQA_FLASH, device="cpu")
    state = init(torch.Generator().manual_seed(0))
    embed = state["params"]["embed"]
    before = embed.detach().clone()
    tokens = ptf.sample_batch(torch.Generator().manual_seed(1), GQA_FLASH, 2,
                              device="cpu")
    state, loss = step(state, tokens)
    assert state["params"]["embed"] is embed
    assert not torch.equal(embed.detach(), before)
    assert all(p.grad is None for p in ptf._leaves(state["params"]))
    assert np.isfinite(float(loss))
    assert counts == (fa.flash_attention.launches,
                      fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches)


def test_sample_batch_is_a_seeded_ramp():
    gen = torch.Generator().manual_seed(3)
    tokens = ptf.sample_batch(gen, MODEL, 5, 20, device="cpu")
    assert tokens.shape == (5, 20) and tokens.dtype == torch.long
    assert ((tokens[:, 1:] - tokens[:, :-1]) % MODEL.vocab_size == 1).all()
    assert int(tokens.min()) >= 0 and int(tokens.max()) < MODEL.vocab_size
    again = ptf.sample_batch(torch.Generator().manual_seed(3), MODEL, 5, 20,
                             device="cpu")
    assert torch.equal(tokens, again)
    assert ptf.sample_batch(gen, MODEL, 2, device="cpu").shape == (
        2, MODEL.max_seq)


REMAT_CASES = {"model_bf16": dataclasses.replace(MODEL, dtype="bfloat16"),
               "model": MODEL, "gqa_flash": GQA_FLASH}


@pytest.mark.parametrize("name", sorted(REMAT_CASES))
def test_remat_matches(name):
    """tests/test_model.py:107 on the port, plus the gradients: each block
    under torch.utils.checkpoint gives the loss of the plain forward
    (held at 1e-5, as the reference holds it) and the same gradients
    (the backward recomputes the block with the same operations on the
    same inputs), and the JAX remat loss (1e-5 in fp32; 1e-3 relative in
    bf16, whose activations round at other places in the two)."""
    cfg = REMAT_CASES[name]
    cfg_remat = dataclasses.replace(cfg, remat=True)
    tree, (tokens, *_) = _tree(cfg), _batches(cfg)
    tokens_t = torch.as_tensor(tokens).long()

    def loss_and_grads(c):
        params = params_from_numpy(tree, c, device="cpu")
        leaves = ptf._leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = ptf.loss_fn(params, tokens_t, c)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    counts = fa.flash_attention.launches
    plain_loss, plain_grads = loss_and_grads(cfg)
    remat_loss, remat_grads = loss_and_grads(cfg_remat)
    assert fa.flash_attention.launches == counts
    np.testing.assert_allclose(remat_loss, plain_loss, rtol=1e-5)
    for g_remat, g_plain in zip(remat_grads, plain_grads):
        torch.testing.assert_close(g_remat, g_plain, rtol=1e-5, atol=1e-7)
    want = float(jtf.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(tokens), jax_cfg(cfg_remat)))
    np.testing.assert_allclose(remat_loss, want, rtol=1e-5 if
                               cfg.dtype == "float32" else 1e-3)


@pytest.mark.parametrize("field", ["n_experts", "int8_kv", "int8_native",
                                   "seq_parallel"])
def test_unported_training_features_raise(field):
    """Every config feature trains now. ``n_experts`` trains through
    autograd with the MoE auxiliary loss in the loss, as the JAX
    ``make_train_step`` does (AdamW, the fp32 bars above); the int8
    serving flags take no path in training (fp32 parameters are plain
    tensors), and ``seq_parallel`` without a mesh is plain attention on
    both sides (the reference's ``_use_ring`` needs a mesh with a
    ``seq`` axis), so those steps equal the plain config's exactly and
    the JAX package's at the fp32 bars. ``seq_parallel`` runs all
    ``STEPS`` steps."""
    value = 2 if field == "n_experts" else True
    cfg = dataclasses.replace(MODEL, **{field: value})
    steps = STEPS if field == "seq_parallel" else 2
    tree, batches = _tree(cfg), _batches(cfg)[:steps]
    want_losses, want = _jax_run(cfg, tree, batches, True)
    got_losses, got = _port_run(cfg, tree, batches, True)
    loss_tol, param_tol = FP32_TOL[True]
    np.testing.assert_allclose(got_losses, want_losses, atol=loss_tol,
                               rtol=0)
    for j, p in _leaf_pairs(want, got):
        np.testing.assert_allclose(p, j, atol=param_tol, rtol=0)
    if field != "n_experts":
        assert got_losses == _port_run(MODEL, tree, batches, True)[0]
