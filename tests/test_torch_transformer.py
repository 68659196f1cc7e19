"""PyTorch port parity: the transformer forward (models/transformer.py).

The same numpy-seeded weights and tokens go through the JAX package's
``transformer.forward`` and the port's; logits agree at 1e-4 in fp32
(both sides accumulate in fp32, only the summation order differs) and
at 2e-2 in bf16 (one bf16 ulp of rounding placed differently). The
flash path is held to the 2e-4 bar of tests/test_pallas.py, with the
JAX side's Pallas kernel in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import decode as jdecode
from kind_tpu_sim.models import transformer as jtf
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.weights import params_from_numpy

from torch_parity import TINY, jax_cfg, make_params, prompts
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CONFIGS = {
    "fp32_mha": ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_seq=64,
                                dtype="float32"),
    "fp32_gqa": ptf.ModelConfig(vocab_size=64, d_model=64, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=128,
                                max_seq=64, dtype="float32"),
    "fp32_pod": dataclasses.replace(ptf.pod_config(), dtype="float32"),
}


def _tokens(cfg, b, t, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax_fp32(name):
    cfg = CONFIGS[name]
    jparams, pparams = make_params(cfg)
    toks = _tokens(cfg, 2, 24)
    ref = np.asarray(jtf.forward(jparams, jnp.asarray(toks), jax_cfg(cfg)))
    out = ptf.forward(pparams, torch.as_tensor(toks).long(), cfg).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_forward_matches_jax_bf16():
    """bf16 activations and a bf16 serving snapshot: the product
    roundings sit in the same places (linear and PV round to bf16,
    scores and readout accumulate in fp32)."""
    cfg = ptf.ModelConfig(vocab_size=64, d_model=64, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=128, max_seq=64)
    jparams, _ = make_params(cfg)
    jsnap = jdecode.serving_params(jparams, jax_cfg(cfg))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jsnap)
    psnap = params_from_numpy(tree, cfg, device="cpu",
                              dtype=torch.bfloat16)
    toks = _tokens(cfg, 2, 16)
    ref = np.asarray(jtf.forward(jsnap, jnp.asarray(toks), jax_cfg(cfg)))
    out = ptf.forward(psnap, torch.as_tensor(toks).long(), cfg).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kv", [1, 2])
def test_flash_forward_matches_jax_flash(kv):
    """cfg.flash: the port's flash path (plain version on the CPU)
    against the JAX forward through the Pallas kernel (interpret)."""
    cfg = ptf.ModelConfig(vocab_size=64, d_model=64, n_heads=2,
                          n_kv_heads=kv, n_layers=2, d_ff=128, max_seq=64,
                          dtype="float32", flash=True)
    jparams, pparams = make_params(cfg)
    toks = _tokens(cfg, 2, 64)
    ref = np.asarray(jtf.forward(jparams, jnp.asarray(toks), jax_cfg(cfg)))
    out = ptf.forward(pparams, torch.as_tensor(toks).long(), cfg).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)
    dense = ptf.forward(pparams, torch.as_tensor(toks).long(),
                        dataclasses.replace(cfg, flash=False)).numpy()
    np.testing.assert_allclose(out, dense, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(5, 48).astype(np.float32)
    w = rng.rand(48).astype(np.float32) + 0.5
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(jtf._rms_norm(jx, jnp.asarray(w)).astype(jnp.float32))
    px = torch.as_tensor(x).to(getattr(torch, dtype))
    out = ptf._rms_norm(px, torch.as_tensor(w)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_rotary_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(5, 12)]).astype(np.int32)
    ref = np.asarray(jtf._rotary(jnp.asarray(x), jnp.asarray(pos)))
    out = ptf._rotary(torch.as_tensor(x), torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax(causal):
    rng = np.random.RandomState(5)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    v = rng.randn(2, 12, 2, 16).astype(np.float32)
    ref = np.asarray(jtf._attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
    out = ptf._attention(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_init_params_tree_matches_jax():
    """Same tree, shapes and scales as the JAX init (the draws differ:
    torch.Generator is not jax.random)."""
    cfg = CONFIGS["fp32_gqa"]
    jp = jtf.init_params(jax.random.PRNGKey(0), jax_cfg(cfg))
    pp = ptf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(pp) == sorted(jp)
    assert len(pp["blocks"]) == len(jp["blocks"])
    pairs = [(jp["embed"], pp["embed"]),
             (jp["final_norm"], pp["final_norm"])]
    for jb, pb in zip(jp["blocks"], pp["blocks"]):
        assert sorted(jb) == sorted(pb)
        pairs += [(jb[name], pb[name]) for name in jb]
    for jleaf, pleaf in pairs:
        assert tuple(pleaf.shape) == jleaf.shape
        assert pleaf.dtype == torch.float32
        np.testing.assert_allclose(float(pleaf.std()),
                                   float(jnp.std(jleaf)), rtol=0.2,
                                   atol=1e-6)


def test_serving_params_layout_matches_jax():
    cfg = dataclasses.replace(CONFIGS["fp32_gqa"], dtype="bfloat16")
    jparams, pparams = make_params(cfg)
    jsnap = jdecode.serving_params(jparams, jax_cfg(cfg))
    psnap = pdecode.serving_params(pparams, cfg)
    for jb, pb in zip(jsnap["blocks"], psnap["blocks"]):
        for name in jb:
            want = torch.bfloat16 if jb[name].dtype == jnp.bfloat16 \
                else torch.float32
            assert pb[name].dtype == want, name
    assert psnap["embed"].dtype == torch.bfloat16
    assert psnap["final_norm"].dtype == torch.float32


def test_params_from_numpy_checks_shapes():
    cfg = CONFIGS["fp32_mha"]
    _, pparams = make_params(cfg)
    tree = {"embed": np.zeros((cfg.vocab_size + 1, cfg.d_model),
                              np.float32),
            "final_norm": np.ones(cfg.d_model, np.float32),
            "blocks": [{} for _ in range(cfg.n_layers)]}
    with pytest.raises(ValueError, match="embed shape"):
        params_from_numpy(tree, cfg, device="cpu")
    assert pparams["embed"].device.type == "cpu"


def test_unported_config_features_raise():
    """``n_experts`` is served: ``init_params`` builds the reference's
    MoE subtree in place of the dense MLP (router (d, e), w_up (e, d,
    d_ff), w_down (e, d_ff, d), fp32) and the forward runs it, returning
    its auxiliary loss. ``seq_parallel`` is served too: without a mesh
    the reference's ``_use_ring`` is False and attention is plain, so
    the port's forward equals the JAX forward of the same config (the
    fp32 bar) and ``greedy_generate`` equals the engine's stream and the
    JAX decoder's on the tiny config."""
    cfg = dataclasses.replace(CONFIGS["fp32_mha"], n_experts=4)
    params = ptf.init_params(cfg, device="cpu")
    jparams = jtf.init_params(jax.random.PRNGKey(0), jax_cfg(cfg))
    for pb, jb in zip(params["blocks"], jparams["blocks"]):
        assert sorted(pb) == sorted(jb)
        assert sorted(pb["moe"]) == sorted(jb["moe"])
        for name, leaf in jb["moe"].items():
            assert tuple(pb["moe"][name].shape) == leaf.shape
            assert pb["moe"][name].dtype == torch.float32
    toks = torch.as_tensor(_tokens(cfg, 2, 16)).long()
    logits, aux = ptf.forward(params, toks, cfg, return_aux=True)
    assert torch.isfinite(logits).all() and float(aux) > 0

    sp = dataclasses.replace(TINY, seq_parallel=True)
    jparams, pparams = make_params(sp, embed_scale=0.5, block_scale=6.0)
    assert sorted(ptf.init_params(sp, device="cpu")) == sorted(pparams)
    toks = _tokens(sp, 2, 24)
    ref = np.asarray(jtf.forward(jparams, jnp.asarray(toks), jax_cfg(sp)))
    out = ptf.forward(pparams, torch.as_tensor(toks).long(), sp).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    batch = np.asarray(prompts(2, sp.vocab_size, seed=5, base=9, step=0),
                       np.int32)
    gen = pdecode.greedy_generate(pparams, sp, batch, 12, chunk=4,
                                  device="cpu").numpy()
    want = np.asarray(jdecode.greedy_generate(jparams, jax_cfg(sp),
                                              jnp.asarray(batch), 12,
                                              chunk=4))
    assert (gen == want).all()
    eng = pserving.ServingEngine(
        pparams, sp, pserving.ServingConfig(max_slots=2, max_len=32,
                                            chunk=4), device="cpu")
    for i, row in enumerate(batch):
        eng.submit(pserving.Request(f"r{i}", row.tolist(), max_new=12))
    done = {c.request_id: c.tokens for c in eng.run()}
    for i, row in enumerate(gen):
        assert done[f"r{i}"] == row[9:].tolist()
