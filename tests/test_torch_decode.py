"""PyTorch port parity: the rest of ``models/decode.py``.

``decode_step`` (one token through the cache, read stale) against the
port's full forward and the JAX package's ``decode_step``;
``sample_generate`` in its greedy modes against JAX's greedy
continuation; sampled streams held to reproducibility and validity
(the port's noise comes from a counter-based hash, not ``jax.random``),
and the sampling filters to JAX's on the same logits;
``generate_report``. Same weights on both sides (JAX init, crossed
through numpy), fp32 tiny GQA config.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import decode as jdecode
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import transformer as ptf

from torch_parity import TINY, jax_cfg, make_params, prompts
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
# fp32 on both sides; the cache path and the forward sum in other
# orders (the reference's own bar for this comparison)
LOGIT_TOL = 2e-4


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


@pytest.fixture(scope="module")
def batch():
    return np.asarray(prompts(2, CFG.vocab_size, seed=7, base=8, step=0),
                      np.int32)


def test_decode_step_matches_forward_and_jax(params):
    """Feeding a sequence token by token through the cache reproduces
    the full forward's logits at every position, and the JAX package's
    decode_step logits and cache."""
    jparams, pparams = params
    tokens = np.asarray(prompts(2, CFG.vocab_size, seed=1, base=12, step=0),
                        np.int32)
    full = ptf.forward(pparams, torch.as_tensor(tokens).long(), CFG).numpy()
    pcache = pdecode.init_cache(CFG, 2, 12, device="cpu")
    jcache = jdecode.init_cache(jax_cfg(CFG), 2, 12)
    for pos in range(12):
        pl, pcache = pdecode.decode_step(
            pparams, CFG, torch.as_tensor(tokens[:, pos]).long(), pcache, pos)
        jl, jcache = jdecode.decode_step(jparams, jax_cfg(CFG),
                                         jnp.asarray(tokens[:, pos]), jcache,
                                         pos)
        np.testing.assert_allclose(pl.numpy(), full[:, pos], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for jl, pl in zip(jcache, pcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(pl[name].numpy(),
                                       np.asarray(jl[name]), atol=1e-5,
                                       rtol=1e-5)


def test_sample_generate_greedy_modes_match_jax(params, batch):
    """temperature 0 and top_k 1 both reduce sampling to greedy: the
    port's streams equal its greedy_generate and the JAX package's."""
    jparams, pparams = params
    want = np.asarray(jdecode.greedy_generate(jparams, jax_cfg(CFG),
                                              jnp.asarray(batch), 10))
    greedy = pdecode.greedy_generate(pparams, CFG, batch, 10,
                                     device="cpu").numpy()
    t0 = pdecode.sample_generate(pparams, CFG, batch, 10, 7,
                                 pdecode.SamplingConfig(temperature=0.0),
                                 device="cpu").numpy()
    k1 = pdecode.sample_generate(pparams, CFG, batch, 10, 7,
                                 pdecode.SamplingConfig(top_k=1),
                                 device="cpu").numpy()
    assert (greedy == want).all()
    assert (t0 == want).all() and (k1 == want).all()


def test_sample_generate_reproducible_and_valid(params, batch):
    _, pparams = params
    scfg = pdecode.SamplingConfig(temperature=1.0, top_k=8, top_p=0.9)
    a = pdecode.sample_generate(pparams, CFG, batch, 12, 3, scfg,
                                device="cpu").numpy()
    b = pdecode.sample_generate(pparams, CFG, batch, 12, 3, scfg,
                                device="cpu").numpy()
    assert (a == b).all()
    assert a.shape == (2, 20)
    assert ((a >= 0) & (a < CFG.vocab_size)).all()
    assert (a[:, :8] == batch).all()
    # uniform logits keep every token through the filters, so draws
    # depend on the key
    flat = torch.zeros((4, CFG.vocab_size))
    draws = [pdecode._sample_token(flat, scfg, (k, 0)).numpy()
             for k in range(8)]
    assert all(((d >= 0) & (d < CFG.vocab_size)).all() for d in draws)
    assert any(not (draws[0] == d).all() for d in draws[1:])
    # one key serves a batch: each row draws its own noise
    rows = pdecode._sample_token(torch.zeros((64, CFG.vocab_size)), scfg,
                                 (3, 0))
    assert len(set(rows.tolist())) > 1


def test_sample_generate_single_token_and_penalty_refused(params, batch):
    _, pparams = params
    out = pdecode.sample_generate(pparams, CFG, batch, 1, 0,
                                  pdecode.SamplingConfig(top_p=0.5),
                                  device="cpu")
    assert out.shape == (2, 9)
    with pytest.raises(ValueError, match="repetition_penalty"):
        pdecode.sample_generate(pparams, CFG, batch, 4, 0,
                                pdecode.SamplingConfig(repetition_penalty=1.2),
                                device="cpu")


def test_top_p_tiny_keeps_argmax(params, batch):
    _, pparams = params
    greedy = pdecode.greedy_generate(pparams, CFG, batch, 8, device="cpu")
    nucleus = pdecode.sample_generate(
        pparams, CFG, batch, 8, 9,
        pdecode.SamplingConfig(temperature=1.0, top_p=1e-6), device="cpu")
    assert torch.equal(greedy, nucleus)


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8),
    dict(temperature=1.0, min_p=0.1),
    dict(temperature=0.9, top_k=20, top_p=0.95, min_p=0.02),
], ids=["top_k", "top_p", "min_p", "all"])
def test_sampling_filters_match_jax(knobs, monkeypatch):
    """The logits the port's draw takes its argmax over (the serving
    engines' ``_filtered_scaled``, which ``_sample_token`` calls with one
    row of knobs per row) equal the logits the JAX package's
    ``_sample_token`` hands its categorical draw (captured), filtered
    entries in the same places."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(4, 64) * 3).astype(np.float32)
    captured = []

    def categorical(key, lg, axis=-1):
        captured.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jdecode._sample_token(jnp.asarray(logits),
                          jdecode.SamplingConfig(**knobs),
                          jax.random.PRNGKey(0), jnp.int32)
    want = captured[0]
    scfg = pdecode.SamplingConfig(**knobs)

    def rows(value, dtype):
        return torch.full((4,), value, dtype=dtype)

    got = pdecode._filtered_scaled(
        torch.as_tensor(logits), rows(scfg.temperature, torch.float32),
        rows(scfg.top_k, torch.int32), rows(scfg.top_p, torch.float32),
        rows(scfg.min_p, torch.float32)).numpy()
    assert ((want <= -1e29) == (got <= -1e29)).all()
    live = want > -1e29
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6)


def test_generate_report_is_consistent():
    """The cached continuation's last token is the uncached forward's
    argmax (fp32 tiny model, the reference test's configuration)."""
    cfg = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_seq=32, dtype="float32")
    rep = pdecode.generate_report(cfg, batch=2, prompt_len=8, num_new=8,
                                  device="cpu")
    assert rep["ok"] and rep["cache_consistent"], rep
    assert sorted(rep) == sorted(jdecode.generate_report(
        jax_cfg(cfg), batch=2, prompt_len=8, num_new=8))


def test_decode_entry_points_without_a_card_raise(monkeypatch, params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdecode.sample_generate(params[1], CFG, [[1, 2, 3]], 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdecode.generate_report()
