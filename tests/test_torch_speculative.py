"""PyTorch port parity: speculative decoding (models/speculative.py).

Same weights (JAX init, crossed through numpy), prompts and buffers on
both sides, fp32 tiny GQA config with flash=True (the JAX side's Pallas
flash kernel in interpret mode, the port's wrapper on its plain
version). Greedy tokens and verify-step counts must be equal; the
draft proposals, accept counts and emitted windows exactly; raw-model
logprobs within 1e-5 (fp32 log_softmax, summed in another order).
Sampled acceptance draws from the port's own counter-based noise, so it
is held to JAX on a shared uniform (the accept count) and to the target
law by Monte Carlo (the bonus token).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import speculative as jspec
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import speculative as pspec
from kind_tpu_sim_torch.models import transformer as ptf

from torch_parity import TINY, jax_cfg, make_params
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
LP_TOL = 1e-5
# 1/sqrt(n) noise of a 40000-sample histogram is ~2.5e-3 at p = 0.25;
# the reference's own Monte Carlo bar
LAW_ATOL = 0.012


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


def batch(seed, rows, length):
    return np.random.RandomState(seed).randint(
        0, CFG.vocab_size, size=(rows, length)).astype(np.int32)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_propose_ngram_matches_jax(k):
    """Random buffers over a 6-token alphabet (bigrams recur), a row of
    distinct tokens (no match: repeat the last), a row whose only match
    sits at the buffer's end (the clamped slice), ragged totals."""
    rng = np.random.RandomState(k)
    out = rng.randint(0, 6, size=(6, 24)).astype(np.int32)
    out[1] = np.arange(24) + 10
    out[2, :6] = [1, 2, 9, 9, 1, 2]
    total = np.asarray([24, 20, 6, 2, 1, 13], np.int32)
    want = np.asarray(jspec.propose_ngram(jnp.asarray(out),
                                          jnp.asarray(total), k))
    got = pspec.propose_ngram(torch.as_tensor(out).long(),
                              torch.as_tensor(total).long(), k).numpy()
    assert (got == want).all()
    assert (got[1] == out[1, 19]).all()


def _accept_inputs(seed, b=5, k=3, vocab=16, length=20):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, k + 1, vocab).astype(np.float32)
    preds = logits.argmax(-1)
    # row r agrees with the model on its first r drafts, then differs
    draft = preds[:, :k].copy()
    for r in range(b):
        if r < k:
            draft[r, r] = (draft[r, r] + 1) % vocab
    out = rng.randint(0, vocab, size=(b, length)).astype(np.int32)
    total = np.asarray([4, 9, length - 2, 11, 6][:b], np.int32)
    active = np.asarray([True, True, True, False, True][:b])
    return logits, draft, out, total, active


def test_greedy_accept_and_emit_matches_jax():
    """Accept counts 0..k (one past the buffer's end, clamped), an
    inactive row frozen: out, total, emit and m exact, logprobs to
    LP_TOL."""
    k = 3
    logits, draft, out, total, active = _accept_inputs(0, k=k)
    j = jspec._accept_and_emit(jnp.asarray(logits), jnp.asarray(draft),
                               jnp.asarray(out), jnp.asarray(total),
                               jnp.asarray(active), None, k=k)
    p = pspec._accept_and_emit(
        torch.as_tensor(logits), torch.as_tensor(draft).long(),
        torch.as_tensor(out).long(), torch.as_tensor(total).long(),
        torch.as_tensor(active), None, k=k)
    for name, a, b in zip(("out", "total", "emit", "m"), j[:4], p[:4]):
        assert (np.asarray(a) == b.numpy()).all(), name
    np.testing.assert_allclose(p[4].numpy(), np.asarray(j[4]), atol=LP_TOL)
    assert p[3].tolist() == [0, 1, 2, 0, 3]


def test_rejection_select_accept_count_matches_jax():
    """The same probs, draft and uniforms: the accept count is JAX's
    exactly (the bonus token comes from each side's own noise)."""
    rng = np.random.RandomState(1)
    b, k, vocab = 64, 4, 12
    probs = rng.dirichlet(np.ones(vocab) * 0.3, size=(b, k + 1)).astype(
        np.float32)
    draft = np.stack([rng.choice(vocab, size=k, p=None)
                      for _ in range(b)]).astype(np.int32)
    draft[:16] = probs[:16, :k].argmax(-1)     # likely accepted
    u = rng.rand(b, k + 1).astype(np.float32)
    keys = jnp.repeat(jax.vmap(jax.random.PRNGKey)(
        jnp.arange(b, dtype=jnp.uint32))[:, None, :], k + 1, axis=1)
    m_j, _ = jspec._rejection_select(jnp.asarray(probs), jnp.asarray(draft),
                                     jnp.asarray(u), keys)
    seeds = torch.stack([torch.arange(b), torch.zeros(b, dtype=torch.long)],
                        1)
    gidx = torch.arange(k + 1)[None, :].repeat(b, 1)
    m_p, bonus = pspec._rejection_select(
        torch.as_tensor(probs), torch.as_tensor(draft).long(),
        torch.as_tensor(u), seeds, gidx)
    assert m_p.tolist() == np.asarray(m_j).tolist()
    assert len(set(m_p.tolist())) > 2
    assert ((bonus >= 0) & (bonus < vocab)).all()


@pytest.mark.parametrize("draft_pick", ["likeliest", "rarest"])
def test_rejection_select_preserves_the_target_law(draft_pick):
    """Monte Carlo over 40000 rows (each its own seed): the token emitted
    at the first position, draft if accepted else the bonus from the
    residual, follows p within LAW_ATOL, whichever draft is proposed."""
    vocab, k, n = 8, 1, 40000
    rng = np.random.RandomState(0)
    p_row = rng.dirichlet(np.ones(vocab))
    probs = torch.as_tensor(np.tile(p_row, (n, k + 1, 1)), dtype=torch.float32)
    pick = int(np.argmax(p_row) if draft_pick == "likeliest"
               else np.argmin(p_row))
    draft = torch.full((n, k), pick, dtype=torch.long)
    seeds = torch.stack([torch.arange(n), torch.full((n,), 7)], 1)
    gidx = torch.full((n, k + 1), 3, dtype=torch.long) + torch.arange(k + 1)
    u = pspec._counter_uniform(seeds, gidx, 0)
    m, bonus = pspec._rejection_select(probs, draft, u, seeds, gidx)
    emitted0 = torch.where(m >= 1, draft[:, 0], bonus).numpy()
    hist = np.bincount(emitted0, minlength=vocab) / n
    np.testing.assert_allclose(hist, p_row, atol=LAW_ATOL)


def test_counter_uniform_is_a_pure_function_of_its_key():
    """A draw depends on (seed, generation index, stream) alone: the
    same key in another row, batch or shape gives the same value;
    another index or stream another; values lie in (0, 1) and spread
    evenly."""
    seeds = torch.tensor([[5, 0], [5, 0], [9, 1]])
    a = pspec._counter_uniform(seeds, torch.tensor([[3, 4], [3, 4], [3, 4]]),
                               0)
    assert a[0].tolist() == a[1].tolist() and a[0, 0] != a[2, 0]
    b = pspec._counter_uniform(seeds[1:2], torch.tensor([4]), 0)
    assert b[0] == a[1, 1]
    assert pspec._counter_uniform(seeds[:1], torch.tensor([3]), 1)[0] != a[0, 0]
    wide = pspec._counter_uniform(seeds, torch.tensor([3, 3, 3]), 1, 64)
    assert wide.shape == (3, 64) and torch.equal(wide[0], wide[1])
    flat = pspec._counter_uniform(
        torch.stack([torch.arange(20000), torch.zeros(20000, dtype=torch.long)],
                    1), torch.zeros(20000, dtype=torch.long), 0)
    assert 0.0 < float(flat.min()) and float(flat.max()) < 1.0
    hist = np.histogram(flat.numpy(), bins=10, range=(0, 1))[0] / 20000
    np.testing.assert_allclose(hist, 0.1, atol=0.01)


def test_unit_float_stays_inside_the_open_interval():
    """The extreme hashes map strictly inside (0, 1) in fp32, so no
    Gumbel draw is infinite (with 24 bits the largest rounded to 1.0)."""
    h = torch.tensor([0, 1, 0x7FFFFFFF, 0xFFFFFE00, 0xFFFFFFFF])
    u = pdecode._unit_float(h)
    assert u.dtype == torch.float32
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert torch.isfinite(-torch.log(-torch.log(u))).all()


def test_decode_and_speculative_draws_share_one_hash():
    """One noise source for every sampled token: the Gumbel noise a
    plain decode step draws for (seed, generation index), from host
    keys or on the device, is the bonus draw's noise at that index;
    with uniform residual mass the bonus is its argmax. A batch row
    joins the key only where one seed serves a batch."""
    vocab = 64
    seeds, gidx = [3, 2 ** 40 + 5], [7, 0]
    temp = torch.ones(2)
    host = pdecode._gumbel_noise(list(zip(seeds, gidx)), vocab, temp, "cpu")
    words = torch.as_tensor(pdecode._seed_words(seeds))
    dev = pdecode._counter_gumbel(words, torch.tensor(gidx), vocab)
    assert torch.equal(host, dev)
    probs = torch.full((2, 2, vocab), 1.0 / vocab)
    draft = torch.zeros((2, 1), dtype=torch.long)
    g = torch.tensor(gidx)[:, None] + torch.arange(2)
    m, bonus = pspec._rejection_select(probs, draft, torch.ones((2, 2)),
                                       words, g)
    assert m.tolist() == [0, 0]
    rest = host.clone()
    rest[:, 0] = -float("inf")  # the rejected draft's mass is zeroed
    assert bonus.tolist() == rest.argmax(dim=-1).tolist()
    rows = pdecode._gumbel_noise([(3, 7, 0), (3, 7, 1)], vocab, temp, "cpu")
    assert not torch.equal(rows[0], rows[1])
    assert not torch.equal(rows[0], host[0])


@pytest.mark.parametrize("k", [1, 4])
def test_speculative_generate_matches_jax_and_greedy(params, k):
    """Tokens and verify steps equal JAX's; tokens equal the port's own
    greedy_generate; a one-token prompt (no bigram history) too."""
    jparams, pparams = params
    for prompt in (batch(3, 3, 11), np.asarray([[7], [11]], np.int32)):
        want, jstats = jspec.speculative_generate(
            jparams, jax_cfg(CFG), jnp.asarray(prompt), 18, draft_k=k,
            return_stats=True)
        got, stats = pspec.speculative_generate(
            pparams, CFG, prompt, 18, draft_k=k, return_stats=True,
            device="cpu")
        assert (got.numpy() == np.asarray(want)).all()
        assert stats == jstats
        greedy = pdecode.greedy_generate(pparams, CFG, prompt, 18,
                                         device="cpu")
        assert torch.equal(got, greedy)
    assert pspec.speculative_generate(pparams, CFG, prompt, 0, device="cpu",
                                      return_stats=True)[1] == {"steps": 0}


@pytest.fixture(scope="module")
def draft_model():
    dcfg = ptf.ModelConfig(vocab_size=CFG.vocab_size, d_model=16, n_heads=2,
                           n_layers=1, d_ff=32, max_seq=64, dtype="float32")
    return (dcfg,) + make_params(dcfg, seed=9, block_scale=4.0)


def test_draft_model_generate_matches_jax(params, draft_model):
    """A small random draft model: tokens and verify steps equal JAX's
    and the port's greedy stream."""
    jparams, pparams = params
    dcfg, jd, pd = draft_model
    prompt = batch(5, 3, 13)
    want, jstats = jspec.draft_model_generate(
        jparams, jax_cfg(CFG), jd, jax_cfg(dcfg), jnp.asarray(prompt), 16,
        draft_k=3, return_stats=True)
    got, stats = pspec.draft_model_generate(
        pparams, CFG, pd, dcfg, prompt, 16, draft_k=3, return_stats=True,
        device="cpu")
    assert (got.numpy() == np.asarray(want)).all() and stats == jstats
    assert torch.equal(got, pdecode.greedy_generate(pparams, CFG, prompt, 16,
                                                    device="cpu"))


def test_self_draft_accepts_every_window_and_vocab_mismatch_raises(params):
    """The target drafting for itself proposes its own argmax stream:
    k+1 tokens every step; a draft model of another vocab raises."""
    _, pparams = params
    k, num_new = 3, 21
    prompt = batch(6, 2, 9)
    out, stats = pspec.draft_model_generate(
        pparams, CFG, pparams, CFG, prompt, num_new, draft_k=k,
        return_stats=True, device="cpu")
    assert torch.equal(out, pdecode.greedy_generate(pparams, CFG, prompt,
                                                    num_new, device="cpu"))
    assert stats["steps"] == -(-(num_new - 1) // (k + 1))
    bad = dataclasses.replace(CFG, vocab_size=32)
    with pytest.raises(ValueError, match="vocab"):
        pspec.draft_model_generate(pparams, CFG, pparams, bad, prompt, 4,
                                   device="cpu")


def test_draft_cache_has_no_holes_after_full_acceptance(params):
    """After fully accepted windows the draft cache holds real k/v at
    every position below total - 1 (the k+1-th proposal step writes the
    last accepted draft's row)."""
    _, pparams = params
    k, t_p, rounds = 3, 9, 3
    prompt = torch.as_tensor(batch(6, 2, t_p)).long()
    length = t_p + rounds * (k + 1) + k + 2
    logits, cache = pdecode.prefill(pparams, CFG, prompt, length)
    _, draft_cache = pdecode.prefill(pparams, CFG, prompt, length)
    out, total = pspec._new_buffer(prompt, logits.argmax(-1), length)
    for _ in range(rounds):
        out, total, m = pspec._draft_verify_step(
            pparams, pparams, cache, draft_cache, out, total, cfg=CFG,
            dcfg=CFG, k=k)
        assert (m == k).all()
    rows = draft_cache[0]["k"]
    for r, t in enumerate(total.tolist()):
        assert (rows[r, :t - 1].abs().sum(dim=(1, 2)) > 0).all()


def test_speculative_report():
    rep = pspec.speculative_report(device="cpu")
    assert rep == {"greedy_exact": True, "ok": True, "generated": 12}
