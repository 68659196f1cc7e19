"""PyTorch port parity: Switch-MoE (models/moe.py) and its hooks in the
transformer, the train step and the serving engines.

Same numpy-seeded inputs and JAX-initialised weights (crossed through
numpy) on both sides, fp32. ``moe_mlp``'s output agrees at atol 1e-5
and its auxiliary loss at 1e-6 (fp32 products in another summation
order; the routing decisions are equal). Which tokens are kept (their
MLP output non-zero) must be equal, including under heavy dropping.
The train steps are held at tests/test_torch_training.py's fp32 AdamW
bars. The served streams must equal the JAX engines' (routing sets as
the reference's: the grid's slots a decode step, each window position a
verify window, each prompt alone at admission).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import decode as jdecode
from kind_tpu_sim.models import moe as jmoe
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim.models import transformer as jtf
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import moe as pmoe
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.weights import params_from_numpy

from torch_parity import TINY, drive, jax_cfg, make_params, prompts
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

# 4 experts (MoeConfig's default): capacity 2 x tokens / 4 drops tokens
# whenever a routed set leans on one expert, so the routed sets show (with
# 2 experts the capacity is every token and nothing ever drops)
CFG = dataclasses.replace(TINY, n_experts=4, flash=False)
MAX_NEW = 10


def _moe_inputs(moe, shape, seed=0):
    mp = jmoe.init_moe_params(jax.random.PRNGKey(seed), shape[-1], 64,
                              jmoe.MoeConfig(*dataclasses.astuple(moe)))
    x = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    pmp = {k: torch.tensor(np.asarray(v)) for k, v in mp.items()}
    return mp, pmp, x


@pytest.mark.parametrize("capacity_factor", [0.1, 0.5, 2.0])
def test_moe_mlp_and_kept_tokens_match_jax(capacity_factor):
    """tests/test_moe.py:29-40's dropping case (capacity 0.1 x 40 / 2 =
    2 slots an expert) and two roomier ones: out, aux and the kept-token
    pattern."""
    moe = pmoe.MoeConfig(n_experts=2, capacity_factor=capacity_factor)
    mp, pmp, x = _moe_inputs(moe, (1, 40, 32))
    jout, jaux = jmoe.moe_mlp(jnp.asarray(x), mp,
                              jmoe.MoeConfig(2, capacity_factor))
    pout, paux = pmoe.moe_mlp(torch.tensor(x), pmp, moe)
    jout = np.asarray(jout)
    np.testing.assert_allclose(pout.numpy(), jout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(paux), float(jaux), atol=1e-6, rtol=0)
    kept = (np.abs(jout[0]) > 1e-7).any(axis=-1)
    np.testing.assert_array_equal((pout[0].abs() > 1e-7).any(dim=-1).numpy(),
                                  kept)
    if capacity_factor == 0.1:
        assert kept.sum() <= 4


def test_moe_mlp_batched_and_aux_bound_match_jax():
    """tests/test_moe.py:15-26: (2, 16, 32) through 4 experts, the
    auxiliary term at least 0.99 x its weight on both sides."""
    moe = pmoe.MoeConfig(4)
    mp, pmp, x = _moe_inputs(moe, (2, 16, 32), seed=2)
    jout, jaux = jmoe.moe_mlp(jnp.asarray(x), mp, jmoe.MoeConfig(4))
    pout, paux = pmoe.moe_mlp(torch.tensor(x), pmp, moe)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(paux), float(jaux), atol=1e-6, rtol=0)
    assert float(paux) >= moe.aux_loss_weight * 0.99


def test_router_ties_take_the_first_expert():
    """A zero router gives every expert the same probability: argmax
    takes the first, as jnp.argmax does, so expert 0 fills to capacity
    (20 of 40 tokens at factor 1.0) and the rest drop, on both sides."""
    moe = pmoe.MoeConfig(n_experts=2, capacity_factor=1.0)
    mp, pmp, x = _moe_inputs(moe, (1, 40, 32), seed=3)
    mp = dict(mp, router=jnp.zeros_like(mp["router"]))
    pmp = dict(pmp, router=torch.zeros_like(pmp["router"]))
    jout, _ = jmoe.moe_mlp(jnp.asarray(x), mp, jmoe.MoeConfig(2, 1.0))
    pout, _ = pmoe.moe_mlp(torch.tensor(x), pmp, moe)
    kept = (pout[0].abs() > 1e-7).any(dim=-1)
    assert kept[:20].all() and not kept[20:].any()
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)


def test_init_moe_params_shapes_and_scales():
    moe = pmoe.MoeConfig(n_experts=3)
    p = pmoe.init_moe_params(torch.Generator().manual_seed(0), 32, 64, moe)
    j = jmoe.init_moe_params(jax.random.PRNGKey(0), 32, 64,
                             jmoe.MoeConfig(3))
    for name in ("router", "w_up", "w_down"):
        assert tuple(p[name].shape) == j[name].shape
        assert p[name].dtype == torch.float32
        # same scale of init: std within 15% of the reference's
        ratio = float(p[name].std()) / float(jnp.std(j[name]))
        assert 0.85 < ratio < 1.15, (name, ratio)


def test_forward_and_loss_with_moe_match_jax():
    jparams, pparams = make_params(CFG)
    toks = np.random.RandomState(4).randint(0, CFG.vocab_size,
                                            (2, 17)).astype(np.int32)
    jcfg = jax_cfg(CFG)
    jl, jaux = jax.jit(lambda p, t: jtf.forward(p, t, jcfg, return_aux=True))(
        jparams, jnp.asarray(toks))
    pl, paux = ptf.forward(pparams, torch.tensor(toks).long(), CFG,
                           return_aux=True)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(paux), float(jaux), atol=1e-6, rtol=0)
    want = float(jax.jit(lambda p, t: jtf.loss_fn(p, t, jcfg))(
        jparams, jnp.asarray(toks)))
    got = float(ptf.loss_fn(pparams, torch.tensor(toks).long(), CFG))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_moe_train_steps_match_jax():
    """5 AdamW steps of the port's ``make_train_step`` against the JAX
    one from the same parameters on the same ramp batches: losses (the
    auxiliary term in them) at 1e-4, every parameter, the router and the
    experts included, at 5e-5."""
    import optax

    cfg = dataclasses.replace(CFG, max_seq=16)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jtf.init_params(jax.random.PRNGKey(0), jax_cfg(cfg)))
    rng = np.random.RandomState(5)
    batches = [((rng.randint(0, cfg.vocab_size, (4, 1))
                 + np.arange(17)[None, :]) % cfg.vocab_size).astype(np.int32)
               for _ in range(5)]
    jstep, _ = jtf.make_train_step(jax_cfg(cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": optax.adamw(1e-2).init(jparams)}
    pstep, init = ptf.make_train_step(cfg, device="cpu")
    pstate = init(params_from_numpy(tree, cfg, device="cpu"))
    jl, pl = [], []
    for tokens in batches:
        jstate, loss = jstep(jstate, jnp.asarray(tokens))
        jl.append(float(loss))
        pstate, loss = pstep(pstate, torch.tensor(tokens).long())
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    jleaves = jax.tree_util.tree_leaves(jstate["params"])
    pflat = {id(t): t for t in ptf._leaves(pstate["params"])}
    assert len(jleaves) == len(pflat)

    def paired(jnode, pnode):
        if isinstance(jnode, dict):
            for key in jnode:
                yield from paired(jnode[key], pnode[key])
        elif isinstance(jnode, list):
            for j, p in zip(jnode, pnode):
                yield from paired(j, p)
        else:
            yield np.asarray(jnode), pnode.detach().numpy()

    for j, p in paired(jstate["params"], pstate["params"]):
        np.testing.assert_allclose(p, j, atol=5e-5, rtol=0)
    assert pl[-1] < pl[0]


def test_moe_admission_wave_matches_the_scanned_admission():
    """A stacked wave of 3 prompts of one bucket (true lengths 5, 11,
    16, padded to 16): each row's MoE routes alone over its padded
    prompt, as the JAX engine's scan of single-prompt prefills does, so
    the wave's logits equal the JAX wave's and each row's first token is
    the one its prompt gets admitted alone."""
    jparams, pparams = make_params(CFG, embed_scale=0.5, block_scale=6.0)
    lens = [5, 11, 16]
    rng = np.random.RandomState(6)
    toks = np.zeros((3, 16), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.randint(0, CFG.vocab_size, n)
    jcache = jdecode.init_cache(jax_cfg(CFG), 4, 32)
    _, jlogits = jserving._prefill_many_into_slots(
        jparams, jcache, jnp.asarray(toks), jnp.asarray(lens, jnp.int32),
        jnp.asarray([2, 0, 3], jnp.int32), cfg=jax_cfg(CFG))
    pcache = pdecode.init_cache(CFG, 4, 32, device="cpu")
    plogits = pserving._prefill_many_into_slots(
        pparams, pcache, torch.tensor(toks).long(), lens, [2, 0, 3], cfg=CFG)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for r, n in enumerate(lens):
        alone = pserving._prefill_into_slot(
            pparams, pdecode.init_cache(CFG, 1, 32, device="cpu"),
            torch.tensor(toks[r:r + 1]).long(), n, 0, cfg=CFG)
        assert int(alone.argmax()) == int(plogits[r].argmax())
        np.testing.assert_allclose(alone.numpy(), plogits[r].numpy(),
                                   atol=1e-5, rtol=1e-5)


PAGED = dict(chunk=8, paged_blocks=24, block_size=8)
# name: (port engine, JAX engine, ServingConfig knobs, prompts): "stream"
# five short prompts, "family" a 16-token head and four prompts on it
# with cache_prefix (hits counted alike, at least one), "long" five of 28-36
# tokens (a pool of 10 blocks of 8 then preempts)
ENGINES = {
    "dense waves": (pserving.ServingEngine, jserving.ServingEngine,
                    dict(chunk=8, admission_wave_sizes=(1, 2)), "stream"),
    "dense prefix hits": (pserving.ServingEngine, jserving.ServingEngine,
                          dict(chunk=8, prefix_cache_entries=4), "family"),
    "overlapped rounds": (pserving.ServingEngine, jserving.ServingEngine,
                          dict(chunk=8, overlap_rounds=True), "stream"),
    "paged": (pserving.PagedServingEngine, jserving.PagedServingEngine,
              PAGED, "stream"),
    "paged chunked prefill": (pserving.PagedServingEngine,
                              jserving.PagedServingEngine,
                              dict(PAGED, prefill_chunk=8), "stream"),
    "paged pool of 10 blocks": (pserving.PagedServingEngine,
                                jserving.PagedServingEngine,
                                dict(PAGED, paged_blocks=10), "long"),
    "paged kernel tier": (pserving.PagedServingEngine,
                          jserving.PagedServingEngine,
                          dict(PAGED, paged_kernel=True), "stream"),
    "speculative": (pserving.SpeculativeServingEngine,
                    jserving.SpeculativeServingEngine,
                    dict(speculative_k=3), "stream"),
    "paged speculative": (pserving.PagedSpeculativeServingEngine,
                          jserving.PagedSpeculativeServingEngine,
                          dict(speculative_k=3, paged_blocks=24,
                               block_size=8), "stream"),
}


def _prompts(which):
    if which == "stream":
        return prompts(5, CFG.vocab_size)
    if which == "long":
        return prompts(5, CFG.vocab_size, seed=12, base=28, step=2)
    head = prompts(1, CFG.vocab_size, seed=9, base=16)[0]
    rng = np.random.RandomState(10)
    return [head] + [head + rng.randint(0, CFG.vocab_size, n).tolist()
                     for n in (3, 7, 5, 6)]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_moe_engine_streams_match_jax(name):
    """n_experts=4 through each engine: the decode grid routes its slots
    together (inactive rows too), a verify window each position over the
    slots, admission each prompt alone (or a wave, or a window of 8 by
    chunked prefill, or a suffix after a prefix hit). Greedy streams
    equal the JAX engine's, on the dense grid (waves, prefix hits,
    overlapped rounds), the paged gather tier (chunked prefill, a pool
    of 10 blocks under pressure), the paged kernel tier and both
    speculative engines. Left out: the speculative
    grid with chunked prefill, where the reference overwrites a pending
    slot's rows (ROADMAP fault C-5)."""
    port, ref, knobs, which = ENGINES[name]
    jparams, pparams = make_params(CFG, embed_scale=0.5, block_scale=6.0)
    ps = _prompts(which)
    req = dict(cache_prefix=True) if which == "family" else {}
    sc = dict(max_slots=2, max_len=48, **knobs)
    jeng = ref(jparams, jax_cfg(CFG), jserving.ServingConfig(**sc))
    peng = port(pparams, CFG, pserving.ServingConfig(**sc), device="cpu")
    want = drive(jserving, jeng, ps, MAX_NEW, **req)
    got = drive(pserving, peng, ps, MAX_NEW, **req)
    if which == "family":
        assert peng.prefix_cache.hits == jeng.prefix_cache.hits > 0
    if which == "long":
        assert peng.report()["paged"]["preemptions"] > 0
    assert {r: c.tokens for r, c in got.items()} == {
        r: c.tokens for r, c in want.items()}
