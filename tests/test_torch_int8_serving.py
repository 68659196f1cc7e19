"""PyTorch port parity: the int8 serving tiers (int8 weights, W8A8 and the
int8 KV cache) through decode, the engines and speculative decoding.

Both sides serve the same int8 snapshot (``quantize_params`` of the same
JAX-initialised fp32 weights; the two snapshots are bitwise equal,
tests/test_torch_quant.py) with the same prompts, fp32 activations.
Every int8 product is exact on both sides and every quantization is the
same operation by operation, so caches hold equal int8 rows, scales
equal to fp32 summation order (rtol 1e-6: the k/v they quantize are
fp32 sums taken in another order) and logits agree at 1e-4. int8
streams are not an exact-argmax contract (the reference's decode.py
docstring): a greedy stream may split from the JAX engine's only where
the JAX forward's top-2 logits lie within ``SPLIT_REL`` of its largest
logit (``assert_streams_split_only_at_ties``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import decode as jdecode
from kind_tpu_sim.models import quant as jquant
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim.models import speculative as jspec
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import quant as pquant
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import speculative as pspec

from torch_parity import (
    TINY,
    assert_streams_split_only_at_ties,
    drive,
    jax_cfg,
    make_params,
    prompts,
)
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = dataclasses.replace(TINY, flash=False, int8_kv=True, int8_native=True)
DEQUANT = dataclasses.replace(CFG, int8_native=False)
SPLIT_REL = 1e-2   # tests/test_torch_serving.py's bar for int8 streams
MAX_NEW = 12
SC = dict(max_slots=2, max_len=48, chunk=8)


@pytest.fixture(scope="module")
def snapshots():
    """(JAX int8 snapshot, port int8 snapshot) of the same weights."""
    jparams, pparams = make_params(CFG, embed_scale=0.5, block_scale=6.0)
    return (jquant.quantize_params(jparams, jax_cfg(CFG)),
            pquant.quantize_params(pparams, CFG))


@pytest.fixture(scope="module")
def stream_prompts():
    return prompts(5, CFG.vocab_size)


def _same_cache(pcache, jcache):
    for pl, jl in zip(pcache, jcache):
        for name in ("k", "v"):
            np.testing.assert_array_equal(pl[name].q.numpy(),
                                          np.asarray(jl[name].q))
            np.testing.assert_allclose(pl[name].scale.numpy(),
                                       np.asarray(jl[name].scale), rtol=1e-6,
                                       atol=0)


def _streams(done):
    return {rid: c.tokens for rid, c in done.items()}


@pytest.mark.parametrize("cfg", [CFG, DEQUANT], ids=["native", "dequant"])
def test_prefill_and_decode_step_match_jax(snapshots, cfg):
    """``prefill`` into a 24-row int8 cache (rows past the prompt keep q 0
    and scale 1, as initialised) and two ``decode_step``s: logits at
    1e-4, the int8 cache rows equal (scales to rtol 1e-6)."""
    jparams, pparams = snapshots
    prompt = np.asarray(prompts(2, cfg.vocab_size, seed=7, base=9,
                                step=0), np.int32)
    jcfg = jax_cfg(cfg)
    jl, jc = jax.jit(lambda p, t: jdecode.prefill(p, jcfg, t, 24))(
        jparams, jnp.asarray(prompt))
    pl, pc = pdecode.prefill(pparams, cfg, torch.tensor(prompt).long(), 24)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _same_cache(pc, jc)
    assert (pc[0]["k"].scale[:, 9:] == 1).all()
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    step = jax.jit(lambda p, t, c, pos: jdecode.decode_step(p, jcfg, t, c,
                                                            pos))
    for pos in (9, 10):
        jl, jc = step(jparams, jnp.asarray(tok), jc, pos)
        pl, pc = pdecode.decode_step(pparams, cfg, torch.tensor(tok).long(),
                                     pc, pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        _same_cache(pc, jc)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


@pytest.mark.parametrize("cfg", [CFG, DEQUANT], ids=["native", "dequant"])
def test_chunked_decode_matches_jax(snapshots, cfg):
    """``greedy_generate``: the int8 big cache frozen within each chunk,
    the bf16-dtype chunk buffer merged (quantized) at its end; 19 steps
    at chunk 8 cross two merges and end on a remainder."""
    jparams, pparams = snapshots
    batch = np.asarray(prompts(3, cfg.vocab_size, seed=5, base=9, step=0),
                       np.int32)
    jcfg = jax_cfg(cfg)
    ref = np.asarray(jax.jit(lambda p, t: jdecode.greedy_generate(
        p, jcfg, t, 20, chunk=8))(jparams, jnp.asarray(batch)))
    out = pdecode.greedy_generate(pparams, cfg, batch, 20, chunk=8,
                                  device="cpu").numpy()
    ps = [row[:9].tolist() for row in batch]
    assert_streams_split_only_at_ties(
        jparams, cfg, ps, {f"r{i}": out[i, 9:].tolist() for i in range(3)},
        {f"r{i}": ref[i, 9:].tolist() for i in range(3)}, SPLIT_REL)


def test_prefill_into_slot_writes_quantized_zeros_past_the_prompt(snapshots):
    """A slot's prefill writes the whole row, as the reference's padded
    write does: past the prompt q 0 and scale 1e-8/127 (quantized
    zeros); the untouched slot keeps the initial scale 1. Its prefix
    rows copied out (``_read_slot_rows``) equal the reference's."""
    jparams, pparams = snapshots
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = prompts(1, CFG.vocab_size, seed=8, base=11)[0]
    jcache = jdecode.init_cache(jax_cfg(CFG), 2, 32)
    jcfg = jax_cfg(CFG)
    jcache, jl = jax.jit(lambda p, c, t, n, slot: jserving._prefill_into_slot(
        p, c, t, n, slot, cfg=jcfg))(jparams, jcache, jnp.asarray(toks),
                                     jnp.asarray(11), jnp.asarray(1))
    pcache = pdecode.init_cache(CFG, 2, 32, device="cpu")
    pl = pserving._prefill_into_slot(pparams, pcache,
                                     torch.tensor(toks).long(), 11, 1,
                                     cfg=CFG)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _same_cache(pcache, jcache)
    scale = pcache[0]["k"].scale
    assert (scale[1, 11:] == np.float32(1e-8) / np.float32(127)).all()
    assert (scale[0] == 1).all()
    jrows = jserving._read_slot_rows(jcache, 1, 16)
    prows = pserving._read_slot_rows(pcache, 1, 16)
    _same_cache(prows, jrows)
    pserving._write_slot_rows(pcache, prows, 0)
    _same_cache(pserving._read_slot_rows(pcache, 0, 16), jrows)


PAGED = dict(paged_blocks=24, block_size=8)
# name: (port engine, JAX engine, ServingConfig knobs, prompts): "stream"
# the module's five, "family" a 16-token head and two prompts on it,
# with cache_prefix (hits
# counted alike, at least one), "long" five of 28-36 tokens (a pool of 10
# blocks of 8 then preempts)
ENGINES = {
    "dense": (pserving.ServingEngine, jserving.ServingEngine, {}, "stream"),
    "dense chunked prefill": (pserving.ServingEngine, jserving.ServingEngine,
                              dict(prefill_chunk=8), "stream"),
    "dense admission waves": (pserving.ServingEngine,
                              jserving.ServingEngine,
                              dict(admission_wave_sizes=(1, 2)), "stream"),
    "overlapped rounds": (pserving.ServingEngine, jserving.ServingEngine,
                          dict(overlap_rounds=True), "stream"),
    "paged gather tier": (pserving.PagedServingEngine,
                          jserving.PagedServingEngine, PAGED, "stream"),
    "paged prefix hits": (pserving.PagedServingEngine,
                          jserving.PagedServingEngine,
                          dict(PAGED, prefix_cache_entries=4), "family"),
    "paged chunked prefill": (pserving.PagedServingEngine,
                              jserving.PagedServingEngine,
                              dict(PAGED, prefill_chunk=8), "stream"),
    "paged waves": (pserving.PagedServingEngine, jserving.PagedServingEngine,
                    dict(PAGED, admission_wave_sizes=(1, 2)), "stream"),
    "paged pool of 10 blocks": (pserving.PagedServingEngine,
                                jserving.PagedServingEngine,
                                dict(paged_blocks=10, block_size=8), "long"),
    "paged speculative, pool of 10 blocks": (
        pserving.PagedSpeculativeServingEngine,
        jserving.PagedSpeculativeServingEngine,
        dict(paged_blocks=10, block_size=8, speculative_k=3), "long"),
}


def _family():
    """The 16-token head (two blocks of 8) and the two members of
    ``test_int8_prefix_hits_match_jax`` on it."""
    head = prompts(1, CFG.vocab_size, seed=9, base=16)[0]
    rng = np.random.RandomState(10)
    return [head] + [head + rng.randint(0, CFG.vocab_size, n).tolist()
                     for n in (3, 7)]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_int8_engine_streams_match_jax(snapshots, stream_prompts, name):
    """W8A8 with an int8 KV cache through every engine: the dense grid
    (whole prompts, windows of 8 by chunked prefill, admission waves,
    overlapped rounds), the paged gather tier (prefix hits, chunked
    prefill, waves, a pool of 10 blocks under pressure) and the paged
    speculative engine on that pool: the JAX engine's streams."""
    port, ref, knobs, which = ENGINES[name]
    jparams, pparams = snapshots
    ps = {"stream": stream_prompts, "family": _family(),
          "long": prompts(5, CFG.vocab_size, seed=12, base=28, step=2)}[which]
    req = dict(cache_prefix=True) if which == "family" else {}
    jeng = ref(jparams, jax_cfg(CFG), jserving.ServingConfig(**SC, **knobs))
    peng = port(pparams, CFG, pserving.ServingConfig(**SC, **knobs),
                device="cpu")
    want = drive(jserving, jeng, ps, MAX_NEW, **req)
    got = drive(pserving, peng, ps, MAX_NEW, **req)
    if which == "family":
        assert peng.prefix_cache.hits == jeng.prefix_cache.hits > 0
    if which == "long":
        assert peng.report()["paged"]["preemptions"] > 0
    assert_streams_split_only_at_ties(snapshots[0], CFG, ps, _streams(got),
                                      _streams(want), SPLIT_REL)


def test_int8_prefix_hits_match_jax(snapshots):
    """A stored 16-token head (int8 rows and scales), then two members
    that hit it and run only their suffix (``_window_block`` against the
    int8 prefix): hits counted alike, the JAX engine's streams."""
    jparams, pparams = snapshots
    head = prompts(1, CFG.vocab_size, seed=9, base=16)[0]
    rng = np.random.RandomState(10)
    members = [head + rng.randint(0, CFG.vocab_size, n).tolist()
               for n in (3, 7)]
    sc = dict(SC, prefix_cache_entries=4)
    out = {}
    for mod, engine in (
            (jserving, jserving.ServingEngine(
                jparams, jax_cfg(CFG), jserving.ServingConfig(**sc))),
            (pserving, pserving.ServingEngine(
                pparams, CFG, pserving.ServingConfig(**sc), device="cpu"))):
        engine.submit(mod.Request("h", head, MAX_NEW, cache_prefix=True))
        done = {c.request_id: c.tokens for c in engine.run()}
        for i, m in enumerate(members):
            engine.submit(mod.Request(f"m{i}", m, MAX_NEW))
        done.update({c.request_id: c.tokens for c in engine.run()})
        out[mod] = (done, engine.prefix_cache.hits)
    (want, jhits), (got, phits) = out[jserving], out[pserving]
    assert phits == jhits == 2
    ps = {"h": head, "m0": members[0], "m1": members[1]}
    ordered = ["h", "m0", "m1"]
    assert_streams_split_only_at_ties(
        jparams, CFG, [ps[r] for r in ordered],
        {f"r{i}": got[r] for i, r in enumerate(ordered)},
        {f"r{i}": want[r] for i, r in enumerate(ordered)}, SPLIT_REL)


def test_paged_kernel_tier_refuses_int8_pools_as_the_reference(snapshots):
    """int8 pools serve on the gather tier: ``paged_kernel`` with
    ``int8_kv`` raises the reference's message on both sides."""
    jparams, pparams = snapshots
    sc = dict(SC, paged_blocks=24, block_size=8, paged_kernel=True)
    with pytest.raises(ValueError) as ref:
        jserving.PagedServingEngine(jparams, jax_cfg(CFG),
                                    jserving.ServingConfig(**sc))
    with pytest.raises(ValueError) as port:
        pserving.PagedServingEngine(pparams, CFG, pserving.ServingConfig(**sc),
                                    device="cpu")
    assert str(port.value) == str(ref.value)
    assert "int8_kv uses the gather tier" in str(port.value)


def test_speculative_generate_int8_native_matches_jax(snapshots):
    """Solo ``speculative_generate`` (k 3) on the int8 snapshot with W8A8
    and the int8 cache: each verify window's cache scores and values go
    through the exact int8 product, its k/v rows are quantized at the
    write; the JAX streams and verify steps."""
    jparams, pparams = snapshots
    batch = np.asarray(prompts(2, CFG.vocab_size, seed=11, base=10, step=0),
                       np.int32)
    ref, jstats = jspec.speculative_generate(
        jparams, jax_cfg(CFG), jnp.asarray(batch), 14, draft_k=3,
        return_stats=True)
    out, pstats = pspec.speculative_generate(pparams, CFG, batch, 14,
                                             draft_k=3, return_stats=True,
                                             device="cpu")
    ref, out = np.asarray(ref), out.numpy()
    splits = assert_streams_split_only_at_ties(
        jparams, CFG, [row[:10].tolist() for row in batch],
        {f"r{i}": out[i, 10:].tolist() for i in range(2)},
        {f"r{i}": ref[i, 10:].tolist() for i in range(2)}, SPLIT_REL)
    if not splits:
        assert pstats == jstats


@pytest.mark.parametrize("paged", [False, True], ids=["grid", "paged"])
def test_int8_speculative_engines_match_jax(snapshots, stream_prompts,
                                            paged):
    jparams, pparams = snapshots
    knobs = dict(SC, speculative_k=3)
    if paged:
        knobs.update(paged_blocks=24, block_size=8)
    port = (pserving.PagedSpeculativeServingEngine if paged
            else pserving.SpeculativeServingEngine)
    ref = (jserving.PagedSpeculativeServingEngine if paged
           else jserving.SpeculativeServingEngine)
    want = drive(jserving, ref(jparams, jax_cfg(CFG),
                               jserving.ServingConfig(**knobs)),
                 stream_prompts, MAX_NEW)
    got = drive(pserving, port(pparams, CFG, pserving.ServingConfig(**knobs),
                               device="cpu"), stream_prompts, MAX_NEW)
    assert_streams_split_only_at_ties(jparams, CFG, stream_prompts,
                                      _streams(got), _streams(want),
                                      SPLIT_REL)
