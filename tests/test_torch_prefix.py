"""PyTorch port parity: prefix caching, dense and paged.

The suffix forward (``speculative._window_block``, the dense
``_suffix_into_slot`` and ``paged.paged_suffix``) is held to the JAX
package's functions on the same weights and cache contents; the two
prefix caches take the reference classes' operation sequences and must
give the same hits, misses, entries and refcounts; and the engines'
greedy streams through prefix hits equal the JAX engines' and the cold
path's. fp32 tiny GQA config, weights from the reference (numpy
crossing); logits and k/v at 1e-4 / 1e-5 (fp32, summation order only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kind_tpu_sim.models import paged as jpaged
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim.models import speculative as jspec
from kind_tpu_sim_torch.models import paged as ppaged
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import speculative as pspec

from torch_parity import TINY, assert_margins, jax_cfg, make_params
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
# the function-level suffix tests prefill with the plain attention (the
# suffix path never runs the flash kernel); the weights are the same
PLAIN = dataclasses.replace(TINY, flash=False)
MARGIN = 1e-3
LOGIT_TOL, KV_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


def make_prompt(seed, length):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               size=length).tolist()


def run_both(params, kw, waves, paged=False):
    """Each wave of (request id, prompt, max_new, extra) submitted to the
    port's and the JAX package's engine with the same configuration and
    drained before the next. Returns ({id: tokens} port, JAX, port
    engine, JAX engine)."""
    jparams, pparams = params
    jcls, pcls = ((jserving.PagedServingEngine, pserving.PagedServingEngine)
                  if paged else (jserving.ServingEngine,
                                 pserving.ServingEngine))
    jeng = jcls(jparams, jax_cfg(CFG), jserving.ServingConfig(**kw))
    peng = pcls(pparams, CFG, pserving.ServingConfig(**kw), device="cpu")
    outs = []
    for mod, eng in ((pserving, peng), (jserving, jeng)):
        out = {}
        for wave in waves:
            for rid, prompt, max_new, extra in wave:
                eng.submit(mod.Request(rid, prompt, max_new, **extra))
            out.update({c.request_id: c.tokens for c in eng.run()})
        outs.append(out)
    return outs[0], outs[1], peng, jeng


def _layer_inputs(seed, b, s, w):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, w, CFG.d_model) * 0.5).astype(np.float32)
    cache = {n: rng.randn(b, s, CFG.kv_heads, CFG.head_dim).astype(
        np.float32) for n in ("k", "v")}
    return x, cache


def test_window_block_matches_jax(params):
    """Two rows masked at their own base, a window of 5 after them."""
    jparams, pparams = params
    x, cache = _layer_inputs(0, 2, 16, 5)
    base = np.asarray([3, 11], np.int32)
    jx, jk, jv = jspec._window_block(
        jnp.asarray(x), jparams["blocks"][0], jax_cfg(CFG),
        {n: jnp.asarray(a) for n, a in cache.items()}, jnp.asarray(base))
    px, pk, pv = pspec._window_block(
        torch.as_tensor(x), pparams["blocks"][0], CFG,
        {n: torch.as_tensor(a) for n, a in cache.items()},
        torch.as_tensor(base))
    for got, want in ((px, jx), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KV_TOL, rtol=1e-4)


def test_suffix_into_slot_matches_jax(params):
    """A slot holding a 10-token prefix (prefilled) continues with a
    6-token suffix padded to 8: the same logits and cache as JAX's."""
    jparams, pparams = params
    prompt = make_prompt(1, 16)
    pre = pserving._padded_window(prompt[:10])
    jcache = jserving.init_cache(jax_cfg(PLAIN), 2, 32)
    jcache, _ = jserving._prefill_into_slot(
        jparams, jcache, jnp.asarray(pre, jnp.int32), jnp.int32(10), 1,
        cfg=jax_cfg(PLAIN))
    pcache = pserving.init_cache(PLAIN, 2, 32, device="cpu")
    pserving._prefill_into_slot(pparams, pcache, torch.as_tensor(pre), 10, 1,
                                cfg=PLAIN)
    suf = pserving._padded_window(prompt[10:])
    jcache, jl = jserving._suffix_into_slot(
        jparams, jcache, jnp.asarray(suf, jnp.int32), jnp.int32(6),
        jnp.int32(10), 1, cfg=jax_cfg(PLAIN))
    pl = pserving._suffix_into_slot(pparams, pcache, torch.as_tensor(suf), 6,
                                    10, 1, cfg=PLAIN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for jlc, plc in zip(jcache, pcache):
        for n in ("k", "v"):
            np.testing.assert_allclose(plc[n].numpy(), np.asarray(jlc[n]),
                                       atol=KV_TOL, rtol=1e-4)


def test_paged_suffix_matches_jax_and_leaves_shared_blocks(params):
    """Blocks 3 and 5 hold a 16-token prefix; a suffix of 5 runs through
    table [3, 5, 7, 0]: the same logits and pool as JAX's, and the
    prefix blocks are not written."""
    jparams, pparams = params
    prompt = make_prompt(2, 21)
    row = np.asarray([3, 5, 7, 0], np.int32)
    jpools = jpaged.init_pools(jax_cfg(PLAIN), 9, 8)
    ppools = ppaged.init_pools(PLAIN, 9, 8, device="cpu")
    pre = pserving._padded_window(prompt[:16])
    jpools, _ = jpaged.paged_prefill(jparams, jpools,
                                     jnp.asarray(pre, jnp.int32),
                                     jnp.int32(16), jnp.asarray(row),
                                     cfg=jax_cfg(PLAIN))
    ppaged.paged_prefill(pparams, ppools, torch.as_tensor(pre), 16,
                         torch.as_tensor(row), cfg=PLAIN)
    shared = [{n: t[[3, 5]].clone() for n, t in lc.items()} for lc in ppools]
    suf = pserving._padded_window(prompt[16:])
    jpools, jl = jpaged.paged_suffix(jparams, jpools,
                                     jnp.asarray(suf, jnp.int32),
                                     jnp.int32(5), jnp.int32(16),
                                     jnp.asarray(row), cfg=jax_cfg(PLAIN))
    pl = ppaged.paged_suffix(pparams, ppools, torch.as_tensor(suf), 5, 16,
                             torch.as_tensor(row), cfg=PLAIN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for jlc, plc, before in zip(jpools, ppools, shared):
        for n in ("k", "v"):
            np.testing.assert_allclose(plc[n][1:].numpy(),
                                       np.asarray(jlc[n])[1:], atol=KV_TOL,
                                       rtol=1e-4)
            assert torch.equal(plc[n][[3, 5]], before[n])


def test_prefix_cache_operations_match_the_reference():
    """The same stores and lookups (nested prefixes, LRU overflow, an
    entry that does not fit max_len) give the same hits, misses,
    entries and returned lengths in both PrefixCache classes."""
    a, b = list(range(6)), list(range(6)) + [9, 9, 9, 9]
    ops = [("store", a, 8), ("store", b, 16), ("lookup", b + [1], None),
           ("lookup", a + [2], None), ("lookup", [7, 7], None),
           ("lookup", b + [1] * 20, 24), ("store", [5] * 3, 4),
           ("lookup", b + [3], None), ("store", [6] * 3, 4),
           ("lookup", a + [4], None), ("lookup", b + [4], 32)]
    got = []
    for cls in (jserving.PrefixCache, pserving.PrefixCache):
        cache, trace = cls(3), []
        for op, prompt, pad in ops:
            if op == "store":
                cache.store(prompt, {"len": len(prompt), "pad": pad})
            else:
                hit = cache.lookup(prompt, max_len=pad)
                trace.append(None if hit is None else hit["len"])
        got.append((trace, cache.report(), list(cache.entries)))
    assert got[0] == got[1]


def test_paged_prefix_cache_operations_match_the_reference():
    """The same block stores, lookups and evictions over each package's
    allocator: the same hits, misses, shared blocks, entries and
    refcounts."""
    got = []
    for mod in (jpaged, ppaged):
        alloc = mod.BlockAllocator(12)
        cache = mod.PagedPrefixCache(2, alloc, 4)
        x = alloc.alloc(3)
        y = alloc.alloc(2)
        cache.store(list(range(10)), x)          # 2 full blocks
        cache.store(list(range(3)), y)           # no full block
        cache.store([7] * 8, y)                  # 2 blocks
        trace = [cache.lookup(list(range(10)) + [1]),
                 cache.lookup(list(range(8))), cache.lookup([7] * 9)]
        cache.store([8] * 4, x[2:])              # overflow: evict LRU
        trace.append(cache.lookup(list(range(9))))
        alloc.free(x)
        alloc.free(y)
        evicted = [cache.evict_lru(), cache.evict_lru(), cache.evict_lru()]
        got.append(([None if h is None else (h["len"], h["blocks"])
                     for h in trace], evicted, cache.report(),
                    alloc.free_blocks, [alloc.refcount(b) for b in x + y]))
    assert got[0] == got[1]


def test_dense_prefix_hit_equals_cold_and_jax(params):
    """Two follow-ups admitted through a hit (restored rows, suffix-only
    forward) emit what the cold engine and the JAX engine emit."""
    system = make_prompt(60, 12)
    kw = dict(max_slots=2, max_len=64, chunk=8, prefix_cache_entries=4)
    waves = [[("warm", system, 6, dict(cache_prefix=True))],
             [("a", system + make_prompt(61, 4), 8, {}),
              ("b", system + make_prompt(62, 5), 8, {})]]
    port, ref, peng, jeng = run_both(params, kw, waves)
    assert port == ref
    assert peng.prefix_cache.report() == jeng.prefix_cache.report()
    assert peng.prefix_cache.report()["hits"] == 2
    assert peng.report()["suffix_windows"] == 2
    cold, _, _, _ = run_both(params, dict(max_slots=2, max_len=64, chunk=8),
                             waves[1:])
    assert {r: port[r] for r in cold} == cold
    for rid, prompt, _, _ in waves[1]:
        assert_margins(params[1], CFG, prompt, port[rid], MARGIN)


def test_dense_prefix_lru_eviction_and_miss_accounting(params):
    kw = dict(max_slots=2, max_len=64, chunk=8, prefix_cache_entries=2)
    stored = [make_prompt(70 + i, 8 + i) for i in range(3)]
    waves = [[(f"s{i}", p, 4, dict(cache_prefix=True))
              for i, p in enumerate(stored)],
             [("q", make_prompt(99, 7), 6, {})]]
    port, ref, peng, jeng = run_both(params, kw, waves)
    assert port == ref
    assert peng.prefix_cache.report() == jeng.prefix_cache.report()
    assert peng.prefix_cache.report()["entries"] == 2
    assert tuple(stored[0]) not in peng.prefix_cache.entries
    assert peng.prefix_cache.report()["misses"] >= 1


def test_dense_overflowing_suffix_goes_cold(params):
    """A suffix whose padded window would run past max_len is no hit:
    the cold path runs, the streams equal the JAX engine's."""
    system = make_prompt(90, 12)
    kw = dict(max_slots=2, max_len=64, chunk=8, prefix_cache_entries=4)
    long_prompt = system + make_prompt(91, 45)
    waves = [[("warm", system, 4, dict(cache_prefix=True))],
             [("long", long_prompt, 6, {})]]
    port, ref, peng, _ = run_both(params, kw, waves)
    assert port == ref
    stats = peng.prefix_cache.report()
    assert stats["hits"] == 0 and stats["misses"] >= 1
    assert peng.report()["suffix_windows"] == 0


def test_dense_longest_prefix_wins(params):
    short = make_prompt(80, 6)
    longer = short + make_prompt(81, 6)
    kw = dict(max_slots=2, max_len=64, chunk=8, prefix_cache_entries=4)
    waves = [[("s", short, 4, dict(cache_prefix=True)),
              ("l", longer, 4, dict(cache_prefix=True))],
             [("x", longer + [1, 2], 5, {})]]
    port, ref, peng, _ = run_both(params, kw, waves)
    assert port == ref
    hit = peng.prefix_cache.lookup(longer + [1, 2])
    assert hit is not None and hit["len"] == len(longer)


def test_paged_prefix_sharing_exact_and_refcounted(params):
    """A hit points the slot at the stored blocks: streams equal JAX's,
    the entry's 2 blocks outlive the slots, and two concurrent hits
    share them."""
    shared = make_prompt(5, 16)
    kw = dict(max_slots=2, max_len=48, chunk=8, paged_blocks=16,
              block_size=8, prefix_cache_entries=4, paged_kernel=True)
    waves = [[("cold", shared + [1, 2], 6, dict(cache_prefix=True))],
             [("hot", shared + [5, 6, 7], 6, {})],
             [("h1", shared + [9], 4, {}), ("h2", shared + [11, 12], 4, {})]]
    port, ref, peng, jeng = run_both(params, kw, waves, paged=True)
    assert port == ref
    rep = peng.report()
    assert rep["prefix_cache"] == jeng.report()["prefix_cache"]
    assert rep["prefix_cache"]["hits"] == 3
    assert rep["prefix_cache"]["shared_blocks"] == 6
    assert rep["paged"]["blocks_in_use"] == 2
    (entry,) = peng.prefix_cache.entries.values()
    assert [peng.alloc.refcount(b) for b in entry["blocks"]] == [1, 1]


def test_paged_prefix_eviction_frees_blocks(params):
    kw = dict(max_slots=1, max_len=48, chunk=8, paged_blocks=24,
              block_size=8, prefix_cache_entries=1)
    waves = [[("a", make_prompt(6, 9), 4, dict(cache_prefix=True))],
             [("b", make_prompt(7, 17), 4, dict(cache_prefix=True))]]
    port, ref, peng, _ = run_both(params, kw, waves[:1], paged=True)
    assert port == ref and peng.report()["paged"]["blocks_in_use"] == 1
    for rid, prompt, max_new, extra in waves[1]:
        peng.submit(pserving.Request(rid, prompt, max_new, **extra))
    peng.run()
    rep = peng.report()
    assert rep["prefix_cache"]["entries"] == 1
    assert rep["paged"]["blocks_in_use"] == 2
    assert peng.prefix_cache.evict_lru()
    assert peng.report()["paged"]["blocks_in_use"] == 0


def test_cache_held_blocks_cannot_starve_admission(params):
    """Entries holding 4 of 7 blocks are evicted under admission
    pressure instead of blocking a request that needs 4."""
    kw = dict(max_slots=1, max_len=48, chunk=8, paged_blocks=8,
              block_size=8, prefix_cache_entries=4)
    waves = [[(f"c{i}", make_prompt(9 + i, 16), 4, dict(cache_prefix=True))
              for i in range(2)],
             [("big", make_prompt(30, 28), 4, {})]]
    port, ref, peng, _ = run_both(params, kw, waves, paged=True)
    assert port == ref and len(port) == 3
    assert peng.report()["paged"]["blocks_in_use"] <= 4
