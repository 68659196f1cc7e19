"""PyTorch port parity: the paged KV cache and PagedServingEngine.

Same weights (JAX init, crossed through numpy) and prompts on both
sides, fp32 tiny GQA config with flash=True; the JAX side's Pallas
flash and paged-attention kernels run in interpret mode, the port's
wrappers take their plain versions (CPU tensors). Greedy streams must
be equal token for token, with every compared step's top-2 logit
margin above the logit tolerance (1e-3), so a mismatch is a real
divergence and not a tie. Pool contents agree at 1e-5 and logprobs at
1e-4 (fp32 on both sides; summation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import paged as jpaged
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch.models import paged as ppaged
from kind_tpu_sim_torch.models import serving as pserving

from torch_parity import (
    TINY,
    assert_margins,
    drive,
    jax_cfg,
    make_params,
    prompts,
)
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
MARGIN = 1e-3
MAX_NEW = 12
# 4 usable blocks of 8 positions: two slots cannot both hold prompt +
# generation, so the run preempts and replays (tests/test_paged.py)
POOL = dict(max_slots=2, max_len=48, chunk=8, paged_blocks=5, block_size=8)
TIERS = {"gather": False, "kernel": True}


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


@pytest.fixture(scope="module")
def stream_prompts():
    return prompts(5, CFG.vocab_size)


@pytest.fixture(scope="module")
def jax_runs(params, stream_prompts):
    """Both JAX tiers once per module: {tier: (completions, report)}."""
    out = {}
    for tier, kernel in TIERS.items():
        eng = jserving.PagedServingEngine(
            params[0], jax_cfg(CFG),
            jserving.ServingConfig(**POOL, paged_kernel=kernel))
        done = drive(jserving, eng, stream_prompts, MAX_NEW, logprobs=True)
        out[tier] = (done, eng.report()["paged"])
    return out


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_paged_engine_streams_match_jax_under_preemption(
        params, stream_prompts, jax_runs, tier):
    """Mixed prompt lengths, mid-flight admission and a pool small
    enough to force recompute preemption: the port's engine emits the
    JAX engine's streams on the same tier, preempts as often, and
    returns every block."""
    _, pparams = params
    eng = pserving.PagedServingEngine(
        pparams, CFG, pserving.ServingConfig(**POOL,
                                             paged_kernel=TIERS[tier]),
        device="cpu")
    done = drive(pserving, eng, stream_prompts, MAX_NEW, logprobs=True)
    jdone, jrep = jax_runs[tier]
    rep = eng.report()["paged"]
    assert sorted(done) == sorted(jdone)
    assert rep["preemptions"] > 0
    assert rep["preemptions"] == jrep["preemptions"]
    assert rep["blocks_in_use"] == jrep["blocks_in_use"] == 0
    for rid, comp in done.items():
        assert comp.tokens == jdone[rid].tokens, rid
        assert comp.finish_reason == jdone[rid].finish_reason == "length"
        assert len(comp.tokens) == MAX_NEW
        np.testing.assert_allclose(comp.logprobs, jdone[rid].logprobs,
                                   atol=1e-4, rtol=1e-4)
        assert_margins(pparams, CFG, comp.prompt, comp.tokens, MARGIN)


def test_paged_tiers_equal_the_dense_grid(params, jax_runs,
                                         stream_prompts):
    """Both paged tiers' streams (which the port's paged engines equal
    token for token, above) are the port's dense-grid streams."""
    _, pparams = params
    dense = pserving.ServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=2, max_len=48,
                                             chunk=8), device="cpu")
    want = {r: c.tokens for r, c in
            drive(pserving, dense, stream_prompts, MAX_NEW).items()}
    for tier in TIERS:
        assert {r: c.tokens for r, c in jax_runs[tier][0].items()} == want


def _prefilled(jparams, pparams, ps, bsz=8, nblocks=12, width=4):
    """Both packages' pools after paged_prefill of each prompt into its
    own blocks (slot s gets distinct blocks; table padding stays at the
    garbage block). Returns (jpools, ppools, tables, first tokens)."""
    tables = np.zeros((len(ps), width), np.int32)
    nxt = 1
    for s, p in enumerate(ps):
        n = ppaged.blocks_needed(len(p) + 8, bsz)
        tables[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    jpools = jpaged.init_pools(jax_cfg(CFG), nblocks, bsz)
    ppools = ppaged.init_pools(CFG, nblocks, bsz, device="cpu")
    firsts = []
    for s, p in enumerate(ps):
        window = pserving._padded_window(p)
        jpools, jl = jpaged.paged_prefill(
            jparams, jpools, jnp.asarray(window, jnp.int32),
            jnp.int32(len(p)), jnp.asarray(tables[s]), cfg=jax_cfg(CFG))
        pl = ppaged.paged_prefill(
            pparams, ppools, torch.as_tensor(window), len(p),
            torch.as_tensor(tables[s]), cfg=CFG)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        firsts.append(int(pl.argmax()))
    return jpools, ppools, tables, firsts


def _assert_pools_match(jpools, ppools):
    """Every block but the garbage block holds the same k/v."""
    for jl, pl in zip(jpools, ppools):
        for name in ("k", "v"):
            np.testing.assert_allclose(pl[name][1:].numpy(),
                                       np.asarray(jl[name])[1:], atol=1e-5,
                                       rtol=1e-5)


def test_paged_prefill_logits_and_pool_writes_match_jax(params):
    jpools, ppools, _, _ = _prefilled(*params, prompts(2, CFG.vocab_size,
                                                       seed=3, base=5,
                                                       step=6))
    _assert_pools_match(jpools, ppools)


def test_paged_decode_chunk_kernel_matches_jax(params):
    """One scheduling quantum on the kernel tier from the same prefilled
    pools (two live slots of different lengths, one inactive slot of
    length 0 whose table is all garbage): the same tokens, logprobs and
    pool writes as the JAX package's Pallas tier, and as the port's
    gather tier."""
    jparams, pparams = params
    ps = prompts(2, CFG.vocab_size, seed=4, base=6, step=7)
    jpools, ppools, tables, firsts = _prefilled(jparams, pparams, ps)
    tables = np.concatenate([tables, np.zeros((1, tables.shape[1]),
                                              np.int32)])
    lengths = np.asarray([len(p) for p in ps] + [0], np.int32)
    active = np.asarray([True, True, False])
    last = np.asarray(firsts + [0], np.int32)
    presence = np.zeros((3, CFG.vocab_size), bool)
    b = len(lengths)
    jstate = (jnp.zeros(b, jnp.float32), jnp.zeros(b, jnp.int32),
              jnp.ones(b, jnp.float32), jnp.zeros(b, jnp.float32),
              jnp.ones(b, jnp.float32),
              jax.vmap(jax.random.PRNGKey)(jnp.zeros(b, jnp.uint32)),
              jnp.asarray(lengths))
    jpools, _, _, jemit, _, jlps = jpaged.paged_decode_chunk_kernel(
        jparams, jpools, jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(last), jnp.asarray(active), jstate,
        jnp.asarray(presence), cfg=jax_cfg(CFG), chunk=8)
    gather_pools = [{n: t.clone() for n, t in lc.items()} for lc in ppools]
    outs = {}
    for name, fn, pools in (("kernel", ppaged.paged_decode_chunk_kernel,
                             ppools),
                            ("gather", ppaged.paged_decode_chunk,
                             gather_pools)):
        # sampling None: every row greedy and penalty-free, as jstate's
        emit, lps = fn(
            pparams, pools, torch.as_tensor(tables),
            torch.as_tensor(lengths), torch.as_tensor(last).long(),
            torch.as_tensor(active), None,
            torch.as_tensor(presence), cfg=CFG, chunk=8)
        outs[name] = (emit.numpy(), lps.numpy())
    live = active
    for emit, lps in outs.values():
        assert (emit[live] == np.asarray(jemit)[live]).all()
        np.testing.assert_allclose(lps[live], np.asarray(jlps)[live],
                                   atol=1e-4, rtol=1e-4)
    _assert_pools_match(jpools, ppools)
    _assert_pools_match(jpools, gather_pools)


def test_scatter_rows_and_gather_view_match_jax():
    rng = np.random.RandomState(2)
    nblocks, bsz, kv, hd, slots, chunk = 9, 4, 2, 8, 3, 6
    pools = [{n: rng.randn(nblocks, bsz, kv, hd).astype(np.float32)
              for n in ("k", "v")} for _ in range(2)]
    tables = np.asarray([[3, 5, 0], [1, 2, 4], [7, 0, 0]], np.int32)
    starts = np.asarray([2, 5, 1], np.int32)
    active = np.asarray([True, True, False])
    rows = [{n: rng.randn(slots, chunk, kv, hd).astype(np.float32)
             for n in ("k", "v")} for _ in range(2)]
    jview = jpaged.gather_view(
        [{n: jnp.asarray(a) for n, a in lc.items()} for lc in pools],
        jnp.asarray(tables))
    tpools = [{n: torch.as_tensor(a.copy()) for n, a in lc.items()}
              for lc in pools]
    pview = ppaged.gather_view(tpools, torch.as_tensor(tables))
    for jl, pl in zip(jview, pview):
        for n in ("k", "v"):
            assert (pl[n].numpy() == np.asarray(jl[n])).all()
    jnew = jpaged.scatter_rows(
        [{n: jnp.asarray(a) for n, a in lc.items()} for lc in pools],
        jnp.asarray(tables), jnp.asarray(starts),
        [{n: jnp.asarray(a) for n, a in r.items()} for r in rows],
        jnp.asarray(active))
    ppaged.scatter_rows(tpools, torch.as_tensor(tables),
                        torch.as_tensor(starts),
                        [{n: torch.as_tensor(a) for n, a in r.items()}
                         for r in rows], torch.as_tensor(active))
    for jl, pl in zip(jnew, tpools):
        for n in ("k", "v"):
            assert (pl[n][1:].numpy() == np.asarray(jl[n])[1:]).all()


@pytest.mark.parametrize("base,true_len", [(0, 5), (6, 9), (3, 20)])
def test_window_indices_match_jax(base, true_len):
    table_row = np.asarray([4, 2, 6], np.int32)
    jb, jo = jpaged._window_indices(12, base, 4, 3, true_len,
                                    jnp.asarray(table_row))
    pb, po = ppaged._window_indices(12, base, 4, 3, true_len,
                                    torch.as_tensor(table_row))
    assert (pb.numpy() == np.asarray(jb)).all()
    assert (po.numpy() == np.asarray(jo)).all()


def test_block_allocator_matches_jax():
    """The same alloc/share/free sequence leaves both allocators with
    the same blocks, counts and peaks, and both refuse the same
    misuse."""
    allocs = [jpaged.BlockAllocator(6), ppaged.BlockAllocator(6)]
    got = []
    for alloc in allocs:
        a = alloc.alloc(2)
        b = alloc.alloc(3)
        none = alloc.alloc(1)
        alloc.share(a)
        alloc.free(a)
        alloc.free(b[:1])
        c = alloc.alloc(1)
        with pytest.raises(ValueError, match="double free"):
            alloc.free(b[:1] + b[:1])
        with pytest.raises(ValueError, match="bad block"):
            alloc.free([0])
        got.append((a, b, none, c, alloc.free_blocks, alloc.in_use,
                    alloc.peak_in_use, alloc.refcount(a[0])))
    assert got[0] == got[1]
    for n, bsz in ((1, 8), (8, 8), (9, 8), (0, 4)):
        assert ppaged.blocks_needed(n, bsz) == jpaged.blocks_needed(n, bsz)
    for n in (1, 2, 3, 5, 9):
        assert ppaged.width_bucket(n) == jpaged.width_bucket(n)


def test_paged_capacity_and_kernel_int8_checks(params):
    _, pparams = params
    eng = pserving.PagedServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=1, paged_blocks=3,
                                             block_size=8), device="cpu")
    with pytest.raises(ValueError, match="pool capacity"):
        eng.submit(pserving.Request("x", list(range(20)), max_new=8))
    with pytest.raises(ValueError, match="paged_blocks >= 2"):
        pserving.PagedServingEngine(pparams, CFG,
                                    pserving.ServingConfig(paged_blocks=1),
                                    device="cpu")


def test_fixed_width_overflow_fails_loudly(params):
    _, pparams = params
    eng = pserving.PagedServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=1, max_len=48,
                                             chunk=8, paged_blocks=8,
                                             block_size=8, paged_width=2,
                                             paged_kernel=True),
        device="cpu")
    eng.submit(pserving.Request("w", list(range(10)), max_new=20))
    with pytest.raises(ValueError, match="paged_width is fixed"):
        eng.run()
