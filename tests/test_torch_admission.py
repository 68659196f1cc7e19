"""PyTorch port parity: chunked prefill and batched admission waves.

Every engine run here also runs the JAX package's engine with the same
configuration, weights (JAX init, crossed through numpy) and prompts,
and the greedy streams must be equal token for token; the port's
streams must also equal its own per-slot, whole-prompt admission.
fp32 tiny GQA config with flash=True (the JAX side's Pallas kernels in
interpret mode, the port's wrappers on their plain versions).
"""

import dataclasses

import numpy as np
import pytest

from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch.models import serving as pserving

from torch_parity import TINY, jax_cfg, make_params
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
MAX_NEW = 6


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


def make_prompt(seed, length):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               size=length).tolist()


def run(mod, params, kw, waves, paged=False, per_slot=False, hook=None):
    """Drain each wave of (request id, prompt, max_new, extra) through an
    engine of ``mod`` (either package's serving module); ``per_slot``
    forces sequential admission, ``hook(engine)`` runs before the first
    wave. Returns ({id: tokens}, engine)."""
    jparams, pparams = params
    cls = mod.PagedServingEngine if paged else mod.ServingEngine
    if mod is pserving:
        eng = cls(pparams, CFG, pserving.ServingConfig(**kw), device="cpu")
    else:
        eng = cls(jparams, jax_cfg(CFG), jserving.ServingConfig(**kw))
    if per_slot:
        eng._batch_admission = lambda: False
    if hook is not None:
        hook(eng)
    out = {}
    for wave in waves:
        for rid, prompt, max_new, extra in wave:
            eng.submit(mod.Request(rid, prompt, max_new, **extra))
        out.update({c.request_id: c.tokens for c in eng.run()})
    return out, eng


def count_groups(eng):
    """Count the engine's stacked dispatches and their rows."""
    seen = {"waves": 0, "rows": 0}
    orig = eng._prefill_group

    def counting(group):
        seen["waves"] += 1
        seen["rows"] += len(group)
        return orig(group)

    eng._prefill_group = counting
    eng.seen = seen


CHUNK_LENS = [3, 8, 9, 21, 16]


def chunk_requests():
    return [[(f"c{i}", make_prompt(120 + i, n), MAX_NEW, {})
             for i, n in enumerate(CHUNK_LENS)]]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_equals_whole_prompt_and_jax(params, paged):
    """Prompts below, at and across the window size, more requests than
    slots: windows of 8 interleaved with decode emit the whole-prompt
    streams and the JAX engine's."""
    kw = dict(max_slots=2, max_len=48, chunk=8)
    if paged:
        kw.update(paged_blocks=16, block_size=8, paged_kernel=True)
    whole, _ = run(pserving, params, kw, chunk_requests(), paged)
    kw["prefill_chunk"] = 8
    port, eng = run(pserving, params, kw, chunk_requests(), paged)
    ref, _ = run(jserving, params, kw, chunk_requests(), paged)
    assert port == whole == ref
    rep = eng.report()
    # one window per 8 prompt tokens; every window after a prompt's
    # first runs against its prefix
    assert rep["prefills"] == sum(-(-n // 8) for n in CHUNK_LENS)
    assert rep["suffix_windows"] == rep["prefills"] - len(CHUNK_LENS)
    assert rep["pending_prefill"] == 0


def test_chunked_pending_slots_are_not_claimed_twice(params):
    """A claimed slot streaming its prompt stays out of the free-slot
    scan: one window a round, then activation."""
    kw = dict(max_slots=2, max_len=48, chunk=8, prefill_chunk=4)
    _, eng = run(pserving, params, kw, [])
    eng.submit(pserving.Request("p", make_prompt(4, 12), 4))
    eng.submit(pserving.Request("q", make_prompt(5, 12), 4))
    eng.submit(pserving.Request("r", make_prompt(6, 5), 4))
    eng._admit_and_advance()
    assert sorted(eng._pending) == [0, 1] and len(eng.queue) == 1
    assert [st["done"] for st in eng._pending.values()] == [4, 4]
    eng._admit_and_advance()
    assert sorted(eng._pending) == [0, 1] and len(eng.queue) == 1
    eng._admit_and_advance()
    assert not eng._pending and len(eng.queue) == 1
    assert all(r is not None for r in eng.slot_req)


def test_prefix_hit_composes_with_chunked_prefill(params):
    """A hit fast-forwards the window cursor; a chunked admission stores
    at completion. Streams equal whole-prompt admission's and JAX's,
    with the same hit count."""
    shared = make_prompt(142, 17)
    waves = [[("store", shared, 5, dict(cache_prefix=True))],
             [("reuse", shared + [7, 2, 9], 5, {})]]
    kw = dict(max_slots=2, max_len=64, chunk=8, prefix_cache_entries=4)
    whole, weng = run(pserving, params, kw, waves)
    kw["prefill_chunk"] = 8
    port, peng = run(pserving, params, kw, waves)
    ref, jeng = run(jserving, params, kw, waves)
    assert port == whole == ref
    assert peng.prefix_cache.hits == weng.prefix_cache.hits == 1
    assert jeng.prefix_cache.hits == 1


def test_chunked_paged_with_block_sharing(params):
    """Paged windows and a block-granular hit: dense whole-prompt, paged
    whole-prompt and paged chunked streams equal each other and JAX's
    paged chunked engine, one hit each."""
    shared = make_prompt(150, 16)
    waves = [[("store", shared, 5, dict(cache_prefix=True)),
              ("mid", make_prompt(151, 9), 6, {})],
             [("reuse", shared + [4, 4, 1], 5, {})]]
    kw = dict(max_slots=2, max_len=64, chunk=8, prefix_cache_entries=4)
    dense, _ = run(pserving, params, kw, waves)
    kw.update(paged_blocks=24, block_size=8)
    paged_whole, pw = run(pserving, params, kw, waves, paged=True)
    kw["prefill_chunk"] = 8
    paged_chunked, pc = run(pserving, params, kw, waves, paged=True)
    ref, jc = run(jserving, params, kw, waves, paged=True)
    assert dense == paged_whole == paged_chunked == ref
    assert pw.prefix_cache.hits == pc.prefix_cache.hits == 1
    assert jc.prefix_cache.hits == 1


def wave_requests():
    """Two prompt buckets (8 and 16), greedy."""
    return [[(f"b{i}", make_prompt(200 + i, (4 + i) if i < 4 else (5 + i)),
              MAX_NEW, dict(seed=i)) for i in range(8)]]


def test_waves_equal_per_slot_dense_and_jax(params):
    """Same-bucket misses run as stacked prefills with one first-token
    readback a wave; streams equal per-slot admission and the JAX
    engine's; buckets split into separate waves."""
    kw = dict(max_slots=4, max_len=48, chunk=8)
    batched, eng = run(pserving, params, kw, wave_requests(),
                       hook=count_groups)
    per_slot, slot_eng = run(pserving, params, kw, wave_requests(),
                             per_slot=True, hook=count_groups)
    ref, _ = run(jserving, params, kw, wave_requests())
    assert batched == per_slot == ref
    assert slot_eng.seen["waves"] == 0
    assert eng.seen["rows"] == 8 and eng.seen["waves"] < 8
    rep = eng.report()
    assert rep["prefill_dispatches"] == eng.seen["waves"]
    assert sum(n * c for n, c in rep["waves"].items()) == 8


def test_waves_keep_sampled_streams(params):
    """A wave of sampled and greedy requests: the batched first-token
    sample is the per-slot one (same keys, same filters)."""
    reqs = [[(r, p, n, dict(extra, sampling=pserving.SamplingConfig(
        temperature=1.1)) if i % 2 else extra)
        for i, (r, p, n, extra) in enumerate(wave_requests()[0])]]
    kw = dict(max_slots=4, max_len=48, chunk=8)
    batched, _ = run(pserving, params, kw, reqs)
    per_slot, _ = run(pserving, params, kw, reqs, per_slot=True)
    assert batched == per_slot


def test_waves_paged_fixed_width_and_jax(params):
    """Fixed-width paged engines batch admission; dynamic-width ones stay
    per slot; all streams equal each other and JAX's fixed-width
    engine's."""
    reqs = [[(f"pb{i}", make_prompt(230 + i, 4 + 2 * i), MAX_NEW,
              dict(seed=i)) for i in range(6)]]
    kw = dict(max_slots=4, max_len=64, chunk=8, paged_blocks=40,
              block_size=8, paged_kernel=True)
    fixed = dict(kw, paged_width=4)
    batched, eng = run(pserving, params, fixed, reqs, paged=True,
                       hook=count_groups)
    sequential, seq = run(pserving, params, fixed, reqs, paged=True,
                          per_slot=True, hook=count_groups)
    dynamic, dyn = run(pserving, params, kw, reqs, paged=True,
                       hook=count_groups)
    ref, _ = run(jserving, params, fixed, reqs, paged=True)
    assert batched == sequential == dynamic == ref
    assert eng.seen["waves"] >= 1
    assert seq.seen["waves"] == dyn.seen["waves"] == 0
    assert eng.report()["paged"]["blocks_in_use"] == 0


def test_wave_sizes_follow_the_wave_not_the_grid(params):
    """A wave of 6 on an 8-slot grid dispatches 6 rows (4+2 by default,
    4+1+1 with sizes (1, 4)), streams equal; sizes without 1 raise."""
    reqs = [[(f"w{i}", make_prompt(300 + i, 6), 4, dict(seed=i))
             for i in range(6)]]
    kw = dict(max_slots=8, max_len=32, chunk=8)
    default, d_eng = run(pserving, params, kw, reqs, hook=count_groups)
    sparse_kw = dict(kw, admission_wave_sizes=(1, 4))
    sparse, s_eng = run(pserving, params, sparse_kw, reqs, hook=count_groups)
    ref, _ = run(jserving, params, sparse_kw, reqs)
    assert default == sparse == ref
    assert d_eng.seen["rows"] == s_eng.seen["rows"] == 6
    assert d_eng.report()["waves"] == {2: 1, 4: 1}
    assert s_eng.report()["waves"] == {1: 2, 4: 1}
    with pytest.raises(ValueError, match="admission_wave_sizes"):
        pserving.ServingEngine(params[1], CFG, pserving.ServingConfig(
            max_slots=4, admission_wave_sizes=(2, 4)), device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_wave_flushes_before_a_claim_that_extends_its_store(params, paged):
    """A head with cache_prefix and its member in one admission round:
    the member's claim flushes the head's wave first, so it hits as
    under sequential admission, as in the JAX engine."""
    head = make_prompt(400, 16)
    reqs = [[("h", head, 4, dict(cache_prefix=True)),
             ("x", make_prompt(401, 9), 4, {}),
             ("m", head + [3, 1], 4, {})]]
    kw = dict(max_slots=4, max_len=48, chunk=8, prefix_cache_entries=4)
    if paged:
        kw.update(paged_blocks=24, block_size=8, paged_width=6)
    port, eng = run(pserving, params, kw, reqs, paged=paged)
    ref, jeng = run(jserving, params, kw, reqs, paged=paged)
    assert port == ref
    assert eng.prefix_cache.hits == jeng.prefix_cache.hits == 1


def test_warm_admission_rejects_a_live_engine(params):
    kw = dict(max_slots=2, max_len=48, chunk=8)
    _, eng = run(pserving, params, kw, [])
    eng.submit(pserving.Request("live", make_prompt(3, 6), 20))
    eng.step_round()
    with pytest.raises(RuntimeError, match="idle engine"):
        eng.warm_admission((6,))
    done = {c.request_id: c for c in [*eng.poll(), *eng.run()]}
    assert len(done["live"].tokens) == 20
    _, chunked = run(pserving, params, dict(kw, prefill_chunk=4), [])
    chunked.submit(pserving.Request("pend", make_prompt(4, 12), 4))
    chunked._admit()
    assert chunked._pending
    with pytest.raises(RuntimeError, match="idle engine"):
        chunked.warm_admission((6,))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_warm_admission_leaves_no_state(params, paged):
    """Warming runs the stacked dispatches on dummy prompts and leaves
    queue, allocator and counters as they were; streams afterwards equal
    an unwarmed engine's and JAX's."""
    kw = dict(max_slots=4, max_len=48, chunk=8)
    if paged:
        kw.update(paged_blocks=24, block_size=8, paged_width=4)
    reqs = [[("a", make_prompt(41, 6), 5, {})]]

    def warm(eng):
        before = eng.report()
        eng.warm_admission((6, 12), sizes=(1, 2))
        assert eng.report() == before
        if paged:
            assert eng.alloc.free_blocks == 23 and eng.alloc.peak_in_use == 0

    warmed, _ = run(pserving, params, kw, reqs, paged=paged, hook=warm)
    cold, _ = run(pserving, params, kw, reqs, paged=paged)
    ref, _ = run(jserving, params, kw, reqs, paged=paged)
    assert warmed == cold == ref


def test_warm_admission_is_a_no_op_for_chunked_and_dynamic_width(params):
    for kw, paged in ((dict(max_slots=2, max_len=48, prefill_chunk=4),
                       False),
                      (dict(max_slots=2, max_len=48, paged_blocks=8,
                            block_size=8), True)):
        _, eng = run(pserving, params, kw, [], paged=paged,
                     hook=count_groups)
        eng.warm_admission((6,))
        assert eng.seen["waves"] == 0


def test_config_copies_keep_the_reference_fields():
    """The knobs this slice serves keep the reference's defaults."""
    for name in ("prefix_cache_entries", "prefill_chunk",
                 "admission_wave_sizes"):
        assert (getattr(pserving.ServingConfig(), name)
                == getattr(jserving.ServingConfig(), name))
    assert dataclasses.fields(pserving.Request)[6].name == "cache_prefix"


def test_chunked_window_past_max_len_keeps_the_prefix(params):
    """The last window of a 13-token prompt (5 tokens, padded to 8 from
    position 8) runs past max_len 15. The port writes only the rows
    that fit, so the chunked stream equals the whole-prompt one, the
    JAX engine's whole-prompt stream included. (The reference's
    chunked engine clamps the window's start to 7 and writes position
    8's k/v over position 7; its second token differs for seed 5.)"""
    kw = dict(max_slots=1, max_len=15, chunk=4)
    for seed in range(6):
        reqs = [[("r", make_prompt(seed, 13), 2, {})]]
        whole, _ = run(pserving, params, kw, reqs)
        chunked, _ = run(pserving, params, dict(kw, prefill_chunk=8), reqs)
        ref, _ = run(jserving, params, kw, reqs)
        assert chunked == whole == ref, seed


def test_realistic_stream_definition():
    """The realistic stream of ``profile_serving``: 28 requests, 16
    independents of the bench's prompt lengths, 4 families whose heads
    are stored and come ahead of their 2 members, each member's prompt
    its head's plus its suffix; the same list every call."""
    from kind_tpu_sim_torch import profile_serving as ps

    reqs = ps.realistic_requests(32768)
    assert len(reqs) == 28
    assert [r.request_id for r in reqs] == [
        r.request_id for r in ps.realistic_requests(32768)]
    heads = {r.request_id: (i, r) for i, r in enumerate(reqs)
             if r.cache_prefix}
    assert len(heads) == ps.REALISTIC_FAMILIES
    indep = [r for r in reqs if not r.request_id.startswith("rf")]
    assert len(indep) == ps.REALISTIC_INDEPENDENT
    assert {len(r.prompt) for r in indep} <= set(ps.REALISTIC_LENS)
    assert all(r.max_new == ps.REALISTIC_MAX_NEW for r in reqs)
    for i, r in enumerate(reqs):
        if r.request_id.startswith("rf") and not r.cache_prefix:
            j, head = heads[r.request_id.split("m")[0] + "h"]
            assert j < i
            assert r.prompt[:ps.REALISTIC_HEAD] == head.prompt
            assert (len(r.prompt) - ps.REALISTIC_HEAD
                    in ps.REALISTIC_SUFFIXES)
    long = ps.longprompt_requests(32768)
    assert [len(r.prompt) for r in long] == [224] * 8 + [ps.LONG]
