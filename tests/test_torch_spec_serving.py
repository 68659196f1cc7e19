"""PyTorch port parity: the speculative serving engines.

``SpeculativeServingEngine`` (prompt lookup or a draft model) and
``PagedSpeculativeServingEngine`` against the JAX package's engines of
the same configuration and against the port's dense grid: same weights
(JAX init, crossed through numpy), fp32 tiny GQA config with flash=True
(the JAX side's Pallas flash kernel in interpret mode). Greedy streams
must be equal token for token, and the verify-window counts equal
JAX's. Raw-model logprobs agree within 1e-4 (fp32 log_softmax of logits
that the window and the chunk forward sum in other orders). Sampled
streams draw from the port's own noise: they are held to be a pure
function of (request, seed), not to JAX's draws.
"""

import dataclasses
import inspect

import numpy as np
import pytest

from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptf

from torch_parity import TINY, drive, jax_cfg, make_params, prompts
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
MAX_NEW = 12
LP_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


@pytest.fixture(scope="module")
def draft_model():
    dcfg = ptf.ModelConfig(vocab_size=CFG.vocab_size, d_model=16, n_heads=2,
                           n_layers=1, d_ff=32, max_seq=64, dtype="float32")
    return (dcfg,) + make_params(dcfg, seed=11, block_scale=4.0)


def family_prompts():
    """A 16-token head (two blocks of 8), three members extending it and
    one independent prompt: prefix hits on both storages."""
    rng = np.random.RandomState(21)
    head = rng.randint(0, CFG.vocab_size, size=16).tolist()
    return ([head] + [head + rng.randint(0, CFG.vocab_size, size=n).tolist()
                      for n in (3, 6, 9)]
            + [rng.randint(0, CFG.vocab_size, size=11).tolist()])


SPEC = dict(max_slots=2, max_len=48, speculative_k=3)
PAGED = dict(paged_blocks=12, block_size=8)
# (engine name, configuration, prompts, request keywords)
CASES = {
    "grid": ("SpeculativeServingEngine", SPEC, "stream", {}),
    "grid prefix hits": (
        "SpeculativeServingEngine", dict(SPEC, prefix_cache_entries=2),
        "family", dict(cache_prefix=True)),
    "paged": ("PagedSpeculativeServingEngine", dict(SPEC, **PAGED), "stream",
              {}),
    # 6 usable blocks for 3 slots of up to 4 blocks each: growth preempts
    "paged under pool pressure": (
        "PagedSpeculativeServingEngine",
        dict(SPEC, max_slots=3, paged_blocks=7, block_size=8), "stream", {}),
    "paged chunked prefill and prefix hits": (
        "PagedSpeculativeServingEngine",
        dict(SPEC, prefill_chunk=8, prefix_cache_entries=2, paged_blocks=16,
             block_size=8), "family", dict(cache_prefix=True)),
}


def engines(params, name, kw, draft=None):
    """(port engine, JAX engine) of one configuration."""
    jparams, pparams = params
    extra_p, extra_j = {}, {}
    if draft is not None:
        dcfg, jd, pd = draft
        extra_p, extra_j = dict(draft=(pd, dcfg)), dict(
            draft=(jd, jax_cfg(dcfg)))
    port = getattr(pserving, name)(pparams, CFG, pserving.ServingConfig(**kw),
                                   device="cpu", **extra_p)
    ref = getattr(jserving, name)(jparams, jax_cfg(CFG),
                                  jserving.ServingConfig(**kw), **extra_j)
    return port, ref


def dense_streams(pparams, ps, **req):
    eng = pserving.ServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=2, max_len=48,
                                             chunk=8), device="cpu")
    return {r: c.tokens for r, c in drive(pserving, eng, ps, MAX_NEW,
                                          **req).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_match_jax_and_the_dense_grid(params, case):
    name, kw, which, req = CASES[case]
    ps = (prompts(5, CFG.vocab_size) if which == "stream"
          else family_prompts())
    port, ref = engines(params, name, kw)
    got = drive(pserving, port, ps, MAX_NEW, **req)
    want = drive(jserving, ref, ps, MAX_NEW, **req)
    tokens = {r: c.tokens for r, c in got.items()}
    assert tokens == {r: c.tokens for r, c in want.items()}
    assert tokens == dense_streams(params[1], ps)
    assert all(c.finish_reason == "length" for c in got.values())
    rep, jrep = port.report(), ref.report()
    assert rep["speculative"] == jrep["speculative"]
    assert rep.get("prefix_cache", {}).get("hits") == jrep.get(
        "prefix_cache", {}).get("hits")
    if "paged" in rep:
        assert rep["paged"]["preemptions"] == jrep["paged"]["preemptions"]
        assert rep["paged"]["blocks_in_use"] == jrep["paged"]["blocks_in_use"]
    if "pressure" in case:
        assert rep["paged"]["preemptions"] > 0
    if "prefix" in case:
        assert rep["prefix_cache"]["hits"] > 0


def test_grid_chunked_prefill_keeps_a_pending_slots_rows(params):
    """Chunked prefill (with prefix hits) on the speculative grid: a
    slot streaming its prompt in is inactive during the verify rounds
    between its windows, and its cache rows must stay as its windows
    wrote them. The streams equal the JAX engine's with whole-prompt
    admission and the dense grid's. (The JAX engine's own chunked
    speculative grid writes inactive rows at their clamped base and
    splits from these streams: ROADMAP, Queue C.)"""
    ps = family_prompts()
    port, _ = engines(params, "SpeculativeServingEngine",
                      dict(SPEC, prefill_chunk=8, prefix_cache_entries=2))
    _, whole = engines(params, "SpeculativeServingEngine",
                       dict(SPEC, prefix_cache_entries=2))
    got = drive(pserving, port, ps, MAX_NEW, cache_prefix=True)
    want = drive(jserving, whole, ps, MAX_NEW, cache_prefix=True)
    tokens = {r: c.tokens for r, c in got.items()}
    assert tokens == {r: c.tokens for r, c in want.items()}
    assert tokens == dense_streams(params[1], ps)
    rep = port.report()
    assert rep["prefix_cache"]["hits"] > 0
    assert rep["suffix_windows"] > rep["prefix_cache"]["hits"]


def test_draft_model_engine_matches_jax_and_the_dense_grid(params,
                                                           draft_model):
    """A random one-layer draft model: the JAX engine's streams and
    verify windows, the dense grid's streams; the target drafting for
    itself takes no more windows."""
    ps = prompts(5, CFG.vocab_size)
    port, ref = engines(params, "SpeculativeServingEngine", SPEC,
                        draft=draft_model)
    got = {r: c.tokens for r, c in drive(pserving, port, ps, MAX_NEW).items()}
    want = {r: c.tokens for r, c in drive(jserving, ref, ps, MAX_NEW).items()}
    assert got == want == dense_streams(params[1], ps)
    rep = port.report()["speculative"]
    assert rep == ref.report()["speculative"]
    assert rep["proposer"] == "draft-model"
    assert port.draft_prefills == len(ps)
    self_draft = pserving.SpeculativeServingEngine(
        params[1], CFG, pserving.ServingConfig(**SPEC), (params[1], CFG),
        device="cpu")
    assert {r: c.tokens for r, c in drive(
        pserving, self_draft, ps, MAX_NEW).items()} == got
    assert self_draft.verify_steps <= port.verify_steps


def _sampled_run(pparams, engine, extra_load, seed=77, **kw):
    samp = pdecode.SamplingConfig(temperature=1.3, top_k=20, min_p=0.01)
    rng = np.random.RandomState(90)
    p_s, p_g = (rng.randint(0, CFG.vocab_size, size=n).tolist()
                for n in (7, 5))
    eng = engine(pparams, CFG, pserving.ServingConfig(**dict(SPEC, **kw)),
                 device="cpu")
    eng.submit(pserving.Request("s", p_s, 14, sampling=samp, seed=seed))
    eng.submit(pserving.Request("g", p_g, 9))
    for i in range(extra_load):
        eng.submit(pserving.Request(
            f"x{i}", rng.randint(0, CFG.vocab_size, size=6).tolist(), 7,
            sampling=samp, seed=200 + i))
    return {c.request_id: c.tokens for c in eng.run()}, p_g


def test_sampled_streams_replay_and_mix_with_greedy(params):
    """A seeded sampled stream is a pure function of (request, seed):
    the same with other co-tenants, with one verify window a round or
    four, and over paged storage, and another with another seed; the
    greedy co-tenant keeps the dense grid's stream beside it."""
    _, pparams = params
    a, p_g = _sampled_run(pparams, pserving.SpeculativeServingEngine, 0)
    runs = [_sampled_run(pparams, pserving.SpeculativeServingEngine, 3)[0],
            _sampled_run(pparams, pserving.SpeculativeServingEngine, 2,
                         spec_windows=1)[0],
            _sampled_run(pparams, pserving.PagedSpeculativeServingEngine, 3,
                         paged_blocks=24, block_size=8)[0]]
    for b in runs:
        assert b["s"] == a["s"] and b["g"] == a["g"]
    assert len(a["s"]) == 14 and all(0 <= t < CFG.vocab_size for t in a["s"])
    solo = pdecode.greedy_generate(pparams, CFG, [p_g], 9, device="cpu")
    assert a["g"] == solo[0, len(p_g):].tolist()
    other_seed = _sampled_run(pparams, pserving.SpeculativeServingEngine, 0,
                              seed=78)[0]
    assert other_seed["s"] != a["s"] and other_seed["g"] == a["g"]


@pytest.mark.parametrize("windows", [1, 4])
def test_spec_windows_streams_and_steps_match_jax(params, windows):
    """One verify window a round against four: the same streams, and
    each the JAX engine's verify-window count."""
    ps = prompts(5, CFG.vocab_size)
    port, ref = engines(params, "SpeculativeServingEngine",
                        dict(SPEC, spec_windows=windows))
    got = {r: c.tokens for r, c in drive(pserving, port, ps, MAX_NEW).items()}
    want = {r: c.tokens for r, c in drive(jserving, ref, ps, MAX_NEW).items()}
    assert got == want == dense_streams(params[1], ps)
    assert port.verify_steps == ref.verify_steps


def test_logprobs_match_the_dense_grid_and_jax(params):
    """Logprobs through both speculative engines: the dense grid's
    tokens, logprobs within LP_TOL of the dense grid's and of the JAX
    speculative engine's."""
    jparams, pparams = params
    ps = prompts(3, CFG.vocab_size, seed=4)
    dense = drive(pserving, pserving.ServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=2, max_len=48,
                                             chunk=8), device="cpu"),
        ps, MAX_NEW, late=1, logprobs=True)
    for name, kw in (("SpeculativeServingEngine", SPEC),
                     ("PagedSpeculativeServingEngine",
                      dict(SPEC, paged_blocks=14, block_size=8))):
        port, ref = engines(params, name, kw)
        got = drive(pserving, port, ps, MAX_NEW, late=1, logprobs=True)
        want = drive(jserving, ref, ps, MAX_NEW, late=1, logprobs=True)
        for rid, c in got.items():
            assert c.tokens == dense[rid].tokens, (name, rid)
            assert len(c.logprobs) == len(c.tokens)
            np.testing.assert_allclose(c.logprobs, dense[rid].logprobs,
                                       atol=LP_TOL)
            np.testing.assert_allclose(c.logprobs, want[rid].logprobs,
                                       atol=LP_TOL)


@pytest.mark.parametrize("engine", ["SpeculativeServingEngine",
                                    "PagedSpeculativeServingEngine"])
def test_repetition_penalty_refused_at_submit(params, engine):
    """Refused at submit with the reference's message, the engine left
    untouched: the same id resubmits cleanly."""
    kw = dict(SPEC, **PAGED) if "Paged" in engine else SPEC
    eng = getattr(pserving, engine)(params[1], CFG,
                                    pserving.ServingConfig(**kw),
                                    device="cpu")
    prompt = prompts(1, CFG.vocab_size, seed=46)[0]
    with pytest.raises(ValueError, match="repetition_penalty is not "
                                         "supported by the speculative"):
        eng.submit(pserving.Request(
            "r", prompt, 4, sampling=pdecode.SamplingConfig(
                temperature=1.0, repetition_penalty=1.5)))
    eng.submit(pserving.Request("r", prompt, 4))
    (done,) = eng.run()
    assert len(done.tokens) == 4


def test_engine_knobs_refused_like_the_reference(params, draft_model):
    _, pparams = params
    with pytest.raises(ValueError, match="speculative_k >= 1"):
        pserving.SpeculativeServingEngine(pparams, CFG,
                                          pserving.ServingConfig(),
                                          device="cpu")
    with pytest.raises(ValueError, match="spec_windows must be >= 1"):
        pserving.SpeculativeServingEngine(
            pparams, CFG, pserving.ServingConfig(speculative_k=2,
                                                 spec_windows=0),
            device="cpu")
    with pytest.raises(ValueError, match="PagedSpeculativeServingEngine"):
        pserving.SpeculativeServingEngine(
            pparams, CFG, pserving.ServingConfig(speculative_k=2, **PAGED),
            device="cpu")
    with pytest.raises(ValueError, match="verify window uses the gather"):
        pserving.PagedSpeculativeServingEngine(
            pparams, CFG, pserving.ServingConfig(speculative_k=2,
                                                 paged_kernel=True, **PAGED),
            device="cpu")
    dcfg, _, pd = draft_model
    bad = dataclasses.replace(dcfg, vocab_size=32)
    with pytest.raises(ValueError, match="draft vocab 32"):
        pserving.SpeculativeServingEngine(
            pparams, CFG, pserving.ServingConfig(speculative_k=2),
            (pd, bad), device="cpu")


def test_speculative_engine_arguments_keep_the_reference_order():
    """``draft`` is the fourth parameter, as in the reference, so a
    positional draft lands on it; the port's device, clock and mesh
    follow as keywords only."""
    port = inspect.signature(pserving.SpeculativeServingEngine.__init__)
    ref = inspect.signature(jserving.SpeculativeServingEngine.__init__)
    positional = [n for n, p in port.parameters.items()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional == list(ref.parameters)[:len(positional)]
    assert positional == ["self", "params", "cfg", "serving", "draft"]
    assert all(port.parameters[n].kind is inspect.Parameter.KEYWORD_ONLY
               for n in ("device", "clock", "mesh"))
    assert port.parameters["draft"].default is None
