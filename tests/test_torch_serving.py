"""PyTorch port parity: decoding and the dense continuous-batching engine.

Same weights (JAX init, crossed through numpy) and prompts on both
sides, fp32 tiny GQA config with flash=True (the JAX side's Pallas
flash kernel runs in interpret mode). Greedy streams must be equal
token for token; every compared step's top-2 logit margin is checked
to exceed the logit tolerance (1e-3), so a mismatch is a real
divergence and not a tie. Sampling is compared on the same logits and
the same injected Gumbel noise.
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
from kind_tpu_sim.models import transformer as jtransformer
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import quant as pquant
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptransformer

from torch_parity import (
    TINY,
    assert_margins,
    assert_streams_split_only_at_ties,
    drive,
    jax_cfg,
    make_params,
    prompts,
)

CFG = TINY
MARGIN = 1e-3
MAX_NEW = 12
# an int8 or MoE stream may split from the reference's only where the
# reference's top-2 logits lie within this share of its largest logit:
# a one-step change of one quantized value moves a logit by up to about
# 1/127 of its row's scale
SPLIT_REL = 1e-2


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


@pytest.fixture(scope="module")
def stream_prompts():
    return prompts(5, CFG.vocab_size)


@pytest.fixture(scope="module")
def jax_dense(params, stream_prompts):
    sc = jserving.ServingConfig(max_slots=2, max_len=48, chunk=8)
    eng = jserving.ServingEngine(params[0], jax_cfg(CFG), sc)
    return drive(jserving, eng, stream_prompts, MAX_NEW, logprobs=True)


def test_greedy_generate_matches_jax_across_chunks(params):
    """Solo decoder: prefill + chunked cached decode; 19 steps at chunk
    8 cross two chunk boundaries and end on a remainder chunk."""
    jparams, pparams = params
    batch = np.asarray(prompts(3, CFG.vocab_size, seed=5, base=9, step=0),
                       np.int32)
    ref = np.asarray(jdecode.greedy_generate(jparams, jax_cfg(CFG),
                                             jnp.asarray(batch), 20,
                                             chunk=8))
    out = pdecode.greedy_generate(pparams, CFG, batch, 20, chunk=8,
                                  device="cpu").numpy()
    assert (out == ref).all()
    for row in out:
        assert_margins(pparams, CFG, row[:9].tolist(), row[9:].tolist(),
                       MARGIN)


def test_prefill_logits_and_cache_match_jax(params):
    jparams, pparams = params
    prompt = np.asarray(prompts(1, CFG.vocab_size, seed=6, base=11)[0:1],
                        np.int32)
    jl, jc = jdecode.prefill(jparams, jax_cfg(CFG), jnp.asarray(prompt), 16)
    pl, pc = pdecode.prefill(pparams, CFG, torch.as_tensor(prompt).long(),
                             16)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for jlayer, player in zip(jc, pc):
        for name in ("k", "v"):
            np.testing.assert_allclose(player[name].numpy(),
                                       np.asarray(jlayer[name]), atol=1e-5,
                                       rtol=1e-5)


def test_dense_engine_streams_match_jax(params, stream_prompts, jax_dense):
    """Mixed prompt lengths, mid-flight admission, more requests than
    slots: the port's ServingEngine emits the JAX engine's streams."""
    _, pparams = params
    sc = pserving.ServingConfig(max_slots=2, max_len=48, chunk=8)
    eng = pserving.ServingEngine(pparams, CFG, sc, device="cpu")
    done = drive(pserving, eng, stream_prompts, MAX_NEW, logprobs=True)
    assert sorted(done) == sorted(jax_dense)
    for rid, comp in done.items():
        assert comp.tokens == jax_dense[rid].tokens, rid
        assert comp.finish_reason == jax_dense[rid].finish_reason == "length"
        assert_margins(pparams, CFG, comp.prompt, comp.tokens, MARGIN)


def test_dense_engine_logprobs_match_jax(params, stream_prompts, jax_dense):
    _, pparams = params
    sc = pserving.ServingConfig(max_slots=2, max_len=48, chunk=8)
    eng = pserving.ServingEngine(pparams, CFG, sc, device="cpu")
    done = drive(pserving, eng, stream_prompts, MAX_NEW, logprobs=True)
    for rid, comp in done.items():
        np.testing.assert_allclose(comp.logprobs, jax_dense[rid].logprobs,
                                   atol=1e-4, rtol=1e-4)


def test_engine_latency_fields_and_report(params, stream_prompts):
    _, pparams = params
    sc = pserving.ServingConfig(max_slots=2, max_len=48, chunk=8)
    eng = pserving.ServingEngine(pparams, CFG, sc, device="cpu")
    done = drive(pserving, eng, stream_prompts, MAX_NEW)
    for comp in done.values():
        assert 0 <= comp.ttft_s <= comp.e2e_s
    rep = eng.report()
    assert rep["latency"]["completed"] == len(stream_prompts)
    assert rep["prefills"] == len(stream_prompts)
    assert rep["active"] == 0 and rep["queued"] == 0


def test_eos_stops_early(params, stream_prompts):
    _, pparams = params
    sc = pserving.ServingConfig(max_slots=2, max_len=48, chunk=8)
    eng = pserving.ServingEngine(pparams, CFG, sc, device="cpu")
    free = drive(pserving, eng, stream_prompts[:1], MAX_NEW,
                 late=0)["r0"].tokens
    eos = free[3]
    cut = free[:free.index(eos) + 1]
    eng = pserving.ServingEngine(pparams, CFG, sc, device="cpu")
    eng.submit(pserving.Request("e", stream_prompts[0], MAX_NEW, eos_id=eos))
    (comp,) = eng.run()
    assert comp.tokens == cut and comp.finish_reason == "stop"


def _sampling_rows(seed=0, b=6, vocab=64):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, vocab) * 3).astype(np.float32)
    temp = np.asarray([0.0, 0.7, 1.0, 1.3, 0.9, 1.1], np.float32)[:b]
    top_k = np.asarray([0, 5, 0, 20, 0, 3], np.int32)[:b]
    top_p = np.asarray([1.0, 1.0, 0.8, 0.95, 1.0, 0.5], np.float32)[:b]
    min_p = np.asarray([0.0, 0.0, 0.05, 0.0, 0.2, 0.0], np.float32)[:b]
    rep_pen = np.asarray([1.3, 1.0, 1.2, 1.0, 0.8, 1.5], np.float32)[:b]
    presence = rng.rand(b, vocab) < 0.2
    return logits, temp, top_k, top_p, min_p, rep_pen, presence


def test_rep_penalty_and_filters_match_jax():
    logits, temp, top_k, top_p, min_p, rep_pen, presence = _sampling_rows()
    jpen = jserving._apply_rep_penalty(jnp.asarray(logits),
                                       jnp.asarray(rep_pen),
                                       jnp.asarray(presence))
    ppen = pserving._apply_rep_penalty(torch.as_tensor(logits),
                                       torch.as_tensor(rep_pen),
                                       torch.as_tensor(presence))
    np.testing.assert_allclose(ppen.numpy(), np.asarray(jpen), rtol=1e-6)
    jf = np.asarray(jserving._filtered_scaled(
        jpen, jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p),
        jnp.asarray(min_p)))
    pf = pserving._filtered_scaled(
        ppen, torch.as_tensor(temp), torch.as_tensor(top_k),
        torch.as_tensor(top_p), torch.as_tensor(min_p)).numpy()
    assert ((jf <= -1e29) == (pf <= -1e29)).all()
    live = jf > -1e29
    np.testing.assert_allclose(pf[live], jf[live], rtol=1e-6)


def test_sample_rows_matches_jax_with_the_same_gumbel_noise():
    """Gumbel-max with injected noise: the port's draw equals JAX's
    ``_sample_rows`` whose categorical uses the same noise (JAX's
    categorical is argmax(logits + gumbel(key)))."""
    arrs = _sampling_rows(seed=1)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(6, dtype=jnp.uint32))
    noise = np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (64,), jnp.float32))(keys))
    want = np.asarray(jserving._sample_rows(
        *(jnp.asarray(a) for a in arrs), keys))
    got = pserving._sample_rows(*(torch.as_tensor(a) for a in arrs),
                                noise=torch.as_tensor(noise)).numpy()
    assert (got == want).all()
    assert got[0] == np.argmax(np.asarray(jserving._apply_rep_penalty(
        *(jnp.asarray(a) for a in (arrs[0], arrs[5], arrs[6]))))[0])


def test_gumbel_noise_is_a_pure_function_of_seed_and_index():
    temp = torch.tensor([1.0, 1.0, 0.0])
    a = pserving._gumbel_noise([(7, 3), (7, 4), (7, 3)], 64, temp, "cpu")
    b = pserving._gumbel_noise([(7, 3), (7, 4), (7, 3)], 64, temp, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    assert (a[2] == 0).all()  # greedy rows draw nothing


def test_sampled_stream_reproducible_and_placement_independent(
        params, stream_prompts):
    """A seeded sampled request is a pure function of (request, seed,
    index): the same stream alone, in a busy dense grid, and through a
    paged pool small enough to force recompute preemption."""
    _, pparams = params
    samp = pdecode.SamplingConfig(temperature=1.0, top_k=20)

    def run(engine):
        for i, p in enumerate(stream_prompts):
            engine.submit(pserving.Request(f"s{i}", p, MAX_NEW,
                                           sampling=samp, seed=100 + i))
        return {c.request_id: c.tokens for c in engine.run()}, engine

    dense, _ = run(pserving.ServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=2, max_len=48,
                                             chunk=8), device="cpu"))
    paged, eng = run(pserving.PagedServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=2, max_len=48,
                                             chunk=8, paged_blocks=5,
                                             block_size=8,
                                             paged_kernel=True),
        device="cpu"))
    assert eng.preemptions > 0
    assert dense == paged
    solo = pserving.ServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=1, max_len=48,
                                             chunk=8), device="cpu")
    solo.submit(pserving.Request("s3", stream_prompts[3], MAX_NEW,
                                 sampling=samp, seed=103))
    assert solo.run()[0].tokens == dense["s3"]
    assert any(len(set(toks)) > 1 for toks in dense.values())


def test_serving_from_params_that_require_grad_builds_no_graph(
        params, stream_prompts, monkeypatch):
    """Parameters as a train step leaves them (leaves requiring grad)
    serve the same streams as detached ones, and no cache, pool or
    logit tensor carries autograd history."""
    from kind_tpu_sim_torch.models import quant

    _, pparams = params
    trained = {"embed": pparams["embed"].clone().requires_grad_(),
               "final_norm": pparams["final_norm"].clone().requires_grad_(),
               "blocks": [{k: v.clone().requires_grad_() for k, v in b.items()}
                          for b in pparams["blocks"]]}
    logits_grad = []
    real = quant.readout

    def spy(x, embed, native=False):
        out = real(x, embed, native)
        logits_grad.append(out.requires_grad)
        return out

    monkeypatch.setattr(quant, "readout", spy)
    dense_sc = pserving.ServingConfig(max_slots=2, max_len=48, chunk=8)
    paged_sc = pserving.ServingConfig(max_slots=2, max_len=48, chunk=8,
                                      paged_blocks=9, block_size=8,
                                      paged_kernel=True)
    for engine, sc, storage in ((pserving.ServingEngine, dense_sc, "cache"),
                                (pserving.PagedServingEngine, paged_sc,
                                 "pools")):
        streams = {}
        for name, p in (("trained", trained), ("detached", pparams)):
            eng = engine(p, CFG, sc, device="cpu")
            done = drive(pserving, eng, stream_prompts, MAX_NEW)
            streams[name] = {rid: c.tokens for rid, c in done.items()}
            layers = getattr(eng, storage)
            assert not any(t.requires_grad for lc in layers
                           for t in lc.values()), storage
            assert not eng.last_token.requires_grad
        assert streams["trained"] == streams["detached"], engine.__name__
    batch = np.asarray(prompts(2, CFG.vocab_size, seed=5, base=9, step=0))
    out = pdecode.greedy_generate(trained, CFG, batch, 10, chunk=4,
                                  device="cpu")
    assert not out.requires_grad
    assert torch.equal(out, pdecode.greedy_generate(pparams, CFG, batch, 10,
                                                    chunk=4, device="cpu"))
    assert logits_grad and not any(logits_grad)
    snapshot = pdecode.serving_params(trained, CFG)
    assert not snapshot["embed"].requires_grad
    assert not snapshot["blocks"][0]["attn_norm"].requires_grad


def _overlap_refused(pparams):
    sc = dict(max_slots=2, max_len=48, chunk=8, overlap_rounds=True)
    pserving.ServingEngine(pparams, CFG, pserving.ServingConfig(**sc),
                           device="cpu")
    with pytest.raises(ValueError, match="overlap_rounds is dense/spec-grid"):
        pserving.PagedServingEngine(
            pparams, CFG, pserving.ServingConfig(paged_blocks=12,
                                                 block_size=8, **sc),
            device="cpu")


def _speculative_k_refused(pparams):
    sc = pserving.ServingConfig(max_slots=2, max_len=48, speculative_k=2)
    pserving.SpeculativeServingEngine(pparams, CFG, sc, device="cpu")
    with pytest.raises(ValueError, match="construct SpeculativeServingEngine"):
        pserving.ServingEngine(pparams, CFG, sc, device="cpu")


def _max_queue_refused(pparams):
    eng = pserving.ServingEngine(
        pparams, CFG, pserving.ServingConfig(max_slots=2, max_len=48,
                                             max_queue=1), device="cpu")
    eng.submit(pserving.Request("a", [1, 2], 2))
    with pytest.raises(pserving.EngineSaturated, match="max_queue=1"):
        eng.submit(pserving.Request("b", [1, 2], 2))


# the knobs that sat outside the slice until the engine surface was
# ported: each is served now and raises only where it still must (on
# an engine that does not take it, or past its limit)
UNPORTED_KNOBS = {
    "overlap_rounds": _overlap_refused,
    "speculative_k": _speculative_k_refused,
    "max_queue": _max_queue_refused,
}


@pytest.mark.parametrize("knob", sorted(UNPORTED_KNOBS))
def test_knobs_outside_the_slice_raise(params, knob):
    UNPORTED_KNOBS[knob](params[1])


ADMISSION_KNOBS = {
    "prefix_cache_entries": dict(prefix_cache_entries=2),
    "prefill_chunk": dict(prefill_chunk=8),
    "admission_wave_sizes": dict(admission_wave_sizes=(1, 2)),
}


@pytest.mark.parametrize("knob", sorted(ADMISSION_KNOBS))
def test_admission_knobs_are_served(params, stream_prompts, knob):
    """The admission knobs (once outside the slice) run on both engines
    and serve the streams the default engine serves."""
    _, pparams = params
    base = dict(max_slots=2, max_len=48, chunk=8)
    want = {r: c.tokens for r, c in drive(
        pserving, pserving.ServingEngine(
            pparams, CFG, pserving.ServingConfig(**base), device="cpu"),
        stream_prompts, MAX_NEW).items()}
    for engine, extra in ((pserving.ServingEngine, {}),
                          (pserving.PagedServingEngine,
                           dict(paged_blocks=24, block_size=8,
                                paged_width=6))):
        sc = pserving.ServingConfig(**base, **extra, **ADMISSION_KNOBS[knob])
        eng = engine(pparams, CFG, sc, device="cpu")
        got = drive(pserving, eng, stream_prompts, MAX_NEW,
                    cache_prefix=True)
        assert {r: c.tokens for r, c in got.items()} == want, engine


@pytest.mark.parametrize("field", ["int8_kv", "int8_native", "n_experts"])
def test_config_features_outside_the_slice_raise(params, stream_prompts,
                                                 field):
    """These config features are served now (only a mesh still raises):
    the int8 flags on an int8 snapshot (``quantize_params`` on both
    sides) and ``n_experts`` on MoE weights from the JAX init, each
    through ``ServingEngine``, emit the JAX engine's greedy streams (a
    split allowed only at a near tie, ``SPLIT_REL``)."""
    value = 4 if field == "n_experts" else True
    cfg = dataclasses.replace(CFG, **{field: value})
    if field == "n_experts":
        jparams, pparams = make_params(cfg, embed_scale=0.5, block_scale=6.0)
    else:
        jparams = jquant.quantize_params(params[0], jax_cfg(cfg))
        pparams = pquant.quantize_params(params[1], cfg)
    sc = dict(max_slots=2, max_len=48, chunk=8)
    want = drive(jserving, jserving.ServingEngine(
        jparams, jax_cfg(cfg), jserving.ServingConfig(**sc)),
        stream_prompts, MAX_NEW)
    got = drive(pserving, pserving.ServingEngine(
        pparams, cfg, pserving.ServingConfig(**sc), device="cpu"),
        stream_prompts, MAX_NEW)
    assert_streams_split_only_at_ties(
        jparams, cfg, stream_prompts, {r: c.tokens for r, c in got.items()},
        {r: c.tokens for r, c in want.items()}, SPLIT_REL)


FIELD_CLASSES = {
    "ServingConfig": (pserving.ServingConfig, jserving.ServingConfig),
    "Request": (pserving.Request, jserving.Request),
    "Completion": (pserving.Completion, jserving.Completion),
    "SamplingConfig": (pdecode.SamplingConfig, jdecode.SamplingConfig),
    "ModelConfig": (ptransformer.ModelConfig, jtransformer.ModelConfig),
}


@pytest.mark.parametrize("name", sorted(FIELD_CLASSES))
def test_config_fields_match_the_reference_in_order(name):
    """The port's copies keep the reference's field names, order and
    defaults, so positional arguments land on the same fields."""
    port, ref = FIELD_CLASSES[name]
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    for pf, rf in zip(dataclasses.fields(port), dataclasses.fields(ref)):
        assert pf.default == rf.default, pf.name


def test_positional_serving_config_lands_like_the_reference():
    args = (4, 128, 16, 0, 64, 16, 0, 4)
    port, ref = pserving.ServingConfig(*args), jserving.ServingConfig(*args)
    assert port.spec_windows == ref.spec_windows == 4
    assert port.paged_kernel is ref.paged_kernel is False


def test_unported_spec_windows_and_cache_prefix_raise(params, stream_prompts):
    """``spec_windows`` and ``deadline_s`` are served now: one verify
    window a round gives the streams four do (and the dense grid's),
    and a ``cache_prefix`` request with a deadline it meets completes
    in full."""
    _, pparams = params
    want = {r: c.tokens for r, c in drive(
        pserving, pserving.ServingEngine(
            pparams, CFG, pserving.ServingConfig(max_slots=2, max_len=48,
                                                 chunk=8), device="cpu"),
        stream_prompts, MAX_NEW).items()}
    for windows in (1, 4):
        sc = pserving.ServingConfig(max_slots=2, max_len=48,
                                    speculative_k=2, spec_windows=windows)
        eng = pserving.SpeculativeServingEngine(pparams, CFG, sc,
                                                device="cpu")
        got = drive(pserving, eng, stream_prompts, MAX_NEW)
        assert {r: c.tokens for r, c in got.items()} == want, windows
    eng = pserving.ServingEngine(pparams, CFG, pserving.ServingConfig(),
                                 device="cpu")
    eng.submit(pserving.Request("c", [1, 2], 4, cache_prefix=True,
                                deadline_s=3600.0))
    (comp,) = eng.run()
    assert len(comp.tokens) == 4 and comp.finish_reason == "length"
    assert not comp.deadline_exceeded


def test_mesh_and_deadline_raise(params):
    """A valid mesh serves: the engine over ('data', 2) on two gloo ranks
    emits the unsharded engine's streams; an invalid one raises the
    reference's guard (3 slots over a data axis of 2). A deadline is
    served: a request whose budget is spent before admission completes
    unserved, with no tokens."""
    import torch_parity
    from kind_tpu_sim_torch.parallel import launch

    knobs = dict(max_slots=2, max_len=48, chunk=8)
    reqs = [(f"m{i}", p, 6) for i, p in enumerate(
        torch_parity.prompts(3, CFG.vocab_size, seed=4))]
    meshed, bad = launch.spawn(
        torch_parity.mesh_rank_serve, 2, torch_parity.tree_numpy(params[0]),
        CFG, (2,), ("data",),
        [dict(engine="ServingEngine", knobs=knobs, reqs=reqs),
         dict(engine="ServingEngine", knobs=dict(knobs, max_slots=3),
              reqs=[])], backend="gloo", timeout_s=120)
    assert meshed[0] == torch_parity.serve_plain(params[1], CFG,
                                                 "ServingEngine", knobs, reqs)
    assert bad[0] == "raise" and "divisible" in bad[1]
    now = [0.0]
    eng = pserving.ServingEngine(params[1], CFG, pserving.ServingConfig(),
                                 device="cpu", clock=lambda: now[0])
    eng.submit(pserving.Request("d", [1, 2], 4, deadline_s=1.0))
    now[0] = 1.5
    (comp,) = eng.run()
    assert comp.finish_reason == "deadline_exceeded"
    assert comp.deadline_exceeded and comp.tokens == []
    assert comp.e2e_s == 1.5 and comp.ttft_s is None


def test_capacity_and_paged_knobs_are_checked(params):
    eng = pserving.ServingEngine(params[1], CFG,
                                 pserving.ServingConfig(max_len=16),
                                 device="cpu")
    with pytest.raises(ValueError, match="slot capacity"):
        eng.submit(pserving.Request("big", [1] * 10, 8))
    with pytest.raises(ValueError, match="PagedServingEngine"):
        pserving.ServingEngine(params[1], CFG,
                               pserving.ServingConfig(paged_blocks=8),
                               device="cpu")
