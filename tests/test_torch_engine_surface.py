"""PyTorch port parity: the rest of the serving engine's surface.

Overlapped rounds, deadlines, ``max_queue`` shedding, slot-failure
recovery, latency rounding, ``outstanding`` / ``reset_latency`` and the
two report smokes, each against the JAX package's engine with the same
configuration, weights (JAX init, crossed through numpy), prompts and,
where time matters, the same fake clock. fp32 tiny GQA config with
flash=True (the JAX side's Pallas kernels in interpret mode). Greedy
streams and every completion field must be equal; sampled streams come
from the port's own noise and are held to the port's sequential
schedule.
"""

import dataclasses

import numpy as np
import pytest

from kind_tpu_sim import metrics as jmetrics
from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch import metrics as pmetrics
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptf

from torch_parity import TINY, jax_cfg, make_params
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
# a non-round clock step, so the rounding of ttft/e2e shows
TICK = 0.1234567891


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


@pytest.fixture(scope="module")
def draft_model():
    """A one-layer draft model: (cfg, JAX params, port params)."""
    dcfg = ptf.ModelConfig(vocab_size=CFG.vocab_size, d_model=16, n_heads=2,
                           n_layers=1, d_ff=32, max_seq=64, dtype="float32")
    return (dcfg,) + make_params(dcfg, seed=11, block_scale=4.0)


def make_prompt(seed, length):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               size=length).tolist()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt=TICK):
        self.t += dt


def engine(mod, params, kw, cls="ServingEngine", clock=None, draft=None):
    """``mod``'s engine; ``draft`` (cfg, JAX params, port params) makes
    it a draft-model speculative engine."""
    jparams, pparams = params
    if mod is pserving:
        extra = {} if draft is None else dict(draft=(draft[2], draft[0]))
        return getattr(pserving, cls)(pparams, CFG,
                                      pserving.ServingConfig(**kw),
                                      device="cpu", clock=clock, **extra)
    extra = {} if draft is None else dict(draft=(draft[1], jax_cfg(draft[0])))
    return getattr(jserving, cls)(jparams, jax_cfg(CFG),
                                  jserving.ServingConfig(**kw), clock=clock,
                                  **extra)


def completions(done):
    return {c.request_id: dataclasses.astuple(c) for c in done}


def overlap_requests(mod, pparams, greedy_only=False):
    """Every third request sampled; two greedy ones stop at eos, the
    third token of their own greedy stream."""
    reqs = []
    for i in range(8):
        sampled = i % 3 == 1
        if greedy_only and sampled:
            continue
        prompt = make_prompt(240 + i, 5 + 2 * i)
        max_new = 4 + 2 * (i % 3)
        eos = None
        if i % 4 == 2:
            solo = pdecode.greedy_generate(pparams, CFG, [prompt], max_new,
                                           device="cpu")
            eos = int(solo[0, len(prompt) + 2])
        samp = (mod.SamplingConfig(temperature=1.2) if mod is jserving
                else pdecode.SamplingConfig(temperature=1.2)) if sampled \
            else None
        reqs.append(mod.Request(f"ov{i}", prompt, max_new=max_new,
                                sampling=samp, seed=i, eos_id=eos))
    return reqs


# the engines that take overlap_rounds (the paged ones refuse it):
# name -> (engine, ServingConfig fields, with a draft model)
OVERLAP_ENGINES = {
    "dense": ("ServingEngine", dict(max_slots=2, max_len=64, chunk=8), False),
    "spec": ("SpeculativeServingEngine",
             dict(max_slots=2, max_len=64, speculative_k=3), False),
    "draft": ("SpeculativeServingEngine",
              dict(max_slots=2, max_len=64, speculative_k=3), True),
}


@pytest.mark.parametrize("name", sorted(OVERLAP_ENGINES))
def test_overlap_equals_sequential_and_jax(params, draft_model, name):
    """8 requests on 2 slots (re-admission behind zombie rounds), greedy,
    sampled and eos mixed: the pipelined run gives the sequential
    streams; the greedy ones are also the JAX engine's, pipelined."""
    cls, kw, with_draft = OVERLAP_ENGINES[name]
    draft = draft_model if with_draft else None

    def run(mod, greedy_only=False, **extra):
        eng = engine(mod, params, dict(kw, **extra), cls, draft=draft)
        for r in overlap_requests(mod, params[1], greedy_only):
            eng.submit(r)
        return ({c.request_id: (c.tokens, c.finish_reason) for c in eng.run()},
                eng)

    seq, _ = run(pserving)
    over, eng = run(pserving, overlap_rounds=True)
    assert over == seq
    assert any(r == "stop" for _, r in seq.values())
    assert eng.outstanding() == 0 and not eng.report()["active"]
    ref, _ = run(jserving, greedy_only=True, overlap_rounds=True)
    assert {r: v for r, v in over.items() if r in ref} == ref


@pytest.mark.parametrize("name", sorted(OVERLAP_ENGINES))
def test_round_dispatch_reads_nothing_back(params, draft_model, name,
                                           monkeypatch):
    """A round's dispatch never reads a tensor on the host, sampled
    rows included: their noise is made where the logits are, from the
    host's seeds and the device's lengths. On a card any such read
    would wait for the round in flight and undo the overlap."""
    cls, kw, with_draft = OVERLAP_ENGINES[name]
    eng = engine(pserving, params, dict(kw, overlap_rounds=True), cls,
                 draft=draft_model if with_draft else None)
    for r in overlap_requests(pserving, params[1]):
        eng.submit(r)
    dispatch, reads = eng._round_dispatch, []

    def guarded():
        def refuse(attr):
            def read(*args, **kwargs):
                reads.append(attr)
                raise AssertionError(f"Tensor.{attr} inside a dispatch")
            return read

        with monkeypatch.context() as m:
            for attr in ("cpu", "item", "tolist", "numpy", "__bool__",
                         "__int__", "__float__"):
                m.setattr(pserving.torch.Tensor, attr, refuse(attr))
            return dispatch()

    eng._round_dispatch = guarded
    done = eng.run()
    assert len(done) == 8 and not reads
    assert any(r.sampling is not None for r in overlap_requests(
        pserving, params[1]))


@pytest.mark.parametrize("cls", ["PagedServingEngine",
                                 "PagedSpeculativeServingEngine"])
def test_overlap_refused_on_paged(params, cls):
    kw = dict(max_slots=2, max_len=48, chunk=8, paged_blocks=12, block_size=8,
              overlap_rounds=True,
              speculative_k=3 if "Spec" in cls else 0)
    with pytest.raises(ValueError, match="overlap_rounds is dense/spec-grid "
                                         "only"):
        engine(pserving, params, kw, cls)


def test_pipelined_retire_discards_resubmitted_instance(params):
    """A round's retire keys on the admission generation, not on the
    Request object: the same instance finished and resubmitted onto its
    old slot between dispatch and retire gets none of the old round's
    tokens."""
    eng = engine(pserving, params, dict(max_slots=1, max_len=64, chunk=8))
    req = pserving.Request("z", make_prompt(5, 9), max_new=24)
    eng.submit(req)
    eng._admit_and_advance()
    handles = eng._round_dispatch()
    eng._finish(0)
    eng.submit(req)
    eng._admit_and_advance()
    assert eng.slot_req[0] is req
    before = list(eng.slot_emitted[0])
    eng._round_retire(handles)
    assert eng.slot_emitted[0] == before


def drain(eng, clock, rounds=200):
    done = []
    for _ in range(rounds):
        if not eng.outstanding():
            break
        eng.step_round()
        clock.advance()
        done.extend(eng.poll())
    return done


DEADLINE_ENGINES = {
    "dense": ("ServingEngine", dict(max_slots=2, max_len=64, chunk=8)),
    "spec": ("SpeculativeServingEngine",
             dict(max_slots=2, max_len=64, speculative_k=3)),
    "paged": ("PagedServingEngine",
              dict(max_slots=2, max_len=64, chunk=8, paged_blocks=20,
                   block_size=8)),
}


@pytest.mark.parametrize("name", sorted(DEADLINE_ENGINES))
def test_deadline_mid_stream_matches_jax(params, name):
    """A request whose budget runs out mid-decode completes as
    deadline_exceeded with a prefix of its uninterrupted stream; its
    slot takes the next request; every completion (tokens, reason,
    ttft, e2e) and the latency report equal the JAX engine's under the
    same clock."""
    cls, kw = DEADLINE_ENGINES[name]
    out = {}
    for mod in (pserving, jserving):
        clock = FakeClock()
        eng = engine(mod, params, kw, cls, clock)
        eng.submit(mod.Request("dead", make_prompt(70, 5), max_new=40, seed=0,
                               deadline_s=0.3))
        eng.submit(mod.Request("live", make_prompt(71, 5), max_new=8, seed=0))
        eng.submit(mod.Request("next", make_prompt(71, 5), max_new=4, seed=0))
        out[mod] = completions(drain(eng, clock)), eng.report()
    (got, rep), (want, jrep) = out[pserving], out[jserving]
    assert got == want
    assert rep["latency"] == jrep["latency"]
    dead = pserving.Completion(*got["dead"])
    assert dead.finish_reason == "deadline_exceeded" and dead.deadline_exceeded
    assert 0 < len(dead.tokens) < 40
    eng = engine(pserving, params, kw, cls)
    eng.submit(pserving.Request("dead", make_prompt(70, 5), max_new=40,
                                seed=0))
    (full,) = eng.run()
    assert full.tokens[:len(dead.tokens)] == dead.tokens
    if "paged" in rep:
        assert rep["paged"]["blocks_in_use"] == 0


def test_deadline_while_queued_and_mid_chunked_prefill_matches_jax(params):
    """Expired while its prompt streams in by chunked prefill (checked
    after a round, so beside a decoding co-tenant): no tokens, the
    slot's blocks freed. Expired in the queue: no prefill, no tokens.
    Every completion equals the JAX engine's under the same clock."""
    kw = dict(max_slots=2, max_len=64, chunk=8, paged_blocks=12,
              block_size=8, prefill_chunk=4)
    out = {}
    for mod in (pserving, jserving):
        clock = FakeClock()
        eng = engine(mod, params, kw, "PagedServingEngine", clock)
        eng.submit(mod.Request("head", make_prompt(74, 4), max_new=40,
                               seed=0))
        eng.submit(mod.Request("slow", make_prompt(72, 30), max_new=4,
                               seed=0, deadline_s=0.3))
        eng.submit(mod.Request("tail", make_prompt(73, 4), max_new=4,
                               seed=0, deadline_s=0.1))
        out[mod] = completions(drain(eng, clock)), eng.report()
    (got, rep), (want, _) = out[pserving], out[jserving]
    assert got == want
    for rid in ("slow", "tail"):
        c = pserving.Completion(*got[rid])
        assert c.finish_reason == "deadline_exceeded" and c.tokens == []
        assert c.ttft_s is None and c.e2e_s is not None
    assert pserving.Completion(*got["head"]).finish_reason == "length"
    assert rep["prefills"] >= 2 and rep["paged"]["blocks_in_use"] == 0


def test_latency_is_rounded_like_the_reference(params):
    """ttft_s and e2e_s to 6 places, the report's latency to 4, read off
    a clock with non-round times: equal to the JAX engine's."""
    kw = dict(max_slots=2, max_len=64, chunk=8)
    out = {}
    for mod in (pserving, jserving):
        clock = FakeClock()
        eng = engine(mod, params, kw, clock=clock)
        for i in range(3):
            eng.submit(mod.Request(f"t{i}", make_prompt(80 + i, 5),
                                   max_new=5 + 3 * i, seed=i))
            clock.advance(TICK / 7)
        out[mod] = completions(drain(eng, clock)), eng.report()["latency"]
    assert out[pserving] == out[jserving]
    comps, lat = out[pserving]
    times = [t for c in map(lambda c: pserving.Completion(*c),
                            comps.values()) for t in (c.ttft_s, c.e2e_s)]
    assert all(t == round(t, 6) for t in times)
    assert any(t != round(t, 5) for t in times)
    assert all(v == round(v, 4) for v in lat.values())


def test_max_queue_sheds_and_accepted_requests_complete(params):
    """Past max_queue, submit raises EngineSaturated, counts the shed
    and records it in the recovery log; everything accepted completes
    with the JAX engine's streams; report()'s chaos block is the
    reference's."""
    kw = dict(max_slots=2, max_len=64, chunk=8, max_queue=2)
    out = {}
    for mod, log, saturated in ((pserving, pmetrics, pserving.EngineSaturated),
                                (jserving, jmetrics, jserving.EngineSaturated)):
        before = log.recovery_log().counts()
        eng = engine(mod, params, kw)
        accepted = []
        for i in range(4):
            req = mod.Request(f"q{i}", make_prompt(90 + i, 5), max_new=5,
                              seed=i)
            try:
                eng.submit(req)
                accepted.append(req.request_id)
            except saturated:
                pass
            if i == 2:
                eng.step_round()  # admits q0, q1: the queue has room
        shed_rep = eng.report()["chaos"]
        done = {c.request_id: c.tokens for c in eng.run()}
        out[mod] = (accepted, done, shed_rep,
                    log.recovery_log().snapshot_since(before))
    assert out[pserving] == out[jserving]
    accepted, done, chaos, events = out[pserving]
    assert accepted == ["q0", "q1", "q3"] and sorted(done) == accepted
    assert chaos == {"slot_failures": 0, "requeues": 0, "shed": 1,
                     "quarantined": []}
    assert events == {"request_shed": 1}


SLOT_FAILURE_ENGINES = {
    "dense": ("ServingEngine", dict(max_slots=2, max_len=64, chunk=8)),
    "paged kernel tier": ("PagedServingEngine",
                          dict(max_slots=2, max_len=64, chunk=8,
                               paged_blocks=24, block_size=8,
                               paged_kernel=True)),
}


@pytest.mark.parametrize("name", sorted(SLOT_FAILURE_ENGINES))
def test_slot_failure_replays_exactly_like_jax(params, name):
    """A busy slot fails mid-stream: its request is requeued at the front
    and replays its exact stream (sampled too), its blocks come back,
    the slot takes nothing while quarantined and serves again once
    restored; the recovery log, report()'s chaos block and every
    stream equal the JAX engine's."""
    cls, kw = SLOT_FAILURE_ENGINES[name]
    reqs = [(make_prompt(11 + i, 5 + 3 * i), i) for i in range(3)]

    def run(mod, log, inject):
        before = log.recovery_log().counts()
        eng = engine(mod, params, kw, cls)
        for i, (p, seed) in enumerate(reqs):
            samp = None if i != 1 else (
                pdecode.SamplingConfig(temperature=1.1) if mod is pserving
                else mod.SamplingConfig(temperature=1.1))
            eng.submit(mod.Request(f"p{i}", p, max_new=20, seed=50 + seed,
                                   sampling=samp))
        seen = {}
        if inject:
            eng.step_round()
            in_use = eng.report().get("paged", {}).get("blocks_in_use")
            assert eng.inject_slot_failure(0)
            seen["after"] = eng.report().get("paged", {}).get("blocks_in_use")
            assert in_use is None or seen["after"] < in_use
            eng.step_round()
            seen["quarantined_idle"] = eng.slot_req[0] is None
            seen["chaos"] = eng.report()["chaos"]
            eng.restore_slot(0)
        done = eng.poll() + eng.run()
        seen["events"] = log.recovery_log().snapshot_since(before)
        seen["in_use"] = eng.report().get("paged", {}).get("blocks_in_use")
        return {c.request_id: c.tokens for c in done}, seen

    clean, _ = run(pserving, pmetrics, False)
    faulted, seen = run(pserving, pmetrics, True)
    assert faulted == clean
    assert seen["quarantined_idle"]
    assert seen["chaos"] == {"slot_failures": 1, "requeues": 1, "shed": 0,
                             "quarantined": [0]}
    assert seen["events"] == {"slot_failure": 1, "slot_requeue": 1}
    assert seen["in_use"] in (None, 0)
    jclean, _ = run(jserving, jmetrics, False)
    jfaulted, jseen = run(jserving, jmetrics, True)
    greedy = [r for r in clean if r != "p1"]
    assert ({r: faulted[r] for r in greedy}
            == {r: jfaulted[r] for r in greedy}
            == {r: jclean[r] for r in greedy})
    assert seen == jseen


def test_every_slot_quarantined_raises_and_idle_failure_displaces_nothing(
        params):
    for mod in (pserving, jserving):
        eng = engine(mod, params, dict(max_slots=2, max_len=64, chunk=8))
        assert not eng.inject_slot_failure(1)   # idle: nothing requeued
        assert eng.inject_slot_failure(0, quarantine=True) is False
        eng.submit(mod.Request("w", make_prompt(3, 5), max_new=4))
        with pytest.raises(RuntimeError, match="all 2 slots are quarantined"):
            eng.run()
        with pytest.raises(ValueError, match="out of range"):
            eng.inject_slot_failure(2)
        eng.restore_slot(1)
        (done,) = eng.run()
        assert len(done.tokens) == 4
        assert eng.report()["chaos"] == {"slot_failures": 2, "requeues": 0,
                                         "shed": 0, "quarantined": [0]}


def test_outstanding_and_reset_latency(params):
    for mod in (pserving, jserving):
        eng = engine(mod, params, dict(max_slots=2, max_len=64, chunk=8))
        assert eng.outstanding() == 0
        for i in range(4):
            eng.submit(mod.Request(f"o{i}", make_prompt(60 + i, 4),
                                   max_new=10, seed=i))
        assert eng.outstanding() == 4
        eng.step_round()                 # two in slots, two queued
        assert eng.outstanding() == 4
        assert len(eng.run()) == 4 and eng.outstanding() == 0
        assert eng.report()["latency"]["completed"] == 4
        eng.reset_latency()
        assert "latency" not in eng.report()


def test_engines_report_and_serving_report_match_the_reference():
    """The reference's result keys and configurations (its own test's
    engine list), and ``ok``; serving_report's whole result is the
    reference's."""
    rep = pserving.engines_report(device="cpu")
    assert rep == {"engines": ["grid", "grid_chunked_prefill", "paged",
                               "paged_spec", "paged_spec_chunked", "spec"],
                   "requests": 3, "all_streams_identical": True, "ok": True}
    rep, jrep = (pserving.serving_report(device="cpu"),
                 jserving.serving_report())
    assert rep == jrep and rep["ok"]
