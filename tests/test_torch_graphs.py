"""PyTorch port: the protocol that lets a serving round run as a CUDA
graph (``kind_tpu_sim_torch/models/graphs.py``), pinned on the CPU.

On a card every engine replays one CUDA graph a round key; on the CPU
it runs the same round functions eagerly, through the same buffers. So
the CPU can show what capture needs, for the six round functions (the
dense chunk, the paged gather and kernel tiers, the prompt-lookup and
draft-model grids, the paged verify scan) on the tiny config:

* two rounds with one key run the same aten operations on the same
  shapes, dtypes and non-tensor arguments, however their host state
  (lengths, active slots, block tables, seeds, temperatures) differs,
  and no round copies from the host;
* the key changes with the table width, ``sampled`` and ``k``, and not
  with contents;
* the engine's state stays at fixed addresses across rounds,
  admissions and a slot failure;
* outputs a later round rewrites in place (a graph's) give the eager
  streams, which equal the JAX engine's;
* the bench's compiled decode loop (``DecodeProgram``) gives the eager
  loop's tokens, and its chunks of one size run the same operations
  whatever their first position.

What only a card can show (capture, replay, launch counts at replay)
is held by ``chip_smoke.py``'s compiled-rounds phase.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch import device as pdevice
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import graphs
from kind_tpu_sim_torch.models import quant as pquant
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.ops import flash_attention as pfa
from kind_tpu_sim_torch.ops import int8_matmul as pim
from kind_tpu_sim_torch.ops import paged_attention as ppa

from torch_parity import TINY, jax_cfg, make_params

CFG = TINY
GRID = dict(max_slots=2, max_len=64)
PAGED = dict(paged_blocks=16, block_size=4)
SPEC = dict(speculative_k=3, spec_windows=2)
# name -> (engine, ServingConfig fields, with a draft model)
CASES = {
    "dense": ("ServingEngine", dict(GRID, chunk=4), False),
    "paged gather": ("PagedServingEngine", dict(GRID, chunk=4, **PAGED),
                     False),
    "paged kernel": ("PagedServingEngine",
                     dict(GRID, chunk=4, paged_kernel=True, **PAGED), False),
    "prompt lookup": ("SpeculativeServingEngine", dict(GRID, **SPEC), False),
    "draft model": ("SpeculativeServingEngine", dict(GRID, **SPEC), True),
    "paged verify": ("PagedSpeculativeServingEngine",
                     dict(GRID, **SPEC, **PAGED), False),
}
# (prompt length, max_new) of the greedy wave; (prompt length, max_new,
# temperature, seed) of the sampled one
GREEDY = ((5, 10), (9, 12), (7, 9))
SAMPLED = ((6, 10, 0.7, 5), (8, 10, 1.3, 9), (11, 10, 0.9, 2))


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


@pytest.fixture(scope="module")
def draft():
    dcfg = ptf.ModelConfig(vocab_size=CFG.vocab_size, d_model=16, n_heads=2,
                           n_layers=1, d_ff=32, max_seq=64, dtype="float32")
    return dcfg, make_params(dcfg, seed=11, block_scale=4.0)[1]


def waves(mod=pserving):
    """The greedy wave and the sampled wave, as ``mod``'s Requests."""
    rng = np.random.RandomState(3)
    greedy = [mod.Request(f"g{i}", rng.randint(0, CFG.vocab_size,
                                               size=n).tolist(), new)
              for i, (n, new) in enumerate(GREEDY)]
    sampled = [mod.Request(f"s{i}", rng.randint(0, CFG.vocab_size,
                                                size=n).tolist(), new,
                           sampling=mod.SamplingConfig(temperature=t),
                           seed=seed)
               for i, (n, new, t, seed) in enumerate(SAMPLED)]
    return greedy, sampled


def make_engine(params, draft, name, **extra):
    cls, kw, with_draft = CASES[name]
    more = dict(draft=(draft[1], draft[0])) if with_draft else {}
    return getattr(pserving, cls)(params[1], CFG,
                                  pserving.ServingConfig(**dict(kw, **extra)),
                                  device="cpu", **more)


def serve(eng, *stream):
    """Each wave submitted, then drained; {request_id: tokens}."""
    out = {}
    for wave in stream:
        for r in wave:
            eng.submit(dataclasses.replace(r))
        out.update({c.request_id: c.tokens for c in eng.run()})
    return out


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    return x


class OpLog(TorchDispatchMode):
    """Every aten operation run inside, with its arguments' shapes,
    dtypes and non-tensor values."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _sig(args), _sig(kwargs)))
        return func(*args, **kwargs)


def _refuse(*args, **kwargs):
    raise AssertionError("to_device inside a round function")


def _host_state(eng):
    """What the round about to run reads of the host's state."""
    spec = hasattr(eng, "total")
    return {"lengths": (eng.total if spec else eng._in.lengths).tolist(),
            "active": eng._in.active.tolist(),
            "tables": {w: t.tolist() for w, t in eng._in._tables.items()},
            "temp": eng._in._sampling[0].tolist(),
            "seeds": eng._in._sampling[5].tolist()}


class Recorder:
    """An engine's ``_round`` that runs the round eagerly under
    ``OpLog`` with ``to_device`` refused, recording (key, host state,
    operations) a round."""

    def __init__(self, eng, monkeypatch):
        self.eng, self.mp, self.rounds = eng, monkeypatch, []

    def __call__(self, key, fn):
        state = _host_state(self.eng)
        with self.mp.context() as m:
            for mod in (pdevice, pdecode, pserving):
                m.setattr(mod, "to_device", _refuse)
            with OpLog() as log:
                out = fn()
        self.rounds.append((key, state, log.ops))
        return out


def _split_walk(qg, k_pool, v_pool, tables, lengths):
    """The paged kernel's stand-in for this test: the split kernel's
    plain version, whose walk is the table's width. The one-pass plain
    version walks as far as the longest slot, read from the lengths: a
    CPU-only step, the card's kernels plan from shapes alone."""
    bps = ppa.blocks_per_split(tables.shape[1], k_pool.shape[1])
    return ppa.paged_attention_split_ref(qg, k_pool, v_pool, tables,
                                         lengths, bps)


@pytest.mark.parametrize("name", list(CASES))
def test_rounds_of_one_key_run_the_same_operations(params, draft, name,
                                                   monkeypatch):
    """The capture-safety proxy: every round of a key runs the same
    aten operations on the same shapes, dtypes and non-tensor arguments
    as the first, while the host state it reads differs (lengths or
    totals, active slots, tables, and on the sampled key the seeds and
    temperatures), and no round calls ``to_device``."""
    monkeypatch.setattr(ppa, "paged_attention_ref", _split_walk)
    eng = make_engine(params, draft, name)
    rec = eng._round = Recorder(eng, monkeypatch)
    serve(eng, *waves())
    by_key = collections.defaultdict(list)
    for key, state, ops in rec.rounds:
        by_key[key].append((state, ops))
    sampled_keys = [k for k in by_key if k[-1]]
    assert sampled_keys and any(not k[-1] for k in by_key)
    assert len({str(s["active"]) for k in by_key for s, _ in by_key[k]}) > 1
    for key, rounds in by_key.items():
        first_state, first_ops = rounds[0]
        assert first_ops and all(ops == first_ops for _, ops in rounds), key
        if len(rounds) > 1:
            assert any(s["lengths"] != first_state["lengths"]
                       for s, _ in rounds), key
    repeated = [k for k, rounds in by_key.items() if len(rounds) > 1]
    assert any(not k[-1] for k in repeated) and any(k[-1] for k in repeated)

    def differ(keys, field):
        return any(len({str(field(s, k)) for s, _ in by_key[k]}) > 1
                   for k in keys)

    assert differ([k for k in repeated if k[-1]],
                  lambda s, k: (s["temp"], s["seeds"]))
    if "paged" in name:
        # the key's width is its second-to-last value
        assert differ(repeated, lambda s, k: s["tables"][k[-2]])


def _keys(eng):
    keys = []

    def record(key, fn):
        keys.append(key)
        return fn()

    eng._round = record
    return keys


def test_key_changes_with_width_sampled_and_k_not_contents(params, draft):
    """A dynamic-width paged engine gets one key a table width and
    ``sampled`` value, whatever its tables hold; a speculative engine
    one a ``sampled`` value; another draft width another key."""
    greedy, sampled = waves()
    eng = make_engine(params, draft, "paged kernel")
    keys = _keys(eng)
    widths = []
    build = eng._build_tables

    def tables():
        host = build()
        widths.append(host.shape[1])
        return host

    eng._build_tables = tables
    serve(eng, greedy, sampled)
    assert len(keys) == len(widths) > len(set(keys))
    assert [k[2] for k in keys] == widths and len(set(widths)) > 1
    assert {k[3] for k in keys} == {False, True}
    assert len(set(keys)) == len({(k[2], k[3]) for k in keys})

    spec_keys = {}
    for k in (2, 3):
        eng = make_engine(params, draft, "prompt lookup", speculative_k=k)
        got = _keys(eng)
        serve(eng, greedy, sampled)
        spec_keys[k] = set(got)
        assert spec_keys[k] == {("verify", k, 2, False),
                                ("verify", k, 2, True)}
    assert not spec_keys[2] & spec_keys[3]


def test_the_device_alone_picks_graphs_or_eager(params, draft):
    """CPU engines run the eager function; a card's runner is a
    ``RoundGraphs`` (made without touching a card: its stream and pool
    come at the first capture)."""
    for name in CASES:
        assert make_engine(params, draft, name)._round is graphs.eager
    assert graphs.round_runner(torch.device("cpu")) is graphs.eager
    runner = graphs.round_runner(torch.device("cuda"))
    assert isinstance(runner, graphs.RoundGraphs)
    assert (runner.captured, runner.replays, runner.capture_s) == (0, 0, 0.0)


def _addresses(eng):
    names = ["last_token", "presence", "out", "total"]
    ptrs = {n: getattr(eng, n).data_ptr() for n in names if hasattr(eng, n)}
    ptrs["lengths"] = eng._in.lengths.data_ptr()
    ptrs["active"] = eng._in.active.data_ptr()
    ptrs["sampling"] = [t.data_ptr() for t in eng._in._sampling]
    return ptrs


@pytest.mark.parametrize("name", ["dense", "paged kernel", "prompt lookup",
                                  "paged verify"])
def test_state_stays_at_fixed_addresses(params, draft, name):
    """``last_token``, ``presence``, ``out`` and ``total`` (and the
    round's input buffers) keep their storage across rounds,
    admissions, a slot failure and its restore."""
    eng = make_engine(params, draft, name)
    before = _addresses(eng)
    greedy, sampled = waves()
    for r in greedy + sampled[:1]:
        eng.submit(dataclasses.replace(r))
    eng.step_round()
    eng.step_round()
    assert _addresses(eng) == before
    assert eng.inject_slot_failure(0)
    eng.step_round()
    eng.restore_slot(0)
    for r in sampled[1:]:
        eng.submit(dataclasses.replace(r))
    done = eng.run()
    assert len(done) == len(greedy) + len(sampled)
    assert _addresses(eng) == before


class StaticOutputs:
    """A CPU stand-in for a card's graphs: each key's outputs live in
    tensors of their own that every later round of the key rewrites in
    place, as a replay rewrites a graph's outputs."""

    def __init__(self):
        self.outputs = {}

    def __call__(self, key, fn):
        got = fn()
        static = self.outputs.setdefault(key, tuple(t.clone() for t in got))
        for s, g in zip(static, got):
            s.copy_(g)
        return static


@pytest.fixture(scope="module")
def jax_greedy(params):
    """The JAX dense engine's streams of the greedy wave."""
    eng = jserving.ServingEngine(params[0], jax_cfg(CFG),
                                 jserving.ServingConfig(**CASES["dense"][1]))
    return serve(eng, waves(jserving)[0])


@pytest.mark.parametrize("name", list(CASES))
def test_rewritten_outputs_serve_the_eager_streams(params, draft, name,
                                                   jax_greedy):
    """Through outputs that the next round rewrites in place, an engine
    serves the streams it serves eagerly (sequential and, where the
    engine allows it, overlapped), and its greedy streams are the JAX
    dense engine's."""
    stream = waves()
    want = serve(make_engine(params, draft, name), *stream)
    overlap = [False] + ([True] if "paged" not in name else [])
    for over in overlap:
        eng = make_engine(params, draft, name, overlap_rounds=over)
        eng._round = StaticOutputs()
        assert serve(eng, *stream) == want
    assert {r: t for r, t in want.items() if r in jax_greedy} == jax_greedy


def test_capture_takes_back_its_launch_counts_and_replays_add_them():
    """The runner's bookkeeping of the wrappers' launch counts: what a
    capture counted is taken off, and each replay adds it again; counts
    of wrappers the round did not launch stay as they were."""
    wrappers = (pfa.flash_attention, ppa.paged_attention, pim.int8_matmul)
    saved = [(w.launches, dict(w.launches_by_route)) for w in wrappers]
    try:
        before = graphs.launch_counts()
        ppa.paged_attention.launches += 3
        ppa.paged_attention.launches_by_route["split_kv"] += 3
        pim.int8_matmul.launches += 5
        pim.int8_matmul.launches_by_route["gemv"] += 4
        pim.int8_matmul.launches_by_route["wgmma"] += 1
        delta = graphs.take_launches(before)
        assert graphs.launch_counts() == before
        assert [w for w, _, _ in delta] == [ppa.paged_attention,
                                            pim.int8_matmul]
        graphs.add_launches(delta)
        graphs.add_launches(delta)
        after = dict(zip(graphs._wrappers(), graphs.launch_counts()))
        b = dict(zip(graphs._wrappers(), before))
        pa_n, pa_routes = after[ppa.paged_attention]
        assert pa_n == b[ppa.paged_attention][0] + 6
        assert pa_routes["split_kv"] == (
            b[ppa.paged_attention][1]["split_kv"] + 6)
        im_n, im_routes = after[pim.int8_matmul]
        assert im_n == b[pim.int8_matmul][0] + 10
        assert (im_routes["gemv"], im_routes["wgmma"]) == (
            b[pim.int8_matmul][1]["gemv"] + 8,
            b[pim.int8_matmul][1]["wgmma"] + 2)
        assert after[pfa.flash_attention] == b[pfa.flash_attention]
    finally:
        for w, (n, routes) in zip(wrappers, saved):
            w.launches, w.launches_by_route = n, routes


@pytest.mark.parametrize("tier", ["bf16 path", "w8a8 int8 kv"])
def test_decode_program_is_the_eager_loop_as_rounds(params, tier,
                                                    monkeypatch):
    """``DecodeProgram`` (the bench's decode as a graph a chunk size)
    emits ``generate_from_cache``'s tokens, call after call on its one
    cache; the chunks of one size run the same aten operations on the
    same shapes whatever their first position (which enters through a
    buffer), with ``to_device`` refused."""
    cfg, p = CFG, params[1]
    if tier != "bf16 path":
        cfg = dataclasses.replace(CFG, int8_kv=True, int8_native=True)
        p = pquant.quantize_params(p, cfg)
    rng = np.random.RandomState(4)
    prompt = torch.as_tensor(rng.randint(0, CFG.vocab_size, size=(2, 9)))
    n_new = 2 * graphs.DecodeProgram.CHUNK + 6  # chunks 64, 64 and 5
    with torch.no_grad():
        logits, cache = pdecode.prefill(p, cfg, prompt, 9 + n_new)
        first = torch.argmax(logits, -1)
        want = pdecode.generate_from_cache(p, cfg, first, cache, 9, n_new)
        _, cache = pdecode.prefill(p, cfg, prompt, 9 + n_new)
        prog = graphs.DecodeProgram(p, cfg, cache)
        rounds = []

        def record(key, fn):
            with monkeypatch.context() as m:
                for mod in (pdevice, pdecode):
                    m.setattr(mod, "to_device", _refuse)
                with OpLog() as log:
                    out = fn()
            rounds.append((key, log.ops))
            return out

        prog._round = record
        got = prog(first, 9, n_new)
        again = prog(first, 9, n_new)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert [k for k, _ in rounds[:3]] == [("solo chunk", 64)] * 2 + [
        ("solo chunk", 5)]
    assert rounds[0][1] == rounds[1][1] == rounds[3][1]


def test_store_takes_a_device_start_as_an_int_start():
    """``decode._store`` with a (1,) tensor start writes the rows an int
    start writes, clamped the same way at the cache's end."""
    rng = np.random.RandomState(5)
    for start in (0, 3, 7, 12):
        upd = torch.as_tensor(rng.randn(2, 4, 1, 3), dtype=torch.float32)
        a = torch.zeros(2, 10, 1, 3)
        b = torch.zeros(2, 10, 1, 3)
        pdecode._store(a, upd, start)
        pdecode._store(b, upd, torch.tensor([start]))
        assert torch.equal(a, b), start
