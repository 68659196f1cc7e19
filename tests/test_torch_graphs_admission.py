"""PyTorch port: admission and the solo speculative generators as
compiled programs (``kind_tpu_sim_torch/models/graphs.py``), pinned on
the CPU.

On a card an engine runs each admission program (a wave's stacked
prefill with its first-token sample, a window against a prefix, the
dense prefix store and restore, a draft model's prompt prefill) as a
CUDA graph a key, and the solo generators their prefill and verify
step; on the CPU the same buffer-driven functions run eagerly. So the
CPU can show what capture needs, on the tiny config:

* two calls of one key run the same aten operations on the same shapes,
  dtypes and non-tensor arguments, whatever the host values they read
  (slots, bases, true lengths, tables, seeds, arena rows), and no call
  copies from the host;
* the key changes with the wave size, the bucket, the table width,
  ``sampled`` and k, and not with contents;
* outputs that a later call of the key rewrites (a graph's) serve the
  eager streams, a wave of two sub-waves of one key included;
* the buffer-driven functions equal the JAX package's
  (``_prefill_many_into_slots``, ``_paged_prefill_many``,
  ``_suffix_into_slot``, ``paged_suffix``, ``_read_slot_rows`` /
  ``_write_slot_rows``) at the tolerances of ``test_torch_prefix.py``.

Capture, replay and the launch counts at replay are held on the card by
``chip_smoke.py``.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from kind_tpu_sim.models import serving as jserving
from kind_tpu_sim_torch import device as pdevice
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import graphs
from kind_tpu_sim_torch.models import paged as ppaged
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import speculative as pspec
from kind_tpu_sim_torch.models import transformer as ptf

from torch_parity import TINY, jax_cfg, make_params
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = TINY
PLAIN = dataclasses.replace(TINY, flash=False)
LOGIT_TOL, KV_TOL = 1e-4, 1e-5
GRID = dict(max_slots=4, max_len=64, chunk=4)
PAGED = dict(paged_blocks=40, block_size=4)
# name -> (engine class, ServingConfig fields, with a draft model)
CASES = {
    "dense waves": ("ServingEngine", dict(GRID, prefix_cache_entries=3),
                    False),
    "dense chunked": ("ServingEngine", dict(GRID, prefill_chunk=4,
                                            prefix_cache_entries=3), False),
    "paged waves": ("PagedServingEngine", dict(GRID, paged_width=16,
                                               prefix_cache_entries=3,
                                               **PAGED), False),
    "paged chunked": ("PagedServingEngine", dict(GRID, prefill_chunk=4,
                                                 prefix_cache_entries=3,
                                                 **PAGED), False),
    "draft model": ("SpeculativeServingEngine",
                    dict(GRID, speculative_k=2, spec_windows=2), True),
}


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, embed_scale=0.5, block_scale=6.0)


@pytest.fixture(scope="module")
def draft():
    dcfg = ptf.ModelConfig(vocab_size=CFG.vocab_size, d_model=16, n_heads=2,
                           n_layers=1, d_ff=32, max_seq=64, dtype="float32")
    return dcfg, make_params(dcfg, seed=11, block_scale=4.0)[1]


def prompt(seed, n):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               size=n).tolist()


def stream(mod=pserving, seed=0):
    """Four waves: cache_prefix heads and a greedy wave in two buckets,
    a sampled wave of the same buckets, prompts that extend the heads
    (prefix hits, windows against them), then the first wave's and the
    third's shapes again with other contents."""
    head = [prompt(seed + i, 9 + 2 * i) for i in range(2)]
    waves = [
        [mod.Request("h0", head[0], 5, cache_prefix=True),
         mod.Request("h1", head[1], 5, cache_prefix=True),
         mod.Request("g0", prompt(seed + 5, 10), 6),
         mod.Request("g1", prompt(seed + 6, 5), 6)],
        [mod.Request(f"s{i}", prompt(seed + 10 + i, 6 + 5 * i), 6,
                     sampling=mod.SamplingConfig(temperature=0.8 + 0.3 * i),
                     seed=seed + 3 + i) for i in range(3)],
        [mod.Request("x0", head[0] + prompt(seed + 20, 3), 5),
         mod.Request("x1", head[1] + prompt(seed + 21, 6), 5,
                     sampling=mod.SamplingConfig(temperature=1.1),
                     seed=seed + 9, logprobs=True)],
        [mod.Request("g2", prompt(seed + 7, 12), 4),
         mod.Request("g3", prompt(seed + 8, 14), 4),
         mod.Request("x2", head[0] + prompt(seed + 22, 4), 4)],
    ]
    return waves


def make_engine(params, draft, name, **extra):
    cls, kw, with_draft = CASES[name]
    more = dict(draft=(draft[1], draft[0])) if with_draft else {}
    return getattr(pserving, cls)(params[1], CFG,
                                  pserving.ServingConfig(**dict(kw, **extra)),
                                  device="cpu", **more)


def serve(eng, waves):
    out = {}
    for wave in waves:
        for r in wave:
            eng.submit(dataclasses.replace(r))
        out.update({c.request_id: (c.tokens, c.logprobs) for c in eng.run()})
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


def _refuse_host(real):
    """``real`` (torch.as_tensor, torch.tensor, torch.from_numpy) that
    refuses host data: a compiled program may take only device
    tensors."""
    def guarded(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise AssertionError("a host copy inside a compiled program")
        return real(data, *args, **kwargs)

    return guarded


def _to_device(*args, **kwargs):
    raise AssertionError("to_device inside a compiled program")


class Recorder:
    """A runner that runs each call eagerly under ``OpLog`` with every
    host copy refused, recording (key, the host values in the engine's
    admission buffers, operations)."""

    def __init__(self, monkeypatch, buffers=None):
        self.mp, self.buffers, self.calls = monkeypatch, buffers, []

    def __call__(self, key, fn):
        state = {} if self.buffers is None else {
            k: b.tolist() for k, b in self.buffers._bufs.items()}
        with self.mp.context() as m:
            for mod in (pdevice, pdecode, pserving):
                m.setattr(mod, "to_device", _to_device)
            for name in ("as_tensor", "tensor", "from_numpy"):
                m.setattr(torch, name, _refuse_host(getattr(torch, name)))
            with OpLog() as log:
                out = fn()
        self.calls.append((key, state, log.ops))
        return out


@pytest.fixture(scope="module", autouse=True)
def warm(params):
    """Fill the port's per-process constant caches (rotary frequencies,
    0-d constants) before any call is recorded."""
    eng = pserving.ServingEngine(params[1], CFG, pserving.ServingConfig(
        **GRID), device="cpu")
    eng.submit(pserving.Request("w", [1, 2, 3], 2))
    eng.run()


@pytest.mark.parametrize("name", list(CASES))
def test_calls_of_one_key_run_the_same_operations(params, draft, name,
                                                  monkeypatch):
    """Every admission program of a key runs the operations its first
    call ran, while the host values it reads differ, and none copies
    from the host."""
    eng = make_engine(params, draft, name)
    rec = eng._admit_round = Recorder(monkeypatch, eng._adm)
    serve(eng, stream())
    by_key = collections.defaultdict(list)
    for key, state, ops in rec.calls:
        by_key[key].append((state, ops))
    families = {k[0] for k in by_key}
    want = {"dense waves": {"prefill", "suffix", "prefix store",
                            "prefix restore"},
            "dense chunked": {"prefill", "suffix", "prefix store",
                              "prefix restore"},
            "paged waves": {"paged prefill", "paged suffix"},
            "paged chunked": {"paged prefill", "paged suffix"},
            "draft model": {"prefill", "draft prefill"}}[name]
    assert want <= families, families
    repeated = [k for k, calls in by_key.items() if len(calls) > 1]
    assert repeated
    for key, calls in by_key.items():
        first_state, first_ops = calls[0]
        assert first_ops and all(ops == first_ops for _, ops in calls), key
        if len(calls) > 1:
            assert any(s != first_state for s, _ in calls[1:]), key
    if name.endswith("waves"):
        assert any(k[1] > 1 for k in by_key if "prefill" in k[0])
        assert any(k[-1] for k in by_key) and any(not k[-1] for k in by_key
                                                  if "prefill" in k[0])


def _keys(eng):
    keys = []

    def record(key, fn):
        keys.append(key)
        return fn()

    eng._admit_round = record
    return keys


def test_key_changes_with_shape_and_sampled_not_contents(params, draft):
    """Streams of other contents (prompts, seeds, slots) make the same
    keys; the wave size, the bucket, the table width and ``sampled``
    each make others."""
    got = {}
    for seed in (0, 100):
        eng = make_engine(params, draft, "paged waves")
        keys = _keys(eng)
        serve(eng, stream(seed=seed))
        got[seed] = keys
    assert got[0] == got[100]
    keys = got[0]
    waves = [k for k in keys if k[0] == "paged prefill"]
    # (K, bucket, width, sampled)
    assert {k[1] for k in waves} >= {1, 2} and len({k[2] for k in waves}) > 1
    assert {k[4] for k in waves} == {False, True}
    assert {k[3] for k in waves} == {16}
    eng = make_engine(params, draft, "paged waves", paged_width=12)
    wide = _keys(eng)
    serve(eng, stream())
    assert {k[3] for k in wide if k[0] == "paged prefill"} == {12}
    # a window's key: (bucket, width, sampled) paged, (bucket, sampled)
    # dense, whatever its base and true length
    eng = make_engine(params, draft, "dense chunked")
    dense = _keys(eng)
    serve(eng, stream())
    assert {k for k in dense if k[0] == "suffix"} <= {
        ("suffix", 8, False), ("suffix", 8, True)}
    assert {k[:2] for k in dense if k[0] == "prefill"} == {("prefill", 1)}


class StaticOutputs:
    """A CPU stand-in for a card's graphs: each key's outputs live in
    tensors of their own that every later call of the key rewrites in
    place, as a replay rewrites a graph's outputs."""

    def __init__(self):
        self.outputs = {}

    def __call__(self, key, fn):
        got = fn()
        static = self.outputs.setdefault(key, tuple(t.clone() for t in got))
        for s, g in zip(static, got):
            s.copy_(g)
        return static


@pytest.mark.parametrize("name", list(CASES))
def test_rewritten_outputs_serve_the_eager_streams(params, draft, name):
    """Through outputs the next call of the key rewrites, the engine
    serves the streams (and first-token logprobs) it serves eagerly;
    four prompts of one bucket under wave sizes (1, 2) make two
    sub-waves of one key in one wave."""
    extra = {"admission_wave_sizes": (1, 2)} if name.endswith("waves") \
        else {}
    waves = stream() + [[pserving.Request(f"w{i}", prompt(40 + i, 12), 4)
                         for i in range(4)]]
    want = serve(make_engine(params, draft, name, **extra), waves)
    eng = make_engine(params, draft, name, **extra)
    eng._admit_round = StaticOutputs()
    assert serve(eng, waves) == want
    if extra:
        assert eng.wave_sizes[2] >= 2


def test_the_device_alone_picks_graphs_or_eager(params, draft):
    for name in CASES:
        assert make_engine(params, draft, name)._admit_round is graphs.eager
    assert isinstance(graphs.round_runner(torch.device("cuda")),
                      graphs.RoundGraphs)


# ---------------------------------------------------------------------
# the buffer-driven functions against the JAX package's


def _buf(values, dtype=torch.long):
    return torch.as_tensor(np.asarray(values), dtype=dtype)


def test_wave_prefill_matches_jax(params):
    """Three prompts of one bucket into rows 3, 0 and 2, their slots and
    true lengths read from tensors."""
    jparams, pparams = params
    lens = [11, 16, 9]
    toks = np.stack([pserving._padded_window(prompt(i, n))[0]
                     for i, n in enumerate(lens)])
    jcache = jserving.init_cache(jax_cfg(PLAIN), 4, 32)
    jcache, jl = jserving._prefill_many_into_slots(
        jparams, jcache, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lens, jnp.int32), jnp.asarray([3, 0, 2], jnp.int32),
        cfg=jax_cfg(PLAIN))
    pcache = pserving.init_cache(PLAIN, 4, 32, device="cpu")
    pl = pserving._prefill_many_into_slots(
        pparams, pcache, torch.as_tensor(toks), _buf(lens), _buf([3, 0, 2]),
        cfg=PLAIN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for jlc, plc in zip(jcache, pcache):
        for n in ("k", "v"):
            np.testing.assert_allclose(plc[n].numpy(), np.asarray(jlc[n]),
                                       atol=KV_TOL, rtol=1e-4)


def test_paged_wave_prefill_matches_jax(params):
    """Two prompts through fixed-width table rows (read from a tensor):
    the reference's scan of paged prefills."""
    jparams, pparams = params
    lens = [13, 10]
    toks = np.stack([pserving._padded_window(prompt(5 + i, n))[0]
                     for i, n in enumerate(lens)])
    tables = np.asarray([[4, 2, 6, 5], [1, 7, 3, 0]], np.int32)
    from kind_tpu_sim.models import paged as jpaged

    jpools = jpaged.init_pools(jax_cfg(PLAIN), 8, 4)
    jpools, jl = jserving._paged_prefill_many(
        jparams, jpools, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lens, jnp.int32), jnp.asarray(tables),
        cfg=jax_cfg(PLAIN))
    ppools = ppaged.init_pools(PLAIN, 8, 4, device="cpu")
    pl = ppaged.paged_prefill_many(pparams, ppools, torch.as_tensor(toks),
                                   _buf(lens), _buf(tables, torch.int32),
                                   cfg=PLAIN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for jlc, plc in zip(jpools, ppools):
        for n in ("k", "v"):
            np.testing.assert_allclose(plc[n][1:].numpy(),
                                       np.asarray(jlc[n])[1:], atol=KV_TOL,
                                       rtol=1e-4)


@pytest.mark.parametrize("base,true_len", [(10, 6), (8, 3), (24, 5)],
                         ids=["hit", "chunk window", "past max_len"])
def test_suffix_from_buffers_matches_jax(params, base, true_len):
    """A window against a slot's prefix with slot, base and true length
    read from (1,) tensors; the last case runs past the row's end (max
    len 30): the port writes only the rows that fit, so the JAX side
    gets the unpadded window (its write clamps a window's start)."""
    jparams, pparams = params
    full = prompt(1, base + true_len)
    max_len = 30
    pre = pserving._padded_window(full[:base])
    jcache = jserving.init_cache(jax_cfg(PLAIN), 2, max_len)
    jcache, _ = jserving._prefill_into_slot(
        jparams, jcache, jnp.asarray(pre, jnp.int32), jnp.int32(base), 1,
        cfg=jax_cfg(PLAIN))
    pcache = pserving.init_cache(PLAIN, 2, max_len, device="cpu")
    pserving._prefill_into_slot(pparams, pcache, torch.as_tensor(pre), base,
                                1, cfg=PLAIN)
    suf = pserving._padded_window(full[base:])
    jsuf = suf if base + suf.shape[1] <= max_len else suf[:, :true_len]
    jcache, jl = jserving._suffix_into_slot(
        jparams, jcache, jnp.asarray(jsuf, jnp.int32), jnp.int32(true_len),
        jnp.int32(base), 1, cfg=jax_cfg(PLAIN))
    pl = pserving._suffix_into_slot(pparams, pcache, torch.as_tensor(suf),
                                    _buf([true_len]), _buf([base]),
                                    _buf([1]), cfg=PLAIN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for jlc, plc in zip(jcache, pcache):
        for n in ("k", "v"):
            np.testing.assert_allclose(plc[n].numpy(), np.asarray(jlc[n]),
                                       atol=KV_TOL, rtol=1e-4)


def test_paged_suffix_from_buffers_matches_jax(params):
    """``paged_suffix`` with base and true length in (1,) tensors: the
    reference's logits and pool, the shared blocks unwritten."""
    from kind_tpu_sim.models import paged as jpaged

    jparams, pparams = params
    full = prompt(2, 21)
    row = np.asarray([3, 5, 7, 0], np.int32)
    jpools = jpaged.init_pools(jax_cfg(PLAIN), 9, 8)
    ppools = ppaged.init_pools(PLAIN, 9, 8, device="cpu")
    pre = pserving._padded_window(full[:16])
    jpools, _ = jpaged.paged_prefill(jparams, jpools,
                                     jnp.asarray(pre, jnp.int32),
                                     jnp.int32(16), jnp.asarray(row),
                                     cfg=jax_cfg(PLAIN))
    ppaged.paged_prefill(pparams, ppools, torch.as_tensor(pre), _buf([16]),
                         _buf(row, torch.int32), cfg=PLAIN)
    shared = [{n: t[[3, 5]].clone() for n, t in lc.items()} for lc in ppools]
    suf = pserving._padded_window(full[16:])
    jpools, jl = jpaged.paged_suffix(jparams, jpools,
                                     jnp.asarray(suf, jnp.int32),
                                     jnp.int32(5), jnp.int32(16),
                                     jnp.asarray(row), cfg=jax_cfg(PLAIN))
    pl = ppaged.paged_suffix(pparams, ppools, torch.as_tensor(suf),
                             _buf([5]), _buf([16]), _buf(row, torch.int32),
                             cfg=PLAIN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for jlc, plc, before in zip(jpools, ppools, shared):
        for n in ("k", "v"):
            np.testing.assert_allclose(plc[n][1:].numpy(),
                                       np.asarray(jlc[n])[1:], atol=KV_TOL,
                                       rtol=1e-4)
            assert torch.equal(plc[n][[3, 5]], before[n])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16 path", "int8 kv"])
def test_arena_store_and_restore_match_jax(params, int8):
    """The prefix store into a ``PrefixArena`` row and the restore from
    it, slot and arena row read from tensors, equal the reference's
    ``_read_slot_rows`` and ``_write_slot_rows`` (int8 caches: q and
    scale alike)."""
    jparams, pparams = params
    cfg = dataclasses.replace(PLAIN, int8_kv=int8)
    toks = pserving._padded_window(prompt(7, 14))
    jcache = jserving.init_cache(jax_cfg(cfg), 3, 32)
    jcache, _ = jserving._prefill_into_slot(
        jparams, jcache, jnp.asarray(toks, jnp.int32), jnp.int32(14), 2,
        cfg=jax_cfg(cfg))
    pcache = pserving.init_cache(cfg, 3, 32, device="cpu")
    pserving._prefill_into_slot(pparams, pcache, torch.as_tensor(toks), 14,
                                2, cfg=cfg)
    arena = pserving.PrefixArena(pcache, 3)
    row = arena.take(16)
    pserving._store_rows(pcache, arena.storage(16), _buf([2]), _buf([row]))
    jrows = jserving._read_slot_rows(jcache, 2, 16)
    jcache = jserving._write_slot_rows(jcache, jrows, 0)
    pserving._restore_rows(pcache, arena.storage(16), _buf([0]), _buf([row]))

    def parts(x):
        return list(x) if isinstance(x, tuple) else [x]

    for jlc, plc, jstored, pstored in zip(jcache, pcache, jrows,
                                          arena.storage(16)):
        for n in ("k", "v"):
            for j, p in zip(parts(jlc[n]), parts(plc[n])):
                np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                           atol=KV_TOL, rtol=1e-4)
            for j, p in zip(parts(jstored[n]), parts(pstored[n])):
                np.testing.assert_allclose(p[row:row + 1].numpy(),
                                           np.asarray(j), atol=KV_TOL,
                                           rtol=1e-4)


def test_arena_rows_return_with_evictions(params):
    """A dense prefix cache of 2 entries stores 4 prompts of one bucket:
    the LRU drops give their arena rows back, and at most capacity + 1
    rows are ever taken."""
    eng = make_engine(params, None, "dense waves", prefix_cache_entries=2)
    for i in range(4):
        eng.submit(pserving.Request(f"p{i}", prompt(60 + i, 10), 2,
                                    cache_prefix=True))
        eng.run()
    assert len(eng.prefix_cache.entries) == 2
    assert eng._arena.rows == 3 and len(eng._arena._free[16]) == 1
    rows = sorted(e["row"] for e in eng.prefix_cache.entries.values())
    assert len(set(rows)) == 2


# ---------------------------------------------------------------------
# the solo speculative generators


@pytest.mark.parametrize("with_draft", [False, True],
                         ids=["prompt lookup", "draft model"])
def test_solo_programs_run_one_key_a_step(params, draft, with_draft,
                                          monkeypatch):
    """``speculative_generate`` and ``draft_model_generate`` as compiled
    programs: every verify step of one k runs the same operations while
    the totals advance, the prefill one program, no host copy; another k
    is another key, another prompt the same keys; the tokens equal the
    greedy decode's."""
    p = params[1]
    rng = np.random.RandomState(8)
    prompts = [torch.as_tensor(rng.randint(0, CFG.vocab_size, (2, 9)))
               for _ in range(2)]
    keys = {}
    for k in (2, 3):
        for i, pr in enumerate(prompts):
            d = (draft[1], draft[0]) if with_draft else None
            prog = pspec.solo_program(p, CFG, pr, 12, k, draft=d)
            rec = prog._round = Recorder(monkeypatch)
            totals = []

            def step(_rec=rec, _prog=prog):
                def run(key, fn):
                    out = _rec(key, fn)
                    totals.append(_prog.total.tolist())
                    return out
                return run

            prog._round = step()
            got = pspec._solo_generate(prog, pr, 12, False)
            want = pdecode.greedy_generate(p, CFG, pr, 12, device="cpu")
            assert torch.equal(got, want)
            calls = rec.calls
            assert [c[0] for c in calls[:2]] == [("prefill",), ("step", k)]
            steps = [ops for key, _, ops in calls if key[0] == "step"]
            assert len(steps) > 1 and all(ops == steps[0] for ops in steps)
            assert len({str(t) for t in totals}) > 1
            keys[(k, i)] = {c[0] for c in calls}
    assert keys[(2, 0)] == keys[(2, 1)] != keys[(3, 0)] == keys[(3, 1)]


def test_solo_programs_are_kept_by_what_they_read(params):
    """One call's program serves the next with the same parameters and
    shapes; other parameters (another tree of the same shapes) or another
    prompt length make another, and the oldest beyond two is dropped."""
    p = params[1]
    other = {k: v for k, v in p.items()}
    other["embed"] = p["embed"].clone()
    pr = torch.zeros((2, 9), dtype=torch.long)
    pspec._PROGRAMS.clear()
    a = pspec.solo_program(p, CFG, pr, 8, 2)
    assert pspec.solo_program(p, CFG, pr, 8, 2) is a
    b = pspec.solo_program(other, CFG, pr, 8, 2)
    c = pspec.solo_program(p, CFG, torch.zeros((2, 10), dtype=torch.long),
                           8, 2)
    assert len({id(a), id(b), id(c)}) == 3
    assert list(pspec._PROGRAMS.values()) == [b, c]
