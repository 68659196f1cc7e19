"""Continuous-batching serving engines, in PyTorch.

Counterpart of ``kind_tpu_sim/models/serving.py``: a fixed grid of
``max_slots`` slots decodes in chunks of ``chunk`` tokens; between
chunks finished slots retire and queued requests are admitted. The
scheduler state (slot lengths, active flags, per-slot sampling knobs)
lives on the host as numpy arrays; the device holds the KV storage,
each slot's last token and its seen-token set. Each round costs one
device-to-host copy: its emitted tokens, queued into pinned host memory
right after the round's launches, with an event the retire waits on.
On a card a round is one CUDA graph replay, the counterpart of the
reference's jitted round programs (``models/graphs.py``): the host
state a round reads enters through fixed device buffers, and the round
writes its results back into the engine's state in place.

Four engines: ``ServingEngine`` over a dense (slots, max_len) cache,
``PagedServingEngine`` over a paged block pool (models/paged.py), whose
decode attention runs on the hand-written paged-attention kernel when
``ServingConfig.paged_kernel`` is set and through a gathered view
otherwise, and their speculative twins ``SpeculativeServingEngine``
and ``PagedSpeculativeServingEngine`` (models/speculative.py): a round
scans ``spec_windows`` verify windows of ``speculative_k`` drafted
tokens each, drafted by prompt lookup or by a draft model. Prefill
runs the flash-attention kernel when the model config sets ``flash``.

Sampled tokens are a pure function of (request, seed, generation
index): each draw's noise comes from (seed, index) alone, so placement,
co-tenants and recompute preemption cannot change a stream. Correctness
contract: a greedy request decoded through a busy grid, speculative or
not, emits exactly what ``decode.greedy_generate`` emits.

Admission, the way a prompt gets into the KV storage, has three
features that share one pair of hooks (``_claim_pending`` /
``_prefill_window``, then ``_store_pending``):

* prefix caching (``prefix_cache_entries``, ``Request.cache_prefix``):
  a hit restores a stored prefix (dense: a device copy of its rows;
  paged: the shared blocks, refcounted) and runs only the suffix;
* chunked prefill (``prefill_chunk``): a prompt enters in windows, one
  per scheduling round, interleaved with decode;
* admission waves (``admission_wave_sizes``): a round's cache misses
  that share a prompt bucket run as one stacked prefill of K prompts
  (K decomposed into the configured sizes, largest first) with one
  host readback of their first tokens.

The first window of a prompt runs the forward (the flash kernel when
the model config sets ``flash``); a suffix window runs
``speculative._window_block`` against the prefix.

The rest of the engine surface: ``overlap_rounds`` pipelines ``run()``
(round N+1 is launched before round N is read back; dense and
speculative grids), ``Request.deadline_s`` completes an expired request
with ``finish_reason="deadline_exceeded"``, ``max_queue`` sheds new
requests with ``EngineSaturated``, and ``inject_slot_failure`` /
``restore_slot`` requeue a slot's request for exact replay and
quarantine the slot.

Every engine serves the int8 tiers (``ModelConfig.int8_kv``: int8 KV
rows with per-row scales, quantized at every write; ``int8_native``:
W8A8 products; an int8 weight snapshot from ``quant.quantize_params``)
and MoE configs (``n_experts``: each decode step routes the grid's
slots together, each verify-window position the slots at that
position, each admitted prompt alone, as the JAX package routes them).
int8 pools serve on the paged gather tier only, as in the reference.

Every engine serves over a mesh (``parallel/mesh.py``), as the
reference's tensor-parallel serving does. Every rank runs the same host
scheduler on the same requests. The parameters are Megatron-sharded over
'model' (``transformer.shard_params``), the KV storage holds this
rank's KV heads, and the slots of the dense grids are split over 'data':
each data rank's cache holds its own slots (plus one sink row the
other slots' writes are aimed at), a round computes only those rows,
and its emitted tokens and logprobs are all-gathered over 'data' so
every rank's scheduler stays in step. Whole-prompt prefills run on
every data rank (each keeps its own slots' rows); a window against a
slot's prefix runs on the slot's data rank and its logits are
broadcast. Paged pools keep the block axis global, so paged engines
refuse a data axis; the paged kernel tier is refused under any mesh, as
the reference refuses its Pallas tier. On a card, rounds are CUDA graphs
with their collectives captured when the mesh's backend is NCCL, and
eager under gloo, whose collectives run on the host; ``report()`` says
which (``"mesh"``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.device import resolve, to_device, torch_dtype
from kind_tpu_sim_torch.models.decode import (
    NEG,
    SamplingConfig,
    _block_decode_chunk,
    _counter_gumbel,
    _filtered_scaled,
    _gumbel_noise,
    _map_kv,
    _new_chunk_buffers,
    _write,
    init_cache,
)
from kind_tpu_sim_torch.models import graphs
from kind_tpu_sim_torch.models.quant import QuantArray, embed_lookup
from kind_tpu_sim_torch.models.transformer import (
    ModelConfig,
    Params,
    _block_core,
    _readout,
    _rms_norm,
    shard_params,
)
from kind_tpu_sim_torch.parallel import tp


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine knobs (the vLLM --max-num-seqs / --max-model-len analog),
    with the JAX package's names, order and defaults."""

    max_slots: int = 4        # concurrent sequences (the decode batch)
    max_len: int = 128        # per-slot KV capacity (prompt + generated)
    chunk: int = 16           # decode tokens per round between
    #                           scheduling boundaries
    prefix_cache_entries: int = 0
    paged_blocks: int = 0     # >0: paged KV (PagedServingEngine)
    block_size: int = 16      # KV positions per pool block
    speculative_k: int = 0    # >0: drafts of this width, verified in
    #                           windows of k+1 tokens (the speculative
    #                           engines only)
    spec_windows: int = 4     # speculative engines: verify windows
    #                           scanned per dispatch
    paged_kernel: bool = False  # paged tier only: the CUDA paged-
    #                             attention kernel (direct block reads)
    paged_width: int = 0      # paged tier: fixed block-table width
    #                           (0 = power-of-two bucketing)
    admission_wave_sizes: tuple = ()
    overlap_rounds: bool = False  # run(): launch round N+1 before
    #                               reading round N back (dense and
    #                               speculative grids only)
    prefill_chunk: int = 0
    max_queue: int = 0        # >0: submit() raises EngineSaturated
    #                           once this many requests are queued


class EngineSaturated(RuntimeError):
    """submit() shed a request: the queue is at ServingConfig.max_queue.
    Accepted (queued or in-flight) requests are unaffected: shedding
    happens at admission, never mid-stream."""


@dataclasses.dataclass
class Request:
    """One generation request; ``max_new`` includes the first sampled
    token. ``eos_id`` stops generation early when emitted. ``sampling``
    None or temperature<=0 means greedy; ``seed`` None draws fresh
    entropy at submit (stored on the request, so the run replays)."""

    request_id: str
    prompt: List[int]
    max_new: int
    eos_id: Optional[int] = None
    sampling: Optional[SamplingConfig] = None
    seed: Optional[int] = None
    cache_prefix: bool = False   # store the prompt's k/v for later hits
    deadline_s: Optional[float] = None  # e2e budget in clock seconds from
    #                                    submit(), checked once a round
    logprobs: bool = False       # raw-model log-probability per token


@dataclasses.dataclass
class Completion:
    request_id: str
    prompt: List[int]
    tokens: List[int]          # generated tokens (eos included if hit)
    finish_reason: str         # "stop" (eos), "length" or
    #                            "deadline_exceeded" (tokens so far kept)
    deadline_exceeded: bool = False
    ttft_s: Optional[float] = None   # submit -> first token, 6 places
    e2e_s: Optional[float] = None    # submit -> completion, 6 places
    logprobs: Optional[List[float]] = None


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= n (>= lo): the prompt padding."""
    b = lo
    while b < n:
        b *= 2
    return b


def _padded_window(toks) -> np.ndarray:
    """(1, bucket(len)) zero-padded token window."""
    arr = np.zeros((1, _bucket(len(toks))), np.int64)
    arr[0, :len(toks)] = toks
    return arr


# ---------------------------------------------------------------------
# device functions


def _prefill_into_slot(params, cache, tokens, true_len: int, slot: int, *,
                       cfg: ModelConfig):
    """Run the prompt (1, L_pad) through the forward and write k/v for
    positions < true_len into row ``slot`` of the cache, in place (the
    rest of the row is zeroed: in an int8 cache, quantized zeros with
    scale 1e-8/127, as the reference's padded write leaves). Returns the
    fp32 logits (vocab,) at the TRUE last position; padding cannot leak
    into them (causal)."""
    return _prefill_many_into_slots(params, cache, tokens, [true_len], [slot],
                                    cfg=cfg)[0]


def _prefill_many_into_slots(params, cache, tokens, true_lens, slots, *,
                             cfg: ModelConfig):
    """K whole-prompt prefills as ONE stacked forward: ``tokens`` (K,
    L_pad) within one prompt bucket, row r written into cache row
    ``slots[r]`` for its first ``true_lens[r]`` positions (the rest of
    the row zeroed), in place. Each row's result equals its own
    ``_prefill_into_slot`` (the flash kernel launches once per layer
    for the whole wave; an MoE routes each prompt alone, over its
    bucket-padded length, as the reference's scan of single-prompt
    prefills does). Returns (K, vocab) fp32 logits at each row's true
    last position."""
    k_rows, t_p = tokens.shape
    dev = tokens.device
    positions = torch.arange(t_p, device=dev)[None, :].expand(k_rows, t_p)
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    lens = torch.as_tensor(true_lens, device=dev)
    keep = (torch.arange(t_p, device=dev)[None, :]
            < lens[:, None])[:, :, None, None]
    rows = torch.as_tensor(slots, device=dev)
    for bparams, layer_cache in zip(params["blocks"], cache):
        x, _, k, v = _block_core(x, bparams, cfg, positions, "rows")
        for arr, upd in ((layer_cache["k"], k), (layer_cache["v"], v)):
            n = min(t_p, arr.shape[1])
            whole = upd.new_zeros((k_rows, arr.shape[1]) + upd.shape[2:])
            whole[:, :n] = torch.where(keep, upd, 0)[:, :n]
            _write(arr, rows, whole)
    last = x[torch.arange(k_rows, device=dev), lens - 1]
    h = _rms_norm(last, params["final_norm"])
    return _readout(h, params["embed"], cfg.int8_native).float()


def _suffix_into_slot(params, cache, tokens, true_len: int, base: int,
                      slot: int, *, cfg: ModelConfig):
    """Continue a slot whose first ``base`` positions already hold k/v
    (a restored prefix, or the earlier windows of a chunked prefill):
    run the window (1, w_pad) through the model attending to that
    prefix (``speculative._window_block``), write its k/v from ``base``
    on (positions past ``true_len`` zeroed; none past the row's end),
    in place, and return the fp32 logits at the TRUE last window
    position. ``_prefill_into_slot`` is the base == 0 case."""
    from kind_tpu_sim_torch.models.speculative import _window_block

    w = tokens.shape[1]
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    keep = (torch.arange(w, device=dev) < true_len)[None, :, None, None]
    base_vec = torch.full((1,), base, device=dev)
    for bparams, layer_cache in zip(params["blocks"], cache):
        row = {name: _map_kv(arr, lambda a: a[slot:slot + 1])
               for name, arr in layer_cache.items()}
        x, kk, vv = _window_block(x, bparams, cfg, row, base_vec)
        for arr, upd in ((layer_cache["k"], kk), (layer_cache["v"], vv)):
            n = min(w, arr.shape[1] - base)
            _write(arr, (slot, slice(base, base + n)),
                   torch.where(keep, upd, 0)[0, :n])
    h = _rms_norm(x[:, true_len - 1, :], params["final_norm"])
    return _readout(h, params["embed"], cfg.int8_native)[0].float()


def _read_slot_rows(cache, slot: int, length: int):
    """Copies of the first ``length`` cache rows of ``slot``, one
    {"k", "v"} of (1, length, kv, hd) per layer (int8 caches: q and
    scale, as they are): the store half of dense prefix caching."""
    return [{name: _map_kv(arr, lambda a: a[slot:slot + 1, :length].clone())
             for name, arr in layer_cache.items()} for layer_cache in cache]


def _write_slot_rows(cache, entry_kv, slot: int) -> None:
    """Copy a stored prefix entry's rows into ``slot`` from position 0,
    device to device, in place: the restore half."""
    for layer_cache, entry in zip(cache, entry_kv):
        for name, arr in layer_cache.items():
            pairs = (zip(arr, entry[name]) if isinstance(arr, QuantArray)
                     else ((arr, entry[name]),))
            for dst, src in pairs:
                dst[slot, :src.shape[1]] = src[0]


class PrefixCache:
    """Host-side LRU of prompt -> device KV rows (the exact-prefix tier
    of automatic prefix caching). Entries are keyed by the stored token
    tuple and padded to a power-of-two length. ``lookup`` returns the
    LONGEST stored entry that strictly prefixes the query and fits the
    slot; admission copies its rows and runs only the suffix. The k/v
    of a prefix are positional (computed at positions 0..p-1), so they
    are exact wherever they land."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries = collections.OrderedDict()
        # stored length -> entry count: lookup probes one key per
        # distinct length instead of comparing every entry
        self._len_count: Dict[int, int] = collections.Counter()
        self.hits = 0
        self.misses = 0

    def lookup(self, prompt: List[int], max_len: Optional[int] = None):
        """Longest USABLE stored strict prefix of ``prompt``
        (LRU-refreshed); None on a miss. With ``max_len``, an entry
        whose stored rows (its pad) or whose bucket-padded suffix
        window would run past ``max_len`` is no hit: it is not counted
        or refreshed, and a shorter stored prefix that fits wins."""
        for length in sorted(self._len_count, reverse=True):
            if length >= len(prompt):
                continue
            key = tuple(prompt[:length])
            entry = self.entries.get(key)
            if entry is None:
                continue
            if max_len is not None and (
                    entry["pad"] > max_len
                    or entry["len"] + _bucket(len(prompt) - entry["len"])
                    > max_len):
                continue
            self.hits += 1
            self.entries.move_to_end(key)
            return entry
        self.misses += 1
        return None

    def store(self, prompt: List[int], entry) -> None:
        key = tuple(prompt)
        if key not in self.entries:
            self._len_count[len(key)] += 1
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.capacity:
            old_key, _ = self.entries.popitem(last=False)
            self._len_count[len(old_key)] -= 1
            if not self._len_count[len(old_key)]:
                del self._len_count[len(old_key)]

    def report(self) -> Dict[str, Any]:
        return {"entries": len(self.entries), "hits": self.hits,
                "misses": self.misses}


def _raw_token_lp(logits, toks):
    """log_softmax of the raw fp32 logits at the chosen tokens.
    logits (..., vocab), toks (...) -> (...) fp32."""
    lg = logits.float()
    picked = lg.gather(-1, toks[..., None].long())[..., 0]
    return picked - torch.logsumexp(lg, dim=-1)


def _apply_rep_penalty(logits, rep_pen, presence):
    """HF/vLLM repetition penalty per row: logits of tokens in
    ``presence`` (b, vocab) bool are divided by the penalty when
    positive, multiplied when negative; 1.0 is the identity."""
    pen = rep_pen[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(presence & (pen != 1.0), penalized, logits)


def _sample_rows(logits, temp, top_k, top_p, min_p, rep_pen, presence,
                 noise):
    """Per-row sampling over fp32 logits (b, vocab), each row with its
    own knobs. Rows with temp <= 0 are greedy: argmax of the PENALIZED
    logits. Sampled rows take the Gumbel-max draw argmax(filtered +
    noise); ``noise`` (b, vocab) is the rows' ``_counter_gumbel`` draw
    (tests pass another implementation's to match its draw)."""
    logits = _apply_rep_penalty(logits, rep_pen, presence)
    greedy = torch.argmax(logits, dim=-1)
    scaled = _filtered_scaled(logits, temp, top_k, top_p, min_p)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temp <= 0.0, greedy, sampled)


def _chunk_scan(params, big_cache, lengths, last_token, active, sampling,
                presence, *, cfg: ModelConfig, chunk: int, block_fn=None):
    """One scheduling quantum: ``chunk`` tokens for every slot against
    a big cache that is only read (inactive slots compute too, their
    emissions are ignored by the host and their write-back suppressed
    by the caller's merge). ``big_cache`` is per-layer (b, s, kv, hd)
    — the dense grid or a paged gather view; ``block_fn(x, bparams,
    big_lc, small_lc, i)`` overrides the per-layer block (the paged
    kernel tier). Every input is a device tensor, nothing is copied
    from the host: ``lengths`` (b,) int32, ``active`` (b,) bool and
    ``sampling``, None when every row is greedy and penalty-free (the
    JAX package's lax.cond, decided on the host, a graph key) or the
    tuple (temp, top_k, top_p, min_p, rep_pen, seed words, prompt_len)
    of ``graphs.RoundInputs.sampling``. ``last_token`` (b,) and
    ``presence`` (b, vocab) bool, the seen-token sets, are updated in
    place. Returns (chunk buffers, emitted (b, chunk), raw-model
    logprobs (b, chunk))."""
    b = last_token.shape[0]
    device = last_token.device
    dtype = torch_dtype(cfg.dtype)
    if block_fn is None:
        # each slot attends over its own [0, lengths[b]) prefix
        def block_fn(x, bparams, big_lc, small_lc, i):
            return _block_decode_chunk(x, bparams, cfg, big_lc, small_lc,
                                       lengths, i)
    small = _new_chunk_buffers(cfg, b, chunk, device)
    if sampling is not None:
        temp, top_k, top_p, min_p, rep_pen, words, prompt_len = sampling
        # generation index of the token selected at step i: generation
        # 0 came from the prefill logits at admission
        gen0 = lengths.long() + 1 - prompt_len
    rows = torch.arange(b, device=device)
    token = last_token
    emitted, lps = [], []
    for i in range(chunk):
        x = embed_lookup(params["embed"], token, dtype)
        for bparams, big_lc, small_lc in zip(params["blocks"], big_cache,
                                             small):
            x, _ = block_fn(x, bparams, big_lc, small_lc, i)
        x = _rms_norm(x, params["final_norm"])
        logits = _readout(x, params["embed"], cfg.int8_native)
        if sampling is not None:
            noise = _counter_gumbel(words, gen0 + i, logits.shape[-1])
            nxt = _sample_rows(logits, temp, top_k, top_p, min_p, rep_pen,
                               presence, noise=noise)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(active, nxt, token)  # inactive slots hold
        # the emitted token joins its row's seen set (masked: an
        # inactive slot's held token must not re-mark itself)
        presence[rows, nxt] = presence[rows, nxt] | active
        lps.append(_raw_token_lp(logits, nxt))
        emitted.append(nxt)
        token = nxt
    last_token.copy_(token)
    return small, torch.stack(emitted, dim=1), torch.stack(lps, dim=1)


def _scatter_chunk(cache_arr, small_arr, starts, active) -> None:
    """Merge each slot's chunk-buffer rows into the big cache at that
    slot's offset, in place (quantized per row into an int8 cache).
    Inactive slots and slots whose window would run past max_len (only
    reachable on a slot's final round, which retires it) rewrite their
    current bytes instead."""
    b, chunk = small_arr.shape[:2]
    max_len = cache_arr.shape[1]
    sel = active & (starts + chunk <= max_len)
    cols = (torch.clamp(starts, 0, max_len - chunk).long()[:, None]
            + torch.arange(chunk, device=starts.device)[None, :])
    rows = torch.arange(b, device=starts.device)[:, None].expand(b, chunk)
    _write(cache_arr, (rows, cols), small_arr, keep=sel[:, None, None, None])


def _decode_chunk(params, cache, lengths, last_token, active, sampling,
                  presence, *, cfg: ModelConfig, chunk: int):
    """One scheduling quantum over the dense slot grid (``_chunk_scan``,
    then each slot's chunk merged into the cache); the cache,
    ``last_token`` and ``presence`` are updated in place. Returns
    (emitted (slots, chunk), logprobs)."""
    small, emitted, lps = _chunk_scan(
        params, cache, lengths, last_token, active, sampling, presence,
        cfg=cfg, chunk=chunk)
    for big_lc, small_lc in zip(cache, small):
        _scatter_chunk(big_lc["k"], small_lc["k"], lengths, active)
        _scatter_chunk(big_lc["v"], small_lc["v"], lengths, active)
    return emitted, lps


# ---------------------------------------------------------------------
# host-side engine


def _scoped(method):
    """Run an engine method with the engine's split in scope
    (``parallel.tp``): its parameters and storage are this rank's
    shards."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with tp.scope(self._shards):
            return method(self, *args, **kwargs)

    return run


def _check_mesh_divisibility(cfg: ModelConfig, slots: int, mesh) -> None:
    data = mesh.axis_size("data")
    model = mesh.axis_size("model")
    if slots % data != 0:
        raise ValueError(
            f"max_slots {slots} not divisible by mesh data axis {data}")
    if cfg.kv_heads % model != 0:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} not divisible by mesh model axis "
            f"{model}")


def _check_slice(cfg: ModelConfig, serving: ServingConfig, mesh) -> None:
    """Loud, not silent: a knob outside the ported slices would
    otherwise "run" and serve with the wrong semantics. Every mesh
    rejection fires before the weights are sharded, as the reference's
    do before its weight transfer."""
    if mesh is not None:
        if serving.paged_kernel:
            raise ValueError(
                "the paged-attention kernel tier does not partition under "
                "a mesh (its CUDA kernel reads whole pools); use the "
                "gather tier")
        if serving.paged_blocks and mesh.axis_size("data") > 1:
            raise ValueError(
                "paged mesh serving shards kv heads over 'model' only — "
                "the block pool is global across slots, so the slot axis "
                "cannot shard over 'data'; use a mesh without a data axis")
        _check_mesh_divisibility(cfg, serving.max_slots, mesh)
    waves = serving.admission_wave_sizes
    if waves and (1 not in waves
                  or any(w < 1 or w > serving.max_slots for w in waves)):
        raise ValueError(
            "admission_wave_sizes must include 1 and stay within "
            f"[1, max_slots={serving.max_slots}]; got {waves!r}")


class ServingEngine:
    """Continuous-batching scheduler over a dense (slots, max_len) cache.

    ``run()`` drains the queue; ``submit`` / ``step_round`` / ``poll``
    are the incremental surface. ``device`` is the card unless the
    caller asks for the CPU; ``params`` must already live there.
    ``clock`` is what every latency stamp and deadline reads (default
    ``time.monotonic``). ``mesh`` serves tensor-parallel (the module
    docstring): every rank constructs the engine with the same whole
    ``params`` and drives it with the same requests.
    """

    # the speculative engines take ServingConfig.speculative_k; the
    # others refuse it rather than serve without speculation
    _speculative = False

    def __init__(self, params: Params, cfg: ModelConfig,
                 serving: ServingConfig = ServingConfig(), device="cuda",
                 clock=None, mesh=None):
        self.device = resolve(device)
        _check_slice(cfg, serving, mesh)
        if serving.speculative_k > 0 and not self._speculative:
            raise ValueError(
                f"{type(self).__name__} ignores speculative_k; construct "
                "SpeculativeServingEngine or PagedSpeculativeServingEngine")
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}; the engine "
                f"runs on {self.device}")
        self._clock = clock if clock is not None else time.monotonic
        self.mesh = mesh
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
        # what the engine's computations are split over: the parameters
        # over 'model' (experts over 'expert' or 'model'); a round of a
        # dense grid's slots also over 'data'
        self._shards = tp.shards_of(mesh, None)
        data = tp.axis(mesh, "data") if mesh is not None else None
        self._data = data if data is not None and data.size > 1 else None
        self._lo, self._hi = tp.split_rows(serving.max_slots, self._data)
        self.params = params
        self.cfg = cfg
        self.serving = serving
        n = serving.max_slots
        # host-side scheduler state
        self.lengths = np.zeros(n, np.int32)
        self.active = np.zeros(n, bool)
        self.temp = np.zeros(n, np.float32)
        self.top_k = np.zeros(n, np.int32)
        self.top_p = np.ones(n, np.float32)
        self.min_p = np.zeros(n, np.float32)
        self.rep_pen = np.ones(n, np.float32)
        self.seeds: List[int] = [0] * n
        self.prompt_len = np.zeros(n, np.int64)
        # device state: each slot's last token and seen-token set
        self.last_token = torch.zeros(n, dtype=torch.long,
                                      device=self.device)
        self.presence = torch.zeros((n, cfg.vocab_size), dtype=torch.bool,
                                    device=self.device)
        # what a round reads of the host's state enters through these
        # buffers, and the round runs through ``_round``: a CUDA graph
        # per key on a card, the eager function on the CPU
        self._in = graphs.RoundInputs(n, self.device)
        self._round = graphs.round_runner(self.device, mesh)

        self.queue: List[Request] = []
        self.slot_req: List[Optional[Request]] = [None] * n
        # per-slot admission generation, bumped at every activation: a
        # round's retire keeps a slot's rows only if the generation is
        # the one it was launched with (a slot freed and re-admitted in
        # between, even by the same Request object, is detected)
        self._slot_gen: List[int] = [0] * n
        self.slot_emitted: List[List[int]] = [[] for _ in range(n)]
        self.slot_lps: List[List[float]] = [[] for _ in range(n)]
        # chunked prefill: slot -> {"req", "done"} for claimed slots
        # whose prompts are still streaming in
        self._pending: Dict[int, Dict[str, Any]] = {}
        self.finished: List[Completion] = []
        # chaos state: quarantined slots and the fault/recovery counts
        # report() publishes
        self._failed_slots: set = set()
        self.slot_failures = 0
        self.requeues = 0
        self.shed = 0
        self._req_clock: Dict[str, Dict[str, float]] = {}
        self._lat_window = collections.deque(maxlen=1024)
        self._lat_count = 0
        self._lat_ttft_max = 0.0
        self._lat_e2e_max = 0.0
        self._lat_itl_max = 0.0
        # dispatch counts. prefills: prompt windows run through the
        # model, one per request and window (a wave counts each row);
        # prefill_dispatches: the forwards among them that start a
        # prompt (a lone first window or a stacked wave), each
        # launching the flash kernel once per layer (cfg.flash);
        # suffix_windows: windows run against a prefix by
        # speculative._window_block; wave_sizes: stacked dispatches by
        # size; decode_rounds: chunks of chunk x n_layers decode
        # attention calls
        self.prefills = 0
        self.prefill_dispatches = 0
        self.suffix_windows = 0
        self.wave_sizes: Dict[int, int] = collections.Counter()
        self.decode_rounds = 0
        with tp.scope(self._shards):
            self._init_storage()

    def _init_storage(self) -> None:
        if self.serving.paged_blocks or self.serving.paged_kernel:
            raise ValueError(
                f"{type(self).__name__} ignores paged_blocks/"
                "paged_kernel; construct PagedServingEngine")
        self.cache = init_cache(self.cfg, self._storage_slots(),
                                self.serving.max_len, device=self.device)
        self.prefix_cache = (PrefixCache(self.serving.prefix_cache_entries)
                             if self.serving.prefix_cache_entries > 0
                             else None)

    # -- the slots' split over 'data' (dense grids) --------------------

    def _storage_slots(self) -> int:
        """Rows of a slot-indexed storage: every slot, or this data
        rank's slots and the sink row."""
        if self._data is None:
            return self.serving.max_slots
        return self._hi - self._lo + 1

    def _row(self, slot: int) -> int:
        """The storage row of ``slot``: the sink row for a slot of
        another data rank (writes aimed there are never read)."""
        if self._data is None:
            return slot
        if self._lo <= slot < self._hi:
            return slot - self._lo
        return self._hi - self._lo

    def _owner(self, slot: int) -> int:
        return slot // (self._hi - self._lo)

    def _owns(self, slot: int) -> bool:
        return self._data is None or self._lo <= slot < self._hi

    def _mine(self, t):
        """This data rank's slots of a per-slot tensor (a view), or of
        each tensor of a tuple; None stays None."""
        if self._data is None or t is None:
            return t
        if isinstance(t, tuple):
            return tuple(self._mine(x) for x in t)
        return t[self._lo:self._hi]

    def _local(self, storage):
        """Per-layer views of a slot-indexed storage without its sink
        row: the rows a round computes."""
        if self._data is None:
            return storage
        n = self._hi - self._lo
        return [{name: _map_kv(arr, lambda a: a[:n])
                 for name, arr in lc.items()} for lc in storage]

    def _gathered(self, fn, dims):
        """A round function over this rank's slots made a round over the
        grid: ``fn`` runs with the slots' split in scope and each output
        is all-gathered over 'data' along its slot dimension (``dims``)."""
        if self._data is None:
            return fn
        shards = self._shards._replace(data=self._data)

        def run():
            with tp.scope(shards):
                outs = fn()
            return tuple(tp.all_gather(o, self._data, d)
                         for o, d in zip(outs, dims))

        return run

    def _from_owner(self, slot: int, fn, vocab: int):
        """fp32 logits (vocab,) that only ``slot``'s data rank can
        compute (a window against the slot's prefix): computed there
        and broadcast over 'data'."""
        if self._data is None:
            return fn()
        if self._owns(slot):
            out = fn().contiguous()
        else:
            out = torch.empty(vocab, dtype=torch.float32, device=self.device)
        return tp.broadcast(out, self._data, self._owner(slot))

    # -- public surface ------------------------------------------------

    def submit(self, request: Request) -> None:
        if (self.serving.max_queue
                and len(self.queue) >= self.serving.max_queue):
            # shed at admission with a typed error to back off on;
            # in-flight streams are untouched
            self.shed += 1
            metrics.recovery_log().record(
                "request_shed", request=request.request_id,
                queued=len(self.queue))
            raise EngineSaturated(
                f"queue at max_queue={self.serving.max_queue}; "
                f"request {request.request_id!r} shed")
        self._capacity_check(request)
        self._check_request(request)
        if request.sampling is not None:
            # at submit, not admission: a refusal inside run() would
            # abandon the co-tenants' drain
            self._check_sampling(request.sampling)
        if request.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if request.seed is None:
            # per-request entropy, stored so the run replays
            request.seed = int.from_bytes(os.urandom(4), "little")
        if request.request_id in self._req_clock:
            raise ValueError(
                f"request id {request.request_id!r} is already queued or "
                "in flight")
        self._req_clock[request.request_id] = {"submit": self._clock()}
        self.queue.append(request)

    @torch.no_grad()
    @_scoped
    def step_round(self) -> None:
        """One scheduling quantum: admit into free slots, advance each
        pending chunked prefill by one window, decode one chunk for the
        whole grid, retire finished slots. Runs without autograd, so
        parameters that require grad build no graph and leave none in
        the storage."""
        self._admit_and_advance()
        handles = self._round_dispatch()
        if handles is not None:
            self._round_retire(handles)

    def _admit_and_advance(self) -> None:
        """Fill free slots, then advance each pending chunked prefill by
        exactly one window (the pacing contract)."""
        self._admit()
        if self._pending:
            self._advance_prefills()

    def _round_dispatch(self):
        """Launch one decode round for the grid and queue its readback;
        returns (staged readback, admission-generation snapshot), or
        None when no slot is live."""
        if not any(r is not None for r in self.slot_req):
            return None
        emitted, lps = self._decode_round()
        return self._stage(emitted, lps), list(self._slot_gen)

    def _round_retire(self, handles) -> None:
        staged, owners = handles
        emitted, lps = self._fetch(staged)
        self._retire(emitted, lps, owners)
        self._expire_deadlines()

    def _stage(self, *arrs):
        """Queue the copy of a round's outputs to the host without
        waiting. On a card each goes into pinned host memory with
        ``non_blocking=True`` and an event is recorded behind the
        copies, so the retire waits for this round alone, not for a
        round launched after it. The logprobs plane (the last array)
        rides along only when a live request asked for logprobs;
        otherwise it is None."""
        if not any(r is not None and r.logprobs for r in self.slot_req):
            arrs = arrs[:-1] + (None,)
        if self.device.type != "cuda":
            return [None if a is None else a.clone() for a in arrs], None
        host = []
        for a in arrs:
            if a is not None:
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a, non_blocking=True)
                a = h
            host.append(a)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _fetch(staged):
        """Wait for a staged round and return its arrays as numpy."""
        host, done = staged
        if done is not None:
            done.synchronize()
        return [None if h is None else h.numpy() for h in host]

    def _expire_deadlines(self) -> None:
        """Deadline enforcement once a round, after its retire: every
        live or mid-prefill slot whose request's budget has run out
        completes now with finish_reason "deadline_exceeded" (tokens
        already emitted are kept) and frees its slot."""
        now = self._clock()

        def expired(req) -> bool:
            if req is None or req.deadline_s is None:
                return False
            clock = self._req_clock.get(req.request_id)
            return (clock is not None
                    and now - clock["submit"] >= req.deadline_s)

        for slot, req in enumerate(self.slot_req):
            if expired(req):
                self._finish(slot, reason="deadline_exceeded")
        for slot in [s for s, st in self._pending.items()
                     if expired(st["req"])]:
            req = self._pending.pop(slot)["req"]
            self._release_storage(slot)
            self._complete_unserved(req)

    def _complete_unserved(self, req: Request) -> None:
        """A deadline_exceeded Completion for a request that never
        reached (or never finished reaching) a slot: expired in the
        queue or mid chunked prefill. No tokens."""
        now = self._clock()
        clock = self._req_clock.pop(req.request_id, None)
        e2e = (round(now - clock["submit"], 6)
               if clock and "submit" in clock else None)
        self.finished.append(Completion(
            request_id=req.request_id, prompt=list(req.prompt), tokens=[],
            finish_reason="deadline_exceeded", deadline_exceeded=True,
            ttft_s=None, e2e_s=e2e, logprobs=None))

    def outstanding(self) -> int:
        """Accepted but unfinished requests: queued, streaming a
        chunked prefill, or in a slot."""
        return (len(self.queue) + len(self._pending)
                + sum(1 for r in self.slot_req if r is not None))

    def poll(self) -> List[Completion]:
        out, self.finished = self.finished, []
        return out

    @torch.no_grad()
    @_scoped
    def run(self) -> List[Completion]:
        """Drain queue, pending prefills and grid; returns completions
        in finish order. With ``overlap_rounds`` the loop is pipelined:
        round N+1 is launched before round N is read back, so the
        readback waits behind device work. The price is one lagged
        round per retirement (a finished slot computes until its
        results are read; the generation snapshot discards those rows)
        and one trailing discarded round per drain."""
        done: List[Completion] = []
        if not self.serving.overlap_rounds:
            while (self.queue or self._pending
                   or any(r is not None for r in self.slot_req)):
                self._assert_serviceable()
                self.step_round()
                done.extend(self.poll())
            return done
        pending = None
        while (self.queue or self._pending or pending is not None
               or any(r is not None for r in self.slot_req)):
            if pending is None:
                self._assert_serviceable()
            if pending is not None and self._round_finishes_all():
                # the round in flight completes every live slot: another
                # launch now would be all zombie rows, so retire it and
                # refill the freed slots first (windows still advance
                # once an iteration, below)
                self._round_retire(pending)
                pending = None
                self._admit()
            nxt = self._round_dispatch()
            if pending is not None:
                self._round_retire(pending)
            pending = nxt
            self._admit_and_advance()
            done.extend(self.poll())
        return done

    def _round_min_tokens(self) -> int:
        """Tokens a round surely delivers to each live slot: ``chunk``
        (the speculative engines: one a window)."""
        return self.serving.chunk

    def _round_finishes_all(self) -> bool:
        """Does the round in flight complete every live slot? Exact for
        budget-bound requests; with an eos_id the stop cannot be
        predicted, so those keep pipelining."""
        lo = self._round_min_tokens()
        saw = False
        for req, emitted in zip(self.slot_req, self.slot_emitted):
            if req is None:
                continue
            saw = True
            if req.eos_id is not None or len(emitted) + lo < req.max_new:
                return False
        return saw

    def _round_sampling(self):
        """The slots' sampling state in the round's buffers, or None
        when no slot samples or penalizes (the JAX package's lax.cond:
        an all-greedy, penalty-free grid, the common serving case, skips
        the sampling pipeline; part of the graph key)."""
        if not (np.any(self.temp > 0.0) or np.any(self.rep_pen != 1.0)):
            return None
        return self._in.sampling(self.temp, self.top_k, self.top_p,
                                 self.min_p, self.rep_pen, self.seeds,
                                 self.prompt_len)

    # -- storage hooks (PagedServingEngine overrides) ------------------

    def _capacity_check(self, request: Request) -> None:
        need = len(request.prompt) + request.max_new
        if need > self.serving.max_len:
            raise ValueError(
                f"request {request.request_id} needs {need} positions; "
                f"slot capacity is {self.serving.max_len}")

    def _can_admit(self, request: Request, reserved: int = 0) -> bool:
        """Admission gate beyond a free slot (paged: the block budget).
        ``reserved`` is storage promised to this round's earlier
        deferred claims, so two claims cannot both pass the gate
        against the same free blocks."""
        return True

    def _reserve_claim(self, request: Request) -> int:
        """Worst-case (cache-miss) storage a deferred claim takes, in
        the units of ``reserved``; the dense grid pre-allocates."""
        return 0

    def _claim_pending(self, slot: int, req: Request) -> int:
        """Per-storage claim bookkeeping; returns the restored prefix
        length, the start of the prompt window (0 on a miss)."""
        return self._restore_prefix(slot, req)

    def _prefill_window(self, slot: int, req: Request, window, w: int,
                        done: int):
        """One prompt window through the model: the plain prefill at
        done 0, the suffix forward against the slot's [0, done) prefix
        after it. Returns the window's fp32 logits."""
        if done == 0:
            return _prefill_into_slot(self.params, self.cache, window, w,
                                      self._row(slot), cfg=self.cfg)
        return self._from_owner(slot, lambda: _suffix_into_slot(
            self.params, self.cache, window, w, done, self._row(slot),
            cfg=self.cfg), self.cfg.vocab_size)

    def _prefill_group(self, group):
        """Storage half of an admission wave (dense grid): the stacked
        whole-prompt prefill. Returns (K, vocab) logits."""
        toks = np.stack([_padded_window(req.prompt)[0] for _, req in group])
        return _prefill_many_into_slots(
            self.params, self.cache, torch.as_tensor(toks, device=self.device),
            [len(req.prompt) for _, req in group],
            [self._row(slot) for slot, _ in group], cfg=self.cfg)

    def _store_pending(self, slot: int, req: Request) -> None:
        """Prompt-complete hook (the prefix-cache store)."""
        self._store_prefix(slot, req)

    def _batch_admission(self) -> bool:
        """Whether the storage takes the stacked admission dispatch (the
        dense grid always does; paged engines need a fixed width)."""
        return True

    def _wave_share_hit(self, stored_prompt, prompt) -> bool:
        """Would a store still pending in this wave serve ``prompt``?
        (Dense: the stored prompt must be an exact prefix.)"""
        return (len(stored_prompt) <= len(prompt)
                and prompt[:len(stored_prompt)] == stored_prompt)

    def _release_storage(self, slot: int) -> None:
        """Dense rows are pre-allocated per slot: nothing to free."""

    # -- engine hooks (the speculative engines override) ---------------

    def _check_sampling(self, samp: SamplingConfig) -> None:
        """Per-engine sampling gate, at submit (the speculative engines
        refuse repetition_penalty)."""

    def _check_request(self, request: Request) -> None:
        """Per-engine request gate, at submit."""

    def _prefill_extras(self, slot: int, request: Request) -> None:
        """Run at activation on every admission path, before the slot's
        state is set (the draft-model engine prefills its draft cache
        here)."""

    def _on_admitted(self, slot: int, request: Request, first: int) -> None:
        """Run at activation once the slot's state is set (the
        speculative engines seed the slot's token buffer)."""

    def _decode_round(self):
        chunk = self.serving.chunk
        lengths, active = self._device_vectors()
        sampling = self._round_sampling()
        emitted, lps = self._round(
            ("chunk", chunk, sampling is not None),
            self._gathered(functools.partial(
                _decode_chunk, self.params, self._local(self.cache),
                self._mine(lengths), self._mine(self.last_token),
                self._mine(active), self._mine(sampling),
                self._mine(self.presence), cfg=self.cfg, chunk=chunk),
                (0, 0)))
        self._advance_lengths()
        return emitted, lps

    def _device_vectors(self):
        """The slots' lengths and active flags in the round's
        buffers."""
        return (self._in.fill(self._in.lengths, self.lengths),
                self._in.fill(self._in.active, self.active))

    def _advance_lengths(self) -> None:
        self.lengths = np.where(self.active,
                                self.lengths + self.serving.chunk,
                                self.lengths).astype(np.int32)
        self.decode_rounds += 1

    # -- prefix cache (dense) ------------------------------------------

    def _restore_prefix(self, slot: int, req: Request) -> int:
        """Copy the longest usable stored prefix of the prompt into
        ``slot``; returns its length (0: a miss or no cache). The
        lookup decides feasibility."""
        if self.prefix_cache is None:
            return 0
        hit = self.prefix_cache.lookup(req.prompt,
                                       max_len=self.serving.max_len)
        if hit is None:
            return 0
        if self._owns(slot):
            _write_slot_rows(self.cache, hit["kv"], self._row(slot))
        return hit["len"]

    def _store_prefix(self, slot: int, req: Request) -> None:
        """Store the slot's whole-prompt k/v, padded to the prompt's
        bucket, once the slot holds all of it."""
        if not (req.cache_prefix and self.prefix_cache is not None):
            return
        t_p = len(req.prompt)
        bucket = min(_bucket(t_p), self.serving.max_len)
        self.prefix_cache.store(req.prompt, {
            "kv": self._slot_rows(slot, bucket),
            "len": t_p, "pad": bucket})

    def _slot_rows(self, slot: int, length: int):
        """``_read_slot_rows`` of ``slot``, on every data rank: its data
        rank reads them and broadcasts them over 'data' (the others read
        their sink row for the shapes)."""
        rows = _read_slot_rows(self.cache, self._row(slot), length)
        if self._data is not None:
            for layer in rows:
                for arr in layer.values():
                    for t in (arr if isinstance(arr, QuantArray) else (arr,)):
                        tp.broadcast(t, self._data, self._owner(slot))
        return rows

    # -- admission and retirement --------------------------------------

    def _admit(self) -> None:
        # a queued request whose budget already ran out pays no prefill
        if any(r.deadline_s is not None for r in self.queue):
            now = self._clock()
            keep = []
            for req in self.queue:
                clock = self._req_clock.get(req.request_id)
                if (req.deadline_s is not None and clock is not None
                        and now - clock["submit"] >= req.deadline_s):
                    self._complete_unserved(req)
                else:
                    keep.append(req)
            self.queue = keep
        claims = []
        # storage promised to this round's deferred claims, so two
        # claims cannot both pass the gate against the same free blocks
        reserved = 0
        for slot in range(self.serving.max_slots):
            if (self.slot_req[slot] is not None or slot in self._pending
                    or slot in self._failed_slots or not self.queue):
                continue
            if not self._can_admit(self.queue[0], reserved):
                break  # FCFS: the head of the queue blocks the round
            req = self.queue.pop(0)
            if self.serving.prefill_chunk > 0:
                # claimed but inactive: _advance_prefills feeds one
                # window a round from the restored prefix on; the claim
                # allocated now, so nothing is reserved
                self._pending[slot] = {"req": req,
                                       "done": self._claim_pending(slot,
                                                                   req)}
                continue
            claims.append((slot, req))
            reserved += self._reserve_claim(req)
        if claims:
            self._admit_claims(claims)

    def _admit_claims(self, claims) -> None:
        """Admit this round's whole-prompt claims. Prefix-cache hits run
        their suffix per slot; misses of one prompt bucket share a
        stacked prefill and one first-token readback
        (``_admit_group``). A claim whose prompt extends a store still
        pending in the wave flushes the wave first, so it hits as it
        would under sequential admission."""
        if not self._batch_admission():
            # dynamic-width paged tables: claim, window, store and
            # activate per slot, each store visible to the next claim
            for slot, req in claims:
                self._admit_single(slot, req, self._claim_pending(slot, req))
            return
        groups: Dict[int, list] = {}
        wave_stores: list = []
        for slot, req in claims:
            if any(self._wave_share_hit(sp, req.prompt)
                   for sp in wave_stores):
                self._flush_groups(groups)
                groups, wave_stores = {}, []
            done = self._claim_pending(slot, req)
            if done:
                self._admit_single(slot, req, done)
                continue
            groups.setdefault(_bucket(len(req.prompt)), []).append(
                (slot, req))
            if req.cache_prefix and self.prefix_cache is not None:
                wave_stores.append(list(req.prompt))
        self._flush_groups(groups)

    def _flush_groups(self, groups) -> None:
        for _, group in sorted(groups.items()):
            self._admit_group(group)

    def _window(self, slot: int, req: Request, window, w: int, done: int):
        """``_prefill_window``, counted."""
        self.prefills += 1
        if done == 0:
            self.prefill_dispatches += 1
        else:
            self.suffix_windows += 1
        return self._prefill_window(slot, req, window, w, done)

    def _admit_single(self, slot: int, req: Request, done: int) -> None:
        """One slot's whole-prompt admission (claim done): the prompt
        past the restored prefix as one window, store, activate."""
        suffix = req.prompt[done:]
        window = torch.as_tensor(_padded_window(suffix), device=self.device)
        logits = self._window(slot, req, window, len(suffix), done)
        self._store_pending(slot, req)
        self._activate(slot, req, logits)

    def _wave_sizes(self) -> list:
        """Sub-wave sizes, largest first: the configured ones, or every
        power of two up to max_slots. 1 is among them, so any wave
        decomposes exactly."""
        sizes = self.serving.admission_wave_sizes
        if not sizes:
            sizes, w = [], 1
            while w <= self.serving.max_slots:
                sizes.append(w)
                w *= 2
        return sorted(sizes, reverse=True)

    def _admit_group(self, group) -> None:
        """One same-bucket admission wave: K decomposed into sub-waves
        of the configured sizes, largest first (11 -> 8+2+1), each one
        stacked prefill and one batched first-token sample; ONE host
        readback for all K first tokens."""
        handles = []
        sizes = self._wave_sizes()
        i = 0
        while i < len(group):
            w = next(s for s in sizes if s <= len(group) - i)
            sub = group[i:i + w]
            i += w
            logits_k = self._prefill_group(sub)
            self.prefills += w
            self.prefill_dispatches += 1
            self.wave_sizes[w] += 1
            handles.append((sub, logits_k, self._first_group(sub, logits_k)))
        firsts = self._first_read_many([h[2] for h in handles])
        j = 0
        for sub, logits_k, _ in handles:
            for r, (slot, req) in enumerate(sub):
                self._store_pending(slot, req)
                self._activate_with_first(slot, req, logits_k[r], firsts[j])
                j += 1

    def _first_group(self, group, logits_k):
        """The first token of each row of a wave, sampled on the device
        from its prefill logits (K, vocab) with key (seed, 0); no
        readback. An all-greedy, penalty-free wave is the argmax."""
        samps = [req.sampling or SamplingConfig(temperature=0.0)
                 for _, req in group]
        temp = np.asarray([s.temperature for s in samps], np.float32)
        rep_pen = np.asarray([s.repetition_penalty for s in samps],
                             np.float32)
        if not (np.any(temp > 0.0) or np.any(rep_pen != 1.0)):
            return torch.argmax(logits_k, dim=-1)
        dev = self.device
        seen = np.stack([self._seen_row(req) for _, req in group])
        keys = [(req.seed or 0, 0) for _, req in group]
        temp = to_device(temp, dev)
        return _sample_rows(
            logits_k, temp,
            to_device(np.asarray([s.top_k for s in samps], np.int32), dev),
            to_device(np.asarray([s.top_p for s in samps], np.float32), dev),
            to_device(np.asarray([s.min_p for s in samps], np.float32), dev),
            to_device(rep_pen, dev), to_device(seen, dev),
            noise=_gumbel_noise(keys, logits_k.shape[-1], temp, dev))

    @staticmethod
    def _first_read_many(arrs) -> List[int]:
        """One host readback of a wave's first tokens, however many
        sub-waves produced them."""
        return torch.cat(arrs).cpu().tolist()

    @torch.no_grad()
    @_scoped
    def warm_admission(self, prompt_lens, sizes=None) -> None:
        """Run every (prompt bucket x sub-wave size) admission dispatch
        the wave decomposition can make on dummy prompts, before
        traffic: the kernels build and the caching allocator grows to
        the waves' size. Scheduler, allocator and counters are left as
        they were: dense grids scribble on idle slots' rows (prefilled
        again before any read), paged engines write through all-zero
        table rows into the garbage block. A no-op for engines that
        admit per slot (dynamic-width paged, chunked prefill)."""
        if any(r is not None for r in self.slot_req) or self._pending:
            raise RuntimeError(
                "warm_admission requires an idle engine (no live slots, "
                "no pending prefills): its dummy prefills overwrite slot "
                "KV state")
        if not self._batch_admission() or self.serving.prefill_chunk > 0:
            return
        for wl in prompt_lens:
            for w in (sizes or self._wave_sizes()):
                group = [(slot, Request(f"__warm_{wl}_{w}_{slot}", [1] * wl,
                                        1, seed=0)) for slot in range(w)]
                self._first_read_many(
                    [self._first_group(group, self._prefill_group(group))])

    def _advance_prefills(self) -> None:
        """One prompt window per pending slot per round: long prompts
        enter in ``prefill_chunk``-token windows between the grid's
        decode chunks; a slot activates when its last window is in."""
        chunk = self.serving.prefill_chunk
        for slot in sorted(self._pending):
            st = self._pending[slot]
            req, done = st["req"], st["done"]
            t_p = len(req.prompt)
            w = min(chunk, t_p - done)
            window = torch.as_tensor(
                _padded_window(req.prompt[done:done + w]), device=self.device)
            logits = self._window(slot, req, window, w, done)
            st["done"] = done + w
            if st["done"] >= t_p:
                self._store_pending(slot, req)
                del self._pending[slot]
                self._activate(slot, req, logits)

    def _seen_row(self, req: Request) -> np.ndarray:
        row = np.zeros(self.cfg.vocab_size, bool)
        row[np.asarray(req.prompt, np.int64)] = True
        return row

    def _activate(self, slot: int, req: Request, logits) -> None:
        """Sample generation 0 from the prefill logits (one scalar
        readback), then the shared bookkeeping."""
        first = self._first_read_many(
            [self._first_group([(slot, req)], logits[None, :])])[0]
        self._activate_with_first(slot, req, logits, first)

    def _activate_with_first(self, slot: int, req: Request, logits,
                             first: int) -> None:
        self._prefill_extras(slot, req)
        samp = req.sampling or SamplingConfig(temperature=0.0)
        self.temp[slot] = samp.temperature
        self.top_k[slot] = samp.top_k
        self.top_p[slot] = samp.top_p
        self.min_p[slot] = samp.min_p
        self.rep_pen[slot] = samp.repetition_penalty
        self.seeds[slot] = req.seed
        self.prompt_len[slot] = len(req.prompt)
        # seen set: the prompt's tokens plus the first token
        self.presence[slot] = to_device(self._seen_row(req), self.device)
        self.presence[slot, first] = True
        self.slot_lps[slot] = []
        if req.logprobs:
            self.slot_lps[slot].append(float(_raw_token_lp(
                logits, torch.tensor(first, device=self.device))))
        # TTFT: the earliest first token survives a recompute preemption
        clock = self._req_clock.get(req.request_id)
        if clock is not None and "first" not in clock:
            clock["first"] = self._clock()
        self.slot_req[slot] = req
        self._slot_gen[slot] += 1
        self.slot_emitted[slot] = [first]
        self.lengths[slot] = len(req.prompt)
        self.last_token[slot] = first
        active = first != req.eos_id and req.max_new > 1
        self.active[slot] = active
        self._on_admitted(slot, req, first)
        if not active:
            self._finish(slot)

    def _retire(self, emitted, lps_h, owners=None) -> None:
        """Credit a round's emitted tokens (host arrays; the logprobs
        None unless a live request asked for them) to the live slots,
        truncated at each budget and eos. With ``owners`` (the round's
        generation snapshot) a slot re-admitted since the round was
        launched is skipped: its rows belong to the previous tenant."""
        for slot, req in enumerate(self.slot_req):
            if req is None or not self.active[slot]:
                continue
            if owners is not None and owners[slot] != self._slot_gen[slot]:
                continue
            have = self.slot_emitted[slot]
            new = emitted[slot, :req.max_new - len(have)].tolist()
            if req.eos_id is not None and req.eos_id in new:
                new = new[:new.index(req.eos_id) + 1]
            have.extend(new)
            if req.logprobs:
                self.slot_lps[slot].extend(
                    float(v) for v in lps_h[slot, :len(new)])
            if (len(have) >= req.max_new
                    or (req.eos_id is not None and have[-1] == req.eos_id)):
                self._finish(slot)

    def _finish(self, slot: int, reason: Optional[str] = None) -> None:
        req = self.slot_req[slot]
        toks = self.slot_emitted[slot]
        if reason is None:
            reason = ("stop" if req.eos_id is not None and toks
                      and toks[-1] == req.eos_id else "length")
        now = self._clock()
        clock = self._req_clock.pop(req.request_id, None)
        ttft = e2e = None
        if clock is not None:
            ttft = round(clock.get("first", now) - clock["submit"], 6)
            e2e = round(now - clock["submit"], 6)
            # mean inter-token latency over the post-first tokens
            itl = (e2e - ttft) / (len(toks) - 1) if len(toks) > 1 else None
            self._lat_window.append((ttft, e2e, itl))
            self._lat_count += 1
            self._lat_ttft_max = max(self._lat_ttft_max, ttft)
            self._lat_e2e_max = max(self._lat_e2e_max, e2e)
            if itl is not None:
                self._lat_itl_max = max(self._lat_itl_max, itl)
        self.finished.append(Completion(
            request_id=req.request_id, prompt=list(req.prompt),
            tokens=list(toks), finish_reason=reason,
            deadline_exceeded=reason == "deadline_exceeded", ttft_s=ttft,
            e2e_s=e2e,
            logprobs=(list(self.slot_lps[slot][:len(toks)])
                      if req.logprobs else None)))
        self._clear_slot(slot)
        self._release_storage(slot)

    def _clear_slot(self, slot: int) -> None:
        """Reset a slot's host bookkeeping and seen set (no completion,
        no storage release) — retirement and recompute preemption. A
        stale temp > 0 on an idle slot would keep the greedy fast path
        off for every later round."""
        self.slot_req[slot] = None
        self.slot_emitted[slot] = []
        self.slot_lps[slot] = []
        self.active[slot] = False
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        self.min_p[slot] = 0.0
        self.rep_pen[slot] = 1.0
        self.presence[slot] = False

    def _evict_slot(self, slot: int) -> Optional[Request]:
        """Tear a claimed slot down without a completion, an active one
        or a chunked prefill mid-stream; returns its request."""
        if slot in self._pending:
            req = self._pending.pop(slot)["req"]
            self._release_storage(slot)
            return req
        req = self.slot_req[slot]
        if req is None:
            return None
        self._clear_slot(slot)
        self._release_storage(slot)
        return req

    # -- chaos surface -------------------------------------------------

    def inject_slot_failure(self, slot: int, quarantine: bool = True) -> bool:
        """Simulate a slot failure: the slot's in-flight or mid-prefill
        request is requeued at the front for exact recompute (a stream
        is a pure function of request, seed and index, so the replay
        equals the uninterrupted stream), its storage is released, and
        the slot is quarantined from admission until ``restore_slot``.
        Returns whether a request was displaced."""
        if not 0 <= slot < self.serving.max_slots:
            raise ValueError(f"slot {slot} out of range")
        req = self._evict_slot(slot)
        if quarantine:
            self._failed_slots.add(slot)
        self.slot_failures += 1
        metrics.recovery_log().record(
            "slot_failure", slot=slot,
            request=req.request_id if req else None)
        if req is not None:
            self.queue.insert(0, req)
            self.requeues += 1
            metrics.recovery_log().record(
                "slot_requeue", slot=slot, request=req.request_id)
        return req is not None

    def restore_slot(self, slot: int) -> None:
        """Lift a slot's quarantine; it takes requests from the next
        scheduling round on."""
        self._failed_slots.discard(slot)

    def _assert_serviceable(self) -> None:
        """Queued work, nothing in flight and every slot quarantined
        would spin run() forever: raise instead."""
        if (self.queue and not self._pending
                and not any(r is not None for r in self.slot_req)
                and len(self._failed_slots) >= self.serving.max_slots):
            raise RuntimeError(
                f"all {self.serving.max_slots} slots are quarantined with "
                f"{len(self.queue)} request(s) queued; call restore_slot() "
                "or shed the queue")

    def report(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "slots": self.serving.max_slots,
            "active": sum(1 for r in self.slot_req if r is not None),
            "queued": len(self.queue),
            "pending_prefill": len(self._pending),
            "finished": len(self.finished),
            "prefills": self.prefills,
            "prefill_dispatches": self.prefill_dispatches,
            "suffix_windows": self.suffix_windows,
            "waves": dict(sorted(self.wave_sizes.items())),
            "decode_rounds": self.decode_rounds,
        }
        if (self.slot_failures or self.requeues or self.shed
                or self._failed_slots):
            out["chaos"] = {
                "slot_failures": self.slot_failures,
                "requeues": self.requeues,
                "shed": self.shed,
                "quarantined": sorted(self._failed_slots),
            }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.report()
        if self.mesh is not None:
            out["mesh"] = {
                "axes": dict(self.mesh.shape),
                "backend": self.mesh.backend,
                "rounds": ("graphs" if isinstance(self._round,
                                                  graphs.RoundGraphs)
                           else "eager"),
            }
        if self._lat_count:
            ttfts = sorted(t for t, _, _ in self._lat_window)
            e2es = sorted(e for _, e, _ in self._lat_window)
            itls = sorted(i for _, _, i in self._lat_window if i is not None)
            out["latency"] = {
                "completed": self._lat_count,
                "ttft_p50_s": round(ttfts[len(ttfts) // 2], 4),
                "ttft_max_s": round(self._lat_ttft_max, 4),
                "e2e_p50_s": round(e2es[len(e2es) // 2], 4),
                "e2e_max_s": round(self._lat_e2e_max, 4),
            }
            if itls:
                out["latency"]["itl_p50_s"] = round(itls[len(itls) // 2], 4)
                out["latency"]["itl_max_s"] = round(self._lat_itl_max, 4)
        return out

    def reset_latency(self) -> None:
        """Discard the latency aggregates (e.g. after warm-up requests
        whose latency is build time, not serving time)."""
        self._lat_window.clear()
        self._lat_count = 0
        self._lat_ttft_max = 0.0
        self._lat_e2e_max = 0.0
        self._lat_itl_max = 0.0


class PagedServingEngine(ServingEngine):
    """Continuous batching over a paged KV pool (models/paged.py).

    Same scheduler, sampling and exactness contracts as the dense grid;
    KV memory scales with tokens in flight (``paged_blocks x
    block_size`` positions shared by all slots). Blocks are allocated
    at chunk boundaries; pool exhaustion first evicts prefix-cache
    entries, then preempts the YOUNGEST slot (recompute: its request is
    requeued at the front and replays its exact stream).
    ``paged_kernel`` selects the CUDA paged-attention tier (blocks read
    through the table, no gathered view); otherwise each round gathers
    a dense view of the pool. A prefix-cache hit points the slot's
    table at the stored blocks (refcounted, no copy).
    """

    def _init_storage(self) -> None:
        from kind_tpu_sim_torch.models import paged

        cfg, serving = self.cfg, self.serving
        if serving.paged_blocks < 2:
            raise ValueError(
                "PagedServingEngine needs ServingConfig.paged_blocks >= 2 "
                "(block 0 is the garbage sink)")
        if serving.overlap_rounds:
            raise ValueError(
                "overlap_rounds is dense/spec-grid only: the paged block "
                "accounting (_ensure_blocks) host-syncs on occupancy every "
                "round, so there is no RTT to hide and preemption between "
                "a dispatched round and its retire is not composed")
        if serving.paged_kernel and cfg.int8_kv:
            raise ValueError(
                "paged_kernel needs bf16 pools; int8_kv uses the gather "
                "tier")
        self.pools = paged.init_pools(cfg, serving.paged_blocks,
                                      serving.block_size, device=self.device)
        self.alloc = paged.BlockAllocator(serving.paged_blocks)
        self.slot_blocks: List[List[int]] = [[] for _ in
                                             range(serving.max_slots)]
        self.slot_admit_seq = [0] * serving.max_slots
        self._admit_counter = 0
        self.preemptions = 0
        self.prefix_cache = (
            paged.PagedPrefixCache(serving.prefix_cache_entries, self.alloc,
                                   serving.block_size)
            if serving.prefix_cache_entries > 0 else None)
        chunk_fn = (paged.paged_decode_chunk_kernel if serving.paged_kernel
                    else paged.paged_decode_chunk)
        self._paged_chunk = functools.partial(chunk_fn, cfg=cfg,
                                              chunk=serving.chunk)

    def _capacity_check(self, request: Request) -> None:
        cap = (self.serving.paged_blocks - 1) * self.serving.block_size
        need = len(request.prompt) + request.max_new
        if need > cap:
            raise ValueError(
                f"request {request.request_id} needs {need} positions; "
                f"pool capacity is {cap}")

    def _can_admit(self, request: Request, reserved: int = 0) -> bool:
        """The cache-miss need plus this round's reservations; under
        pressure, prefix-cache entries are evicted first, so cache-held
        blocks never starve admission."""
        from kind_tpu_sim_torch.models import paged

        need = reserved + paged.blocks_needed(len(request.prompt),
                                              self.serving.block_size)
        while need > self.alloc.free_blocks:
            if (self.prefix_cache is None
                    or not self.prefix_cache.evict_lru()):
                return False
        return True

    def _reserve_claim(self, request: Request) -> int:
        # the cache-miss worst case: a hit allocates fewer, which only
        # makes the gate conservative
        from kind_tpu_sim_torch.models import paged

        return paged.blocks_needed(len(request.prompt),
                                   self.serving.block_size)

    def _claim_pending(self, slot: int, req: Request) -> int:
        """Allocate the whole prompt's blocks up front (_can_admit gated
        the need); a prefix hit shares the stored blocks instead of the
        first ones and returns their (block-aligned) length."""
        from kind_tpu_sim_torch.models import paged

        t_p = len(req.prompt)
        bsz = self.serving.block_size
        self._admit_counter += 1
        self.slot_admit_seq[slot] = self._admit_counter
        hit = (self.prefix_cache.lookup(req.prompt)
               if self.prefix_cache is not None else None)
        base = hit["len"] if hit is not None else 0
        n = paged.blocks_needed(t_p - base, bsz)
        own = self.alloc.alloc(n)
        if own is None:
            raise RuntimeError(
                f"paged claim for {req.request_id!r}: {n}-block allocation "
                "failed after _can_admit passed — admission reservation "
                "accounting is broken")
        if hit is None:
            self.slot_blocks[slot] = own
            return 0
        self.alloc.share(hit["blocks"])
        self.slot_blocks[slot] = list(hit["blocks"]) + own
        return base

    def _table_row(self, slot: int) -> torch.Tensor:
        blocks = self.slot_blocks[slot]
        table_row = np.zeros(self._table_width(len(blocks)), np.int32)
        table_row[:len(blocks)] = blocks
        return torch.as_tensor(table_row, device=self.device)

    def _prefill_window(self, slot: int, req: Request, window, w: int,
                        done: int):
        """One prompt window through the block pool: the paged prefill
        at done 0, the suffix forward against the slot's [0, done)
        blocks after it."""
        from kind_tpu_sim_torch.models import paged

        if done == 0:
            return paged.paged_prefill(self.params, self.pools, window, w,
                                       self._table_row(slot), cfg=self.cfg)
        return paged.paged_suffix(self.params, self.pools, window, w, done,
                                  self._table_row(slot), cfg=self.cfg)

    def _batch_admission(self) -> bool:
        # a fixed table width makes the stacked rows one shape
        return bool(self.serving.paged_width)

    def _prefill_group(self, group):
        """Storage half of an admission wave, paged: the stacked
        whole-prompt prefill into each slot's claimed blocks through
        fixed-width table rows."""
        toks = np.stack([_padded_window(req.prompt)[0] for _, req in group])
        tables = np.zeros((len(group), self.serving.paged_width), np.int32)
        for i, (slot, _) in enumerate(group):
            blocks = self.slot_blocks[slot]
            self._table_width(len(blocks))  # loud overflow check
            tables[i, :len(blocks)] = blocks
        from kind_tpu_sim_torch.models import paged

        return paged.paged_prefill_many(
            self.params, self.pools, torch.as_tensor(toks, device=self.device),
            [len(req.prompt) for _, req in group],
            torch.as_tensor(tables, device=self.device), cfg=self.cfg)

    def _wave_share_hit(self, stored_prompt, prompt) -> bool:
        # block-granular sharing: a pending store serves this claim if
        # they share the first full block
        bsz = self.serving.block_size
        return (len(stored_prompt) >= bsz and len(prompt) >= bsz
                and stored_prompt[:bsz] == prompt[:bsz])

    def _store_pending(self, slot: int, req: Request) -> None:
        if req.cache_prefix and self.prefix_cache is not None:
            # share the slot's blocks: they hold the whole prompt now
            self.prefix_cache.store(req.prompt, self.slot_blocks[slot])

    def _release_storage(self, slot: int) -> None:
        self.alloc.free(self.slot_blocks[slot])
        self.slot_blocks[slot] = []

    def _preempt_youngest(self) -> bool:
        """Evict the most recently admitted slot, active or mid chunked
        prefill (a pending slot holds its prompt's blocks too), free its
        blocks and requeue its request AT THE FRONT for exact
        recompute."""
        candidates = [(self.slot_admit_seq[s], s)
                      for s, r in enumerate(self.slot_req) if r is not None]
        candidates += [(self.slot_admit_seq[s], s) for s in self._pending]
        if not candidates:
            return False
        _, slot = max(candidates)
        self.queue.insert(0, self._evict_slot(slot))
        self.preemptions += 1
        return True

    def _ensure_blocks(self, extend_by: int, occupancy) -> None:
        """Grow each active slot's block list to cover its next
        ``extend_by`` writes past ``occupancy[slot]`` (host integers:
        the chunk engine's lengths, the speculative engine's totals),
        capped at the request's total need, so a final round's
        overshoot never allocates (those writes land in last-block
        slack or the garbage block). Under pool pressure,
        reclaim the cheapest first: prefix-cache entries (a future
        recompute), then the youngest slot (work already done); the
        capacity check guarantees a lone surviving slot always fits."""
        from kind_tpu_sim_torch.models import paged

        bsz = self.serving.block_size
        while True:
            shortfalls = {}
            for s, req in enumerate(self.slot_req):
                if req is None or not self.active[s]:
                    continue
                cover = min(int(occupancy[s]) + extend_by,
                            len(req.prompt) + req.max_new)
                need = (paged.blocks_needed(cover, bsz)
                        - len(self.slot_blocks[s]))
                if need > 0:
                    shortfalls[s] = need
            if sum(shortfalls.values()) <= self.alloc.free_blocks:
                break
            if (self.prefix_cache is not None
                    and self.prefix_cache.evict_lru()):
                continue
            if not self._preempt_youngest():
                break
        for s, need in shortfalls.items():
            got = self.alloc.alloc(need)
            if got is None:
                raise RuntimeError("paged pool exhausted after preemption")
            self.slot_blocks[s].extend(got)

    def _table_width(self, n_blocks: int) -> int:
        """Fixed (``paged_width``) or power-of-two bucketed width; a slot
        outgrowing a fixed width fails loudly instead of writing to the
        garbage block."""
        from kind_tpu_sim_torch.models import paged

        if self.serving.paged_width:
            if n_blocks > self.serving.paged_width:
                raise ValueError(
                    f"slot needs {n_blocks} blocks; paged_width is fixed "
                    f"at {self.serving.paged_width}")
            return self.serving.paged_width
        return paged.width_bucket(n_blocks)

    def _build_tables(self) -> np.ndarray:
        width = self._table_width(
            max((len(b) for b in self.slot_blocks), default=1) or 1)
        tables = np.zeros((self.serving.max_slots, width), np.int32)
        for s, blks in enumerate(self.slot_blocks):
            tables[s, :len(blks)] = blks
        return tables

    def _decode_round(self):
        chunk = self.serving.chunk
        self._ensure_blocks(chunk, self.lengths)
        if not any(r is not None for r in self.slot_req):
            # preemption emptied the grid
            n = self.serving.max_slots
            return (torch.zeros((n, chunk), dtype=torch.long,
                                device=self.device),
                    torch.zeros((n, chunk), device=self.device))
        lengths, active = self._device_vectors()
        tables = self._in.tables(self._build_tables())
        sampling = self._round_sampling()
        emitted, lps = self._round(
            ("paged chunk", chunk, tables.shape[1], sampling is not None),
            functools.partial(self._paged_chunk, self.params, self.pools,
                              tables, lengths, self.last_token, active,
                              sampling, self.presence))
        self._advance_lengths()
        return emitted, lps

    def report(self) -> Dict[str, Any]:
        out = super().report()
        out["paged"] = {
            "blocks": self.serving.paged_blocks,
            "block_size": self.serving.block_size,
            "blocks_in_use": (self.serving.paged_blocks - 1
                              - self.alloc.free_blocks),
            "peak_in_use": self.alloc.peak_in_use,
            "preemptions": self.preemptions,
        }
        return out


class _Speculative:
    """What the two speculative engines share: the slot's token buffer
    (``out`` / ``total``, seeded at admission), the penalty refusal and
    the ragged retire. ``out`` rows hold prompt + emitted tokens, with
    room past the budget for a scan's surplus windows."""

    _speculative = True

    def _check_spec(self) -> None:
        if self.serving.speculative_k < 1:
            raise ValueError(f"{type(self).__name__} needs "
                             "ServingConfig.speculative_k >= 1")
        if self.serving.spec_windows < 1:
            raise ValueError("spec_windows must be >= 1")

    def _init_spec_state(self, rows: int) -> None:
        n = self.serving.max_slots
        self._rows = rows
        self.out = torch.zeros((n, rows), dtype=torch.long,
                               device=self.device)
        self.total = torch.zeros(n, dtype=torch.long, device=self.device)
        # the totals as of the last retire, for block accounting
        self._total_host = np.zeros(n, np.int64)
        self.verify_steps = 0

    def _check_sampling(self, samp: SamplingConfig) -> None:
        if samp.repetition_penalty != 1.0:
            raise ValueError(
                "repetition_penalty is not supported by the speculative "
                "engines yet (the verify window's acceptance math has no "
                "in-window presence state); use the chunked engines")

    def _on_admitted(self, slot: int, request: Request, first: int) -> None:
        t_p = len(request.prompt)
        row = np.zeros(self._rows, np.int64)
        row[:t_p] = request.prompt
        row[t_p] = first
        self.out[slot] = to_device(row, self.device)
        self.total[slot] = t_p + 1
        self._total_host[slot] = t_p + 1

    def _round_min_tokens(self) -> int:
        # every verify window delivers at least its bonus token
        return self.serving.spec_windows

    def _round_retire(self, handles) -> None:
        staged, owners = handles
        emits, ms, total, lps = self._fetch(staged)
        self._total_host = total
        self._spec_retire(emits, ms, lps, owners)
        self._expire_deadlines()

    def _spec_retire(self, emits, ms, lps_h, owners=None) -> None:
        """Ragged retirement of a scanned verify dispatch (host arrays
        emits (W, b, k+1), ms (W, b), lps (W, b, k+1) or None): each
        live slot takes its accepted drafts plus bonus per window,
        truncated at its budget and eos; a slot that finished in window
        w drops its later windows' surplus. ``verify_steps`` counts the
        windows that delivered a token to some slot."""
        used = 0
        for slot, req in enumerate(self.slot_req):
            if req is None or not self.active[slot]:
                continue
            if owners is not None and owners[slot] != self._slot_gen[slot]:
                continue
            have = self.slot_emitted[slot]
            for w in range(emits.shape[0]):
                budget = req.max_new - len(have)
                if budget <= 0:
                    break
                new = emits[w, slot, :int(ms[w, slot]) + 1][:budget].tolist()
                if req.eos_id is not None and req.eos_id in new:
                    new = new[:new.index(req.eos_id) + 1]
                have.extend(new)
                if req.logprobs:
                    self.slot_lps[slot].extend(
                        float(v) for v in lps_h[w, slot, :len(new)])
                used = max(used, w + 1)
                if req.eos_id is not None and have[-1] == req.eos_id:
                    break
            if (len(have) >= req.max_new
                    or (req.eos_id is not None and have[-1] == req.eos_id)):
                self._finish(slot)
        self.verify_steps += used


class SpeculativeServingEngine(_Speculative, ServingEngine):
    """Continuous batching with speculative decoding per slot (the vLLM
    speculative + continuous-batching composition) over a dense grid.

    Each round scans ``spec_windows`` verify windows over the whole
    grid (``speculative._grid_verify_scan``): every active slot drafts
    ``speculative_k`` tokens from its own buffer, each window is
    verified in one forward, and each slot keeps its longest
    model-agreeing prefix plus a bonus token, 1 to k+1 tokens a window.
    Admission and retirement run between rounds. Greedy requests are
    argmax-verified, so their streams equal the dense grid's and the
    solo decoder's; sampled requests use rejection sampling against the
    per-request filtered target distribution, a pure function of
    (request, seed).

    ``draft=(draft_params, draft_cfg)`` (the fourth argument, as in the
    reference) swaps prompt lookup for a draft model with the target's
    vocab: k+1 greedy steps a window over its own per-slot cache.
    Cache rows are ``max_len + spec_windows * (k + 1)``: a slot that
    finishes mid-scan keeps writing until the scan ends. Prefix caching
    and chunked prefill compose unchanged.
    """

    def __init__(self, params: Params, cfg: ModelConfig,
                 serving: ServingConfig = ServingConfig(), draft=None, *,
                 device="cuda", clock=None, mesh=None):
        self._draft = draft
        super().__init__(params, cfg, serving, device=device, clock=clock,
                         mesh=mesh)

    def _init_storage(self) -> None:
        cfg, serving = self.cfg, self.serving
        self._check_spec()
        if serving.paged_blocks or serving.paged_kernel:
            raise ValueError(
                "SpeculativeServingEngine ignores paged_blocks/paged_kernel;"
                " construct PagedSpeculativeServingEngine")
        k, W = serving.speculative_k, serving.spec_windows
        self._init_spec_state(serving.max_len + W * (k + 1))
        n = self._storage_slots()
        self.cache = init_cache(cfg, n, self._rows, device=self.device)
        self.draft_prefills = 0
        if self._draft is not None:
            dparams, dcfg = self._draft
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}")
            _check_slice(dcfg, serving, self.mesh)
            if dparams["embed"].device.type != self.device.type:
                raise ValueError(
                    f"draft params live on {dparams['embed'].device}; the "
                    f"engine runs on {self.device}")
            if self.mesh is not None:
                self._draft = (shard_params(dparams, dcfg, self.mesh), dcfg)
            self.draft_cache = init_cache(dcfg, n, self._rows,
                                          device=self.device)
        self.prefix_cache = (PrefixCache(serving.prefix_cache_entries)
                             if serving.prefix_cache_entries > 0 else None)

    def _prefill_extras(self, slot: int, req: Request) -> None:
        if self._draft is not None:
            # the draft model's own prompt k/v (a small model: one
            # prefill a slot, on every admission path)
            dparams, dcfg = self._draft
            window = torch.as_tensor(_padded_window(req.prompt),
                                     device=self.device)
            _prefill_into_slot(dparams, self.draft_cache, window,
                               len(req.prompt), self._row(slot), cfg=dcfg)
            self.draft_prefills += 1

    def _round_dispatch(self):
        """One scanned verify dispatch for the grid; returns (staged
        readback, generation snapshot) or None when no slot is live."""
        from kind_tpu_sim_torch.models import speculative as spec

        if not any(r is not None for r in self.slot_req):
            return None
        k, W = self.serving.speculative_k, self.serving.spec_windows
        active = self._mine(self._in.fill(self._in.active, self.active))
        sampling = self._mine(self._round_sampling())
        out, total = self._mine(self.out), self._mine(self.total)
        if self._draft is None:
            fn = functools.partial(
                spec._grid_verify_scan, self.params, self._local(self.cache),
                out, total, active, sampling, cfg=self.cfg, k=k, windows=W)
        else:
            dparams, dcfg = self._draft
            fn = functools.partial(
                spec._grid_draft_verify_scan, self.params, dparams,
                self._local(self.cache), self._local(self.draft_cache), out,
                total, active, sampling, cfg=self.cfg, dcfg=dcfg, k=k,
                windows=W)
        key = ("verify", k, W, sampling is not None)
        if self._data is None:
            emits, ms, lps = self._round(key, fn)
        else:
            # the totals ride along: each data rank advanced only its own
            emits, ms, lps, total = self._round(key, self._gathered(
                lambda: (*fn(), total), (1, 1, 1, 0)))
        return (self._stage(emits, ms, total, lps),
                list(self._slot_gen))

    def report(self) -> Dict[str, Any]:
        out = super().report()
        out["speculative"] = {
            "draft_k": self.serving.speculative_k,
            "verify_steps": self.verify_steps,
            "proposer": ("draft-model" if self._draft is not None
                         else "prompt-lookup"),
        }
        if self._draft is not None:
            # draft-model prompt prefills (one per admission), each a
            # flash launch per draft layer when the draft sets flash
            out["draft_prefills"] = self.draft_prefills
        return out


class PagedSpeculativeServingEngine(_Speculative, PagedServingEngine):
    """Speculative decoding over paged storage: continuous batching,
    paged KV, verify windows and greedy-exact or rejection-sampled
    acceptance in one engine. Each window gathers the block view once
    (``paged.paged_verify_step``) and scatters its k/v into each slot's
    blocks; block growth covers a whole round's ``spec_windows *
    (k + 1)`` positions past each slot's total up front. Growth,
    recompute preemption, pressure eviction and block-granular prefix
    sharing are ``PagedServingEngine``'s. The verify window reads the
    gather view, so ``paged_kernel`` is refused, as the reference
    refuses it.
    """

    def _init_storage(self) -> None:
        serving = self.serving
        self._check_spec()
        if serving.paged_kernel:
            raise ValueError(
                "paged_kernel applies to the chunked decode path; the "
                "verify window uses the gather tier")
        super()._init_storage()
        k, W = serving.speculative_k, serving.spec_windows
        cap = (serving.paged_blocks - 1) * serving.block_size
        # every scanned window's write (to total + W*(k+1)) and the emit
        # write stay inside the row
        self._init_spec_state(cap + W * (k + 1))

    def _round_dispatch(self):
        """Grow the blocks for a whole round, then one paged verify
        scan; returns (staged readback, generation snapshot) or None."""
        from kind_tpu_sim_torch.models import paged

        if not any(r is not None for r in self.slot_req):
            return None
        k, W = self.serving.speculative_k, self.serving.spec_windows
        self._ensure_blocks(W * (k + 1), self._total_host)
        if not any(r is not None for r in self.slot_req):
            return None  # preemption emptied the grid
        tables = self._in.tables(self._build_tables())
        active = self._in.fill(self._in.active, self.active)
        sampling = self._round_sampling()
        emits, ms, lps = self._round(
            ("paged verify", k, W, tables.shape[1], sampling is not None),
            functools.partial(paged.paged_verify_scan, self.params,
                              self.pools, tables, self.out, self.total,
                              active, sampling, cfg=self.cfg, k=k,
                              windows=W))
        return (self._stage(emits, ms, self.total, lps),
                list(self._slot_gen))

    def report(self) -> Dict[str, Any]:
        out = super().report()
        out["speculative"] = {
            "draft_k": self.serving.speculative_k,
            "verify_steps": self.verify_steps,
        }
        return out


def _report_setup(cfg, device):
    from kind_tpu_sim_torch.models import transformer as tf

    dev = resolve(device)
    cfg = cfg or tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_seq=64)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    return cfg, params, dev


def engines_report(cfg: ModelConfig = None, device="cuda") -> Dict[str, Any]:
    """One smoke over the whole serving matrix: the same greedy request
    stream through the dense grid, chunked prefill, paged, speculative,
    paged speculative and paged speculative with chunked prefill must
    emit identical streams. Random weights from a seeded
    ``torch.Generator``."""
    cfg, params, dev = _report_setup(cfg, device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=4 + 3 * i).tolist()
               for i in range(3)]

    def run(engine, **knobs):
        eng = engine(params, cfg, ServingConfig(max_slots=2, max_len=48,
                                                **knobs), device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(f"e{i}", p, max_new=6))
        return {c.request_id: tuple(c.tokens) for c in eng.run()}

    paged = dict(paged_blocks=12, block_size=8)
    outs = {
        "grid": run(ServingEngine, chunk=8),
        "grid_chunked_prefill": run(ServingEngine, chunk=8, prefill_chunk=8),
        "paged": run(PagedServingEngine, chunk=8, **paged),
        "spec": run(SpeculativeServingEngine, speculative_k=3),
        "paged_spec": run(PagedSpeculativeServingEngine, speculative_k=3,
                          **paged),
        "paged_spec_chunked": run(PagedSpeculativeServingEngine,
                                  speculative_k=3, prefill_chunk=8,
                                  **paged),
    }
    agree = all(o == outs["grid"] for o in outs.values())
    return {"engines": sorted(outs), "requests": len(prompts),
            "all_streams_identical": bool(agree), "ok": bool(agree)}


def serving_report(cfg: ModelConfig = None, max_slots: int = 2,
                   device="cuda") -> Dict[str, Any]:
    """Smoke and contract check of the continuous-batching engine: a
    mixed greedy and sampled workload with more requests than slots
    drains completely, and the greedy request equals its solo
    decode."""
    from kind_tpu_sim_torch.models import decode

    cfg, params, dev = _report_setup(cfg, device)
    sc = ServingConfig(max_slots=max_slots, max_len=48, chunk=8)
    eng = ServingEngine(params, cfg, sc, device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=4 + i).tolist()
               for i in range(2 * max_slots)]
    for i, p in enumerate(prompts):
        samp = SamplingConfig(temperature=1.2) if i % 2 else None
        eng.submit(Request(f"r{i}", p, max_new=6, sampling=samp, seed=i))
    by_id = {c.request_id: c for c in eng.run()}
    solo = decode.greedy_generate(params, cfg, [prompts[0]], 6,
                                  chunk=sc.chunk, device=dev)
    greedy_exact = by_id["r0"].tokens == solo[0, len(prompts[0]):].tolist()
    all_done = len(by_id) == len(prompts) and all(
        len(c.tokens) == 6 for c in by_id.values())
    ok = bool(greedy_exact and all_done)
    return {"requests": len(prompts), "slots": max_slots,
            "greedy_exact": bool(greedy_exact), "all_finished": bool(all_done),
            "ok": ok}
