"""Autoregressive decoding with a static, chunked KV cache, in PyTorch.

Counterpart of ``kind_tpu_sim/models/decode.py``. A batched prefill
fills a preallocated (batch, max_len) cache in one forward, then
generation runs in chunks: within a chunk the big cache is only read,
new k/v gather in a small chunk buffer, and one merge per chunk writes
them back. Each token attends over three exactly-partitioned score
groups — big cache (< chunk base), chunk buffer (earlier in-chunk
tokens) and its own in-flight k/v — concatenated into one softmax, so
the numerics (and the bf16 rounding of each group's PV product) match
the JAX package step for step.

The JAX package's ``lax.scan`` loops are Python loops here, and the
cache and chunk buffers, which JAX donates and rewrites, are updated
in place.

Numerical contract (dense configs): a token generated through the
cache path equals the argmax of the full (uncached) forward at that
position. Two carve-outs, as in the JAX package: MoE (routing capacity
counts the tokens of the current call: the slots of a decode step
against the whole prompt of the forward) and ``int8_kv`` (in-chunk
tokens are attended from the bf16 chunk buffer, merged ones at int8).
With ``ModelConfig.int8_kv`` the big cache holds int8 rows with one
fp32 scale per (batch, position, kv head) row (``QuantArray``); its
scores and values take the dequant path or, with ``int8_native``, the
exact int8 product of ``ops/int8_matmul.py``.

Sampling draws its Gumbel noise from a counter-based integer hash of
(seed, generation index[, batch row]) computed on the device
(``_counter_uniform``), not from ``jax.random``: sampled streams are
reproducible and valid, not JAX's tokens; greedy streams equal JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from kind_tpu_sim_torch.device import resolve, to_device, torch_dtype
from kind_tpu_sim_torch.models.quant import (
    QuantArray,
    embed_lookup,
    linear,
    quant_rows,
    quantize,
)
from kind_tpu_sim_torch.models.transformer import (
    ModelConfig,
    Params,
    _block_core,
    _mlp,
    _readout,
    _rms_norm,
    _rotary,
    _split_qkv,
    local_heads,
)
from kind_tpu_sim_torch.ops.int8_matmul import int8_matmul

NEG = -1e30


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """Copy of ``params`` with every leaf of two or more dimensions
    (matmul weights, embedding, MoE experts) cast to the activation
    dtype; norm scales and the MoE router stay fp32, int8 QuantArrays
    stay as they are. The readout follows the embedding's dtype, so a
    bf16 snapshot's logits come from bf16 weights (accumulated in
    fp32). Every leaf is detached, so a snapshot of parameters that a
    train step left requiring grad carries no autograd history."""
    dtype = torch_dtype(cfg.dtype)

    def cast(node, name=None):
        if isinstance(node, QuantArray):
            return node
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        node = node.detach()
        return node.to(dtype) if node.ndim >= 2 and name != "router" else node

    return cast(params)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Preallocated per-layer KV cache, (batch, max_len, kv, hd) in the
    activation dtype; with ``cfg.int8_kv`` each k/v is a QuantArray of
    int8 zeros with fp32 scales of one per (batch, position, kv head)
    row. Under a tensor-parallel scope kv is this rank's KV heads."""
    dev = resolve(device)
    shape = (batch, max_len, local_heads(cfg)[1], cfg.head_dim)
    if cfg.int8_kv:
        def qzeros():
            return QuantArray(
                q=torch.zeros(shape, dtype=torch.int8, device=dev),
                scale=torch.ones(shape[:3] + (1,), device=dev))

        return [{"k": qzeros(), "v": qzeros()} for _ in range(cfg.n_layers)]
    dtype = torch_dtype(cfg.dtype)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _map_kv(arr, fn):
    """``fn`` applied to a cache tensor, or to both parts of an int8
    one (q and its per-row scale share the cache's geometry)."""
    if isinstance(arr, QuantArray):
        return QuantArray(q=fn(arr.q), scale=fn(arr.scale))
    return fn(arr)


def _write(arr, index, upd, keep=None) -> None:
    """``arr[index] = upd`` in place, ``upd`` (..., kv, hd) in the
    activation dtype: the one write of k/v rows into a cache or pool.
    An int8 cache gets ``upd`` quantized per (..., kv) row, its q and
    scale written at the same index. With ``keep`` (a mask that
    broadcasts over ``upd``), entries where it is False keep their
    bytes."""
    if isinstance(arr, QuantArray):
        qa = quantize(upd, axis=-1)
        pairs = ((arr.q, qa.q), (arr.scale, qa.scale))
    else:
        pairs = ((arr, upd.to(arr.dtype)),)
    for dst, src in pairs:
        if keep is not None:
            src = torch.where(keep, src, dst[index])
        dst[index] = src


def _store(cache_arr, update, start) -> None:
    """Write ``update`` (b, t, kv, hd) into ``cache_arr`` at sequence
    position ``start``, in place, quantizing per (b, t, kv) row when the
    cache is int8. The start is clamped so the window fits, as
    ``lax.dynamic_update_slice`` clamps it. ``start`` is an int, or a
    (1,) device tensor (a compiled decode program's buffer), which is
    read on the device only."""
    t = update.shape[1]
    limit = cache_arr.shape[1] - t
    if isinstance(start, torch.Tensor):
        rows = start.clamp(0, limit) + torch.arange(t, device=start.device)
        _write(cache_arr, (slice(None), rows), update)
        return
    start = max(0, min(int(start), limit))
    _write(cache_arr, (slice(None), slice(start, start + t)), update)


def _fold(x):
    """(b, w, kv, m, n) -> (b, kv, w*m, n): a verify window's positions
    folded into the rows of one batched product per (b, kv); a 4-D
    (b, kv, m, n) stays as it is."""
    if x.dim() == 4:
        return x
    b, w, kv, m, n = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b, kv, w * m, n)


def _unfold(y, like):
    """``_fold``'s inverse for a product y (b, kv, w*m, n2) of a folded
    ``like`` (b, w, kv, m, n)."""
    if like.dim() == 4:
        return y
    b, w, kv, m, _ = like.shape
    return y.reshape(b, kv, w, m, y.shape[-1]).permute(0, 2, 1, 3, 4)


def _row_scales(cache_arr, ndim: int):
    """An int8 cache's per-row scales (b, s, kv, 1) as (b, [1,] kv, 1, s),
    to multiply scores or probs of ``ndim`` dimensions."""
    row = cache_arr.scale[..., 0].transpose(1, 2)[:, :, None, :]
    return row if ndim == 4 else row[:, None]


def _cache_scores(qg, cache_k, scale, native=False):
    """Scores of qg (b, [w,] kv, g, hd) against a cache (b, s, kv, hd),
    plain or int8: fp32 (b, [w,] kv, g, s). Plain: accumulated in fp32
    from the stored values. int8 dequant: the fp32 product of the
    cast values, then the per-row scale. int8 native (W8A8): qg
    quantized per row and the exact int32 product against the cache's
    int8 rows, read in place."""
    if isinstance(cache_k, QuantArray):
        row = _row_scales(cache_k, qg.dim())
        if native:
            qq, qs = quant_rows(qg)
            acc = _unfold(int8_matmul(_fold(qq),
                                      cache_k.q.permute(0, 2, 3, 1)), qg)
            return acc.float() * (qs * scale) * row
        return torch.einsum("b...kgd,bskd->b...kgs", qg.float(),
                            cache_k.q.float()) * scale * row
    return torch.einsum("b...kgd,bskd->b...kgs", qg.float(),
                        cache_k.float()) * scale


def _cache_values(probs, cache_v, dtype, native=False):
    """probs (b, [w,] kv, g, s) fp32 x a cache's values (b, s, kv, hd) ->
    (b, [w,] kv, g, hd) in ``dtype``. Plain: probs rounded to the value
    dtype, the product rounded to it, as the JAX einsum does. int8: the
    per-row value scale folds into probs first; then the product of
    probs in ``dtype`` with the cast values, or (native) probs quantized
    per row and the exact int32 product, its row scale after."""
    if isinstance(cache_v, QuantArray):
        p = probs * _row_scales(cache_v, probs.dim())
        if native:
            pq, ps = quant_rows(p)
            acc = _unfold(int8_matmul(_fold(pq),
                                      cache_v.q.permute(0, 2, 1, 3)), p)
            return (acc.float() * ps).to(dtype)
        return torch.einsum("b...kgs,bskd->b...kgd", p.to(dtype).float(),
                            cache_v.q.float()).to(dtype)
    return torch.einsum("b...kgs,bskd->b...kgd", probs.to(dtype).float(),
                        cache_v.float()).to(dtype)


def _attend_token(x, bparams, cfg: ModelConfig, positions):
    """Shared decode-step front half for ONE token per row: norm, qkv
    projection, rotary. Returns qg (b, kv, group, hd) and k1/v1
    (b, 1, kv, hd)."""
    b = x.shape[0]
    h = _rms_norm(x, bparams["attn_norm"])
    q, k, v = _split_qkv(linear(h, bparams["wqkv"], native=cfg.int8_native,
                                parallel="column"), cfg, b, 1)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    heads, kv = local_heads(cfg)
    return q.reshape(b, kv, heads // kv, cfg.head_dim), k, v


def _finish_block(x, attn, bparams, cfg: ModelConfig):
    """Shared decode-step back half: output projection + MLP or MoE. x
    is (b, d), or (b, w, d) for a verify window; an MoE routes each
    position over the rows (the reference's vmap over w)."""
    x = x + linear(attn, bparams["wo"], native=cfg.int8_native,
                   parallel="row")
    return x + _mlp(_rms_norm(x, bparams["mlp_norm"]), bparams, cfg,
                    "columns")[0]


def _block_decode(x, bparams, cfg: ModelConfig, layer_cache, pos: int):
    """One block for one token at position ``pos``. The cache is read
    stale (positions < pos) and the in-flight token's k/v attend
    directly; the cache row at ``pos`` is written afterwards, in place."""
    b = x.shape[0]
    dtype = torch_dtype(cfg.dtype)
    positions = torch.full((b, 1), pos, device=x.device)
    qg, k, v = _attend_token(x, bparams, cfg, positions)
    scale = cfg.head_dim ** -0.5
    max_len = layer_cache["k"].shape[1]
    valid = torch.arange(max_len, device=x.device) < pos
    native = cfg.int8_native
    sc_past = _cache_scores(qg, layer_cache["k"], scale,
                            native).masked_fill(~valid[None, None, None, :],
                                                NEG)
    scores = torch.cat([sc_past, _cache_scores(qg, k, scale)], -1)
    probs = torch.softmax(scores, dim=-1)
    attn = (_cache_values(probs[..., :max_len], layer_cache["v"], dtype,
                          native)
            + _cache_values(probs[..., max_len:], v, dtype)
            ).reshape(b, -1)
    _store(layer_cache["k"], k, pos)
    _store(layer_cache["v"], v, pos)
    return _finish_block(x, attn, bparams, cfg), layer_cache


def _reset_cache(cache) -> None:
    """Set a cache to what ``init_cache`` makes, in place: zeros (an
    int8 cache's scales ones)."""
    for layer_cache in cache:
        for arr in layer_cache.values():
            if isinstance(arr, QuantArray):
                arr.q.zero_()
                arr.scale.fill_(1.0)
            else:
                arr.zero_()


def prefill(params: Params, cfg: ModelConfig, prompt, max_len: int,
            cache=None):
    """prompt (b, t_p) -> (last-position logits (b, vocab), filled
    cache) in one batched forward over the whole prompt. With ``cache``
    (of ``init_cache(cfg, b, max_len)``'s shapes) that cache is reset and
    filled in place, the one a compiled program keeps at its address."""
    b, t_p = prompt.shape
    positions = torch.arange(t_p, device=prompt.device).expand(b, t_p)
    x = embed_lookup(params["embed"], prompt, torch_dtype(cfg.dtype))
    if cache is None:
        cache = init_cache(cfg, b, max_len, device=prompt.device)
    else:
        _reset_cache(cache)
    for bparams, layer_cache in zip(params["blocks"], cache):
        x, _, k, v = _block_core(x, bparams, cfg, positions)
        _store(layer_cache["k"], k, 0)
        _store(layer_cache["v"], v, 0)
    last = _rms_norm(x[:, -1, :], params["final_norm"])
    return _readout(last, params["embed"], cfg.int8_native), cache


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, token, cache, pos: int):
    """token (b,) integer at position ``pos`` -> (fp32 logits
    (b, vocab), cache); the cache is written in place."""
    x = embed_lookup(params["embed"], token, torch_dtype(cfg.dtype))
    for bparams, layer_cache in zip(params["blocks"], cache):
        x, _ = _block_decode(x, bparams, cfg, layer_cache, pos)
    x = _rms_norm(x, params["final_norm"])
    return _readout(x, params["embed"], cfg.int8_native), cache


def _block_decode_chunk(x, bparams, cfg: ModelConfig, big, small, base, i):
    """One block for one token inside a decode chunk. ``big`` (the full
    cache, positions < ``base``) is only read; ``small`` is the chunk
    buffer holding positions base..base+i-1 and gets this token's k/v
    at index i, in place. ``base`` is an int (solo decoder) or a (b,)
    tensor of per-slot occupancies (the serving grid)."""
    b = x.shape[0]
    dtype = torch_dtype(cfg.dtype)
    base = torch.as_tensor(base, device=x.device).expand(b)
    positions = (base + i)[:, None]
    qg, k, v = _attend_token(x, bparams, cfg, positions)
    scale = cfg.head_dim ** -0.5

    s_big = big["k"].shape[1]
    c_len = small["k"].shape[1]
    big_mask = (torch.arange(s_big, device=x.device)[None, :]
                < base[:, None])
    sc_big = _cache_scores(qg, big["k"], scale,
                           cfg.int8_native).masked_fill(
        ~big_mask[:, None, None, :], NEG)
    sm_mask = torch.arange(c_len, device=x.device) < i
    sc_sm = _cache_scores(qg, small["k"], scale).masked_fill(
        ~sm_mask[None, None, None, :], NEG)
    scores = torch.cat([sc_big, sc_sm, _cache_scores(qg, k, scale)], -1)
    probs = torch.softmax(scores, dim=-1)
    attn = (
        _cache_values(probs[..., :s_big], big["v"], dtype, cfg.int8_native)
        + _cache_values(probs[..., s_big:s_big + c_len], small["v"], dtype)
        + _cache_values(probs[..., s_big + c_len:], v, dtype)
    ).reshape(b, -1)

    small["k"][:, i] = k[:, 0]
    small["v"][:, i] = v[:, 0]
    return _finish_block(x, attn, bparams, cfg), small


def _new_chunk_buffers(cfg: ModelConfig, b: int, size: int, device):
    dtype = torch_dtype(cfg.dtype)
    shape = (b, size, local_heads(cfg)[1], cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _greedy(logits, step: int):
    return torch.argmax(logits, dim=-1)


def _run_chunk(params, cfg: ModelConfig, token, cache, base,
               size: int, step0: int = 0, select_fn=_greedy):
    """Generate ``size`` tokens with the big cache frozen, then merge
    the chunk buffer into it once. ``select_fn(logits, step)`` picks
    each token; ``step`` counts decode steps from ``step0``. ``base`` is
    an int or a (1,) device tensor (``_store``). Returns (next_token,
    cache, emitted (b, size))."""
    dtype = torch_dtype(cfg.dtype)
    small = _new_chunk_buffers(cfg, token.shape[0], size, token.device)
    emitted = []
    for i in range(size):
        x = embed_lookup(params["embed"], token, dtype)
        for bparams, big_lc, small_lc in zip(params["blocks"], cache,
                                             small):
            x, _ = _block_decode_chunk(x, bparams, cfg, big_lc, small_lc,
                                       base, i)
        x = _rms_norm(x, params["final_norm"])
        token = select_fn(_readout(x, params["embed"], cfg.int8_native),
                          step0 + i).to(token.dtype)
        emitted.append(token)
    for big_lc, small_lc in zip(cache, small):
        _store(big_lc["k"], small_lc["k"], base)
        _store(big_lc["v"], small_lc["v"], base)
    return token, cache, torch.stack(emitted, dim=1)


def _chunked_generate(params, cfg: ModelConfig, first_token, cache,
                      start_pos: int, num_new: int, chunk: int = 64,
                      select_fn=_greedy):
    """``first_token`` sits at ``start_pos``; runs ``num_new - 1`` token
    steps in chunks of ``chunk`` (the JAX package's chunk boundaries:
    full chunks of min(chunk, steps), then the remainder)."""
    steps = num_new - 1
    if steps <= 0:
        return first_token[:, None]
    size = min(chunk, steps)
    n_full, rem = divmod(steps, size)
    token = first_token
    outs = [first_token[:, None]]
    for c in range(n_full):
        token, cache, emitted = _run_chunk(
            params, cfg, token, cache, start_pos + c * size, size,
            c * size, select_fn)
        outs.append(emitted)
    if rem:
        token, cache, emitted = _run_chunk(
            params, cfg, token, cache, start_pos + n_full * size, rem,
            n_full * size, select_fn)
        outs.append(emitted)
    return torch.cat(outs, dim=1)


def generate_from_cache(params: Params, cfg: ModelConfig, first_token,
                        cache, start_pos: int, num_new: int,
                        chunk: int = 64):
    """Greedy decode loop: ``first_token`` (b,) sits at ``start_pos``;
    emits (b, num_new) greedy tokens starting with it."""
    if num_new <= 0:
        return first_token.new_zeros((first_token.shape[0], 0))
    return _chunked_generate(params, cfg, first_token, cache, start_pos,
                             num_new, chunk)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """vLLM-style sampling knobs. temperature<=0 means greedy; top_k=0
    means full vocab; top_p=1.0 disables nucleus filtering; min_p=0
    disables the min-p filter; repetition_penalty=1.0 disables the
    penalty (logits of tokens already in the prompt or output are
    divided by it when positive, multiplied when negative)."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0


def _filtered_scaled(logits, temp, top_k, top_p, min_p=None):
    """Temperature-scaled, top-k/top-p/min-p-filtered logits per row
    (b, vocab); filtered entries are -1e30. The JAX package's math:
    per-row k via the sorted kth value, nucleus cutoff from the mass
    BEFORE each token, min-p floor relative to the max prob."""
    vocab = logits.shape[-1]
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab))
    kth = sorted_desc.gather(
        1, torch.clamp(k_eff - 1, 0, vocab - 1)[:, None].long())
    scaled = scaled.masked_fill(scaled < kth, NEG)

    probs = torch.softmax(scaled, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    # top_p >= 1.0 disables the filter exactly (threshold 2.0)
    p_eff = torch.where(top_p >= 1.0, torch.full_like(top_p, 2.0), top_p)
    keep = (cum - sorted_probs) < p_eff[:, None]
    cutoff = torch.where(keep, sorted_probs,
                         torch.full_like(sorted_probs, 2.0)).amin(
        dim=-1, keepdim=True)
    scaled = scaled.masked_fill(probs < cutoff, NEG)

    if min_p is not None:
        probs = torch.softmax(scaled, dim=-1)
        floor = min_p[:, None] * probs.amax(dim=-1, keepdim=True)
        scaled = scaled.masked_fill((min_p[:, None] > 0.0) & (probs < floor),
                                    NEG)
    return scaled


_MASK32 = 0xFFFFFFFF
_GOLDEN32 = 0x9E3779B9


def _hash32(x):
    """A 32-bit integer hash (lowbias32) of int64 values in
    [0, 2**32), in int64 arithmetic that cannot overflow: each
    product is split into 16-bit halves of the constant."""
    def mul(v, c):
        return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) \
            & _MASK32

    x = x ^ (x >> 16)
    x = mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix(h, v):
    return _hash32(((h ^ (v & _MASK32)) + _GOLDEN32) & _MASK32)


def _seed_words(seeds, *extra) -> np.ndarray:
    """Request seeds as rows of 32-bit words (low, high), followed by
    ``extra`` per-row words (the batch row where one seed serves a
    batch): the ``seeds`` argument of ``_counter_uniform``."""
    words = [[int(s) & _MASK32, (int(s) >> 32) & _MASK32] for s in seeds]
    for col in extra:
        for row, v in zip(words, col):
            row.append(int(v) & _MASK32)
    return np.asarray(words, np.int64).reshape(len(words), -1)


def _counter_uniform(seeds, gidx, stream: int, width: int = 0):
    """Uniforms in (0, 1), fp32, as a pure function of (key words,
    generation index, stream[, column]) — the one source of every
    random draw of sampling. ``seeds`` (b, n) int64 holds each row's
    key as 32-bit words (``_seed_words``), ``gidx`` (b, ...) the
    generation indices; with ``width`` a trailing dimension of that
    many columns is added (one draw per vocabulary entry). Integer
    arithmetic only, so the card and the CPU give the same draws."""
    view = (-1,) + (1,) * (gidx.dim() - 1)
    h = _hash32(seeds[:, 0])
    for j in range(1, seeds.shape[1]):
        h = _mix(h, seeds[:, j])
    h = _mix(_mix(h.view(view), gidx.long()),
             torch.full_like(gidx.long(), stream))
    if width:
        h = _mix(h[..., None], torch.arange(width, device=gidx.device))
    return _unit_float(h)


def _unit_float(h):
    """32-bit hashes -> fp32 uniforms in (0, 1): the top 23 bits plus
    one half, scaled. 24 bits would round the largest value up to
    exactly 1.0 in fp32, an infinite Gumbel draw."""
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))


def _counter_gumbel(seeds, gidx, vocab: int):
    """(b, vocab) fp32 Gumbel noise for generation indices ``gidx`` (b,):
    stream 1 of ``_counter_uniform``, computed where ``seeds`` lies."""
    return -torch.log(-torch.log(_counter_uniform(seeds, gidx, 1, vocab)))


def _gumbel_noise(keys, vocab: int, temp, device):
    """(b, vocab) fp32 Gumbel noise for host keys (seed, generation
    index[, batch row]), computed on ``device`` without waiting for it;
    greedy rows (temp <= 0) get zeros."""
    seeds, gidx = zip(*((k[0], k[1]) for k in keys))
    extra = list(zip(*(k[2:] for k in keys)))
    dev = torch.device(device)
    noise = _counter_gumbel(to_device(_seed_words(seeds, *extra), dev),
                            to_device(np.asarray(gidx, np.int64), dev),
                            vocab)
    return torch.where(temp.to(dev)[:, None] > 0.0, noise,
                       torch.zeros_like(noise))


def _sample_token(logits, sampling: SamplingConfig,
                  key: Tuple[int, int]):
    """One sampling step over fp32 logits (b, vocab) -> tokens (b,):
    greedy at temperature <= 0, else the Gumbel-max draw over
    ``_filtered_scaled`` with the same knobs on every row. ``key`` is
    (seed, generation index); row r's noise is drawn from
    (seed, generation index, r)."""
    if sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    b, dev = logits.shape[0], logits.device

    def rows(value, dtype):
        return torch.full((b,), value, dtype=dtype, device=dev)

    temp = rows(sampling.temperature, torch.float32)
    scaled = _filtered_scaled(logits, temp,
                              rows(sampling.top_k, torch.int32),
                              rows(sampling.top_p, torch.float32),
                              rows(sampling.min_p, torch.float32))
    noise = _gumbel_noise([(*key, r) for r in range(b)], logits.shape[-1],
                          temp, dev)
    return torch.argmax(scaled + noise, dim=-1)


@torch.no_grad()
def sample_generate(params: Params, cfg: ModelConfig, prompt, num_new: int,
                    seed: int, sampling: SamplingConfig = SamplingConfig(),
                    device="cuda"):
    """prompt (b, t_p) integer -> (b, t_p + num_new) sampled
    continuation on ``device``: the prefill and chunked decode of
    ``greedy_generate``, generation index i drawn with key (seed, i),
    so a fixed seed replays the same sequence."""
    if sampling.repetition_penalty != 1.0:
        # the solo path keeps no presence state; the serving engines
        # implement the penalty
        raise ValueError(
            "repetition_penalty is only supported by the serving "
            "engines (models/serving.py), not sample_generate")
    dev = resolve(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    t_p = prompt.shape[1]
    if num_new <= 0:
        return prompt
    logits, cache = prefill(params, cfg, prompt, t_p + num_new)
    first = _sample_token(logits, sampling, (seed, 0))

    def select(logits, step):
        return _sample_token(logits, sampling, (seed, step + 1))

    generated = _chunked_generate(params, cfg, first, cache, t_p, num_new,
                                  select_fn=select)
    return torch.cat([prompt, generated], dim=1)


@torch.no_grad()
def greedy_generate(params: Params, cfg: ModelConfig, prompt, num_new: int,
                    chunk: int = 64, device="cuda"):
    """prompt (b, t_p) integer -> (b, t_p + num_new) greedy continuation
    on ``device`` (the card unless the caller asks for the CPU):
    batched prefill filling the cache, then chunked cached decode.
    Runs without autograd, whatever ``params`` require."""
    dev = resolve(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, t_p = prompt.shape
    if num_new <= 0:
        return prompt
    logits, cache = prefill(params, cfg, prompt, t_p + num_new)
    first = torch.argmax(logits, dim=-1)
    generated = generate_from_cache(params, cfg, first, cache, t_p,
                                    num_new, chunk=chunk)
    return torch.cat([prompt, generated], dim=1)


def generate_report(cfg: ModelConfig = None, batch: int = 2,
                    prompt_len: int = 8, num_new: int = 8,
                    device="cuda") -> Dict[str, Any]:
    """Smoke and self-consistency check: random weights and a prompt
    from seeded ``torch.Generator``s, a greedy continuation, and its
    last token against the argmax of the uncached forward."""
    from kind_tpu_sim_torch.models import transformer as tf

    dev = resolve(device)
    cfg = cfg or tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_seq=32)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    prompt = tf.sample_batch(torch.Generator(device=dev).manual_seed(1),
                             cfg, batch, prompt_len, device=dev)
    out = greedy_generate(params, cfg, prompt, num_new, device=dev)
    with torch.no_grad():
        logits = tf.forward(params, out[:, :-1], cfg)
    consistent = bool((out[:, -1] == logits[:, -1].argmax(dim=-1)).all())
    return {"prompt_len": prompt_len, "generated": num_new,
            "cache_consistent": consistent, "ok": consistent}
