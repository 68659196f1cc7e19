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
position. int8 caches and MoE belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from kind_tpu_sim_torch.device import resolve, torch_dtype
from kind_tpu_sim_torch.models.quant import embed_lookup, linear
from kind_tpu_sim_torch.models.transformer import (
    ModelConfig,
    Params,
    _block_core,
    _mlp,
    _readout,
    _rms_norm,
    _rotary,
    _split_qkv,
    check_supported,
)

NEG = -1e30


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """Copy of ``params`` with every leaf of two or more dimensions
    (matmul weights, embedding) cast to the activation dtype; norm
    scales stay fp32. The readout follows the embedding's dtype, so a
    bf16 snapshot's logits come from bf16 weights (accumulated in
    fp32). Every leaf is detached, so a snapshot of parameters that a
    train step left requiring grad carries no autograd history."""
    dtype = torch_dtype(cfg.dtype)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        node = node.detach()
        return node.to(dtype) if node.ndim >= 2 else node

    return cast(params)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Preallocated per-layer KV cache, (batch, max_len, kv, hd) in the
    activation dtype."""
    if cfg.int8_kv:
        raise NotImplementedError(
            "int8 KV caches are not ported yet (the int8 slice of "
            "kind_tpu_sim_torch)")
    dev = resolve(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _store(cache_arr, update, start: int) -> None:
    """Write ``update`` (b, t, kv, hd) into ``cache_arr`` at sequence
    position ``start``, in place. The start is clamped so the window
    fits, as ``lax.dynamic_update_slice`` clamps it."""
    t = update.shape[1]
    start = max(0, min(int(start), cache_arr.shape[1] - t))
    cache_arr[:, start:start + t] = update.to(cache_arr.dtype)


def _cache_scores(qg, cache_k, scale):
    """Scores of qg (b, kv, g, hd) against a cache tensor (b, s, kv, hd):
    fp32 (b, kv, g, s), accumulated in fp32 from the stored values."""
    return torch.einsum("bkgd,bskd->bkgs", qg.float(),
                        cache_k.float()) * scale


def _cache_values(probs, cache_v, dtype):
    """probs (b, kv, g, s) fp32 x values (b, s, kv, hd) -> (b, kv, g, hd)
    in ``dtype``: probs rounded to the value dtype, product rounded to
    it, as the JAX einsum does."""
    return torch.einsum("bkgs,bskd->bkgd", probs.to(dtype).float(),
                        cache_v.float()).to(dtype)


def _attend_token(x, bparams, cfg: ModelConfig, positions):
    """Shared decode-step front half for ONE token per row: norm, qkv
    projection, rotary. Returns qg (b, kv, group, hd) and k1/v1
    (b, 1, kv, hd)."""
    b = x.shape[0]
    h = _rms_norm(x, bparams["attn_norm"])
    q, k, v = _split_qkv(linear(h, bparams["wqkv"]), cfg, b, 1)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    group = cfg.n_heads // cfg.kv_heads
    return q.reshape(b, cfg.kv_heads, group, cfg.head_dim), k, v


def _finish_block(x, attn, bparams, cfg: ModelConfig):
    """Shared decode-step back half: output projection + MLP."""
    x = x + linear(attn, bparams["wo"])
    return x + _mlp(_rms_norm(x, bparams["mlp_norm"]), bparams)


def prefill(params: Params, cfg: ModelConfig, prompt, max_len: int):
    """prompt (b, t_p) -> (last-position logits (b, vocab), filled
    cache) in one batched forward over the whole prompt."""
    check_supported(cfg)
    b, t_p = prompt.shape
    positions = torch.arange(t_p, device=prompt.device).expand(b, t_p)
    x = embed_lookup(params["embed"], prompt, torch_dtype(cfg.dtype))
    cache = init_cache(cfg, b, max_len, device=prompt.device)
    for bparams, layer_cache in zip(params["blocks"], cache):
        x, _, k, v = _block_core(x, bparams, cfg, positions)
        _store(layer_cache["k"], k, 0)
        _store(layer_cache["v"], v, 0)
    last = _rms_norm(x[:, -1, :], params["final_norm"])
    return _readout(last, params["embed"]), cache


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
    sc_big = _cache_scores(qg, big["k"], scale).masked_fill(
        ~big_mask[:, None, None, :], NEG)
    sm_mask = torch.arange(c_len, device=x.device) < i
    sc_sm = _cache_scores(qg, small["k"], scale).masked_fill(
        ~sm_mask[None, None, None, :], NEG)
    scores = torch.cat([sc_big, sc_sm, _cache_scores(qg, k, scale)], -1)
    probs = torch.softmax(scores, dim=-1)
    attn = (
        _cache_values(probs[..., :s_big], big["v"], dtype)
        + _cache_values(probs[..., s_big:s_big + c_len], small["v"], dtype)
        + _cache_values(probs[..., s_big + c_len:], v, dtype)
    ).reshape(b, cfg.d_model)

    small["k"][:, i] = k[:, 0]
    small["v"][:, i] = v[:, 0]
    return _finish_block(x, attn, bparams, cfg), small


def _new_chunk_buffers(cfg: ModelConfig, b: int, size: int, device):
    dtype = torch_dtype(cfg.dtype)
    shape = (b, size, cfg.kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _run_chunk(params, cfg: ModelConfig, token, cache, base: int,
               size: int):
    """Generate ``size`` greedy tokens with the big cache frozen, then
    merge the chunk buffer into it once. Returns (next_token, cache,
    emitted (b, size))."""
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
        token = torch.argmax(_readout(x, params["embed"]), dim=-1).to(
            token.dtype)
        emitted.append(token)
    for big_lc, small_lc in zip(cache, small):
        _store(big_lc["k"], small_lc["k"], base)
        _store(big_lc["v"], small_lc["v"], base)
    return token, cache, torch.stack(emitted, dim=1)


def _chunked_generate(params, cfg: ModelConfig, first_token, cache,
                      start_pos: int, num_new: int, chunk: int = 64):
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
            params, cfg, token, cache, start_pos + c * size, size)
        outs.append(emitted)
    if rem:
        token, cache, emitted = _run_chunk(
            params, cfg, token, cache, start_pos + n_full * size, rem)
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
