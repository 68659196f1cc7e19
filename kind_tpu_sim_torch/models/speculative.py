"""Window forwards against a KV cache, in PyTorch.

Counterpart of the part of ``kind_tpu_sim/models/speculative.py`` that
prompt admission needs: ``_window_block``, one block over a (b, w)
token window that attends to a cache holding each row's first
``base[r]`` positions plus causally within the window. A prefix-cache
hit runs its prompt's suffix through it, and so does every chunked
prefill window after the first (``serving._suffix_into_slot``,
``paged.paged_suffix``). Speculative decoding itself (drafts, verify
windows, rejection sampling) is a later slice of the port.

The attention is plain PyTorch, as the reference's is plain XLA: fp32
scores from the stored values, one softmax over the cache and window
groups, probabilities rounded to the value dtype before each PV
product and each product rounded to it.
"""

from __future__ import annotations

import torch

from kind_tpu_sim_torch.device import torch_dtype
from kind_tpu_sim_torch.models.decode import NEG, _finish_block
from kind_tpu_sim_torch.models.quant import linear
from kind_tpu_sim_torch.models.transformer import (
    ModelConfig,
    _rms_norm,
    _rotary,
    _split_qkv,
)


def _window_block(x, bparams, cfg: ModelConfig, layer_cache, base):
    """One block over a (b, w, d) window attending to ``layer_cache``
    (per-layer {"k", "v"} of (b, s, kv, hd); row r masked at its own
    ``base[r]``, a (b,) integer tensor) plus causal attention within
    the window, whose position j sits at base + j. Returns (x_out,
    k, v): the window's rotated k/v (b, w, kv, hd) for the caller to
    write."""
    b, w, _ = x.shape
    dtype = torch_dtype(cfg.dtype)
    h = _rms_norm(x, bparams["attn_norm"])
    q, kk, vv = _split_qkv(linear(h, bparams["wqkv"]), cfg, b, w)
    positions = base[:, None] + torch.arange(w, device=x.device)[None, :]
    q = _rotary(q, positions)
    kk = _rotary(kk, positions)

    group = cfg.n_heads // cfg.kv_heads
    scale = cfg.head_dim ** -0.5
    s_big = layer_cache["k"].shape[1]
    qg = q.reshape(b, w, cfg.kv_heads, group, cfg.head_dim).float()
    sc_big = torch.einsum("bwkgd,bskd->bwkgs", qg,
                          layer_cache["k"].float()) * scale
    big_mask = (torch.arange(s_big, device=x.device)[None, :]
                < base[:, None])                               # (b, s)
    sc_big = sc_big.masked_fill(~big_mask[:, None, None, None, :], NEG)
    sc_win = torch.einsum("bwkgd,bvkd->bwkgv", qg, kk.float()) * scale
    causal = torch.tril(torch.ones((w, w), dtype=torch.bool,
                                   device=x.device))
    sc_win = sc_win.masked_fill(~causal[None, :, None, None, :], NEG)

    probs = torch.softmax(torch.cat([sc_big, sc_win], dim=-1), dim=-1)
    attn_big = torch.einsum(
        "bwkgs,bskd->bwkgd", probs[..., :s_big].to(dtype).float(),
        layer_cache["v"].float()).to(dtype)
    attn_win = torch.einsum(
        "bwkgv,bvkd->bwkgd", probs[..., s_big:].to(dtype).float(),
        vv.float()).to(dtype)
    attn = (attn_big + attn_win).reshape(b, w, cfg.d_model)
    return _finish_block(x, attn, bparams, cfg), kk, vv
