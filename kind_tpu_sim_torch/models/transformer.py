"""The flagship decoder-only transformer LM, in PyTorch.

Counterpart of ``kind_tpu_sim/models/transformer.py``: the same
configurations, parameter tree and numerics (bf16 activations, fp32
norms and score/readout accumulation), written as plain functions on
tensors. Parameters are a dict ``{"embed", "final_norm", "blocks":
[...]}`` with the JAX package's names and shapes, so a JAX parameter
tree converts leaf by leaf (``kind_tpu_sim_torch.weights``).

Training runs here too: ``loss_fn``, ``make_train_step`` (AdamW or
SGD, parameters updated in place) and ``sample_batch``; with
``ModelConfig.remat`` each block's activations are recomputed in the
backward instead of kept. ``n_experts > 0`` swaps each block's MLP for
a Switch-MoE (``models/moe.py``, its auxiliary loss added to the
loss); int8 snapshots (``models/quant.py``) serve through the same
forward. Ring attention belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from kind_tpu_sim_torch.device import resolve, torch_dtype

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    dtype: str = "bfloat16"       # activation/matmul dtype
    remat: bool = False           # recompute each block in the backward
    n_experts: int = 0            # >0: Switch-MoE MLP
    n_kv_heads: Optional[int] = None  # grouped-query attention; None = MHA
    flash: bool = False           # flash-attention kernel in prefill
    int8_kv: bool = False         # int8 KV cache (serving)
    int8_native: bool = False     # W8A8: exact int8 x int8 -> int32 products
    seq_parallel: bool = False    # ring attention; no mesh: plain

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_heads if self.n_kv_heads is None else self.n_kv_heads
        assert kv > 0 and self.n_heads % kv == 0
        return kv


def tiny_config() -> ModelConfig:
    return ModelConfig()


def pod_config() -> ModelConfig:
    """The in-pod smoke config."""
    return ModelConfig(vocab_size=256, d_model=64, n_heads=4,
                       n_layers=2, d_ff=256, max_seq=64)


def bench_config() -> ModelConfig:
    """Single-chip benchmark config with 4:1 grouped-query attention."""
    return ModelConfig(vocab_size=32768, d_model=1024, n_heads=16,
                       n_layers=8, d_ff=4096, max_seq=1024, remat=False,
                       n_kv_heads=4)


def bench_config_large() -> ModelConfig:
    """The flagship config: d_model 2048, head_dim 128, d_ff 8192,
    16 query heads over 4 KV heads, 8 layers, 32768-token vocab."""
    return ModelConfig(vocab_size=32768, d_model=2048, n_heads=16,
                       n_layers=8, d_ff=8192, max_seq=1024, remat=False,
                       n_kv_heads=4)


# ---------------------------------------------------------------------
# init


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random fp32 parameters with the JAX package's tree and scales,
    drawn from ``generator`` (a torch.Generator on ``device``; seed 0
    when None). The draws differ from ``jax.random``'s — tests that
    compare against the JAX package convert its parameters instead
    (``weights.params_from_numpy``)."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def dense(shape, scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * scale

    scale = cfg.d_model ** -0.5
    params: Params = {
        "embed": dense((cfg.vocab_size, cfg.d_model), 1.0),
        "final_norm": torch.ones(cfg.d_model, device=dev),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        block = {
            "attn_norm": torch.ones(cfg.d_model, device=dev),
            "mlp_norm": torch.ones(cfg.d_model, device=dev),
            "wqkv": dense(
                (cfg.d_model,
                 (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim), scale),
            "wo": dense((cfg.d_model, cfg.d_model), scale),
        }
        if cfg.n_experts > 0:
            from kind_tpu_sim_torch.models.moe import (MoeConfig,
                                                       init_moe_params)

            block["moe"] = init_moe_params(generator, cfg.d_model, cfg.d_ff,
                                           MoeConfig(n_experts=cfg.n_experts))
        else:
            block["w_up"] = dense((cfg.d_model, cfg.d_ff), scale)
            block["w_down"] = dense((cfg.d_ff, cfg.d_model), cfg.d_ff ** -0.5)
        params["blocks"].append(block)
    return params


# ---------------------------------------------------------------------
# forward


def _readout(x, embed, native=False):
    """Weight-tied fp32 logits (plain or int8 embedding) — the one
    definition forward, prefill and decode share (the cache-vs-forward
    argmax contract)."""
    from kind_tpu_sim_torch.models.quant import readout

    return readout(x, embed, native=native)


def _rms_norm(x, weight, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rotary_freqs(half: int, device: torch.device):
    """Rotary inverse frequencies (half,) fp32, computed on the CPU and
    copied to ``device`` once: a copy per call would wait for the
    device in every layer of every decode step. Callers must not write
    to the shared result."""
    # log(10000) rounded to fp32 first, as jnp.log(10000.0) is
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    return torch.exp(
        -torch.arange(0, half, dtype=torch.float32) * (log_base / half)
    ).to(device)


def _rotary(x, positions):
    """Rotary position embedding over the last (head_dim) axis.
    x: (b, t, heads, hd); positions: (b, t) integer."""
    half = x.shape[-1] // 2
    freqs = _rotary_freqs(half, x.device)
    angles = positions[..., None].float() * freqs        # (B, T, half)
    angles = angles[:, :, None, :]                       # (B, T, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _attention(q, k, v, causal=True):
    """Plain GQA attention. q: (b, t, h, d); k/v: (b, s, kv, d).
    Scores accumulate in fp32 from the activation-dtype values (a
    bf16 x bf16 product is exact in fp32); the PV product rounds to
    the value dtype, as the JAX einsum does."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    group = h // kv
    qg = q.reshape(b, t, kv, group, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                          k.float()) * (d ** -0.5)
    if causal:
        mask = torch.tril(torch.ones(t, k.shape[1], dtype=torch.bool,
                                     device=q.device))
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(b, t, h, d)


def _split_qkv(qkv, cfg: ModelConfig, b: int, t: int):
    """(b, t, (h+2kv)*hd) -> q (b,t,h,hd), k/v (b,t,kv,hd) views."""
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.kv_heads * cfg.head_dim
    q, k, v = torch.split(qkv, [q_dim, kv_dim, kv_dim], dim=-1)
    return (q.reshape(b, t, cfg.n_heads, cfg.head_dim),
            k.reshape(b, t, cfg.kv_heads, cfg.head_dim),
            v.reshape(b, t, cfg.kv_heads, cfg.head_dim))


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype, device: torch.device):
    """A 0-d constant rounded to ``dtype`` on ``device``, made once per
    (value, dtype, device) so the decode step copies nothing to the
    card. Callers must not write to the shared result."""
    return torch.tensor(value, dtype=dtype, device=device)


def _gelu(x):
    """jax.nn.gelu's default (tanh) form, op by op in x's dtype with the
    constants rounded to it: in bf16 every step rounds, as in the JAX
    package (a fused fp32 F.gelu(approximate="tanh") differs from it in
    ~40% of bf16 outputs by one ulp)."""
    def const(v):
        return _const(v, x.dtype, x.device)

    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def _mlp(h, bparams, cfg: ModelConfig, route: str = "all"):
    """The block's MLP on the normed ``h`` -> (out, aux loss). Dense: the
    GELU MLP (plain or int8 weights), aux 0. MoE: the tokens that share
    the experts' capacity are, by ``route``, all of ``h`` ("all": the
    forward and a batched prefill), each batch row of h (b, t, d) alone
    ("rows": one prompt a prefill, as the reference admits a wave one
    prompt at a time), or each column of h (b, w, d), every row of h
    (b, d) ("columns": a decode step, or one position of a verify
    window, routes over the slots)."""
    from kind_tpu_sim_torch.models.quant import linear

    if "moe" not in bparams:
        native = cfg.int8_native
        return linear(_gelu(linear(h, bparams["w_up"], native=native)),
                      bparams["w_down"], native=native), 0.0
    from kind_tpu_sim_torch.models.moe import MoeConfig, moe_mlp

    moe = MoeConfig(n_experts=cfg.n_experts)
    if route == "all":
        return moe_mlp(h, bparams["moe"], moe)
    groups = h if route == "rows" else (
        h[:, None] if h.dim() == 2 else h).transpose(0, 1)
    outs = [moe_mlp(g[None], bparams["moe"], moe) for g in groups]
    out = torch.cat([o for o, _ in outs])
    if route == "columns":
        out = out.transpose(0, 1).reshape(h.shape)
    return out, sum(a for _, a in outs)


def _block_core(x, bparams, cfg: ModelConfig, positions,
                moe_route: str = "all"):
    """Block body, also exposing the rotated k/v so the decode prefill
    can fill its cache. Returns (x_out, aux_loss, k, v); ``moe_route``
    is ``_mlp``'s ``route``."""
    from kind_tpu_sim_torch.models.quant import linear

    b, t, _ = x.shape
    native = cfg.int8_native
    h = _rms_norm(x, bparams["attn_norm"])
    qkv = linear(h, bparams["wqkv"], native=native)
    q, k, v = _split_qkv(qkv, cfg, b, t)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    if cfg.flash:
        # the hand-written flash kernel (ops/flash_attention.py): no
        # (t, t) score matrix in device memory
        from kind_tpu_sim_torch.ops.flash_attention import flash_attention

        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = _attention(q, k, v)
    attn = attn.reshape(b, t, cfg.d_model)
    x = x + linear(attn, bparams["wo"], native=native)
    out, aux = _mlp(_rms_norm(x, bparams["mlp_norm"]), bparams, cfg,
                    moe_route)
    return x + out, aux, k, v


def _block(x, bparams, cfg: ModelConfig, positions):
    x, aux, _, _ = _block_core(x, bparams, cfg, positions)
    return x, aux


def forward(params: Params, tokens, cfg: ModelConfig,
            return_aux: bool = False):
    """tokens (batch, seq) integer -> logits (batch, seq, vocab) fp32;
    with ``return_aux`` also the summed MoE load-balancing loss (0 for
    dense configs). Differentiable in every parameter (the flash
    kernels through ``FlashAttentionFunction``). With ``cfg.remat``
    every block runs under ``torch.utils.checkpoint`` (non-reentrant),
    as the reference wraps it in ``jax.checkpoint``: the backward runs
    the block's forward again instead of keeping its activations."""
    from kind_tpu_sim_torch.models.quant import embed_lookup

    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    aux_total = 0.0
    for bparams in params["blocks"]:
        if cfg.remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _block, x, bparams, cfg, positions, use_reentrant=False)
        else:
            x, aux = _block(x, bparams, cfg, positions)
        aux_total = aux_total + aux
    x = _rms_norm(x, params["final_norm"])
    logits = _readout(x, params["embed"], cfg.int8_native)
    return (logits, aux_total) if return_aux else logits


def loss_fn(params: Params, tokens, cfg: ModelConfig):
    """Next-token cross-entropy: the forward over ``tokens[:, :-1]``,
    log-softmax in fp32, mean negative log-likelihood of
    ``tokens[:, 1:]``, plus the MoE auxiliary loss."""
    logits, aux = forward(params, tokens[:, :-1], cfg, return_aux=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return -picked.mean() + aux


# ---------------------------------------------------------------------
# training


def _leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (embed, final_norm, then
    each block's leaves in key order, an MoE subtree's in its own key
    order)."""
    def block_leaves(node):
        return [leaf for key in sorted(node) for leaf in (
            block_leaves(node[key]) if isinstance(node[key], dict)
            else [node[key]])]

    return ([params["embed"], params["final_norm"]]
            + [leaf for b in params["blocks"] for leaf in block_leaves(b)])


@torch.no_grad()
def sgd_step(params: Params, grads, lr: float) -> Params:
    """Plain SGD, ``p - lr * g`` for every leaf, IN PLACE: ``grads``
    is a list in ``_leaves`` order. Returns ``params``."""
    for p, g in zip(_leaves(params), grads):
        p.sub_(lr * g)
    return params


def make_train_step(cfg: ModelConfig, learning_rate: float = 1e-2,
                    use_optax: bool = True, device="cuda"):
    """Returns (step_fn, init_state), with the reference's keywords.

    ``init_state(source)`` takes a ``torch.Generator`` (random
    parameters, as ``init_params``) or an existing parameter tree (for
    instance one converted from the JAX package by
    ``weights.params_from_numpy``), moves it to ``device`` and returns
    ``{"params", "opt"}``. ``step_fn(state, tokens) -> (state, loss)``
    computes the loss and its gradient and updates the parameters IN
    PLACE, so a tree already on ``device`` is itself the one trained.

    ``use_optax=True`` is the reference's ``optax.adamw(learning_rate)``
    with every hyperparameter written out — betas (0.9, 0.999), eps
    1e-8, weight decay 1e-4 (``torch.optim.AdamW`` would default to
    1e-2), bias correction, no amsgrad — as ``torch.optim.AdamW`` with
    its default implementation (``foreach`` on the card, the per-tensor
    loop on the CPU). ``use_optax=False`` is plain SGD (``sgd_step``).
    ``n_experts > 0`` trains the MoE through autograd, its auxiliary
    loss in the loss. ``seq_parallel`` is plain attention here: the
    reference rides a ring only under a mesh with a ``seq`` axis, and
    the port takes no mesh."""
    dev = resolve(device)

    def init_state(source) -> Dict[str, Any]:
        if isinstance(source, torch.Generator):
            params = init_params(cfg, source, dev)
        else:
            def to_dev(node):
                if isinstance(node, dict):
                    return {k: to_dev(v) for k, v in node.items()}
                return node.to(dev)

            params = {"embed": source["embed"].to(dev),
                      "final_norm": source["final_norm"].to(dev),
                      "blocks": [to_dev(b) for b in source["blocks"]]}
        for p in _leaves(params):
            p.requires_grad_(True)
        opt = None
        if use_optax:
            opt = torch.optim.AdamW(
                _leaves(params), lr=learning_rate, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=1e-4, amsgrad=False)
        return {"params": params, "opt": opt}

    def step_fn(state, tokens):
        params = state["params"]
        leaves = _leaves(params)
        loss = loss_fn(params, tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        if state["opt"] is None:
            sgd_step(params, grads, learning_rate)
        else:
            for p, g in zip(leaves, grads):
                p.grad = g
            state["opt"].step()
            for p in leaves:
                p.grad = None
        return state, loss.detach()

    return step_fn, init_state


def sample_batch(generator: torch.Generator, cfg: ModelConfig, batch: int,
                 seq: Optional[int] = None, device="cuda"):
    """Synthetic structured data (ramps mod vocab) the LM can learn:
    ``(starts + arange(seq)) % vocab`` with the starts drawn from
    ``generator`` (a torch.Generator on ``device``)."""
    dev = resolve(device)
    seq = seq or cfg.max_seq
    starts = torch.randint(0, cfg.vocab_size, (batch, 1),
                           generator=generator, device=dev)
    return (starts + torch.arange(seq, device=dev)[None, :]) % cfg.vocab_size

