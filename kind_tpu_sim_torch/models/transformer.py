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
forward.

Over a mesh (``parallel/mesh.py``) each rank holds its shard of the
tree (``param_specs``, ``shard_params``): Megatron tensor parallelism
over 'model' (wqkv by heads and w_up column-parallel, wo and w_down
row-parallel, the embedding and the tied readout split over the
vocabulary, norms replicated), an MoE's experts over 'expert' (else
'model'), the batch over ('dcn', 'data') and the sequence over 'seq'
(``batch_spec``). The model functions read the split from
``parallel.tp``'s scope; ``forward``, ``loss_fn`` and
``make_train_step`` take ``mesh`` where the reference does. Over a
'seq' axis longer than 1 each rank holds its columns of every row, at
their global positions: with ``seq_parallel`` attention rides the ring
(``parallel/ring_attention.py``, the reference's ``_use_ring``);
without it each rank attends over the sequence gathered along 'seq'
(plain or flash), what GSPMD gives the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from kind_tpu_sim_torch.device import resolve, torch_dtype
from kind_tpu_sim_torch.parallel import tp

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
    seq_parallel: bool = False    # ring attention over 'seq'; else plain

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


def _readout(x, embed, native=False, whole=True):
    """Weight-tied fp32 logits (plain or int8 embedding) — the one
    definition forward, prefill and decode share (the cache-vs-forward
    argmax contract). Under a tensor-parallel scope ``whole=False``
    leaves each rank its vocabulary slice."""
    from kind_tpu_sim_torch.models.quant import readout

    ax = tp.current().model
    if ax is None:
        return readout(x, embed, native=native)
    logits = readout(tp.copy_in(x, ax), embed, native=native)
    return tp.gather_last(logits, ax) if whole else logits


def local_heads(cfg: ModelConfig):
    """(query heads, KV heads) this rank computes: all of them, or its
    share under a tensor-parallel scope."""
    m = tp.model_size()
    return cfg.n_heads // m, cfg.kv_heads // m


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
    """(b, t, (h+2kv)*hd) -> q (b,t,h,hd), k/v (b,t,kv,hd) views, at
    this rank's head counts (``local_heads``)."""
    h, kv = local_heads(cfg)
    hd = cfg.head_dim
    q, k, v = torch.split(qkv, [h * hd, kv * hd, kv * hd], dim=-1)
    return (q.reshape(b, t, h, hd), k.reshape(b, t, kv, hd),
            v.reshape(b, t, kv, hd))


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
        up = linear(h, bparams["w_up"], native=native, parallel="column")
        return linear(_gelu(up), bparams["w_down"], native=native,
                      parallel="row"), 0.0
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
    qkv = linear(h, bparams["wqkv"], native=native, parallel="column")
    q, k, v = _split_qkv(qkv, cfg, b, t)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    seq = tp.current().seq
    if seq is not None and cfg.seq_parallel:
        # sequence-parallel long context: the K/V blocks ride the ring
        from kind_tpu_sim_torch.parallel.ring_attention import (
            ring_attention_shard)

        attn = ring_attention_shard(q, k, v, seq, causal=True)
    elif seq is not None:
        # the sequence gathered along 'seq', this rank's positions kept
        lo = seq.index * t
        attn = _attend(*(tp.gather_dim(x, seq, 1) for x in (q, k, v)),
                       cfg)[:, lo:lo + t]
    else:
        attn = _attend(q, k, v, cfg)
    attn = attn.reshape(b, t, -1)
    x = x + linear(attn, bparams["wo"], native=native, parallel="row")
    out, aux = _mlp(_rms_norm(x, bparams["mlp_norm"]), bparams, cfg,
                    moe_route)
    return x + out, aux, k, v


def _attend(q, k, v, cfg: ModelConfig):
    """Causal attention over the whole of q, k, v: the hand-written
    flash kernel (ops/flash_attention.py, no (t, t) score matrix in
    device memory) with ``cfg.flash``, else plain."""
    if cfg.flash:
        from kind_tpu_sim_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True)
    return _attention(q, k, v)


def _block(x, bparams, cfg: ModelConfig, positions):
    x, aux, _, _ = _block_core(x, bparams, cfg, positions)
    return x, aux


def _block_in(shards, x, bparams, cfg: ModelConfig, positions):
    """``_block`` under ``shards``: what a remat recompute runs, since
    the backward may run on another thread than the scope's."""
    with tp.scope(shards):
        return _block(x, bparams, cfg, positions)


def _mesh_scope(mesh):
    """The scope a call with ``mesh`` runs in (its tokens split over
    ('dcn', 'data')); without one, whatever scope is current."""
    if mesh is None:
        return contextlib.nullcontext()
    return tp.scope(tp.shards_of(mesh))


def _forward(params: Params, tokens, cfg: ModelConfig, whole: bool = True):
    """The forward in the current scope -> (logits, aux); ``whole``
    False leaves each tensor-parallel rank its vocabulary slice."""
    from kind_tpu_sim_torch.models.quant import embed_lookup

    b, t = tokens.shape
    shards = tp.current()
    first = 0 if shards.seq is None else shards.seq.index * t
    positions = torch.arange(first, first + t,
                             device=tokens.device).expand(b, t)
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    aux_total = 0.0
    for bparams in params["blocks"]:
        if cfg.remat:
            # no random draw in a block, so no RNG state to keep (its
            # read would be a host copy a captured step cannot make)
            x, aux = torch.utils.checkpoint.checkpoint(
                _block_in, shards, x, bparams, cfg, positions,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _block(x, bparams, cfg, positions)
        aux_total = aux_total + aux
    x = _rms_norm(x, params["final_norm"])
    return _readout(x, params["embed"], cfg.int8_native, whole), aux_total


def forward(params: Params, tokens, cfg: ModelConfig,
            return_aux: bool = False, mesh=None):
    """tokens (batch, seq) integer -> logits (batch, seq, vocab) fp32;
    with ``return_aux`` also the summed MoE load-balancing loss (0 for
    dense configs). Differentiable in every parameter (the flash
    kernels through ``FlashAttentionFunction``). With ``cfg.remat``
    every block runs under ``torch.utils.checkpoint`` (non-reentrant),
    as the reference wraps it in ``jax.checkpoint``: the backward runs
    the block's forward again instead of keeping its activations.

    With ``mesh`` the parameters are this rank's shards
    (``shard_params``) and ``tokens`` its block of the batch
    (``shard_batch``: its rows, and its columns over 'seq'); the logits
    are that block over the whole vocabulary."""
    with _mesh_scope(mesh):
        logits, aux = _forward(params, tokens, cfg)
    return (logits, aux) if return_aux else logits


def _vocab_parallel_nll(logits, targets, ax):
    """Per-position -log softmax(logits)[target] where each rank of
    ``ax`` holds a slice of the vocabulary: the max, the sum of
    exponentials and the target's logit are each summed (or maxed)
    over the ranks."""
    v = logits.shape[-1]
    m = tp.all_reduce(logits.detach().amax(dim=-1, keepdim=True), ax, "max")
    z = logits - m
    sumexp = tp.reduce_out(torch.exp(z).sum(dim=-1), ax)
    local = targets - ax.index * v
    inside = (local >= 0) & (local < v)
    picked = torch.gather(z, -1, torch.where(inside, local, 0)[..., None])
    picked = tp.reduce_out(picked[..., 0] * inside, ax)
    return torch.log(sumexp) - picked


def _nll(logits, targets):
    """Per-position -log softmax(logits)[target] in fp32 (vocab-parallel
    inside a tensor-parallel scope)."""
    ax = tp.current().model
    if ax is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]
    return _vocab_parallel_nll(logits.float(), targets, ax)


def loss_fn(params: Params, tokens, cfg: ModelConfig, mesh=None):
    """Next-token cross-entropy: the forward over ``tokens[:, :-1]``,
    log-softmax in fp32, mean negative log-likelihood of
    ``tokens[:, 1:]``, plus the MoE auxiliary loss. With ``mesh`` (or
    inside a tensor-parallel scope) the log-softmax is vocab-parallel;
    each rank's loss is its share of the global mean, which is the mean
    of the ranks' losses over ``Shards.token_group()`` (over data ranks
    alone: the mean over this rank's rows)."""
    with _mesh_scope(mesh):
        if tp.current().seq is not None:
            return _seq_loss(params, tokens, cfg)
        logits, aux = _forward(params, tokens[:, :-1], cfg, whole=False)
        return _nll(logits, tokens[:, 1:]).mean() + aux


def _seq_loss(params: Params, tokens, cfg: ModelConfig):
    """``loss_fn`` with the sequence split over 'seq': the forward runs
    over this rank's whole block and the last global position's logit
    is dropped (identical logits under the causal mask; the
    reference's ring loss). The target of a rank's last column is the
    next rank's first token. With the ring the MoE routes every
    position, the final one too, as the reference's ring does; without
    it the final position is left out of routing, as the reference's
    forward over ``tokens[:, :-1]`` leaves it."""
    shards = tp.current()
    seq, group = shards.seq, shards.token_group()
    b, t = tokens.shape
    total = t * seq.size
    scope = shards if cfg.seq_parallel else shards._replace(
        seq_tokens=total - 1)
    with tp.scope(scope):
        logits, aux = _forward(params, tokens, cfg, whole=False)
    firsts = tp.all_gather(tokens[:, :1], seq, 1)
    targets = torch.cat(
        [tokens[:, 1:], firsts[:, (seq.index + 1) % seq.size, None]], dim=1)
    nll = _nll(logits, targets)
    if seq.index == seq.size - 1:
        nll = nll[:, :-1]
    positions = b * (group.size // seq.size) * (total - 1)
    return nll.sum() * (group.size / positions) + aux


# ---------------------------------------------------------------------
# sharding


def param_specs(cfg: ModelConfig, mesh=None):
    """The placement of every leaf, as the reference's PartitionSpec
    tree (a tuple of one axis name or None per dimension): wqkv and
    w_up column-parallel over 'model', wo and w_down row-parallel, the
    embedding split over the vocabulary, norms replicated, an MoE's
    experts over 'expert' (else 'model'). With no mesh (or no 'model'
    axis) everything is replicated. wqkv's columns are split by heads
    (``tp.qkv_columns``), not as one contiguous slice."""
    has_model = mesh is not None and "model" in mesh.axis_names
    m = "model" if has_model else None
    if cfg.n_experts > 0:
        from kind_tpu_sim_torch.models.moe import moe_param_specs

        mlp_spec = {"moe": moe_param_specs(mesh)}
    else:
        mlp_spec = {"w_up": (None, m), "w_down": (m, None)}
    return {
        "embed": (m, None),
        "final_norm": (None,),
        "blocks": [
            {
                "attn_norm": (None,),
                "mlp_norm": (None,),
                "wqkv": (None, m),
                "wo": (m, None),
                **mlp_spec,
            }
            for _ in range(cfg.n_layers)
        ],
    }


def batch_spec(mesh=None):
    """Tokens (batch, seq): batch over 'data' (jointly over ('dcn',
    'data') on a multislice mesh), seq over 'seq' if present."""
    if mesh is None:
        return (None, None)
    names = mesh.axis_names
    if "dcn" in names and "data" in names:
        batch_axes = ("dcn", "data")
    elif "data" in names:
        batch_axes = "data"
    else:
        batch_axes = None
    return (batch_axes, "seq" if "seq" in names else None)


def shard_batch(tokens, mesh):
    """This rank's block of a global batch, as ``batch_spec`` places
    it: its rows, and its columns over a 'seq' axis."""
    if mesh is None:
        return tokens
    lo, hi = tp.split_rows(tokens.shape[0],
                           tp.axis(mesh, "dcn", "data"))
    tokens = tokens[lo:hi]
    if mesh.shape.get("seq", 1) > 1:
        lo, hi = tp.split_rows(tokens.shape[1], tp.axis(mesh, "seq"))
        tokens = tokens[:, lo:hi]
    return tokens


def _qkv_columns(cfg: ModelConfig):
    """wqkv's head split for ``tp.shard_tensor`` / ``tp.gather_tensor``."""
    def columns_of(size, index):
        return tp.qkv_columns(cfg.n_heads, cfg.kv_heads, cfg.head_dim,
                              size, index)

    return columns_of


def _placed(params, cfg: ModelConfig, mesh, fn):
    """``fn(leaf, spec, columns_of)`` over the tree with the specs of
    ``param_specs``; ``columns_of`` is wqkv's head split (None
    elsewhere). A QuantArray's q and scale take the same spec."""
    from kind_tpu_sim_torch.models.quant import QuantArray

    specs = param_specs(cfg, mesh)

    def walk(node, spec, name=None):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, s) for v, s in zip(node, spec)]
        cols = _qkv_columns(cfg) if name == "wqkv" else None
        if isinstance(node, QuantArray):
            return QuantArray(q=fn(node.q, spec, cols),
                              scale=fn(node.scale, spec, cols))
        return fn(node, spec, cols)

    return walk(params, specs)


def shard_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """This rank's shard of the whole tree ``params`` (every rank passes
    the same tree): ``param_specs``' placement, wqkv by heads. A leaf
    whose split dimension does not divide raises, as the reference's
    placement does (an int8 weight's (1, out) scale under a 'model' axis
    longer than 1)."""
    if mesh is None:
        return params
    if cfg.kv_heads % mesh.shape.get("model", 1):
        raise ValueError(
            f"kv_heads {cfg.kv_heads} not divisible by mesh model axis "
            f"{mesh.shape['model']}")

    return _placed(params, cfg, mesh,
                   lambda t, spec, cols: tp.shard_tensor(t, spec, mesh, cols))


def gather_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """``shard_params``' inverse: the whole tree on every rank."""
    if mesh is None:
        return params
    return _placed(params, cfg, mesh,
                   lambda t, spec, cols: tp.gather_tensor(t, spec, mesh,
                                                          cols))


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


def leaf_placements(cfg: ModelConfig, mesh=None) -> list:
    """``param_specs`` in ``_leaves`` order: (spec, columns_of) per leaf,
    as ``tp.shard_tensor`` and ``tp.gather_tensor`` take them."""
    specs = param_specs(cfg, mesh)

    def block(node, name=None):
        if isinstance(node, dict):
            return [s for key in sorted(node) for s in block(node[key], key)]
        return [(node, _qkv_columns(cfg) if name == "wqkv" else None)]

    return ([(specs["embed"], None), (specs["final_norm"], None)]
            + [s for b in specs["blocks"] for s in block(b)])


@torch.no_grad()
def sgd_step(params: Params, grads, lr: float) -> Params:
    """Plain SGD, ``p - lr * g`` for every leaf, IN PLACE: ``grads``
    is a list in ``_leaves`` order. Returns ``params``."""
    for p, g in zip(_leaves(params), grads):
        p.sub_(lr * g)
    return params


def _mean_over(tensors, ax):
    """Each tensor averaged over the ranks of ``ax`` (one flat fp32
    all-reduce)."""
    flat = tp.all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]),
                         ax) / ax.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t).to(t.dtype))
        at += t.numel()
    return out


def make_train_step(cfg: ModelConfig, mesh=None, learning_rate: float = 1e-2,
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
    loop on the CPU), built ``capturable`` on the card (its step count
    and bias correction on the device). ``use_optax=False`` is plain SGD
    (``sgd_step``).
    ``n_experts > 0`` trains the MoE through autograd, its auxiliary
    loss in the loss.

    With ``mesh`` every rank passes the same source; the state holds
    this rank's shards (``shard_params``) and ``"mesh"`` and ``"cfg"``
    entries (for ``models/checkpoint.py``), and
    ``step_fn`` takes this rank's block of the batch (``shard_batch``,
    or ``data.input_pipeline(mesh=...)``). The gradients are averaged
    over the ranks that share the batch (('dcn', 'data') and 'seq':
    ``Shards.token_group``), each rank's loss being its share of the
    global mean, and the returned loss is the global batch's; AdamW,
    elementwise, runs on the shards. ``seq_parallel`` rides the ring
    under a mesh with a 'seq' axis longer than 1 and is plain attention
    elsewhere, as in the reference.

    On a card the step is a compiled program, the reference's
    ``jax.jit(step)``: its first call runs eagerly (AdamW's moments are
    created) and captures a CUDA graph of the step, and every later call
    with the same state and token shape replays it (``graphs.
    round_runner``: without a mesh and on NCCL; a gloo mesh's steps stay
    eager). The tokens are copied into a fixed buffer first; the
    returned loss is a copy of the graph's. ``step_fn._round`` is the
    runner (``graphs.eager`` on the CPU)."""
    dev = resolve(device)
    shards = tp.shards_of(mesh)
    group = shards.token_group()

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
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
            params = _place_leaves(params)
        for p in _leaves(params):
            p.requires_grad_(True)
        opt = None
        if use_optax:
            opt = torch.optim.AdamW(
                _leaves(params), lr=learning_rate, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=1e-4, amsgrad=False,
                capturable=dev.type == "cuda")
        state = {"params": params, "opt": opt}
        if mesh is not None:
            # what a checkpoint needs to gather the shards and to cut a
            # whole state into them
            state["mesh"], state["cfg"] = mesh, cfg
        return state

    def step(state, tokens) -> tuple:
        params = state["params"]
        leaves = _leaves(params)
        with tp.scope(shards):
            loss = loss_fn(params, tokens, cfg)
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if group is not None:
            grads = _mean_over(grads, group)
            loss = _mean_over([loss], group)[0]
        if state["opt"] is None:
            sgd_step(params, grads, learning_rate)
        else:
            for p, g in zip(leaves, grads):
                p.grad = g
            state["opt"].step()
            for p in leaves:
                p.grad = None
        return (loss,)

    return _CompiledStep(step, dev, mesh), init_state


class _CompiledStep:
    """``make_train_step``'s ``step_fn(state, tokens) -> (state, loss)``:
    ``step(state, tokens)`` run through ``_round``
    (``graphs.round_runner``; the eager step's cached blocks make room
    for the graph's pool) on tokens copied into a fixed buffer of their
    shape. The returned loss is a copy of the program's."""

    def __init__(self, step, device, mesh):
        from kind_tpu_sim_torch.models import graphs

        self._step, self._device = step, device
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._round = graphs.round_runner(device, mesh, free_cached=True)

    def __call__(self, state, tokens):
        from kind_tpu_sim_torch.models import graphs

        key = (tuple(tokens.shape), tokens.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(
                tokens.shape, dtype=tokens.dtype, device=self._device)
        buf.copy_(tokens)
        # a step over other parameters or another optimizer is another
        # program
        key += (graphs.pointers(state["params"]), id(state["opt"]))
        loss, = self._round(key, functools.partial(self._step, state, buf))
        return state, loss.clone()


def _place_leaves(params):
    """Every leaf its own storage (a shard that is a view of the whole
    tree would keep the whole tensor alive)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.detach().clone()

    return walk(params)


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

