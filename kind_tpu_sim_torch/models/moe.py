"""Switch-style Mixture-of-Experts MLP, in PyTorch.

Counterpart of ``kind_tpu_sim/models/moe.py``: top-1 (Switch
Transformer) routing with capacity-based token dropping and the
load-balancing auxiliary loss, dispatched densely. A one-hot
(tokens, experts, capacity) dispatch tensor and einsums move tokens to
the experts and back, so every shape is static: no ragged tensors, no
host-side routing.

The tokens routed together in one call share the experts' capacity,
``max(1, int(capacity_factor * tokens / experts))``; a token past its
expert's capacity is dropped (its MLP output is zero, the residual
stream carries it). So which tokens share a call is part of the
result: the callers route exactly the sets the JAX package routes
(``transformer._moe``).

Over a mesh (``moe_param_specs``) each rank holds the experts of its
slice of the 'expert' axis (else 'model'); the tokens are replicated
over that axis, each rank runs its own experts and the combine is
summed over it (``parallel.tp``). While the tokens of the call are
split over data ranks (rows) and 'seq' ranks (columns), routing keeps
the global batch's semantics, as GSPMD's does: capacity from the global
token count, each token's queue position that of the flattened global
(batch, seq) order (after every token of the rows before its row, and
after its row's tokens on the lower 'seq' ranks), the auxiliary loss's
means over every token.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from kind_tpu_sim_torch.parallel import tp


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 4
    capacity_factor: float = 2.0
    aux_loss_weight: float = 1e-2


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    moe: MoeConfig) -> Dict[str, Any]:
    """Random fp32 router and expert weights with the reference's shapes
    and scales, drawn from ``generator`` (a torch.Generator) on its
    device, in the order router, w_up, w_down."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=generator.device,
                           dtype=torch.float32) * scale

    return {
        "router": normal((d_model, moe.n_experts), d_model ** -0.5),
        "w_up": normal((moe.n_experts, d_model, d_ff), d_model ** -0.5),
        "w_down": normal((moe.n_experts, d_ff, d_model), d_ff ** -0.5),
    }


def moe_mlp(x, mparams, moe: MoeConfig) -> Tuple[Any, Any]:
    """x (batch, seq, d) -> (out (batch, seq, d), aux_loss scalar), all
    batch x seq tokens routed as one group.

    The router runs in fp32 (softmax and argmax, which takes the first
    of equal maxima, as ``jnp.argmax`` does); each token's position in
    its expert's queue is the running count of earlier tokens sent
    there; the expert products run in the activation dtype, with the
    tanh form of GELU (``transformer._gelu``). Under a scope with an
    expert axis ``mparams`` holds this rank's experts; with a data or
    'seq' axis ``x`` is this rank's block of the call's tokens (with
    ``seq_tokens`` set, the positions past it are not routed: their
    output is zero)."""
    shards = tp.current()
    b, t, d = x.shape
    seq = shards.seq
    if seq is not None and shards.seq_tokens:
        kept = min(t, max(0, shards.seq_tokens - seq.index * t))
        if kept < t:
            out, aux = _route(x[:, :kept], mparams, moe, shards)
            return torch.cat([out, x.new_zeros(b, t - kept, d)], 1), aux
    return _route(x, mparams, moe, shards)


def _queue(onehot, b: int, t: int, group, seq):
    """Each token's place in its expert's queue, counting from 1, in
    the flattened global (batch, seq) order: the local running count
    along the row plus the tokens of earlier rows and of the same
    row's lower 'seq' ranks, from every rank's per-row counts."""
    if group is None:
        return torch.cumsum(onehot, dim=0)
    e = onehot.shape[-1]
    rows = onehot.reshape(b, t, e)
    queue = torch.cumsum(rows, dim=1)
    n_seq = 1 if seq is None else seq.size
    counts = tp.all_gather(rows.sum(dim=1)[None], group, 0).reshape(
        group.size // n_seq, n_seq, b, e)
    per_row = counts.sum(dim=1).reshape(-1, e)    # global rows in order
    before = torch.cumsum(per_row, dim=0) - per_row
    d_i, s_i = divmod(group.index, n_seq)
    offset = before[d_i * b:(d_i + 1) * b] + counts[d_i, :s_i].sum(dim=0)
    return (queue + offset[:, None]).reshape(-1, e)


def _route(x, mparams, moe: MoeConfig, shards):
    from kind_tpu_sim_torch.models.transformer import _gelu

    group, seq, ex = shards.token_group(), shards.seq, shards.expert
    b, t, d = x.shape
    s = b * t
    e = moe.n_experts
    if group is None:
        total = s
    elif seq is None:
        total = s * group.size
    else:
        total = (group.size // seq.size) * b * (shards.seq_tokens
                                                or t * seq.size)
    capacity = max(1, int(moe.capacity_factor * total / e))

    tokens = x.reshape(s, d)
    logits = tokens.float() @ mparams["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # (s, e)
    expert_idx = torch.argmax(probs, dim=-1)                 # (s,)
    gate = probs.amax(dim=-1)                                # (s,)

    onehot = F.one_hot(expert_idx, e).float()                # (s, e)
    position = _queue(onehot, b, t, group, seq) * onehot - 1.0  # (s, e)
    keep = (position < capacity) & (onehot > 0)
    position = torch.where(keep, position, 0.0).long()
    pos_onehot = F.one_hot(position.amax(dim=-1), capacity).float()
    keep_any = keep.any(dim=-1).float()
    # dispatch[s, e, c] = 1 iff token s sits in slot c of expert e
    dispatch = ((onehot * keep_any[:, None])[:, :, None]
                * pos_onehot[:, None, :])

    weight = gate * keep_any
    if ex is not None:
        # this rank's experts: the replicated tokens and combine weights
        # enter the split region, the partial combines are summed
        lo = ex.index * mparams["w_up"].shape[0]
        dispatch = dispatch[:, lo:lo + mparams["w_up"].shape[0]]
        tokens, weight = tp.copy_in(tokens, ex), tp.copy_in(weight, ex)
    dispatch_c = dispatch.to(x.dtype)
    expert_in = torch.einsum("sec,sd->ecd", dispatch_c, tokens)
    hidden = _gelu(torch.einsum("ecd,edf->ecf", expert_in,
                                mparams["w_up"].to(x.dtype)))
    expert_out = torch.einsum("ecf,efd->ecd", hidden,
                              mparams["w_down"].to(x.dtype))
    combine = dispatch_c * weight.to(x.dtype)[:, None, None]
    out = tp.reduce_out(torch.einsum("sec,ecd->sd", combine, expert_out), ex)

    # load-balancing loss (Switch eq. 4): E * sum_e f_e * P_e
    if group is None:
        fraction = onehot.mean(dim=0)
        router_prob = probs.mean(dim=0)
    else:
        fraction = tp.all_reduce(onehot.sum(dim=0), group) / total
        router_prob = tp.sum_across(probs.sum(dim=0), group) / total
    aux = moe.aux_loss_weight * e * torch.sum(fraction * router_prob)
    return out.reshape(b, t, d).to(x.dtype), aux


def moe_param_specs(mesh=None):
    """The expert dimension of w_up / w_down over 'expert' (preferred)
    or 'model'; the router replicated (the reference's PartitionSpecs,
    as tuples)."""
    axis = None
    if mesh is not None:
        names = mesh.axis_names
        axis = "expert" if "expert" in names else (
            "model" if "model" in names else None)
    return {
        "router": (None, None),
        "w_up": (axis, None, None),
        "w_down": (axis, None, None),
    }
