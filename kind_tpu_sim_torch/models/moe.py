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

The expert weights' sharding over a mesh (the reference's
``moe_param_specs``) belongs to the port's parallel layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F


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
    tanh form of GELU (``transformer._gelu``)."""
    from kind_tpu_sim_torch.models.transformer import _gelu

    b, t, d = x.shape
    s = b * t
    e = moe.n_experts
    capacity = max(1, int(moe.capacity_factor * s / e))

    tokens = x.reshape(s, d)
    logits = tokens.float() @ mparams["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # (s, e)
    expert_idx = torch.argmax(probs, dim=-1)                 # (s,)
    gate = probs.amax(dim=-1)                                # (s,)

    onehot = F.one_hot(expert_idx, e).float()                # (s, e)
    position = torch.cumsum(onehot, dim=0) * onehot - 1.0    # (s, e)
    keep = (position < capacity) & (onehot > 0)
    position = torch.where(keep, position, 0.0).long()
    pos_onehot = F.one_hot(position.amax(dim=-1), capacity).float()
    keep_any = keep.any(dim=-1).float()
    # dispatch[s, e, c] = 1 iff token s sits in slot c of expert e
    dispatch = ((onehot * keep_any[:, None])[:, :, None]
                * pos_onehot[:, None, :])

    dispatch_c = dispatch.to(x.dtype)
    expert_in = torch.einsum("sec,sd->ecd", dispatch_c, tokens)
    hidden = _gelu(torch.einsum("ecd,edf->ecf", expert_in,
                                mparams["w_up"].to(x.dtype)))
    expert_out = torch.einsum("ecf,efd->ecd", hidden,
                              mparams["w_down"].to(x.dtype))
    combine = dispatch_c * (gate * keep_any).to(x.dtype)[:, None, None]
    out = torch.einsum("sec,ecd->sd", combine, expert_out)

    # load-balancing loss (Switch eq. 4): E * sum_e f_e * P_e
    fraction = onehot.mean(dim=0)
    router_prob = probs.mean(dim=0)
    aux = moe.aux_loss_weight * e * torch.sum(fraction * router_prob)
    return out.reshape(b, t, d).to(x.dtype), aux
