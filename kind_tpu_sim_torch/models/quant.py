"""Matmul sites of the model: dense weights only.

Counterpart of ``kind_tpu_sim/models/quant.py``'s ``linear``,
``embed_lookup`` and ``readout``. The int8 ``QuantArray`` paths (weight
dequant, W8A8) are a later slice of the port; a weight that is not a
plain tensor raises.
"""

from __future__ import annotations

import torch


def _dense(w, where: str):
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"{where}: int8 QuantArray weights are not ported yet (the "
            "int8 slice of kind_tpu_sim_torch)")
    return w


def linear(x, w, dtype=None):
    """x @ w in the activation dtype: the product rounds to x.dtype,
    as the JAX package's ``x @ w.astype(x.dtype)`` does."""
    w = _dense(w, "linear")
    return x @ w.to(dtype or x.dtype)


def embed_lookup(embed, tokens, dtype):
    """Token embedding gather."""
    return _dense(embed, "embed_lookup")[tokens].to(dtype)


def readout(x, embed):
    """Weight-tied logits, fp32 out. The JAX einsum accumulates in fp32
    without rounding its output (``preferred_element_type``), so the
    product is taken in fp32 from the embedding-dtype values — a bare
    bf16 matmul would round the logits to bf16."""
    embed = _dense(embed, "readout")
    return x.to(embed.dtype).float() @ embed.float().t()
