"""Int8 quantization for the serving path (weights and KV cache).

Counterpart of ``kind_tpu_sim/models/quant.py``. ``QuantArray(q, scale)``
holds a symmetric int8 tensor: w ~ q * scale, ``scale`` fp32 with the
quantized axis kept as size 1, so ``q * scale`` broadcasts whichever
axis was quantized (per output channel for matmul weights, per row for
the embedding and the KV cache's (batch, position, kv head) rows).

The model's matmul sites (``linear``, ``embed_lookup``, ``readout``)
take a plain tensor or a QuantArray, so one forward serves fp32
training parameters, bf16 serving snapshots and int8 snapshots. Two
int8 paths, as in the JAX package:

* dequant (default): the int8 weight is cast to the activation dtype
  at the product, the product accumulates in fp32 (the reference's
  ``preferred_element_type``; here an fp32 product of the cast values,
  whose every term is exact) and the scale multiplies the fp32 result
  before the cast back;
* native W8A8 (``ModelConfig.int8_native``): the activation is
  quantized per row (``quant_rows``) and the contraction is the exact
  int8 x int8 -> int32 product of ``ops/int8_matmul.py`` (the CUDA
  kernel on the card); the row and channel scales multiply the int32
  result.

Every quantization step is the reference's, operation by operation:
fp32 abs-max, ``max(., 1e-8) / 127``, the division, round half to even
(``torch.round``, as ``jnp.round``), the clip to +-127.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kind_tpu_sim_torch.device import torch_dtype
from kind_tpu_sim_torch.ops.int8_matmul import int8_matmul


class QuantArray(NamedTuple):
    """Per-channel symmetric int8 tensor: w ~ q * scale. ``scale`` keeps
    the quantized axis as size 1."""

    q: torch.Tensor       # int8, the original tensor's shape
    scale: torch.Tensor   # fp32, that shape with the quantized axis 1

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def device(self):
        return self.q.device


def quantize(w, axis: int = 0) -> QuantArray:
    """Symmetric int8 over ``axis`` (the reduction axis of the matmul),
    one scale per output channel."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantArray(q=q, scale=scale)


def dequantize(qa: QuantArray, dtype=None):
    return (qa.q.float() * qa.scale).to(dtype or torch.float32)


def quant_rows(x):
    """Dynamic symmetric int8 over the LAST axis (one scale per row):
    the activation half of W8A8. Returns (q, scale)."""
    qa = quantize(x, axis=-1)
    return qa.q, qa.scale


def _int8_rows_matmul(xq, bq, n: int):
    """xq (..., K) int8 against a 2-D int8 b (K, N), any leading shape:
    the exact int32 product (..., N)."""
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), bq)
    return acc.reshape(lead + (n,))


def linear(x, w, dtype=None, native=False):
    """x @ w for a plain tensor or a QuantArray weight (quantized along
    axis 0: scale (1, out)). Plain: the product in the activation dtype,
    rounded to it, as ``x @ w.astype(x.dtype)``. Dequant: fp32
    accumulation, the channel scale on the fp32 result, then the cast.
    Native: W8A8 through the exact int32 product."""
    if isinstance(w, QuantArray):
        if w.scale.shape[0] != 1:
            raise ValueError(
                "linear() needs a weight quantized along axis 0 "
                f"(scale shape (1, out)); got scale {tuple(w.scale.shape)}")
        if native:
            xq, xs = quant_rows(x)
            acc = _int8_rows_matmul(xq, w.q, w.q.shape[1])
            return (acc.float() * xs * w.scale[0]).to(x.dtype)
        out = x.float() @ w.q.float()
        return (out * w.scale[0]).to(x.dtype)
    return x @ w.to(dtype or x.dtype)


def embed_lookup(embed, tokens, dtype):
    """Token embedding gather for a plain or a per-row quantized table;
    the quantized rows and their scales multiply in ``dtype``."""
    if isinstance(embed, QuantArray):
        rows = embed.q[tokens].to(dtype)
        return rows * embed.scale[tokens].to(dtype)
    return embed[tokens].to(dtype)


def readout(x, embed, native=False):
    """Weight-tied logits, fp32 out, against a plain or quantized
    embedding. Plain: the JAX einsum accumulates in fp32 without
    rounding its output, so the product is taken in fp32 from the
    embedding-dtype values (a bare bf16 matmul would round the logits
    to bf16). Quantized: the dequant or native product, then the
    per-row scale; the native product reads ``embed.q`` in place."""
    if isinstance(embed, QuantArray):
        if native:
            xq, xs = quant_rows(x)
            acc = _int8_rows_matmul(xq, embed.q.t(), embed.q.shape[0])
            return (acc.float() * xs * embed.scale[:, 0]).float()
        logits = x.float() @ embed.q.float().t()
        return (logits * embed.scale[:, 0]).float()
    return x.to(embed.dtype).float() @ embed.float().t()


# the block matmul weights, quantized along axis 0 (K) and held K-major
K_MAJOR = ("wqkv", "wo", "w_up", "w_down")


def k_major(qa: QuantArray) -> QuantArray:
    """The same (K, N) int8 weight with K contiguous: the (K, N) view of
    an (N, K) contiguous tensor. Shape, dtype and values are unchanged;
    the W8A8 product's tensor-core route reads B only K-major (the
    8-bit wgmma forms have no transpose), and its GEMV route reads each
    column's K run in 16-byte loads."""
    return QuantArray(q=qa.q.t().contiguous().t(), scale=qa.scale)


@torch.no_grad()
def quantize_params(params, cfg):
    """Int8 snapshot of the parameters for serving: the embedding per
    row, the block matmul weights per output channel, held K-major
    (``k_major``); norms stay as they are; an MoE subtree keeps its
    router as it is and its experts in the activation dtype. Runs
    without autograd."""
    dtype = torch_dtype(cfg.dtype)
    out = {"embed": quantize(params["embed"], axis=1),
           "final_norm": params["final_norm"], "blocks": []}
    for block in params["blocks"]:
        qblock = {"attn_norm": block["attn_norm"],
                  "mlp_norm": block["mlp_norm"],
                  "wqkv": k_major(quantize(block["wqkv"])),
                  "wo": k_major(quantize(block["wo"]))}
        if "moe" in block:
            qblock["moe"] = {"router": block["moe"]["router"],
                             "w_up": block["moe"]["w_up"].to(dtype),
                             "w_down": block["moe"]["w_down"].to(dtype)}
        else:
            qblock["w_up"] = k_major(quantize(block["w_up"]))
            qblock["w_down"] = k_major(quantize(block["w_down"]))
        out["blocks"].append(qblock)
    return out
