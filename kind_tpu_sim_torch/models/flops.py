"""Analytic FLOP and device-memory byte accounting for the flagship model.

Counterpart of ``kind_tpu_sim/models/flops.py``: the same functions over
the port's own ``ModelConfig``, giving the reference's numbers, so every
throughput the port's bench reports carries the reference's yardstick --
MFU for the compute-bound phases (training, the forward, prefill) and
achieved GB/s against the memory roofline for decode.

All accounting is exact matmul arithmetic derived from ``ModelConfig``
(2 FLOPs per multiply-accumulate); elementwise work (norms, rotary,
softmax, residuals) is O(d) per token and deliberately excluded, which
makes the reported MFU slightly conservative.

The chip table is keyed by ``torch.cuda.get_device_name()`` and holds
NVIDIA's data-sheet rates of the H100 SXM part (dense, no sparsity). The
readout accumulates in fp32, as in the reference, and MFU counts its
FLOPs at the bf16 peak, as the reference does. An unknown device name
raises: the reference falls back to a TPU v5e, which would price a GPU
as a TPU. ``TPU_SIM_PEAK_TFLOPS`` and ``TPU_SIM_PEAK_GBPS`` override the
peaks, as there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

from kind_tpu_sim_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers for one accelerator (public data-sheet values)."""

    name: str
    peak_bf16_tflops: float
    peak_int8_tops: float
    hbm_gib: float
    hbm_gbps: float          # GB/s (decimal)


# Keyed by torch.cuda.get_device_name(). NVIDIA's H100 SXM data sheet:
# 989 TFLOP/s bf16 dense, 1979 TOP/s int8 dense, 3.35 TB/s; the memory
# is the card's own total_memory / 2**30 (torch reads 85,017,493,504
# bytes on an "NVIDIA H100 80GB HBM3, 700.00 W" card).
CHIPS: Dict[str, ChipSpec] = {
    "NVIDIA H100 80GB HBM3": ChipSpec("h100-sxm", 989.0, 1979.0,
                                      79.1787109375, 3350.0),
}


def chip_spec(device_name: str | None) -> ChipSpec:
    """Spec for the local card by its device name; an unknown name
    raises. Overridable for odd hosts via ``TPU_SIM_PEAK_TFLOPS`` /
    ``TPU_SIM_PEAK_GBPS``."""
    spec = CHIPS.get(device_name or "")
    if spec is None:
        raise ValueError(
            f"no chip spec for device {device_name!r}; known: "
            f"{', '.join(sorted(CHIPS))}")
    tflops = os.environ.get("TPU_SIM_PEAK_TFLOPS")
    gbps = os.environ.get("TPU_SIM_PEAK_GBPS")
    if tflops or gbps:
        spec = dataclasses.replace(
            spec,
            name=spec.name + "-override",
            peak_bf16_tflops=float(tflops or spec.peak_bf16_tflops),
            hbm_gbps=float(gbps or spec.hbm_gbps),
        )
    return spec


# ---------------------------------------------------------------------
# parameter / FLOP accounting


def matmul_params(cfg: ModelConfig) -> Dict[str, int]:
    """Element counts of every matmul weight the forward pass reads.

    MoE configs count all experts for storage ('total') but only the
    per-token-active expert weights for FLOPs ('active' -- Switch
    routing is top-1, so one expert's up+down per token).
    """
    d, ff = cfg.d_model, cfg.d_ff
    wqkv = d * (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim
    wo = d * d
    if cfg.n_experts > 0:
        mlp_total = cfg.n_experts * 2 * d * ff + d * cfg.n_experts
        mlp_active = 2 * d * ff + d * cfg.n_experts
    else:
        mlp_total = mlp_active = 2 * d * ff
    readout = cfg.vocab_size * d  # weight-tied embedding, read as logits
    return {
        "per_layer_total": wqkv + wo + mlp_total,
        "per_layer_active": wqkv + wo + mlp_active,
        "readout": readout,
        "total": cfg.n_layers * (wqkv + wo + mlp_total) + readout,
        "active": cfg.n_layers * (wqkv + wo + mlp_active) + readout,
    }


def step_peak_bytes(cfg: ModelConfig, batch: int, seq: int,
                    flash: bool = False, backward: bool = True,
                    optimizer: bool = True) -> float:
    """Rough device-memory high-water estimate for one fwd(+bwd+opt)
    step -- the bench's out-of-memory gate, not an allocator model.

    Terms: weights bf16 (matmul_params 'total'; the embedding is
    weight-tied, so it is counted once as the readout); grads bf16 +
    AdamW m/v in fp32 when training; fp32 logits (the forward's output)
    plus their fp32 cotangent on the backward; ~8 saved (b,t,d)
    residual activations and 2 (b,t,ff) MLP activations per layer for
    the backward (one block's worth plus the block boundaries with
    ``cfg.remat``); and, without flash, the per-layer (b, heads, t, t)
    fp32 probability matrices the dense backward keeps, transient-only
    (x2 working set) on the forward."""
    P = matmul_params(cfg)["total"]
    b, t = batch, seq
    bytes_ = 2.0 * P                       # bf16 weights
    per_layer_acts = (8 * b * t * cfg.d_model * 2.0
                      + 2 * b * t * cfg.d_ff * 2.0)
    if backward:
        bytes_ += 2.0 * P                  # bf16 grads
        if optimizer:
            bytes_ += 8.0 * P              # fp32 adam m+v
        if cfg.remat:
            # only the block-boundary residual per layer is kept; one
            # block's internals exist transiently during its recompute
            bytes_ += (b * t * cfg.d_model * 2.0 * cfg.n_layers
                       + per_layer_acts)
        else:
            bytes_ += per_layer_acts * cfg.n_layers
    # fp32 logits are the forward's live output either way; the
    # backward also holds their cotangent
    bytes_ += 4.0 * b * t * cfg.vocab_size * (2 if backward else 1)
    if not flash:
        probs = 4.0 * b * cfg.n_heads * float(t) * t   # fp32
        # remat recomputes scores one layer at a time (a transient x2
        # working set, like the forward)
        held = (cfg.n_layers if backward and not cfg.remat else 2)
        bytes_ += probs * held
    return bytes_


def fwd_flops_per_token(cfg: ModelConfig, seq: int) -> float:
    """Forward matmul FLOPs per token at sequence length ``seq``.

    2 * active matmul params, plus causal attention: each token at
    position p attends to p+1 keys; averaged over the sequence that is
    (seq+1)/2 positions, with 2*d FLOPs for q·k and 2*d for probs·v
    per (query, key) pair.
    """
    p = matmul_params(cfg)
    t_eff = (seq + 1) / 2.0
    attn = cfg.n_layers * 4.0 * cfg.d_model * t_eff
    return 2.0 * p["active"] + attn


def attention_flops(seq: int, n_heads: int, head_dim: int,
                    batch: int = 1, causal: bool = True) -> float:
    """Total FLOPs of one attention computation (no projections):
    4*head_dim per (query, key) pair per head -- 2*d for q·k and 2*d
    for probs·v -- over t*(t+1)/2 causal pairs (t^2 bidirectional)."""
    pairs = (seq * (seq + 1) / 2.0) if causal else float(seq) * seq
    return 4.0 * head_dim * n_heads * batch * pairs


def train_flops_per_token(cfg: ModelConfig, seq: int) -> float:
    """Full train-step FLOPs per token: fwd + bwd (2x fwd) = 3x.

    The optimizer update is elementwise (O(params) per *step*, not per
    token) and excluded, consistent with the standard 6N+attention MFU
    convention.
    """
    return 3.0 * fwd_flops_per_token(cfg, seq)


def mfu(tokens_per_s: float, flops_per_token: float,
        spec: ChipSpec) -> float:
    """Model FLOPs utilization as a percentage of the bf16 peak."""
    achieved = tokens_per_s * flops_per_token
    return 100.0 * achieved / (spec.peak_bf16_tflops * 1e12)


def train_step_breakdown(cfg: ModelConfig, batch: int, seq: int,
                         spec: ChipSpec, flash: bool = True,
                         backward: bool = True) -> Dict[str, float]:
    """Analytic per-component LOWER BOUNDS (ms) for one train step.

    Each component is bounded by max(its matmul FLOPs at the bf16 peak,
    its unavoidable device-memory bytes at peak bandwidth), assuming
    perfect fusion inside a component and no overlap between components
    (the sum is therefore a lower bound on the step).

    Components: the GEMM families (wqkv, wo, mlp up+down, readout --
    fwd + dgrad + wgrad = 3x fwd FLOPs), attention (flash: fwd + ~2.5x
    bwd incl. its recompute = 3.5x fwd FLOPs, near-zero score traffic;
    dense: adds the fp32 (t,t) score-matrix round trips), cross-entropy
    over the vocab (3 fp32 passes over (tokens, vocab) logits), embed
    gather + scatter-add grad, the optimizer update (7 fp32 passes over
    params) and the per-layer elementwise glue (~12 bf16 passes over
    activations per layer fwd+bwd). ``backward=False`` gives the
    forward-only (loss_fn) bounds."""
    tokens = float(batch * seq)
    peak = spec.peak_bf16_tflops * 1e12
    bw = spec.hbm_gbps * 1e9
    p = matmul_params(cfg)
    d, L = cfg.d_model, cfg.n_layers

    def ms(flops=0.0, bytes_=0.0):
        return round(1e3 * max(flops / peak, bytes_ / bw), 3)

    gemm_f = 6.0 if backward else 2.0
    gemm_layer = gemm_f * p["per_layer_active"] * L * tokens
    t_eff = (seq + 1) / 2.0
    attn_fwd = 4.0 * d * t_eff * tokens * L
    if flash:
        attn = ms(flops=(3.5 if backward else 1.0) * attn_fwd,
                  bytes_=10.0 * tokens * d * 2.0)
    else:
        # fp32 score matrix: write+read through softmax fwd, again in
        # bwd -- 4 passes over (heads, t, t) per layer (2 fwd-only)
        score_bytes = ((4.0 if backward else 2.0) * L * cfg.n_heads
                       * batch * float(seq) * seq * 4.0)
        attn = ms(flops=(3.0 if backward else 1.0) * attn_fwd,
                  bytes_=score_bytes)
    n_params = float(p["total"])
    out = {
        "gemms_ms": ms(flops=gemm_layer),
        "readout_gemm_ms": ms(flops=gemm_f * p["readout"] * tokens),
        "attention_ms": attn,
        "ce_loss_ms": ms(bytes_=(3.0 if backward else 2.0)
                         * tokens * cfg.vocab_size * 4.0),
        "embed_ms": ms(bytes_=tokens * d
                       * ((2.0 + 4.0) if backward else 2.0)),
        "optimizer_ms": (ms(bytes_=7.0 * n_params * 4.0)
                         if backward else 0.0),
        "elementwise_ms": ms(bytes_=(12.0 if backward else 5.0)
                             * L * tokens * d * 2.0),
    }
    out["step_lower_bound_ms"] = round(sum(out.values()), 2)
    return out


# ---------------------------------------------------------------------
# decode byte accounting (bandwidth roofline)


def decode_bytes_per_step(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    weight_bytes: int = 2,
    kv_bytes: int = 2,
) -> Dict[str, float]:
    """Device-memory bytes one greedy decode step moves, by source.

    Every step re-reads every matmul weight once (weights are shared
    across the batch) and the full live KV cache (which scales with
    batch). Scales for int8 tensors are fp32 with one element per
    quantized row/channel -- included, they are what separates the int8
    theory (2x) from int8 practice.
    """
    p = matmul_params(cfg)
    weights = float(p["active"]) * weight_bytes
    scale_bytes = 0.0
    if weight_bytes == 1:
        # per-out-channel scales for block matmuls; per-row for embed
        d, ff = cfg.d_model, cfg.d_ff
        per_layer = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim \
            + d + ff + d
        scale_bytes = 4.0 * (cfg.n_layers * per_layer + cfg.vocab_size)
    kv_elems = (2.0 * cfg.n_layers * batch * cache_len
                * cfg.kv_heads * cfg.head_dim)
    kv_read = kv_elems * kv_bytes
    kv_scale_read = 0.0
    if kv_bytes == 1:
        # one fp32 scale per (layer, k/v, batch, position, kv_head) row
        kv_scale_read = (2.0 * cfg.n_layers * batch * cache_len
                         * cfg.kv_heads * 4.0)
    kv_write = (2.0 * cfg.n_layers * batch
                * cfg.kv_heads * cfg.head_dim * kv_bytes)
    total = weights + scale_bytes + kv_read + kv_scale_read + kv_write
    return {
        "weights": weights + scale_bytes,
        "kv": kv_read + kv_scale_read + kv_write,
        "total": total,
    }


def decode_roofline(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    tokens_per_s: float,
    spec: ChipSpec,
    weight_bytes: int = 2,
    kv_bytes: int = 2,
) -> Dict[str, float]:
    """Achieved memory bandwidth implied by a measured decode rate.

    ``tokens_per_s`` counts generated tokens across the batch; one
    step generates ``batch`` tokens, so steps/s = tokens_per_s/batch.
    """
    b = decode_bytes_per_step(cfg, batch, cache_len, weight_bytes,
                              kv_bytes)
    steps_per_s = tokens_per_s / batch
    achieved = b["total"] * steps_per_s
    return {
        "bytes_per_step_mb": round(b["total"] / 1e6, 1),
        "weight_mb": round(b["weights"] / 1e6, 1),
        "kv_mb": round(b["kv"] / 1e6, 1),
        "achieved_gbps": round(achieved / 1e9, 1),
        "roof_gbps": spec.hbm_gbps,
        "roof_frac": round(achieved / (spec.hbm_gbps * 1e9), 3),
    }
