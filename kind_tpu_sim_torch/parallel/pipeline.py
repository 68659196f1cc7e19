"""Pipeline parallelism: GPipe-style microbatching over a 'stage' axis,
in PyTorch.

Counterpart of ``kind_tpu_sim/parallel/pipeline.py``. Each stage owns a
contiguous slice of the transformer blocks (``stack_stage_params``),
activations pass stage to stage with a point-to-point send to the next
rank of the stage axis (no wraparound), and M + S - 1 ticks run, the
bubbles included: at tick t stage 0 takes microbatch t (clamped; the
extras are discarded), every stage runs its layers (the port's
``transformer._block``, so with ``cfg.flash`` each stage launches the
flash forward once a layer a tick), the last stage keeps microbatch
t - (S - 1), and each stage hands its activations on. The last stage's
outputs then reach every rank. With a 'data' axis each microbatch is
split over it.

The hand-off's transport follows the world's backend
(``tp.start_exchange``): NCCL moves the card's tensors, gloo host
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from kind_tpu_sim_torch.parallel import tp


def stack_stage_params(params, n_stages: int):
    """The blocks' leaves stacked with a leading (n_stages,
    layers_per_stage) prefix: {leaf name: tensor} (an MoE block's
    ``moe`` a dict of its own)."""
    blocks = params["blocks"]
    n_layers = len(blocks)
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible into {n_stages} stages")
    per_stage = n_layers // n_stages

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        x = torch.stack(nodes)
        return x.reshape(n_stages, per_stage, *x.shape[1:])

    return stack(blocks)


def _stage_blocks(stacked, stage: int):
    """Stage ``stage``'s layers as block dicts, in order."""
    def pick(node, j):
        if isinstance(node, dict):
            return {k: pick(v, j) for k, v in node.items()}
        return node[stage, j]

    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [pick(stacked, j) for j in range(first.shape[1])]


def _apply_stage(blocks, x, cfg):
    """This stage's layers over activations x (mb, t, d)."""
    from kind_tpu_sim_torch.models.transformer import _block

    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    for bparams in blocks:
        x, _aux = _block(x, bparams, cfg, positions)
    return x


def _pipeline_local(x_mb, blocks, cfg, ax):
    """This rank's ticks. x_mb (M, mb, t, d): every microbatch (this
    rank's rows of it); returns the last stage's outputs, on every
    rank of ``ax``."""
    n_micro = x_mb.shape[0]
    stages, idx = ax.size, ax.index
    nxt = ax.ranks[idx + 1] if idx + 1 < stages else None
    prev = ax.ranks[idx - 1] if idx > 0 else None
    state = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for tick in range(n_micro + stages - 1):
        if idx == 0:
            state = x_mb[min(tick, n_micro - 1)]
        state = _apply_stage(blocks, state, cfg)
        if idx == stages - 1 and tick >= stages - 1:
            outputs[tick - (stages - 1)] = state
        state = tp.start_exchange(state, nxt, prev).wait()
    return tp.broadcast(outputs, ax, stages - 1)


def pipeline_forward(params, tokens, cfg, mesh, stage_axis: str = "stage",
                     n_microbatches: Optional[int] = None,
                     stacked_params=None):
    """The forward with the blocks pipelined over ``stage_axis``, called
    on every rank of ``mesh`` with the whole parameters and the whole
    ``tokens`` (batch, seq); batch must divide into ``n_microbatches``
    (default: the number of stages), and each microbatch over 'data'
    where the mesh has it. Returns the whole logits, as
    ``transformer.forward``, on every rank. Callers running it again
    pass ``stacked_params=stack_stage_params(params, stages)`` once."""
    from kind_tpu_sim_torch.device import torch_dtype
    from kind_tpu_sim_torch.models.quant import embed_lookup
    from kind_tpu_sim_torch.models.transformer import _readout, _rms_norm

    stages = mesh.shape[stage_axis]
    n_micro = n_microbatches or stages
    b, t = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} "
                         "microbatches")
    data_size = mesh.shape.get("data", 1)
    if (b // n_micro) % data_size:
        raise ValueError(
            f"microbatch size {b // n_micro} (batch {b} / {n_micro} "
            f"microbatches) not divisible over the 'data' mesh axis "
            f"of size {data_size}")
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    x_mb = x.reshape(n_micro, b // n_micro, t, cfg.d_model)
    data = tp.axis(mesh, "data")
    lo, hi = tp.split_rows(b // n_micro, data)
    stacked = (stacked_params if stacked_params is not None
               else stack_stage_params(params, stages))
    ax = tp.axis(mesh, stage_axis)
    with tp.scope(tp.Shards()):
        out = _pipeline_local(x_mb[:, lo:hi].contiguous(),
                              _stage_blocks(stacked, ax.index), cfg, ax)
    if data is not None:
        out = tp.all_gather(out, data, 1)
    x = _rms_norm(out.reshape(b, t, cfg.d_model), params["final_norm"])
    with tp.scope(tp.Shards()):
        return _readout(x, params["embed"])
