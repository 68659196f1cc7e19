"""Parameter trees from numpy: the bridge from the JAX package's params.

A JAX parameter tree (the same dict/list nesting, leaves as numpy
arrays — e.g. ``jax.tree_util.tree_map(lambda a: np.asarray(a,
np.float32), params)``) becomes the port's parameter dict. bf16 leaves
cross as fp32 numpy arrays and are cast back to bf16 here, which is
lossless, so no bf16 numpy dtype is needed on this side. An int8
weight crosses as an object with ``.q`` and ``.scale`` (the JAX
package's ``QuantArray`` of numpy arrays) or a ``(q, scale)`` tuple
whose q is int8, and becomes the port's ``quant.QuantArray`` (a block
matmul weight's held K-major, as ``quant.quantize_params`` holds it);
an MoE block's ``moe`` subtree crosses as a dict.
"""

from __future__ import annotations

import numpy as np
import torch

from kind_tpu_sim_torch.device import resolve
from kind_tpu_sim_torch.models.quant import K_MAJOR, QuantArray, k_major


def params_from_numpy(tree, cfg, device="cuda", dtype=None):
    """numpy tree -> torch params on ``device``. With ``dtype`` the
    leaves of two or more dimensions (matmul weights, embedding, MoE
    experts) are cast to it; 1-D leaves (norm scales) and the MoE
    ``router`` stay fp32 — the layout of ``decode.serving_params``. An
    int8 weight's q and scale are never cast. Shapes are checked
    against ``cfg``."""
    dev = resolve(device)

    def tensor(leaf):
        return torch.from_numpy(np.array(leaf)).to(dev)

    def quant(q, scale, name):
        qa = QuantArray(q=tensor(q), scale=tensor(scale))
        return k_major(qa) if name in K_MAJOR else qa

    def walk(node, name=None):
        if hasattr(node, "q") and hasattr(node, "scale"):
            return quant(node.q, node.scale, name)
        if (isinstance(node, tuple) and len(node) == 2
                and np.asarray(node[0]).dtype == np.int8):
            return quant(node[0], node[1], name)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        t = tensor(node)
        if dtype is not None and t.ndim >= 2 and name != "router":
            t = t.to(dtype)
        return t

    params = walk(tree)
    if tuple(params["embed"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(
            f"embed shape {tuple(params['embed'].shape)} does not match "
            f"cfg ({cfg.vocab_size}, {cfg.d_model})")
    if len(params["blocks"]) != cfg.n_layers:
        raise ValueError(
            f"{len(params['blocks'])} blocks; cfg has {cfg.n_layers}")
    return params
