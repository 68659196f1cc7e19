"""Parameter trees from numpy: the bridge from the JAX package's params.

A JAX parameter tree (the same dict/list nesting, leaves as numpy
arrays — e.g. ``jax.tree_util.tree_map(lambda a: np.asarray(a,
np.float32), params)``) becomes the port's parameter dict. bf16 leaves
cross as fp32 numpy arrays and are cast back to bf16 here, which is
lossless, so no bf16 numpy dtype is needed on this side.
"""

from __future__ import annotations

import numpy as np
import torch

from kind_tpu_sim_torch.device import resolve


def params_from_numpy(tree, cfg, device="cuda", dtype=None):
    """numpy tree -> torch params on ``device``. With ``dtype`` the
    leaves of two or more dimensions (matmul weights, embedding) are
    cast to it and 1-D leaves (norm scales) stay fp32 — the layout of
    ``decode.serving_params``. Shapes are checked against ``cfg``."""
    dev = resolve(device)

    def convert(leaf):
        t = torch.from_numpy(np.array(leaf)).to(dev)
        if dtype is not None and t.ndim >= 2:
            t = t.to(dtype)
        return t

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return convert(node)

    params = walk(tree)
    if tuple(params["embed"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(
            f"embed shape {tuple(params['embed'].shape)} does not match "
            f"cfg ({cfg.vocab_size}, {cfg.d_model})")
    if len(params["blocks"]) != cfg.n_layers:
        raise ValueError(
            f"{len(params['blocks'])} blocks; cfg has {cfg.n_layers}")
    return params
