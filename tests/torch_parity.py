"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and cross between the two
packages as numpy arrays: the JAX package builds the weights
(``transformer.init_params``), the port receives them through
``weights.params_from_numpy``.
"""

import dataclasses

import numpy as np

from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.weights import params_from_numpy

# a small GQA config; scaling the block outputs up (and the embedding
# down) on both sides keeps greedy streams from repeating one token
TINY = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                       n_layers=2, d_ff=64, max_seq=64, dtype="float32",
                       flash=True)


def jax_cfg(cfg):
    """The JAX package's ModelConfig with the same fields."""
    from kind_tpu_sim.models import transformer as jtf

    return jtf.ModelConfig(**dataclasses.asdict(cfg))


def make_params(cfg, seed=0, embed_scale=1.0, block_scale=1.0):
    """(JAX params, port params on the CPU) holding the same fp32
    values: JAX init, optionally rescaled in numpy."""
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jtf.init_params(jax.random.PRNGKey(seed), jax_cfg(cfg)))
    tree["embed"] = tree["embed"] * np.float32(embed_scale)
    for block in tree["blocks"]:
        block["wo"] = block["wo"] * np.float32(block_scale)
        mlp = block.get("moe", block)
        mlp["w_down"] = mlp["w_down"] * np.float32(block_scale)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, params_from_numpy(tree, cfg, device="cpu")


def prompts(n, vocab, seed=0, base=4, step=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=base + step * i).tolist()
            for i in range(n)]


def drive(mod, eng, ps, max_new, late=2, **req):
    """Submit all but the last ``late`` prompts to an engine of either
    package (``mod`` is its serving module), run one round, submit the
    rest mid-flight, drain. Returns {request_id: Completion}."""
    split = len(ps) - late
    for i, p in enumerate(ps[:split]):
        eng.submit(mod.Request(f"r{i}", p, max_new=max_new, **req))
    eng.step_round()
    for i, p in enumerate(ps[split:], start=split):
        eng.submit(mod.Request(f"r{i}", p, max_new=max_new, **req))
    return {c.request_id: c for c in eng.run()}


def assert_margins(params, cfg, prompt, tokens, tol):
    """Every greedy step of ``tokens`` (continuing ``prompt``) is the
    argmax of the port's full forward with a top-2 logit margin above
    ``tol`` — so an equal-stream assertion cannot pass or fail on a
    near tie."""
    import torch

    seq = torch.tensor([list(prompt) + list(tokens[:-1])])
    logits = ptf.forward(params, seq, dataclasses.replace(cfg, flash=False))
    steps = logits[0, len(prompt) - 1:]
    assert steps.argmax(dim=-1).tolist() == list(tokens)
    top2 = steps.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).numpy()
    assert margins.min() > tol, (margins.min(), tol)


def assert_streams_split_only_at_ties(jparams, cfg, ps, got, want, rel):
    """Greedy streams ``got`` and ``want`` ({request id: tokens}, the
    prompts ``ps`` in request order "r0", "r1", ...) are equal, or each
    first splits where the JAX forward's top-2 logits (plain attention,
    on the reference's weights and config ``cfg``) lie within ``rel`` of
    its largest logit magnitude: int8 rounding on either side may turn
    a near tie, nothing else may. Returns the count of splits."""
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    assert sorted(got) == sorted(want)
    jcfg = jax_cfg(dataclasses.replace(cfg, flash=False))
    splits = 0
    for rid in sorted(want):
        a, b = list(got[rid]), list(want[rid])
        assert len(a) == len(b), rid
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = jnp.asarray([list(ps[int(rid[1:])]) + b[:i]], jnp.int32)
        logits = np.asarray(jtf.forward(jparams, seq, jcfg))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0]) / float(np.abs(logits).max())
        assert margin < rel, (rid, i, a[i], b[i], margin, rel)
        splits += 1
    return splits
