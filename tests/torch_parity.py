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


# ---------------------------------------------------------------------
# rank programs for the mesh tests: module-level (the spawned ranks
# import them by name), torch only, every input picklable


def tree_numpy(jparams):
    """A JAX parameter tree as numpy (what crosses to spawned ranks)."""
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a), jparams)


def mesh_rank_serve(tree, cfg, shape, names, cases):
    """On every rank: a ``Mesh(shape, names)``, the port's params from
    ``tree``, then each case served on the mesh. A case is a dict:
    ``engine`` (class name), ``knobs`` (ServingConfig kwargs), ``reqs``
    [(id, prompt, max_new)] and optionally ``draft`` ((tree, cfg)),
    ``cfg`` (another config for the same tree), ``mesh`` ((shape,
    names) of another mesh over the same ranks) and ``int8``
    (``quant.quantize_params`` first). Returns, per case, ({id:
    (tokens, finish_reason)}, report()["mesh"]) or ("raise",
    message)."""
    from kind_tpu_sim_torch.models import quant as pquant
    from kind_tpu_sim_torch.models import serving as pserving
    from kind_tpu_sim_torch.parallel.mesh import Mesh

    meshes = {(tuple(shape), tuple(names)): Mesh(shape, names)}
    results = []
    for case in cases:
        ccfg = case.get("cfg") or cfg
        key = tuple(map(tuple, case.get("mesh") or (shape, names)))
        if key not in meshes:
            meshes[key] = Mesh(*key)
        params = params_from_numpy(tree, ccfg, device="cpu")
        if case.get("int8"):
            params = pquant.quantize_params(params, ccfg)
        extra = {}
        if case.get("draft") is not None:
            dtree, dcfg = case["draft"]
            extra["draft"] = (params_from_numpy(dtree, dcfg, device="cpu"),
                              dcfg)
        try:
            eng = getattr(pserving, case["engine"])(
                params, ccfg, pserving.ServingConfig(**case["knobs"]),
                device="cpu", mesh=meshes[key], **extra)
        except ValueError as exc:
            results.append(("raise", str(exc)))
            continue
        for rid, prompt, n in case["reqs"]:
            eng.submit(pserving.Request(rid, list(prompt), max_new=n))
        done = eng.run()
        results.append(({c.request_id: (tuple(c.tokens), c.finish_reason)
                          for c in done}, eng.report()["mesh"]))
    return results


def serve_plain(params, cfg, engine, knobs, reqs, draft=None):
    """The same case on the port without a mesh: {id: (tokens,
    finish_reason)}."""
    from kind_tpu_sim_torch.models import serving as pserving

    extra = {} if draft is None else {"draft": draft}
    eng = getattr(pserving, engine)(params, cfg,
                                    pserving.ServingConfig(**knobs),
                                    device="cpu", **extra)
    for rid, prompt, n in reqs:
        eng.submit(pserving.Request(rid, list(prompt), max_new=n))
    return {c.request_id: (tuple(c.tokens), c.finish_reason)
            for c in eng.run()}


def mesh_rank_smokes():
    """On 8 ranks: the mesh constructors (shapes, names, errors) and
    every collective smoke. Returns a dict of what each gave."""
    from kind_tpu_sim_torch.parallel import collectives
    from kind_tpu_sim_torch.parallel import mesh as pmesh

    def error(fn):
        try:
            fn()
        except (ValueError, RuntimeError) as exc:
            return f"{type(exc).__name__}: {exc}"
        return None

    out = {}
    m = pmesh.training_mesh(2, 4)
    out["training"] = (m.devices.shape, m.axis_names)
    out["training_seq"] = pmesh.training_mesh(2, 2, 2).axis_names
    out["training_32"] = error(lambda: pmesh.training_mesh(4, 8))
    out["slice_16"] = error(lambda: pmesh.slice_mesh(pmesh.make_slice()))
    s8 = pmesh.slice_mesh(pmesh.make_slice(topology="2x4"))
    out["slice_8"] = (s8.devices.shape, s8.axis_names)
    out["auto"] = pmesh.auto_training_mesh().devices.shape
    out["auto_seq"] = pmesh.auto_training_mesh(with_seq=True).devices.shape
    out["psum"] = collectives.psum_smoke(s8)
    out["ppermute"] = collectives.ring_permute_smoke(s8)
    out["all_gather"] = collectives.all_gather_smoke(s8)
    out["run_all"] = collectives.run_all(s8)
    hc = pmesh.Mesh((2, 4), ("host", "chip"))
    out["host_chip"] = (collectives.psum_smoke(hc),
                        collectives.ring_permute_smoke(hc),
                        collectives.all_gather_smoke(hc))
    out["hierarchical"] = collectives.hierarchical_psum_smoke(
        pmesh.multislice_mesh(2, 2, 2))
    out["no_dcn"] = error(lambda: collectives.hierarchical_psum_smoke(m))
    return out


def rank_raises(bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} refuses")
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def rank_dies(bad_rank):
    """Rank ``bad_rank`` exits without a word; the others wait in a
    collective."""
    import os

    import torch
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        os._exit(3)
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def mesh_rank_tp(tree, cfg, shape, names, batches):
    """On every rank of ``Mesh(shape, names)``: ``shard_params`` then
    ``gather_params`` (exact?), the forward of the first batch (whole
    logits), 3 AdamW and 3 SGD steps (losses, whole leaves), and what a
    'seq' axis of 2 raises (a second mesh over the same ranks, when the
    world has 4)."""
    import torch
    import torch.distributed as dist

    from kind_tpu_sim_torch.models import transformer as ptf_
    from kind_tpu_sim_torch.parallel import mesh as pmesh
    from kind_tpu_sim_torch.parallel import tp

    mesh = pmesh.Mesh(shape, names)
    params = params_from_numpy(tree, cfg, device="cpu")
    back = ptf_.gather_params(ptf_.shard_params(params, cfg, mesh), cfg,
                              mesh)
    out = {"roundtrip": all(torch.equal(a, b) for a, b in zip(
        ptf_._leaves(back), ptf_._leaves(params)))}
    shard = ptf_.shard_params(params, cfg, mesh)
    rows = ptf_.shard_batch(torch.as_tensor(batches[0]).long(), mesh)
    logits = ptf_.forward(shard, rows, cfg, mesh=mesh)
    data = tp.axis(mesh, "dcn", "data")
    out["logits"] = (tp.all_gather(logits, data, 0) if data is not None
                     else logits).numpy()
    out["loss"] = float(ptf_.loss_fn(shard, rows, cfg, mesh=mesh))
    for name, use_optax in (("adamw", True), ("sgd", False)):
        step, init = ptf_.make_train_step(cfg, mesh=mesh, device="cpu",
                                          use_optax=use_optax)
        state = init(params)
        losses = []
        for b in batches:
            state, loss = step(state, ptf_.shard_batch(
                torch.as_tensor(b).long(), mesh))
            losses.append(float(loss))
        whole = ptf_.gather_params(state["params"], cfg, mesh)
        out[name] = (losses, [p.detach().numpy()
                              for p in ptf_._leaves(whole)])
    if dist.get_world_size() == 4:
        seq = pmesh.training_mesh(1, 2, 2)
        raised = []
        for call in (lambda: ptf_.make_train_step(cfg, mesh=seq,
                                                  device="cpu"),
                     lambda: ptf_.forward(shard, rows, cfg, mesh=seq),
                     lambda: ptf_.loss_fn(shard, rows, cfg, mesh=seq)):
            try:
                call()
                raised.append(None)
            except ValueError as exc:
                raised.append(str(exc))
        out["seq"] = raised
    return out


def mesh_rank_moe(tree, cfg, shape, names, batches, x):
    """On every rank of ``Mesh(shape, names)`` (an MoE config): one
    ``moe_mlp`` of block 0's experts over the global tokens ``x``
    (numpy (b, t, d), each data rank routing its rows) -> whole (out,
    aux); then 3 SGD steps -> (losses, whole leaves)."""
    import torch

    from kind_tpu_sim_torch.models import moe as pmoe
    from kind_tpu_sim_torch.models import transformer as ptf_
    from kind_tpu_sim_torch.parallel import mesh as pmesh
    from kind_tpu_sim_torch.parallel import tp

    mesh = pmesh.Mesh(shape, names)
    params = params_from_numpy(tree, cfg, device="cpu")
    shard = ptf_.shard_params(params, cfg, mesh)
    shards = tp.shards_of(mesh)
    xs = ptf_.shard_batch(torch.as_tensor(x), mesh)
    with tp.scope(shards):
        o, aux = pmoe.moe_mlp(xs, shard["blocks"][0]["moe"],
                              pmoe.MoeConfig(n_experts=cfg.n_experts))
    o = tp.all_gather(o, shards.data, 0) if shards.data else o
    step, init = ptf_.make_train_step(cfg, mesh=mesh, device="cpu",
                                      use_optax=False)
    state = init(params)
    losses = []
    for b in batches:
        state, loss = step(state, ptf_.shard_batch(
            torch.as_tensor(b).long(), mesh))
        losses.append(float(loss))
    whole = ptf_.gather_params(state["params"], cfg, mesh)
    return ((o.numpy(), float(aux)),
            (losses, [p.detach().numpy() for p in ptf_._leaves(whole)]))


def mesh_rank_pipeline(cfg, shape, names, batch, steps):
    """On every rank: ``data.input_pipeline(mesh=...)``; returns every
    rank's batches (rank order), gathered over the world."""
    import torch
    import torch.distributed as dist

    from kind_tpu_sim_torch import data as pdata
    from kind_tpu_sim_torch.parallel import mesh as pmesh

    mesh = pmesh.Mesh(shape, names)
    with pdata.input_pipeline(cfg, batch=batch, mesh=mesh, steps=steps,
                              device="cpu") as pipe:
        mine = torch.stack(list(pipe))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [p.numpy() for p in parts]


def mesh_rank_checkpoint(cfg, root):
    """On 8 ranks: train-and-resume over a (2, 4) mesh, then a state of
    a (4, 2) mesh (one AdamW step taken) saved and restored onto a
    (2, 4) one. Returns (first losses, resumed losses, the (4, 2)
    state's whole leaves and moments, the restored state's)."""
    import os

    import torch

    from kind_tpu_sim_torch.models import checkpoint as ckpt_
    from kind_tpu_sim_torch.models import transformer as ptf_
    from kind_tpu_sim_torch.parallel import mesh as pmesh

    mesh_b = pmesh.Mesh((2, 4), ("data", "model"))
    run = os.path.join(root, "run")
    _, first = ckpt_.train_with_checkpointing(
        cfg, run, total_steps=2, checkpoint_every=2, mesh=mesh_b,
        device="cpu")
    _, more = ckpt_.train_with_checkpointing(
        cfg, run, total_steps=4, checkpoint_every=2, mesh=mesh_b,
        device="cpu")

    def whole(state):
        params, opt = ckpt_._whole(
            state, [p.detach() for p in ptf_._leaves(state["params"])],
            state["opt"].state_dict())
        return ([p.numpy() for p in params],
                {i: {k: v.numpy() for k, v in per.items()}
                 for i, per in opt["state"].items()})

    mesh_a = pmesh.Mesh((4, 2), ("data", "model"))
    step_a, init_a = ptf_.make_train_step(cfg, mesh=mesh_a, device="cpu")
    state_a = init_a(torch.Generator().manual_seed(0))
    tokens = ptf_.sample_batch(torch.Generator().manual_seed(3), cfg, 8,
                               device="cpu")
    state_a, _ = step_a(state_a, ptf_.shard_batch(tokens, mesh_a))
    ckpt_.save(os.path.join(root, "cross"), 1, state_a)
    _, init_b = ptf_.make_train_step(cfg, mesh=mesh_b, device="cpu")
    state_b = init_b(torch.Generator().manual_seed(1))
    restored = ckpt_.restore(os.path.join(root, "cross"),
                             ckpt_.abstract_like(state_b))
    wqkv = restored["params"]["blocks"][0]["wqkv"]
    return first, more, whole(state_a), whole(restored), tuple(wqkv.shape)


def jax_serve(jparams, cfg, engine, knobs, reqs, mesh=None, draft=None):
    """A JAX engine (``cfg`` the port's config) on ``mesh`` or none:
    {id: (tokens, finish_reason)}."""
    from kind_tpu_sim.models import serving as js

    extra = {} if draft is None else {"draft": draft}
    eng = getattr(js, engine)(jparams, jax_cfg(cfg),
                              js.ServingConfig(**knobs), mesh=mesh, **extra)
    for rid, prompt, n in reqs:
        eng.submit(js.Request(rid, list(prompt), max_new=n))
    return {c.request_id: (tuple(c.tokens), c.finish_reason)
            for c in eng.run()}


def jax_mesh(shape, names):
    """A jax.sharding.Mesh over the first virtual devices."""
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
