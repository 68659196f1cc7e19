"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and cross between the two
packages as numpy arrays: the JAX package builds the weights
(``transformer.init_params``), the port receives them through
``weights.params_from_numpy``.
"""

import contextlib
import dataclasses
import pathlib

import numpy as np
import pytest

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


# the engine fleet of ``fleet run --engine serving`` in fp32 (no near-ties
# in greedy streams), and its report's sections that hold for a run of
# the control layers: all but the engines' own reports
FLEET_CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                            n_layers=2, d_ff=64, max_seq=128,
                            dtype="float32")
FLEET_SERVING = dict(max_slots=4, max_len=128, chunk=8, max_queue=64)
FLEET_COMPARED = ("requests", "completed", "virtual_s", "slo", "router",
                  "completions", "ok", "config", "fleet_counters", "health",
                  "overload", "tenancy", "integrity", "preemptions",
                  "scheduler", "training", "autoscaler")


@contextlib.contextmanager
def one_thread():
    """One intra-op torch thread: the tiny fleet's ops are too small to
    share out, and under parallel test workers the threads contend."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def torch_one_thread():
    """``one_thread`` over a whole test module (``pytestmark =
    pytest.mark.usefixtures("torch_one_thread")`` after importing it):
    the port's tiny models run faster on one torch thread, and the
    tier-1 run's six workers share the host's cores."""
    with one_thread():
        yield


def fleet_layers_run(fleet, serving, params, cfg, spec, events=(), seed=3,
                     health=False, overload=False, tenancy=None,
                     audit_frac=None, sched=None, training=None,
                     fleet_kw=None, sims=None, **kw):
    """One ``FleetSim`` run of either package (``fleet`` and ``serving``
    its modules) over three ``EngineReplica``s of ``FLEET_SERVING``,
    least-outstanding, tick 0.01, SLO ttft 0.3 / e2e 0.6. ``spec`` is the
    ``WorkloadSpec``'s fields (``tenancy=True``: the stock tenants'
    trace); ``events`` the chaos events' fields; ``health`` and
    ``overload`` turn on the package's default configs, ``tenancy``
    (True or False: isolated or not) its stock tenants; ``sched`` (a
    dict of ``FleetSchedConfig`` fields) places the replicas through the
    scheduler and ``training`` (a list of ``TrainingGangConfig`` fields)
    adds training gangs under them; ``params`` may be a function of the
    replica id (a replica on other weights stands for a defective chip);
    ``fleet_kw`` overrides other
    ``FleetConfig`` fields (an ``autoscaler`` dict becomes the package's
    ``AutoscalerConfig``); a ``sims`` list receives the ``FleetSim``;
    ``kw`` goes to each ``ServingEngine``."""
    fc = dict(replicas=3, policy="least-outstanding", tick_s=0.01,
              slo=fleet.SloPolicy(ttft_s=0.3, e2e_s=0.6),
              health=fleet.DetectorConfig() if health else None,
              overload=fleet.OverloadConfig() if overload else None,
              audit_frac=audit_frac)
    if tenancy is not None:
        fc["tenancy"] = dataclasses.replace(fleet.default_tenancy(),
                                            isolation=tenancy)
    if sched is not None:
        fc["sched"] = fleet.FleetSchedConfig(**sched)
    if training is not None:
        fc["training"] = fleet.TrainingConfig(gangs=tuple(
            fleet.TrainingGangConfig(**g) for g in training))
    fc.update(fleet_kw or {})
    if isinstance(fc.get("autoscaler"), dict):
        fc["autoscaler"] = fleet.AutoscalerConfig(**fc["autoscaler"])
    if spec.get("tenancy"):
        spec = dict(spec, tenancy=fleet.default_tenancy())
    trace = fleet.generate_trace(fleet.WorkloadSpec(**spec), seed)
    clock = fleet.VirtualClock()

    def factory(rid):
        return fleet.EngineReplica(rid, serving.ServingEngine(
            params(rid) if callable(params) else params, cfg,
            serving.ServingConfig(**FLEET_SERVING), clock=clock.now, **kw))

    sim = fleet.FleetSim(fleet.FleetConfig(**fc), trace,
                         replica_factory=factory,
                         chaos_events=[fleet.ChaosEvent(**e) for e in events],
                         clock=clock)
    if sims is not None:
        sims.append(sim)
    return sim.run()


def fleet_layers_pair(params, spec, **layers):
    """The reference's and the port's ``fleet_layers_run`` on the CPU
    with the same fp32 weights ``params`` (JAX, port)."""
    from kind_tpu_sim import fleet as jfleet
    from kind_tpu_sim.models import serving as jserving
    from kind_tpu_sim_torch import fleet as pfleet
    from kind_tpu_sim_torch.models import serving as pserving

    want = fleet_layers_run(jfleet, jserving, params[0], jax_cfg(FLEET_CFG),
                            spec, **layers)
    got = fleet_layers_run(pfleet, pserving, params[1], FLEET_CFG, spec,
                           device="cpu", **layers)
    for key in FLEET_COMPARED:
        assert got.get(key) == want.get(key), key
    assert got["ok"]
    return got


# the H100's calibration, the port's default; the parity tests select it
# on both sides (the reference's own default is a TPU file)
H100_CALIBRATION = str(pathlib.Path(__file__).resolve().parents[1]
                       / "kind_tpu_sim_torch" / "calibration" / "h100.json")


def _tenancy(fleet, tenancy):
    """The stock tenants: isolated (True) or not (False), or a dict of
    tenant name -> ``kv_budget_frac`` (isolated)."""
    ten = fleet.default_tenancy()
    if isinstance(tenancy, dict):
        return dataclasses.replace(ten, isolation=True, tenants=tuple(
            dataclasses.replace(t, kv_budget_frac=tenancy.get(t.name, 1.0))
            for t in ten.tenants))
    return dataclasses.replace(ten, isolation=tenancy)


def sim_fleet_run(fleet, spec, events=(), seed=3, sims=None, **fc):
    """One analytic ``FleetSim`` run of either package (``fleet`` its
    fleet module, no replica factory). ``spec`` is the ``WorkloadSpec``'s
    fields (``tenancy=True``: the tenants of ``fc["tenancy"]``);
    ``events`` the chaos events' fields; ``fc`` the ``FleetConfig``'s
    fields, where ``slo``, ``sim``, ``autoscaler``, ``sched`` and
    ``disagg`` may be dicts of their config's fields, ``health`` and
    ``overload`` True for the defaults, ``tenancy`` as ``_tenancy``
    takes it, ``training`` a list of ``TrainingGangConfig`` fields and
    ``zoo`` True for the package's ``default_zoo()`` (``spec``'s too).
    Defaults: three replicas, least-outstanding, tick 0.01, SLO ttft
    0.3 / e2e 0.6. A ``sims`` list receives the ``FleetSim``."""
    cfg = dict(replicas=3, policy="least-outstanding", tick_s=0.01,
               slo=dict(ttft_s=0.3, e2e_s=0.6))
    cfg.update(fc)
    classes = dict(slo=fleet.SloPolicy, sim=fleet.SimReplicaConfig,
                   autoscaler=fleet.AutoscalerConfig,
                   sched=fleet.FleetSchedConfig, disagg=fleet.DisaggConfig)
    for key, cls in classes.items():
        if isinstance(cfg.get(key), dict):
            cfg[key] = cls(**cfg[key])
    if cfg.get("health") is True:
        cfg["health"] = fleet.DetectorConfig()
    if cfg.get("overload") is True:
        cfg["overload"] = fleet.OverloadConfig()
    if "tenancy" in cfg:
        cfg["tenancy"] = _tenancy(fleet, cfg["tenancy"])
    if "training" in cfg:
        cfg["training"] = fleet.TrainingConfig(gangs=tuple(
            fleet.TrainingGangConfig(**g) for g in cfg["training"]))
    if spec.get("tenancy"):
        spec = dict(spec, tenancy=cfg["tenancy"])
    if cfg.get("zoo") is True:
        cfg["zoo"] = fleet.default_zoo()
    if spec.get("zoo") is True:
        spec = dict(spec, zoo=fleet.default_zoo())
    trace = fleet.generate_trace(fleet.WorkloadSpec(**spec), seed)
    sim = fleet.FleetSim(fleet.FleetConfig(**cfg), trace,
                         chaos_events=[fleet.ChaosEvent(**e) for e in events])
    if sims is not None:
        sims.append(sim)
    return sim.run()


def shared_registry(monkeypatch, tmp_path, extra=None):
    """The reference's generation registry patched, for one test, to the
    port's: ``GENERATIONS``, ``CALIBRATION_DIR`` (``tmp_path``, holding a
    copy of the port's ``generations/h100.json``), ``GENERATION_FACTS
    ["h100"]`` (set in the dict in place: ``zoo`` binds it by name),
    ``ACCELERATOR_GENERATIONS`` and the KIND_TPU_SIM_GENERATION knob.
    ``extra`` (name -> facts) registers test-only generations on both
    sides, each file written by the port's ``derive_generation`` from
    the h100 file into ``tmp_path``, which both registries then read.
    Nothing in either package changes on disk."""
    import json
    import shutil

    from kind_tpu_sim.fleet import costmodel as jcost
    from kind_tpu_sim_torch.fleet import costmodel as pcost

    shutil.copy(pcost.generation_path("h100"), tmp_path / "h100.json")
    gens = ("h100",) + tuple(extra or {})
    monkeypatch.setattr(jcost, "GENERATIONS", gens)
    monkeypatch.setattr(jcost, "CALIBRATION_DIR", tmp_path)
    monkeypatch.setitem(jcost.GENERATION_FACTS, "h100",
                        dict(pcost.GENERATION_FACTS["h100"]))
    monkeypatch.setattr(jcost, "ACCELERATOR_GENERATIONS",
                        dict(pcost.ACCELERATOR_GENERATIONS))
    monkeypatch.setenv("KIND_TPU_SIM_GENERATION", "h100")
    if extra:
        monkeypatch.setattr(pcost, "GENERATIONS", gens)
        monkeypatch.setattr(pcost, "CALIBRATION_DIR", tmp_path)
        base = pcost.load_generation("h100")
        for name, facts in extra.items():
            monkeypatch.setitem(jcost.GENERATION_FACTS, name, dict(facts))
            monkeypatch.setitem(pcost.GENERATION_FACTS, name, dict(facts))
            with open(tmp_path / f"{name}.json", "w",
                      encoding="utf-8") as fh:
                json.dump(pcost.derive_generation(base, name), fh,
                          indent=1, sort_keys=True)
    return gens


def sim_fleet_pair(spec, events=(), **fc):
    """The reference's and the port's ``sim_fleet_run``: their reports,
    as JSON with sorted keys, must be equal; returns the port's."""
    import json

    from kind_tpu_sim import fleet as jfleet
    from kind_tpu_sim_torch import fleet as pfleet

    want = sim_fleet_run(jfleet, spec, events, **fc)
    got = sim_fleet_run(pfleet, spec, events, **fc)
    assert (json.dumps(got, sort_keys=True)
            == json.dumps(want, sort_keys=True))
    return got


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
    logits), 3 AdamW and 3 SGD steps (losses, whole leaves), and, when
    the world has 4, the same model on training_mesh(1, 2, 2) (a 'seq'
    axis of 2 over the same ranks): whole logits, the global loss and 3
    AdamW steps on the batches cut to ``max_seq`` tokens."""
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
        # a 'seq' axis over the same ranks: attention over the gathered
        # sequence; batches cut to max_seq tokens, which split over it
        seq = pmesh.training_mesh(1, 2, 2)
        cut = [bt[:, :cfg.max_seq] for bt in batches]
        shard = ptf_.shard_params(params, cfg, seq)
        block = ptf_.shard_batch(torch.as_tensor(cut[0]).long(), seq)
        out["seq"] = {
            "logits": gather_tokens(ptf_.forward(shard, block, cfg,
                                                 mesh=seq), seq),
            "loss": global_loss(ptf_.loss_fn(shard, block, cfg, mesh=seq),
                                seq),
            "adamw": port_train(cfg, seq, tree, cut, True)}
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


# ---------------------------------------------------------------------
# training against the reference (the bars of tests/test_torch_training.py)

# use_optax -> (loss, params) fp32 bars
FP32_TOL = {True: (1e-4, 5e-5), False: (1e-4, 5e-6)}


def init_tree(cfg, seed=0, router_bias=0.0):
    """The reference's init as numpy; ``router_bias`` added to every
    router's first column (most tokens then pick expert 0, so capacity
    drops tokens and the global batch's queue decides which)."""
    import jax

    from kind_tpu_sim.models import transformer as jtf

    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jtf.init_params(jax.random.PRNGKey(seed), jax_cfg(cfg)))
    for block in tree["blocks"]:
        if "moe" in block:
            block["moe"]["router"][:, 0] += np.float32(router_bias)
    return tree


def ramp_batches(cfg, n=3, batch=8, seed=0, seq=None):
    """``n`` batches of ramps mod vocab, ``seq`` tokens (default
    max_seq + 1)."""
    rng = np.random.RandomState(seed)
    seq = cfg.max_seq + 1 if seq is None else seq
    return [((rng.randint(0, cfg.vocab_size, (batch, 1))
              + np.arange(seq)[None, :]) % cfg.vocab_size).astype(np.int64)
            for _ in range(n)]


def leaves(tree):
    """A parameter tree's leaves in the port's ``_leaves`` order."""
    def block(node):
        return [leaf for key in sorted(node) for leaf in (
            block(node[key]) if isinstance(node[key], dict)
            else [node[key]])]

    return ([tree["embed"], tree["final_norm"]]
            + [leaf for b in tree["blocks"] for leaf in block(b)])


def jax_train(cfg, tree, batches, use_optax, mesh=None):
    """The reference's make_train_step (on ``mesh`` when given) from
    ``tree``: (losses, leaves in the port's order)."""
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.models import transformer as jtf

    step, init_state = jtf.make_train_step(jax_cfg(cfg), mesh=mesh,
                                           use_optax=use_optax)
    state = init_state(jax.random.PRNGKey(0))  # moments: zeros, any init
    state["params"] = jax.tree_util.tree_map(
        lambda t, like: jax.device_put(jnp.asarray(t), like.sharding),
        tree, state["params"])
    losses = []
    for b in batches:
        state, loss = step(state, jnp.asarray(b, jnp.int32))
        losses.append(float(loss))
    return losses, leaves(jax.tree_util.tree_map(np.asarray,
                                                 state["params"]))


def assert_train(got, want, use_optax):
    loss_tol, param_tol = FP32_TOL[use_optax]
    np.testing.assert_allclose(got[0], want[0], atol=loss_tol, rtol=0)
    for p, j in zip(got[1], want[1]):
        np.testing.assert_allclose(p, j, atol=param_tol, rtol=0)


def port_train(cfg, mesh, tree, batches, use_optax):
    """On every rank of ``mesh``: the port's meshed train step from
    ``tree`` over the global ``batches`` -> (losses, whole leaves)."""
    import torch

    step, init = ptf.make_train_step(cfg, mesh=mesh, device="cpu",
                                     use_optax=use_optax)
    state = init(params_from_numpy(tree, cfg, device="cpu"))
    losses = []
    for b in batches:
        state, loss = step(state, ptf.shard_batch(
            torch.as_tensor(b).long(), mesh))
        losses.append(float(loss))
    whole = ptf.gather_params(state["params"], cfg, mesh)
    return losses, [p.detach().numpy() for p in ptf._leaves(whole)]


def global_loss(loss, mesh):
    """The global loss from every rank's share (``loss_fn`` over a
    mesh: the mean over the ranks that share the tokens)."""
    from kind_tpu_sim_torch.parallel import tp

    group = tp.shards_of(mesh).token_group()
    if group is None:
        return float(loss)
    return float(tp.all_reduce(loss.detach()[None], group)[0]) / group.size


def gather_tokens(x, mesh):
    """A (batch, seq, ...) block of every rank joined whole: rows over
    'data', columns over 'seq'."""
    from kind_tpu_sim_torch.parallel import tp

    spec = ("data", "seq") + (None,) * (x.dim() - 2)
    return tp.gather_tensor(x, spec, mesh).numpy()


# ---------------------------------------------------------------------
# long context and pipeline rank programs


def mesh_rank_ring(cases):
    """On 8 ranks: each ring case -- a dict of ``shape``, ``names``,
    ``axis``, ``qkv`` (numpy), ``causal`` and optionally
    ``double_buffer`` and ``grads`` -- with the inputs placed as
    ``ring_specs`` says; returns per case the whole output (and the
    whole gradients of sum(out**2)) and the specs; then the analytic
    long-context smoke at 4096 tokens and a small ``bench_report``."""
    import torch

    from kind_tpu_sim_torch.parallel import multihost, tp
    from kind_tpu_sim_torch.parallel import ring_attention as ra
    from kind_tpu_sim_torch.parallel.mesh import Mesh

    meshes, results = {}, []
    for case in cases:
        key = (tuple(case["shape"]), tuple(case["names"]))
        if key not in meshes:
            meshes[key] = Mesh(*key)
        mesh = meshes[key]
        q, k, v = (torch.from_numpy(x) for x in case["qkv"])
        specs = ra.ring_specs(q.shape, k.shape, mesh, case["axis"])
        grads = case.get("grads", False)
        local = [tp.shard_tensor(x, s, mesh).clone().requires_grad_(grads)
                 for x, s in zip((q, k, v), (specs[0], specs[1], specs[1]))]
        out = ra.ring_attention(*local, mesh, case["axis"],
                                causal=case["causal"],
                                double_buffer=case.get("double_buffer"))
        res = {"out": tp.gather_tensor(out, specs[0], mesh).numpy(),
               "specs": specs}
        if grads:
            (out ** 2).sum().backward()
            res["grads"] = [tp.gather_tensor(x.grad, s, mesh).numpy()
                            for x, s in zip(local, (specs[0], specs[1],
                                                    specs[1]))]
        results.append(res)
    smoke = multihost.ring_long_context_smoke(4096, head_dim=16)
    bench = ra.bench_report(small_tokens=256, large_tokens=1024,
                            head_dim=8, heads=2)
    return results, smoke, bench


def mesh_rank_seq(tree, cfg, batches, root):
    """On 8 ranks, sequence parallelism (``cfg`` fp32, ``seq_parallel``
    off; batches of ``max_seq`` tokens): ``forward``, the ring
    forward's whole logits on training_mesh(2, 1, 4); ``ring`` /
    ``gathered``, 3 AdamW steps on training_mesh(2, 2, 2) with and
    without the ring (losses, whole leaves), and the gathered forward's
    whole logits and global loss there; ``pipeline``, 2 batches of
    ``data.input_pipeline(mesh=...)`` there, gathered whole;
    ``checkpoint``, a ring state of that mesh after one step saved under
    ``root`` and restored onto training_mesh(4, 2) (no 'seq'), both
    states' whole leaves and AdamW moments."""
    import dataclasses as dc

    import torch

    from kind_tpu_sim_torch.parallel import mesh as pmesh

    ring = dc.replace(cfg, seq_parallel=True)
    out = {}
    mesh = pmesh.training_mesh(2, 1, 4)
    params = ptf.shard_params(params_from_numpy(tree, cfg, device="cpu"),
                              cfg, mesh)
    tokens = torch.as_tensor(batches[0]).long()
    out["forward"] = gather_tokens(
        ptf.forward(params, ptf.shard_batch(tokens, mesh), ring, mesh=mesh),
        mesh)

    mesh = pmesh.training_mesh(2, 2, 2)
    out["ring"] = port_train(ring, mesh, tree, batches, True)
    out["gathered"] = port_train(cfg, mesh, tree, batches, True)
    params = ptf.shard_params(params_from_numpy(tree, cfg, device="cpu"),
                              cfg, mesh)
    rows = ptf.shard_batch(tokens, mesh)
    out["gathered_logits"] = gather_tokens(
        ptf.forward(params, rows, cfg, mesh=mesh), mesh)
    out["gathered_loss"] = global_loss(
        ptf.loss_fn(params, rows, cfg, mesh=mesh), mesh)

    from kind_tpu_sim_torch import data as pdata
    from kind_tpu_sim_torch.models import checkpoint as ckpt_

    with pdata.input_pipeline(cfg, batch=8, mesh=mesh, steps=2,
                              device="cpu") as pipe:
        out["pipeline"] = [gather_tokens(b, mesh) for b in pipe]
    step, init = ptf.make_train_step(ring, mesh=mesh, device="cpu")
    state, _ = step(init(params_from_numpy(tree, cfg, device="cpu")), rows)
    ckpt_.save(root, 1, state)
    _, init_b = ptf.make_train_step(ring, mesh=pmesh.training_mesh(4, 2),
                                    device="cpu")
    restored = ckpt_.restore(root, ckpt_.abstract_like(
        init_b(torch.Generator().manual_seed(1))))

    def whole(st):
        params, opt = ckpt_._whole(
            st, [p.detach() for p in ptf._leaves(st["params"])],
            st["opt"].state_dict())
        return ([p.numpy() for p in params],
                [{k: v.numpy() for k, v in per.items()}
                 for _, per in sorted(opt["state"].items())])

    out["checkpoint"] = (whole(state), whole(restored))
    return out


def mesh_rank_seq_moe(tree, cfg, batches, x):
    """On the 8 ranks of (data 2, seq 4), an MoE ``cfg``: one
    ``moe_mlp`` of block 0 over the global tokens ``x`` (whole out,
    aux), 2 SGD steps with the ring (losses, whole leaves) and the
    global loss without it."""
    import dataclasses as dc

    import torch

    from kind_tpu_sim_torch.models import moe as pmoe
    from kind_tpu_sim_torch.parallel import tp
    from kind_tpu_sim_torch.parallel.mesh import Mesh

    mesh = Mesh((2, 4), ("data", "seq"))
    params = params_from_numpy(tree, cfg, device="cpu")
    with tp.scope(tp.shards_of(mesh)):
        o, aux = pmoe.moe_mlp(ptf.shard_batch(torch.as_tensor(x), mesh),
                              params["blocks"][0]["moe"],
                              pmoe.MoeConfig(n_experts=cfg.n_experts))
    tokens = torch.as_tensor(batches[0]).long()
    return {"moe": (gather_tokens(o, mesh), float(aux)),
            "ring": port_train(dc.replace(cfg, seq_parallel=True), mesh,
                               tree, batches, False),
            "loss": global_loss(ptf.loss_fn(
                params, ptf.shard_batch(tokens, mesh), cfg, mesh=mesh),
                mesh)}


def mesh_rank_pipe(tree, cfg, shape, names, cases):
    """On every rank of ``Mesh(shape, names)``: ``pipeline_forward`` of
    each (tokens, n_microbatches) case -> whole logits, or the message
    it raises. A case (tokens, n_microbatches, (tree, cfg)) runs its own
    weights and config."""
    import torch

    from kind_tpu_sim_torch.parallel import pipeline
    from kind_tpu_sim_torch.parallel.mesh import Mesh

    mesh = Mesh(shape, names)
    params = params_from_numpy(tree, cfg, device="cpu")
    out = []
    for tokens, n_micro, *own in cases:
        case_params, case_cfg = params, cfg
        if own:
            case_tree, case_cfg = own[0]
            case_params = params_from_numpy(case_tree, case_cfg, device="cpu")
        try:
            with torch.no_grad():
                out.append(pipeline.pipeline_forward(
                    case_params, torch.as_tensor(tokens).long(), case_cfg,
                    mesh, n_microbatches=n_micro).numpy())
        except ValueError as exc:
            out.append(str(exc))
    return out


# -- gray-straggler-grid without timing the host ------------------------

# the straggler grid's four runs (two clean, detection on, detection off),
# each a stats dict as ``run_cells`` returns it: a host's likely timings
# and counts, with which the scenario's verdict is ok
STRAGGLER_STATS = (
    {"workers": 6, "requeues": 0, "respawns": 0, "faults_injected": 0,
     "probes": 6, "probe_failures": 0, "quarantines": 0, "speculative": 0,
     "makespan_s": 0.62, "detection": []},
    {"workers": 6, "requeues": 0, "respawns": 0, "faults_injected": 0,
     "probes": 6, "probe_failures": 0, "quarantines": 0, "speculative": 0,
     "makespan_s": 0.655, "detection": []},
    {"workers": 6, "requeues": 0, "respawns": 1, "faults_injected": 1,
     "probes": 7, "probe_failures": 0, "quarantines": 1, "speculative": 0,
     "makespan_s": 1.95,
     "detection": [{"component": "worker-4", "transition": "suspected"},
                   {"component": "worker-4", "transition": "quarantined"},
                   {"component": "worker-4", "transition": "restored"}]},
    {"workers": 6, "requeues": 0, "respawns": 0, "faults_injected": 1,
     "probes": 0, "probe_failures": 0, "quarantines": 0, "speculative": 0,
     "makespan_s": 2.55},
)


class CannedGrid:
    """A stand-in for ``scatter_grid_cells`` of either package: the
    straggler grid's calls (``detect`` on, or a straggler fault) get the
    canned ``stats`` in turn, with the cells' true results computed
    without their sleeps; any other grid's call goes to ``real``. Each
    canned call's arguments land in ``calls``."""

    def __init__(self, real, probe, stats=STRAGGLER_STATS):
        self.real, self.probe, self.stats = real, probe, stats
        self.calls = []

    def __call__(self, cells, **kw):
        fault = kw.get("fault") or ("",)
        if not (kw.get("detect") or fault[0] == "straggler"):
            return self.real(cells, **kw)
        stats = dict(self.stats[len(self.calls) % len(self.stats)])
        self.calls.append(dict(kw, cells=list(cells)))
        return ([self.probe(**dict(c, sleep_s=0.0)) for c in cells], stats)
