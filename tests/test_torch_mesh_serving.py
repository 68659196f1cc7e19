"""PyTorch port parity: the dense engines under a mesh
(``tests/test_serving.py:986-1120`` on the port; the paged engines and
int8 weights are ``tests/test_torch_mesh_paged.py``).

The port's engines run on gloo ranks (``parallel.launch.spawn``), the
JAX engines on the conftest's 8 virtual devices with a
``jax.sharding.Mesh`` of the same shape. Each stream must equal the
unsharded port engine's, the JAX engine's on the mesh and the JAX
engine's off it (fp32, greedy): dense and the speculative grid
(prompt lookup and a draft model) over (data 2, model 2), int8 KV. The
reference's guards raise with its messages.
"""

import dataclasses

import pytest

from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.parallel import launch

import torch_parity

# tests/test_serving.py's cfg (2 heads: the model axis splits them), fp32
CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq=128, dtype="float32")
INT8_KV = dataclasses.replace(CFG, int8_kv=True)
DENSE = dict(max_slots=2, max_len=48, chunk=8)
PAGED = dict(max_slots=2, max_len=48, paged_blocks=14, block_size=8)


def _reqs(base, n=4, max_new=7):
    return [(f"m{i}", torch_parity.prompts(1, CFG.vocab_size,
                                           seed=base + i, base=5 + 2 * i,
                                           step=0)[0], max_new)
            for i in range(n)]


REQS = _reqs(90)


@pytest.fixture(scope="module")
def weights():
    jparams, pparams = torch_parity.make_params(CFG, embed_scale=0.5,
                                                block_scale=2.0)
    return jparams, pparams, torch_parity.tree_numpy(jparams)


@pytest.fixture(scope="module")
def draft():
    dcfg = dataclasses.replace(CFG, n_layers=1)
    jparams, pparams = torch_parity.make_params(dcfg, seed=7)
    return dcfg, jparams, pparams, torch_parity.tree_numpy(jparams)


@pytest.fixture(scope="module")
def grid(weights, draft):
    """(data 2, model 2) on 4 ranks: dense, speculative, draft model,
    int8 KV; the guards; ('model', 4), which splits 2 kv heads."""
    dcfg, _, _, dtree = draft
    cases = [
        dict(engine="ServingEngine", knobs=DENSE, reqs=REQS),
        dict(engine="SpeculativeServingEngine",
             knobs=dict(DENSE, speculative_k=3), reqs=REQS),
        dict(engine="SpeculativeServingEngine",
             knobs=dict(DENSE, speculative_k=3), reqs=REQS,
             draft=(dtree, dcfg)),
        dict(engine="ServingEngine", knobs=DENSE, reqs=REQS[:3],
             cfg=INT8_KV),
        dict(engine="ServingEngine", knobs=dict(DENSE, max_slots=3),
             reqs=[]),
        dict(engine="PagedServingEngine", knobs=dict(PAGED, chunk=8),
             reqs=[]),
        dict(engine="ServingEngine", knobs=DENSE, reqs=[],
             mesh=((4,), ("model",))),
    ]
    return launch.spawn(torch_parity.mesh_rank_serve, 4, weights[2], CFG,
                        (2, 2), ("data", "model"), cases, backend="gloo",
                        device="cpu", timeout_s=150)


@pytest.fixture(scope="module")
def jax_plain(weights):
    """The JAX dense engine off the mesh: every greedy stream below
    (dense, speculative, paged, at any storage) is this one."""
    return torch_parity.jax_serve(weights[0], CFG, "ServingEngine", DENSE, REQS)


def test_mesh_serving_matches_unsharded(weights, grid, jax_plain):
    """Dense over (data 2, model 2): the unsharded port's streams, the
    JAX engine's on the same virtual mesh, and off it."""
    plain = torch_parity.serve_plain(weights[1], CFG, "ServingEngine",
                                     DENSE, REQS)
    assert plain == jax_plain
    assert grid[0][0] == plain
    assert grid[0][0] == torch_parity.jax_serve(weights[0], CFG, "ServingEngine", DENSE,
                              REQS, torch_parity.jax_mesh((2, 2), ("data", "model")))
    assert len({s for s, _ in plain.values()}) > 1  # distinct streams


def test_mesh_serving_speculative_grid(weights, grid, jax_plain):
    knobs = dict(DENSE, speculative_k=3)
    assert grid[1][0] == jax_plain
    assert grid[1][0] == torch_parity.jax_serve(weights[0], CFG, "SpeculativeServingEngine",
                              knobs, REQS, torch_parity.jax_mesh((2, 2), ("data", "model")))


def test_mesh_serving_draft_model(weights, draft, grid, jax_plain):
    """The draft-model grid: the draft's params and cache are sharded
    too; greedy streams are the target's."""
    dcfg, _, dparams, _ = draft
    assert grid[2][0] == jax_plain
    assert grid[2][0] == torch_parity.serve_plain(
        weights[1], CFG, "SpeculativeServingEngine",
        dict(DENSE, speculative_k=3), REQS, draft=(dparams, dcfg))


def test_mesh_serving_int8_kv(weights, grid):
    """An int8 KV cache (q and its scales placed together) over (data
    2, model 2): the unsharded int8 engine's streams, and the JAX int8
    engine's on the mesh."""
    plain = torch_parity.serve_plain(weights[1], INT8_KV, "ServingEngine",
                                     DENSE, REQS[:3])
    assert grid[3][0] == plain
    assert grid[3][0] == torch_parity.jax_serve(weights[0], INT8_KV, "ServingEngine", DENSE,
                              REQS[:3], torch_parity.jax_mesh((2, 2), ("data", "model")))


def test_mesh_serving_guards(grid):
    """The reference's guards, with its match strings (the paged
    kernel tier's: tests/test_torch_mesh_paged.py)."""
    kind, msg = grid[4]
    assert kind == "raise" and "divisible" in msg
    kind, msg = grid[5]
    assert kind == "raise" and "data axis" in msg
    kind, msg = grid[6]
    assert kind == "raise" and "kv_heads" in msg


def test_gloo_rounds_run_eagerly_and_say_so(grid):
    assert grid[0][1] == {"axes": {"data": 2, "model": 2},
                          "backend": "gloo", "rounds": "eager"}
