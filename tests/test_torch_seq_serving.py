"""PyTorch port parity: the serving engines on a mesh with a 'seq' axis
against the JAX engines on the same virtual mesh.

The reference's engines serve on a ('data', 'model', 'seq') mesh with
the 'seq' ranks replicating (its ``_shard_kv_storage`` never splits over
'seq'), and its paged engine refuses a 'data' axis longer than 1 there
as elsewhere. The port's engines on gloo ranks (one world of 4, both
meshes over it) must emit the JAX engines' streams, or raise their
message.
"""

import pytest

from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.parallel import launch

import torch_parity

# tests/test_serving.py's cfg (2 heads: the model axis splits them), fp32
CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq=128, dtype="float32")
NAMES = ("data", "model", "seq")
MESHES = ((2, 1, 2), (1, 2, 2))
KNOBS = {
    "ServingEngine": dict(max_slots=2, max_len=48, chunk=8),
    "PagedServingEngine": dict(max_slots=2, max_len=48, paged_blocks=14,
                               block_size=8),
    "SpeculativeServingEngine": dict(max_slots=2, max_len=48, chunk=8,
                                     speculative_k=3, spec_windows=2),
}
REQS = [(f"s{i}", p, 6) for i, p in enumerate(
    torch_parity.prompts(4, CFG.vocab_size, seed=11, base=5, step=2))]
CASES = [(engine, shape) for engine in KNOBS for shape in MESHES]


@pytest.fixture(scope="module")
def jparams():
    return torch_parity.make_params(CFG, seed=3)[0]


@pytest.fixture(scope="module")
def port(jparams):
    cases = [dict(engine=engine, knobs=KNOBS[engine], reqs=REQS,
                  mesh=(shape, NAMES)) for engine, shape in CASES]
    return launch.spawn(torch_parity.mesh_rank_serve, 4,
                        torch_parity.tree_numpy(jparams), CFG, MESHES[0],
                        NAMES, cases, backend="gloo", device="cpu",
                        timeout_s=120)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{e}-{'x'.join(map(str, s))}"
                              for e, s in CASES])
def test_engines_on_a_seq_mesh_match_jax(port, jparams, case):
    engine, shape = CASES[case]
    got = port[case]
    try:
        want = torch_parity.jax_serve(jparams, CFG, engine, KNOBS[engine],
                                      REQS, torch_parity.jax_mesh(shape,
                                                                  NAMES))
    except ValueError as exc:
        assert got == ("raise", str(exc))
        return
    assert got[0] == want
    assert got[1]["axes"] == dict(zip(NAMES, shape))
