"""PyTorch port parity: MoE serving under a mesh.

A 4-expert MoE over (data 2, model 2) on four gloo ranks
(``parallel.launch.spawn``): the experts over 'model' (the reference's
``moe_param_specs`` without an 'expert' axis), attention Megatron-
sharded, the dense grid's slots over 'data', so each decode step routes
the whole grid's slots together with the global batch's capacity across
the data ranks. The dense and speculative grids' greedy streams (fp32)
must equal the unsharded port engine's and the JAX engine's.
"""

import dataclasses

from kind_tpu_sim_torch.parallel import launch

import torch_parity
from test_torch_mesh_serving import CFG


def test_moe_engines_on_a_mesh():
    """A 4-expert MoE over (data 2, model 2): experts over 'model', the
    dense grid's slots over 'data', each decode step routing the whole
    grid's slots together (global capacity across the data ranks); the
    dense and speculative grids' streams equal the unsharded port's and
    the JAX engine's."""
    cfg = dataclasses.replace(CFG, n_experts=4, n_heads=4, n_kv_heads=2)
    jparams, pparams = torch_parity.make_params(cfg, embed_scale=0.5,
                                                block_scale=2.0)
    reqs = [(f"e{i}", p, 9) for i, p in enumerate(
        torch_parity.prompts(6, cfg.vocab_size, seed=3))]
    cases = [dict(engine="ServingEngine",
                  knobs=dict(max_slots=4, max_len=64, chunk=4), reqs=reqs),
             dict(engine="SpeculativeServingEngine",
                  knobs=dict(max_slots=4, max_len=64, chunk=4,
                             speculative_k=3), reqs=reqs)]
    got = launch.spawn(torch_parity.mesh_rank_serve, 4,
                       torch_parity.tree_numpy(jparams), cfg, (2, 2),
                       ("data", "model"), cases, backend="gloo",
                       timeout_s=150)
    want = torch_parity.jax_serve(jparams, cfg, "ServingEngine",
                                  cases[0]["knobs"], reqs)
    for (streams, report), case in zip(got, cases):
        assert report["axes"] == {"data": 2, "model": 2}
        assert streams == torch_parity.serve_plain(
            pparams, cfg, case["engine"], case["knobs"], reqs) == want
