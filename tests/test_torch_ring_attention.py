"""PyTorch port parity: ring attention (``parallel/ring_attention.py``)
against the JAX package's on its 8 virtual devices.

The cases of ``tests/test_ring_attention.py`` (causal, non-causal, both
orderings, 256 tokens, a (data, seq) mesh, GQA, gradients) plus a
'model' axis, the reference's choice of batch and head axes, its
ordering knob, the analytic long-context smoke at 4096 tokens over 8
ranks and ``bench_report``'s keys. The port's ranks are one gloo world
of 8 (``parallel.launch.spawn``); every case's output is gathered whole
and held to the JAX ring at 2e-5 (gradients 5e-4).
"""

import numpy as np
import pytest

from kind_tpu_sim_torch.parallel import launch
from kind_tpu_sim_torch.parallel import ring_attention as pra

import torch_parity

TOL = 2e-5
GRAD_TOL = 5e-4


def _qkv(seed, q_shape, kv_shape=None):
    rng = np.random.RandomState(seed)
    kv_shape = kv_shape or q_shape
    return tuple(rng.randn(*s).astype(np.float32)
                 for s in (q_shape, kv_shape, kv_shape))


CHIP = ((8,), ("chip",), "chip")
QKV = _qkv(0, (2, 64, 4, 16))
# name -> (mesh shape, names, ring axis, inputs, causal, double_buffer)
CASES = {
    "causal": CHIP + (QKV, True, None),
    "double_buffered": CHIP + (QKV, True, True),
    "serial": CHIP + (QKV, True, False),
    "noncausal": CHIP + (QKV, False, None),
    "long_256": CHIP + (_qkv(1, (1, 256, 2, 8)), True, None),
    "data_seq": ((2, 4), ("data", "seq"), "seq",
                 _qkv(2, (2, 32, 2, 8)), True, None),
    "gqa": CHIP + (_qkv(3, (2, 64, 4, 16), (2, 64, 2, 16)), True, None),
    "data_model_seq": ((2, 2, 2), ("data", "model", "seq"), "seq",
                       _qkv(4, (2, 32, 4, 8), (2, 32, 2, 8)), True, None),
    "model_seq_gqa_1kv": ((2, 4), ("model", "seq"), "seq",
                          _qkv(5, (2, 32, 4, 8), (2, 32, 1, 8)), False,
                          None),
}
GRAD_QKV = _qkv(6, (1, 32, 2, 8))


@pytest.fixture(scope="module")
def world():
    cases = [dict(shape=c[0], names=c[1], axis=c[2], qkv=c[3], causal=c[4],
                  double_buffer=c[5]) for c in CASES.values()]
    cases.append(dict(shape=(8,), names=("chip",), axis="chip",
                      qkv=GRAD_QKV, causal=True, grads=True))
    results, smoke, bench = launch.spawn(torch_parity.mesh_rank_ring, 8,
                                         cases, backend="gloo", device="cpu",
                                         timeout_s=120)
    return dict(zip(list(CASES) + ["grads"], results)), smoke, bench


def _jax_ring(name):
    """The JAX ring on a mesh of the case's shape (the ordering forced
    through ``_build_ring_attention`` where the case names one)."""
    import jax.numpy as jnp

    from kind_tpu_sim.parallel import ring_attention as jra

    shape, names, axis, qkv, causal, db = CASES[name]
    mesh = torch_parity.jax_mesh(shape, names)
    q, k, v = (jnp.asarray(x) for x in qkv)
    if db is None:
        return np.asarray(jra.ring_attention(q, k, v, mesh, axis_name=axis,
                                             causal=causal))
    fn = jra._build_ring_attention(mesh, axis, causal, None, None, None, db)
    return np.asarray(fn(q, k, v))


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_the_reference_ring(world, name):
    got = world[0][name]["out"]
    np.testing.assert_allclose(got, _jax_ring(name), atol=TOL, rtol=TOL)
    # and the port's plain attention over the whole sequence
    import torch

    q, k, v = (torch.from_numpy(x) for x in CASES[name][3])
    want = pra.reference_attention(q, k, v, causal=CASES[name][4]).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_specs_are_the_reference_choice(world, name, monkeypatch):
    """The batch, q-head and kv-head axes the reference's
    ``ring_attention`` picks (captured from its ``_build_ring_attention``
    call) are the port's ``ring_specs``."""
    import jax.numpy as jnp

    from kind_tpu_sim.parallel import ring_attention as jra

    shape, names, axis, qkv, causal, _ = CASES[name]
    seen = {}

    def build(mesh, axis_name, causal, batch_axis, q_head_axis,
              kv_head_axis, double_buffer):
        seen["specs"] = ((batch_axis, axis_name, q_head_axis, None),
                         (batch_axis, axis_name, kv_head_axis, None))
        return lambda q, k, v: q

    monkeypatch.setattr(jra, "_build_ring_attention", build)
    jra.ring_attention(*(jnp.asarray(x) for x in qkv),
                       torch_parity.jax_mesh(shape, names), axis_name=axis,
                       causal=causal)
    assert tuple(world[0][name]["specs"]) == seen["specs"]


def test_ring_gradients_match_the_reference(world):
    import jax
    import jax.numpy as jnp

    from kind_tpu_sim.parallel import ring_attention as jra

    mesh = torch_parity.jax_mesh((8,), ("chip",))

    def loss(q, k, v):
        return (jra.ring_attention(q, k, v, mesh, axis_name="chip")
                ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in GRAD_QKV))
    for got, w in zip(world[0]["grads"]["grads"], want):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_ring_long_context_smoke_analytic(world):
    """tests/test_ring_attention.py's analytic smoke (k = 0, v[s] = s:
    out[i] = i / 2) at 4096 tokens over the 8 ranks."""
    report = world[1]
    assert report["ring_ok"], report
    assert report["ring_devices"] == 8 and report["ring_tokens"] == 4096
    assert report["ring_max_rel_err"] < 1e-5


def test_bench_report_has_the_reference_keys(world):
    from kind_tpu_sim.parallel import ring_attention as jra

    want = jra.bench_report(small_tokens=256, large_tokens=1024, head_dim=8,
                            heads=2)
    got = world[2]
    assert sorted(got) == sorted(want)
    assert got["ring_32k_comm_mb"] == want["ring_32k_comm_mb"]


@pytest.mark.parametrize("raw", [None, "", "0", "1", "false", "False", "no",
                                 "yes", "true", "off"])
def test_ordering_knob_reads_as_the_reference_reads_it(raw):
    from kind_tpu_sim.analysis import knobs

    env = {} if raw is None else {pra.DOUBLE_BUFFER_ENV: raw}
    assert pra.double_buffer_default(env) is bool(
        knobs.get(knobs.RING_DOUBLE_BUFFER, env))


def test_ring_of_one_rank_is_plain_attention():
    """No ring (``ax`` None): the per-rank body alone, on the CPU, with
    its gradients against autograd of the plain attention."""
    import torch

    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(7, (2, 16, 4, 8), (2, 16, 2, 8)))
    out = pra.ring_attention_shard(q, k, v, None)
    (out ** 2).sum().backward()
    got = [out.detach()] + [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    ref = pra.reference_attention(q, k, v)
    (ref ** 2).sum().backward()
    want = [ref.detach()] + [x.grad for x in (q, k, v)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    with pytest.raises(ValueError, match="do not divide"):
        pra.ring_attention_shard(q, k[:, :, :1].expand(2, 16, 3, 8), v, None)
