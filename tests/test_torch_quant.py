"""PyTorch port parity: int8 quantization (models/quant.py) and the exact
int8 product (ops/int8_matmul.py).

The same numpy-seeded tensors go through the JAX package's functions and
the port's. Quantization is held exactly: q equal and the fp32 scales
bitwise equal (both sides run fp32 abs-max, max(., 1e-8) / 127, the
division, round half to even and the clip). The int8 product is held
exactly against numpy's int64 product. ``linear`` and ``readout`` take
the exact int32 sum (native) or exact fp32 products (dequant) on both
sides, so their fp32 outputs agree at rtol 1e-6 (the dequant sums run in
another order); bf16 outputs at the port's bf16 bar, 2e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.models import decode as jdecode
from kind_tpu_sim.models import quant as jquant
from kind_tpu_sim.models import transformer as jtf
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import quant as pquant
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.ops import int8_matmul as im
from kind_tpu_sim_torch.weights import params_from_numpy

from torch_parity import jax_cfg, make_params
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq=32, dtype="float32")
BF16_TOL = 2e-2


def _randn(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _same_quant(pq, jq):
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    assert pq.q.dtype == torch.int8 and pq.scale.dtype == torch.float32
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_matches_jax(axis):
    """Rows and columns at different magnitudes, an all-zero row and
    column (scale 1e-8 / 127 on both sides)."""
    w = _randn((24, 40)) * np.arange(1, 41, dtype=np.float32)[None, :]
    w[3, :] = 0.0
    w[:, 5] = 0.0
    _same_quant(pquant.quantize(torch.tensor(w), axis=axis),
                jquant.quantize(jnp.asarray(w), axis=axis))
    pq = pquant.quantize(torch.tensor(w), axis=axis)
    np.testing.assert_array_equal(
        pquant.dequantize(pq).numpy(),
        np.asarray(jquant.dequantize(jquant.quantize(jnp.asarray(w),
                                                     axis=axis))))


def test_quantize_rounds_half_to_even():
    """A row whose scale is exactly 1 (abs-max 127): the half-steps round
    to even, as jnp.round does."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]], np.float32)
    pq = pquant.quantize(torch.tensor(w), axis=-1)
    _same_quant(pq, jquant.quantize(jnp.asarray(w), axis=-1))
    assert pq.q.tolist() == [[127, 0, 2, 2, 0, -2, 126]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_matches_jax(dtype):
    x = _randn((2, 5, 48), seed=1) * np.arange(1, 6, dtype=np.float32)[
        None, :, None]
    jx = jnp.asarray(x).astype(dtype)
    px = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jquant.quant_rows(jx)
    pq, ps = pquant.quant_rows(px)
    assert pq.shape == (2, 5, 48) and ps.shape == (2, 5, 1)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_experts", [0, 2])
def test_quantize_params_matches_jax(n_experts):
    cfg = dataclasses.replace(CFG, n_experts=n_experts, dtype="bfloat16")
    jparams, pparams = make_params(cfg)
    jq = jquant.quantize_params(jparams, jax_cfg(cfg))
    pq = pquant.quantize_params(pparams, cfg)
    _same_quant(pq["embed"], jq["embed"])
    assert pq["embed"].scale.shape == (cfg.vocab_size, 1)
    for jb, pb in zip(jq["blocks"], pq["blocks"]):
        assert sorted(jb) == sorted(pb)
        for name in ("wqkv", "wo") + (() if n_experts else
                                      ("w_up", "w_down")):
            _same_quant(pb[name], jb[name])
            assert pb[name].scale.shape[0] == 1
        assert pb["attn_norm"].dtype == torch.float32
        if n_experts:
            assert pb["moe"]["router"].dtype == torch.float32
            assert pb["moe"]["w_up"].dtype == torch.bfloat16
            for name in ("w_up", "w_down"):
                np.testing.assert_array_equal(
                    pb["moe"][name].float().numpy(),
                    np.asarray(jb["moe"][name].astype(jnp.float32)))


INT8_SHAPES = {
    "2d": ((5, 37), (37, 11)),
    "batch": ((3, 4, 29), (3, 29, 6)),
    "two_batch": ((2, 3, 4, 16), (2, 3, 16, 9)),
    "ragged_k": ((8, 1027), (1027, 3)),
}


@pytest.mark.parametrize("name", sorted(INT8_SHAPES))
def test_int8_matmul_ref_is_the_exact_product(name):
    a_shape, b_shape = INT8_SHAPES[name]
    rng = np.random.RandomState(2)
    a = rng.randint(-127, 128, a_shape).astype(np.int8)
    b = rng.randint(-127, 128, b_shape).astype(np.int8)
    want = np.matmul(a.astype(np.int64), b.astype(np.int64))
    got = im.int8_matmul(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        im.int8_matmul_ref(torch.tensor(a), torch.tensor(b)).numpy(), want)


def test_int8_matmul_ref_where_an_int8_einsum_overflows():
    """Rows of -127 against columns of 127: every sum is -127^2 K, the
    largest |sum|; an einsum of the int8 tensors wraps in int8."""
    k = 8192
    a = torch.full((4, k), -127, dtype=torch.int8)
    b = torch.full((k, 3), 127, dtype=torch.int8)
    got = im.int8_matmul(a, b)
    assert (got == -127 * 127 * k).all()
    wrapped = torch.einsum("mk,kn->mn", a, b)
    assert wrapped.dtype == torch.int8 and not (
        wrapped.long() == -127 * 127 * k).any()


def test_int8_matmul_reads_either_layout_in_place():
    """b with K contiguous (an embedding's transpose, a key cache read as
    (b, kv, hd, s)) or N contiguous (a value cache read as (b, kv, s,
    hd)): the strided views, not copies, give numpy's product."""
    rng = np.random.RandomState(3)
    emb = rng.randint(-127, 128, (50, 24)).astype(np.int8)
    x = rng.randint(-127, 128, (6, 24)).astype(np.int8)
    et = torch.tensor(emb).t()
    assert et.stride() == (1, 24)
    np.testing.assert_array_equal(
        im.int8_matmul(torch.tensor(x), et).numpy(),
        x.astype(np.int64) @ emb.astype(np.int64).T)
    cache = rng.randint(-127, 128, (2, 13, 3, 8)).astype(np.int8)
    q = rng.randint(-127, 128, (2, 3, 4, 8)).astype(np.int8)
    p = rng.randint(-127, 128, (2, 3, 4, 13)).astype(np.int8)
    c = torch.tensor(cache)
    scores = im.int8_matmul(torch.tensor(q), c.permute(0, 2, 3, 1))
    np.testing.assert_array_equal(
        scores.numpy(), np.einsum("bkgd,bskd->bkgs", q.astype(np.int64),
                                  cache.astype(np.int64)))
    values = im.int8_matmul(torch.tensor(p), c.permute(0, 2, 1, 3))
    np.testing.assert_array_equal(
        values.numpy(), np.einsum("bkgs,bskd->bkgd", p.astype(np.int64),
                                  cache.astype(np.int64)))


def test_int8_matmul_refuses_what_it_does_not_take():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 operands"):
        im.int8_matmul(a.float(), a.t())
    with pytest.raises(ValueError, match="do not multiply"):
        im.int8_matmul(a, a)
    with pytest.raises(ValueError, match="at most two batch"):
        im.int8_matmul(a.reshape(1, 1, 1, 4, 8), a.t().reshape(1, 1, 1, 8, 4))
    with pytest.raises(ValueError, match="N or K contiguous"):
        im.int8_matmul(a, torch.zeros(16, 8, dtype=torch.int8)[::2, ::2])
    counts = im.int8_matmul.launches
    im.int8_matmul(a, a.t())
    assert im.int8_matmul.launches == counts  # CPU calls launch nothing


def _linear_inputs(dtype, seed=4):
    x = _randn((3, 5, 64), seed=seed)
    w = _randn((64, 40), seed=seed + 1)
    jx = jnp.asarray(x).astype(dtype)
    px = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, px, w


@pytest.mark.parametrize("native", [False, True], ids=["dequant", "native"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_jax(native, dtype):
    jx, px, w = _linear_inputs(dtype)
    jw, pw = jquant.quantize(jnp.asarray(w)), pquant.quantize(torch.tensor(w))
    want = np.asarray(jquant.linear(jx, jw, native=native).astype(
        jnp.float32))
    got = pquant.linear(px, pw, native=native)
    assert got.dtype == px.dtype and got.shape == (3, 5, 40)
    tol = 1e-6 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("native", [False, True], ids=["dequant", "native"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_readout_matches_jax(native, dtype):
    jx, px, _ = _linear_inputs(dtype, seed=6)
    emb = _randn((50, 64), seed=8)
    jq = jquant.quantize(jnp.asarray(emb), axis=1)
    pq = pquant.quantize(torch.tensor(emb), axis=1)
    want = np.asarray(jquant.readout(jx, jq, native=native))
    got = pquant.readout(px, pq, native=native)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 50)
    tol = 1e-6 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_matches_jax(dtype):
    emb = _randn((50, 16), seed=9)
    toks = np.random.RandomState(10).randint(0, 50, (2, 7)).astype(np.int32)
    want = np.asarray(jquant.embed_lookup(
        jquant.quantize(jnp.asarray(emb), axis=1), jnp.asarray(toks),
        jnp.dtype(dtype)).astype(jnp.float32))
    got = pquant.embed_lookup(pquant.quantize(torch.tensor(emb), axis=1),
                              torch.tensor(toks).long(),
                              getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_forward_on_int8_snapshots_matches_jax():
    """The whole forward on an int8 snapshot, dequant and W8A8, fp32."""
    jparams, pparams = make_params(CFG)
    toks = np.random.RandomState(11).randint(0, CFG.vocab_size,
                                             (2, 16)).astype(np.int32)
    for native in (False, True):
        cfg = dataclasses.replace(CFG, int8_native=native)
        want = np.asarray(jtf.forward(
            jquant.quantize_params(jparams, jax_cfg(cfg)), jnp.asarray(toks),
            jax_cfg(cfg)))
        got = ptf.forward(pquant.quantize_params(pparams, cfg),
                          torch.tensor(toks).long(), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serving_params_and_params_from_numpy_carry_quant_arrays():
    """``serving_params`` leaves QuantArrays (int8 q, fp32 scales) as they
    are and keeps the MoE router fp32; ``params_from_numpy`` carries the
    JAX package's QuantArray of numpy arrays, or a (q, scale) pair, as a
    QuantArray without casting either part, and with ``dtype`` keeps the
    router fp32."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jparams, pparams = make_params(cfg)
    psnap = pdecode.serving_params(pquant.quantize_params(pparams, cfg), cfg)
    assert isinstance(psnap["blocks"][0]["wqkv"], pquant.QuantArray)
    assert psnap["blocks"][0]["wqkv"].q.dtype == torch.int8
    assert psnap["blocks"][0]["wqkv"].scale.dtype == torch.float32
    assert psnap["embed"].scale.dtype == torch.float32

    jq = jquant.quantize_params(jparams, jax_cfg(cfg))
    tree = jax.tree_util.tree_map(np.asarray, jq)
    got = params_from_numpy(tree, cfg, device="cpu", dtype=torch.bfloat16)
    _same_quant(got["embed"], jq["embed"])
    _same_quant(got["blocks"][1]["w_down"], jq["blocks"][1]["w_down"])
    tree["embed"] = (tree["embed"].q, tree["embed"].scale)
    _same_quant(params_from_numpy(tree, cfg, device="cpu")["embed"],
                jq["embed"])

    moe = dataclasses.replace(cfg, n_experts=2)
    jm = jtf.init_params(jax.random.PRNGKey(0), jax_cfg(moe))
    jsnap = jdecode.serving_params(jm, jax_cfg(moe))
    mtree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jm)
    msnap = params_from_numpy(mtree, moe, device="cpu", dtype=torch.bfloat16)
    psnap = pdecode.serving_params(params_from_numpy(mtree, moe,
                                                     device="cpu"), moe)
    for snap in (msnap, psnap):
        block = snap["blocks"][0]["moe"]
        assert block["router"].dtype == torch.float32
        assert block["w_up"].dtype == torch.bfloat16
    assert jsnap["blocks"][0]["moe"]["router"].dtype == jnp.float32
