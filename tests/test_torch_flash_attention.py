"""PyTorch port parity: flash-attention forward (ops/flash_attention.py).

``flash_attention_ref`` — the plain version of the CUDA kernel, which
the port's wrapper runs for CPU tensors — against the JAX package's
Pallas kernel (``pallas_kernels.flash_attention``, interpret mode) on
the same numpy inputs, at the 2e-5 fp32 bar of tests/test_pallas.py
(both sides accumulate in fp32; tiling and summation order differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kind_tpu_sim.ops import pallas_kernels as pk
from kind_tpu_sim_torch.ops import flash_attention as fa


def _qkv(b, t, h, kv, d, s=None, seed=0):
    rng = np.random.RandomState(seed)
    s = t if s is None else s
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, s, kv, d).astype(np.float32),
            rng.randn(b, s, kv, d).astype(np.float32))


def _both(q, k, v, causal, **blocks):
    ref = np.asarray(pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        **blocks))
    out = fa.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), causal=causal).numpy()
    return out, ref


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (4, 1)])
def test_flash_ref_matches_pallas_causal(h, kv):
    out, ref = _both(*_qkv(2, 256, h, kv, 64), causal=True)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2)])
def test_flash_ref_matches_pallas_full(h, kv):
    out, ref = _both(*_qkv(1, 128, h, kv, 64), causal=False)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_flash_ref_odd_length():
    """t = 192 (not a multiple of the 64-row kv tile's power-of-two
    neighbours; the JAX side self-fits 96/64 blocks)."""
    out, ref = _both(*_qkv(1, 192, 2, 2, 64), causal=True,
                     block_q=128, block_kv=128)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_multi_block(causal):
    """Small JAX blocks force a multi-step kv grid on that side; the
    port walks 64-row tiles — two different tilings of one softmax."""
    out, ref = _both(*_qkv(2, 256, 4, 2, 64), causal=causal,
                     block_q=64, block_kv=64)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_flash_ref_ragged_full_cross_attention():
    """t != s without a causal mask (any t, s: the ragged tail of the
    last tile is masked by the port itself)."""
    out, ref = _both(*_qkv(1, 40, 4, 2, 32, s=200), causal=False)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_lse_matches_pallas(causal):
    q, k, v = _qkv(1, 96, 4, 2, 32)
    _, lse_ref = pk._flash_impl(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, 512, 1024, None,
                                needs_lse=True)
    out, lse = fa.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                      torch.as_tensor(v), causal=causal,
                                      return_lse=True)
    assert tuple(lse.shape) == (1, 4, 96)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=2e-5, rtol=2e-5)


def test_flash_ref_bf16_matches_pallas():
    """bf16 inputs: both round P to bf16 before the PV product, against
    different running maxima (one JAX block vs 64-row port tiles), so
    the bar is the bf16 one."""
    q, k, v = _qkv(1, 200, 4, 2, 64)
    ref = np.asarray(pk.flash_attention(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k).astype(
            jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16),
        causal=True).astype(jnp.float32))
    out = fa.flash_attention_ref(
        *(torch.as_tensor(x).bfloat16() for x in (q, k, v)),
        causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2,
                               rtol=2e-2)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 64, 4, 2, 32))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, fa.flash_attention_ref(q, k, v, causal=True))
    assert fa.flash_attention.launches == before


def test_wrapper_reads_strided_inputs():
    """v as a view of a fused qkv projection (the model's layout)."""
    rng = np.random.RandomState(7)
    qkv = torch.as_tensor(rng.randn(1, 48, 8 * 16).astype(np.float32))
    q = qkv[..., :64].reshape(1, 48, 4, 16)
    k = qkv[..., 64:96].reshape(1, 48, 2, 16)
    v = qkv[..., 96:].reshape(1, 48, 2, 16)
    assert not v.is_contiguous()
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "gqa", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 16, 4, 2, 32))
    if case == "head_dim":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif case == "dtype":
        k = k.bfloat16()
    elif case == "gqa":
        q = q[:, :, :3]
    else:
        q = q[0]
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
