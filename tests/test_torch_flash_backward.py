"""PyTorch port parity: the flash-attention backward (ops/flash_attention.py).

The port's gradients — ``torch.autograd.grad`` through
``flash_attention`` on CPU tensors, which runs the plain backward
``flash_attention_bwd_ref`` — against ``jax.vjp`` of the JAX package's
Pallas kernel (``pallas_kernels.flash_attention``, interpret mode, its
``custom_vjp`` backward) on the same numpy q, k, v and upstream
gradient, at the 2e-4 fp32 bar of tests/test_pallas.py (both sides
accumulate in fp32; tiling and summation order differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kind_tpu_sim.ops import pallas_kernels as pk
from kind_tpu_sim_torch.models.transformer import _attention
from kind_tpu_sim_torch.ops import flash_attention as fa

TOL = 2e-4


def _inputs(b, t, h, kv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32),
            rng.randn(b, t, h, d).astype(np.float32))


def _jax_grads(q, k, v, g, causal, dtype=jnp.float32, **blocks):
    def fn(q, k, v):
        return pk.flash_attention(q, k, v, causal=causal, **blocks)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(g).astype(dtype))]


def _port_grads(q, k, v, g, causal, dtype=torch.float32, attend=None):
    leaves = [torch.as_tensor(x).to(dtype).requires_grad_()
              for x in (q, k, v)]
    attend = attend or (lambda *a: fa.flash_attention(*a, causal=causal))
    out = attend(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(g).to(dtype))
    for grad, leaf in zip(grads, leaves):
        assert grad.dtype == leaf.dtype and grad.shape == leaf.shape
    return [x.float().numpy() for x in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_pallas_backward(causal):
    """test_pallas.py:235's shape and blocks: (2, 32, 2, 16), JAX
    block_q 8 and block_kv 16 (a 4 x 2 grid on that side)."""
    q, k, v, g = _inputs(2, 32, 2, 2, 16)
    want = _jax_grads(q, k, v, g, causal, block_q=8, block_kv=16)
    got = _port_grads(q, k, v, g, causal)
    for name, a, r in zip("qkv", got, want):
        np.testing.assert_allclose(a, r, atol=TOL, rtol=TOL, err_msg=name)


def test_gqa_multiblock_grads_match_pallas_backward():
    """test_pallas.py:266's GQA case: q (1, 48, 4, 8) over k/v
    (1, 48, 2, 8), JAX block_q 16 and block_kv 12 — dk/dv summed over
    each group of two q heads."""
    q, k, v, g = _inputs(1, 48, 4, 2, 8, seed=1)
    want = _jax_grads(q, k, v, g, True, block_q=16, block_kv=12)
    got = _port_grads(q, k, v, g, True)
    for name, a, r in zip("qkv", got, want):
        np.testing.assert_allclose(a, r, atol=TOL, rtol=TOL, err_msg=name)


def test_bf16_grads_match_pallas_backward():
    """bf16 inputs: both sides recompute P in fp32 from the same bf16
    values and cast dq, dk, dv to bf16 once, but their forward outputs
    (which D reads) come from different tilings of the online softmax,
    each rounded to bf16. The bar is a few bf16 ulps of the gradients'
    magnitude: 2e-2 absolute on values of order 1-4."""
    q, k, v, g = _inputs(1, 64, 4, 2, 32, seed=2)
    want = _jax_grads(q, k, v, g, True, jnp.bfloat16, block_q=16,
                      block_kv=32)
    got = _port_grads(q, k, v, g, True, torch.bfloat16)
    for name, a, r in zip("qkv", got, want):
        np.testing.assert_allclose(a, r, atol=2e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_dense_attention_grads(causal):
    """The port's flash backward against autograd through the port's
    dense ``_attention`` (test_pallas.py:235's comparison, port side)."""
    q, k, v, g = _inputs(2, 40, 4, 2, 16, seed=3)
    want = _port_grads(q, k, v, g, causal,
                       attend=lambda *a: _attention(*a, causal=causal))
    got = _port_grads(q, k, v, g, causal)
    for name, a, r in zip("qkv", got, want):
        np.testing.assert_allclose(a, r, atol=TOL, rtol=TOL, err_msg=name)


def test_ragged_cross_attention_grads_match_dense():
    """t != s without a causal mask, and t > s with one."""
    rng = np.random.RandomState(4)
    for t, s, causal in ((24, 40, False), (40, 24, True)):
        q = torch.as_tensor(rng.randn(1, t, 4, 16).astype(np.float32))
        k = torch.as_tensor(rng.randn(1, s, 2, 16).astype(np.float32))
        v = torch.as_tensor(rng.randn(1, s, 2, 16).astype(np.float32))
        g = rng.randn(1, t, 4, 16).astype(np.float32)
        args = [x.numpy() for x in (q, k, v)]
        got = _port_grads(*args, g, causal)
        # the dense path's tril(ones(t, s)) masks col <= row as well
        want = _port_grads(*args, g, causal,
                           attend=lambda *a: _attention(*a, causal=causal))
        for name, a, r in zip("qkv", got, want):
            np.testing.assert_allclose(a, r, atol=TOL, rtol=TOL,
                                       err_msg=f"{t}x{s} d{name}")


def test_bwd_wrappers_on_cpu_are_the_plain_version_and_launch_nothing():
    q, k, v, g = (torch.as_tensor(x) for x in _inputs(1, 32, 4, 2, 16))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    counts = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, g)
    assert torch.equal(fa.flash_attention_bwd_dq(q, k, v, out, lse, g), ref[0])
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, g)
    assert torch.equal(dk, ref[1]) and torch.equal(dv, ref[2])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(fa.flash_attention(*leaves), leaves, g)
    assert counts == (fa.flash_attention.launches,
                      fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches)


def test_forward_asks_for_lse_only_when_a_gradient_is_wanted(monkeypatch):
    """The serving path (no grad) runs the forward alone, as the
    reference's primal path runs ``needs_lse=False``."""
    asked = []
    real = fa._forward

    def spy(q, k, v, causal, return_lse):
        asked.append(return_lse)
        return real(q, k, v, causal, return_lse)

    monkeypatch.setattr(fa, "_forward", spy)
    q, k, v, _ = (torch.as_tensor(x) for x in _inputs(1, 16, 2, 2, 8))
    fa.flash_attention(q, k, v)
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        fa.flash_attention(qg, k, v)
    fa.flash_attention(q, k, v, return_lse=True)
    out = fa.flash_attention(qg, k, v)
    assert asked == [False, False, True, True]
    assert out.requires_grad


def test_non_contiguous_upstream_gradient():
    """Autograd may hand the backward a strided gradient."""
    q, k, v, g = _inputs(1, 24, 4, 2, 16, seed=5)
    gt = torch.as_tensor(g).transpose(1, 2).contiguous().transpose(1, 2)
    assert not gt.is_contiguous()
    leaves = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    a = torch.autograd.grad(fa.flash_attention(*leaves), leaves, gt)
    b = torch.autograd.grad(fa.flash_attention(*leaves), leaves,
                            torch.as_tensor(g))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_second_derivative_raises():
    """The backward writes its gradients without building a graph, so a
    double backward must raise rather than return gradients that carry
    no graph."""
    q, k, v, g = (torch.as_tensor(x).requires_grad_()
                  for x in _inputs(1, 16, 4, 2, 16, seed=6))
    dq, _, _ = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v),
                                   g, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


@pytest.mark.parametrize("case", ["lse_shape", "lse_dtype", "g_shape"])
def test_bwd_rejects_what_the_kernels_do_not_take(case):
    q, k, v, g = (torch.as_tensor(x) for x in _inputs(1, 16, 4, 2, 16))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    if case == "lse_shape":
        lse = lse[..., :8]
    elif case == "lse_dtype":
        lse = lse.double()
    else:
        g = g[:, :8]
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse, g)
