"""PyTorch port parity: the kernel-toolchain gate (ops/toolchain.py).

The port's ``matmul``, ``rms_norm`` and ``softmax`` on CPU tensors (their
plain versions) against the Pallas kernels of
``kind_tpu_sim/ops/pallas_kernels.py`` in interpret mode, on the cases
of ``tests/test_pallas.py:13-72`` with inputs made by numpy (the same
values on both sides). Tolerances are the reference's own: matmul fp32
2e-4, bf16 inputs 1e-2 (fp32 sums of exact bf16 products, in another
order), rms_norm 1e-5, softmax 1e-6; bf16 outputs at rtol 2^-7 (one
rounding to bf16 on each side). The cases include the edges the CUDA
kernels' routes must keep: a bf16 weight, row counts that their rows
a block do not divide, -inf entries and an all -inf row (NaN in both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kind_tpu_sim.ops import pallas_kernels as pk
from kind_tpu_sim_torch.ops import toolchain as tc


def _normal(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_matmul_matches_pallas():
    a, b = _normal((256, 128), 0), _normal((128, 256), 1)
    want = pk.matmul(jnp.asarray(a), jnp.asarray(b), block_m=128,
                     block_n=128, block_k=64, interpret=True)
    got = tc.matmul(torch.from_numpy(a), torch.from_numpy(b), block_m=128,
                    block_n=128, block_k=64)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got.numpy(), a.astype(np.float64) @ b,
                               atol=2e-4)


def test_matmul_bf16_inputs_fp32_accumulation():
    a, b = _normal((128, 128), 0), _normal((128, 128), 1)
    want = pk.matmul(jnp.asarray(a, jnp.bfloat16),
                     jnp.asarray(b, jnp.bfloat16), interpret=True)
    got = tc.matmul(torch.from_numpy(a).bfloat16(),
                    torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


# (A shape, B shape, block_m, block_n, block_k)
TILING_CASES = [
    ((100, 128), (128, 128), 64, 128, 128),   # test_pallas.py's ragged m
    ((100, 128), (128, 128), 128, 128, 128),  # block_m = min(128, 100)
    ((256, 96), (96, 128), 128, 128, 64),     # k = 96 over block_k 64
    ((128, 128), (128, 200), 128, 128, 128),  # n = 200 over block_n 128
    ((64, 32), (48, 64), 128, 128, 128),      # k of A != k of B
]


@pytest.mark.parametrize("case", TILING_CASES,
                         ids=[f"{a}@{b}-{m}x{n}x{k}"
                              for a, b, m, n, k in TILING_CASES])
def test_matmul_refuses_what_the_reference_refuses(case):
    shape_a, shape_b, bm, bn, bk = case
    a, b = _normal(shape_a, 0), _normal(shape_b, 1)
    try:
        pk.matmul(jnp.asarray(a), jnp.asarray(b), block_m=bm, block_n=bn,
                  block_k=bk, interpret=True)
        refused = False
    except AssertionError:
        refused = True
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if refused:
        with pytest.raises(ValueError, match="matmul"):
            tc.matmul(ta, tb, block_m=bm, block_n=bn, block_k=bk)
    else:
        got = tc.matmul(ta, tb, block_m=bm, block_n=bn, block_k=bk)
        np.testing.assert_allclose(got.numpy(), a.astype(np.float64) @ b,
                                   atol=2e-4)


def test_matmul_refuses_mixed_or_other_dtypes():
    a = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="both fp32 or both bf16"):
        tc.matmul(a, a.bfloat16())
    with pytest.raises(ValueError, match="both fp32 or both bf16"):
        tc.matmul(a.half(), a.half())


def test_rms_norm_matches_pallas():
    x, w = _normal((32, 128), 0), _normal((128,), 1)
    want = pk.rms_norm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = tc.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    ref = x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6) * w
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_rms_norm_bf16_keeps_the_input_dtype():
    x, w = _normal((16, 64), 2), _normal((64,), 3)
    want = pk.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                       interpret=True)
    got = tc.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # both compute in fp32 and round once to bf16 (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-5)


def test_softmax_matches_pallas():
    x = _normal((16, 128), 0, scale=10.0)
    want = pk.softmax(jnp.asarray(x), interpret=True)
    got = tc.softmax(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               torch.softmax(torch.from_numpy(x), -1).numpy(),
                               atol=1e-6)


def test_softmax_any_rank_keeps_the_input_dtype():
    x = _normal((2, 3, 40), 4, scale=5.0)
    want = pk.softmax(jnp.asarray(x, jnp.bfloat16), interpret=True)
    got = tc.softmax(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 40)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("rows,d,x_dtype", [
    (13, 256, "bfloat16"),   # rows the kernels' 8 rows a block do not divide
    (21, 200, "float32"),
])
def test_rms_norm_bf16_weight_matches_pallas(rows, d, x_dtype):
    x, w = _normal((rows, d), 5, scale=3.0), _normal((d,), 6)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    want = pk.rms_norm(jx, jnp.asarray(w, jnp.bfloat16), interpret=True)
    got = tc.rms_norm(torch.from_numpy(x).to(getattr(torch, x_dtype)),
                      torch.from_numpy(w).bfloat16())
    assert got.dtype == getattr(torch, x_dtype) and want.dtype == jx.dtype
    if x_dtype == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _with_neg_inf(shape, seed):
    """Normal rows with about a third of the entries -inf and row 2
    all -inf."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * 5.0).astype(np.float32)
    x[rng.random_sample(shape) < 0.3] = -np.inf
    x[2] = -np.inf
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_neg_inf_entries_and_an_all_neg_inf_row_match_pallas(dtype):
    x = _with_neg_inf((6, 96), 7)
    want = np.asarray(pk.softmax(jnp.asarray(x, getattr(jnp, dtype)),
                                 interpret=True), np.float32)
    got = tc.softmax(torch.from_numpy(x).to(getattr(torch, dtype)))
    got = got.float().numpy()
    # -inf entries give 0 and the all -inf row is NaN, in both
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    assert (got[np.isneginf(x) & live] == 0).all()
    rtol = 2 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got[live], want[live], rtol=rtol, atol=1e-6)


def test_toolchain_smoke_on_the_cpu():
    report = tc.toolchain_smoke(device="cpu")
    assert set(report) == {"backend", "interpret", "matmul_ok",
                           "rms_norm_ok", "softmax_ok", "ok"}
    assert report["ok"], report
    assert report["backend"] == "cpu"
    assert report["interpret"] is True


def test_cpu_calls_launch_no_kernel():
    counts = (tc.matmul.launches, tc.rms_norm.launches, tc.softmax.launches)
    tc.toolchain_smoke(device="cpu")
    assert counts == (tc.matmul.launches, tc.rms_norm.launches,
                      tc.softmax.launches)
