"""PyTorch port: which kernel a CUDA call would launch.

``flash_attention.forward_route``, ``flash_attention.backward_route``
and ``toolchain.matmul_route`` pick the tensor-core kernel (wgmma fed
by TMA) or the CUDA-core kernel from the inputs alone, before any
launch. These are pure functions of dtype, shape, strides and
alignment, so they are checked here on CPU tensors of the same
layouts; a CPU call of any wrapper still takes the plain version and
counts no launch on either route.
"""

import pytest
import torch

from kind_tpu_sim_torch.ops import flash_attention as fa
from kind_tpu_sim_torch.ops import toolchain as tc

TC, CC = fa.TENSOR_CORES, fa.CUDA_CORES


def _fused(b, t, h, kv, d, dtype=torch.bfloat16, offset=0):
    """q, k, v as views of one fused (b, t, (h + 2 kv) d) buffer, the
    model's layout, starting ``offset`` elements into the allocation."""
    width = (h + 2 * kv) * d
    qkv = torch.zeros(offset + b * t * width, dtype=dtype)[offset:]
    qkv = qkv.view(b, t, width)
    return (qkv[..., :h * d].reshape(b, t, h, d),
            qkv[..., h * d:(h + kv) * d].reshape(b, t, kv, d),
            qkv[..., (h + kv) * d:].reshape(b, t, kv, d))


FLASH_CASES = {
    "bf16 d128 fused views": (_fused(2, 64, 16, 4, 128), TC),
    "bf16 d128 contiguous": (
        tuple(x.contiguous() for x in _fused(1, 40, 4, 2, 128)), TC),
    "bf16 d64 fused views": (_fused(1, 48, 8, 2, 64), TC),
    "fp32 d128": (_fused(1, 64, 4, 2, 128, dtype=torch.float32), CC),
    "bf16 d24": (_fused(1, 64, 4, 2, 24), CC),
    "bf16 base one element off": (_fused(1, 64, 4, 2, 128, offset=1), CC),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_forward_route(case):
    (q, k, v), want = FLASH_CASES[case]
    fa._check(q, k, v)  # every case is one the wrapper takes
    assert fa.forward_route(q, k, v) == want


@pytest.mark.parametrize("stride_bytes,want", [(48, TC), (40, CC)])
def test_flash_route_reads_the_sequence_stride(stride_bytes, want):
    """q's rows ``stride_bytes`` apart: TMA needs a multiple of 16."""
    d = 16
    buf = torch.zeros(64 * stride_bytes // 2, dtype=torch.bfloat16)
    q = buf.as_strided((1, 64, 1, d), (0, stride_bytes // 2, d, 1))
    k = v = torch.zeros(1, 64, 1, d, dtype=torch.bfloat16)
    assert fa.forward_route(q, k, v) == want


def test_flash_route_keeps_expanded_inputs_off_tma():
    """k and v broadcast over the batch (stride 0) take the CUDA cores."""
    q = torch.zeros(2, 32, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 32, 2, 64, dtype=torch.bfloat16).expand(2, -1, -1, -1)
    fa._check(q, k, k)
    assert fa.forward_route(q, k, k) == CC


def test_flash_route_ignores_the_stride_of_a_length_one_axis():
    """b = 1: the batch stride is never followed, even when odd."""
    q, k, v = (torch.zeros(1, 32, 2, 64, dtype=torch.bfloat16)
               for _ in range(3))
    odd = q.as_strided(q.shape, (12345,) + q.stride()[1:])
    assert fa.forward_route(odd, k, v) == TC


def _grad(q, offset=0):
    """A contiguous upstream gradient of q's shape and dtype, starting
    ``offset`` elements into its allocation."""
    n = q.numel()
    return torch.zeros(offset + n, dtype=q.dtype)[offset:].view(q.shape)


def _bwd(b, t, h, kv, d, dtype=torch.bfloat16, offset=0, g_offset=0):
    q, k, v = _fused(b, t, h, kv, d, dtype=dtype, offset=offset)
    return q, k, v, _grad(q, g_offset)


BWD_CASES = {
    "bf16 d128 fused views, contiguous g": (_bwd(2, 64, 16, 4, 128), TC),
    "bf16 d64 fused views, contiguous g": (_bwd(1, 48, 8, 2, 64), TC),
    "fp32 d128": (_bwd(1, 64, 4, 2, 128, dtype=torch.float32), CC),
    "bf16 d24": (_bwd(1, 64, 4, 2, 24), CC),
    "bf16 base one element off": (_bwd(1, 64, 4, 2, 128, offset=1), CC),
    "bf16 g base one element off": (_bwd(1, 64, 4, 2, 128, g_offset=1), CC),
}


def _kernel_g(q, g):
    """g as ``_kernel_inputs`` hands it to the kernels."""
    b, t, h, _ = q.shape
    lse = torch.zeros(b, h, t)
    return fa._kernel_inputs(q, torch.zeros_like(q), lse, g)[0]


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_backward_route(case):
    (q, k, v, g), want = BWD_CASES[case]
    b, t, h, _ = q.shape
    fa._check_bwd(q, k, v, torch.zeros_like(q), torch.zeros(b, h, t), g)
    assert fa.backward_route(q, k, v, _kernel_g(q, g)) == want


@pytest.mark.parametrize("stride_bytes,want", [(48, TC), (40, CC)])
@pytest.mark.parametrize("strided", ["q", "g"])
def test_flash_backward_route_reads_the_sequence_stride(strided,
                                                        stride_bytes, want):
    """q's or g's rows ``stride_bytes`` apart: TMA needs a multiple of
    16, and the backward's kernels read g as they read q."""
    d = 16
    buf = torch.zeros(64 * stride_bytes // 2, dtype=torch.bfloat16)
    rows = buf.as_strided((1, 64, 1, d), (0, stride_bytes // 2, d, 1))
    plain = torch.zeros(1, 64, 1, d, dtype=torch.bfloat16)
    q, g = (rows, plain) if strided == "q" else (plain, rows)
    assert fa.backward_route(q, plain, plain, _kernel_g(q, g)) == want


def test_flash_backward_route_keeps_expanded_inputs_off_tma():
    """k and v broadcast over the batch (stride 0) take the CUDA cores."""
    q = torch.zeros(2, 32, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 32, 2, 64, dtype=torch.bfloat16).expand(2, -1, -1, -1)
    g = torch.zeros_like(q)
    fa._check_bwd(q, k, k, q, torch.zeros(2, 4, 32), g)
    assert fa.backward_route(q, k, k, _kernel_g(q, g)) == CC


@pytest.mark.parametrize("layout", ["head dim strided", "fp32"])
def test_flash_backward_route_takes_g_only_after_kernel_inputs(layout):
    """A g whose head dim is not contiguous, or of another dtype than q,
    is refused by the route; ``_kernel_inputs`` makes it contiguous in
    q's dtype, and the kernels then read it on the tensor cores."""
    q, k, v = _fused(1, 32, 4, 2, 64)
    if layout == "fp32":
        g = torch.zeros(q.shape)
    else:
        g = torch.zeros(1, 32, 64, 4, dtype=q.dtype).transpose(2, 3)
        assert g.shape == q.shape and g.stride(-1) != 1
    with pytest.raises(ValueError, match="_kernel_inputs"):
        fa.backward_route(q, k, v, g)
    g_kernel = _kernel_g(q, g)
    assert g_kernel.stride(-1) == 1 and g_kernel.dtype == q.dtype
    assert fa.backward_route(q, k, v, g_kernel) == TC


def test_kernel_inputs_hand_the_kernels_an_aligned_lse():
    """The tensor-core dk/dv kernel reads lse rows by TMA: a view that
    starts off a 16-byte boundary is copied, an aligned one is not."""
    q, _, _ = _fused(1, 32, 4, 2, 64)
    g, out = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros(1 + 4 * 32)
    aligned, shifted = lse[:128].view(1, 4, 32), lse[1:].view(1, 4, 32)
    assert fa._kernel_inputs(q, out, aligned, g)[1].data_ptr() == \
        aligned.data_ptr()
    copied = fa._kernel_inputs(q, out, shifted, g)[1]
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, shifted)


def test_cpu_backward_calls_take_the_plain_versions_and_count_no_route():
    counts = {fn: (fn.launches, dict(fn.launches_by_route))
              for fn in (fa.flash_attention_bwd_dq,
                         fa.flash_attention_bwd_dkv)}
    q, k, v = (x.float().normal_() for x in _fused(1, 32, 4, 2, 32))
    g = torch.randn(q.shape)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, g)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(fa.flash_attention(*leaves), leaves, g)
    for fn, (n, routes) in counts.items():
        assert fn.launches == n and fn.launches_by_route == routes
        assert set(routes) == {TC, CC}


def _matmul_inputs(m, k, n, dtype=torch.bfloat16, offset=0):
    a = torch.zeros(offset + m * k, dtype=dtype)[offset:].view(m, k)
    return a, torch.zeros(k, n, dtype=dtype)


MATMUL_CASES = {
    "bf16 flagship (8192,2048)@(2048,8192)": ((8192, 2048, 8192), {}, TC),
    "bf16 ragged (384,640)@(640,896)": ((384, 640, 896), {}, TC),
    "fp32 (256,256)@(256,256)": ((256, 256, 256),
                                 {"dtype": torch.float32}, CC),
    "bf16 n=4": ((128, 128, 4), {}, CC),
    "bf16 k=12": ((128, 12, 128), {}, CC),
    "bf16 base one element off": ((128, 128, 128), {"offset": 1}, CC),
}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_matmul_route(case):
    (m, k, n), kwargs, want = MATMUL_CASES[case]
    a, b = _matmul_inputs(m, k, n, **kwargs)
    tc._matmul_check(a, b, 128, 128, 128 if k % 128 == 0 else k)
    assert tc.matmul_route(a, b) == want


def test_cpu_calls_take_the_plain_versions_and_count_no_route():
    flash_routes = dict(fa.flash_attention.launches_by_route)
    matmul_routes = dict(tc.matmul.launches_by_route)
    q, k, v = (x.float().normal_() for x in _fused(1, 32, 4, 2, 32))
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention_ref(q, k, v))
    a, b = torch.randn(128, 64), torch.randn(64, 128)
    assert torch.equal(tc.matmul(a, b), tc.matmul_ref(a, b))
    assert fa.flash_attention.launches_by_route == flash_routes
    assert tc.matmul.launches_by_route == matmul_routes
    assert set(flash_routes) == set(matmul_routes) == {TC, CC}
