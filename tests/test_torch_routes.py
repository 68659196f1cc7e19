"""PyTorch port: which kernel a CUDA call would launch.

``flash_attention.forward_route`` and ``toolchain.matmul_route`` pick
the tensor-core kernel (wgmma fed by TMA) or the CUDA-core kernel from
the inputs alone, before any launch. These are pure functions of dtype,
shape, strides and alignment, so they are checked here on CPU tensors
of the same layouts; a CPU call of either wrapper still takes the plain
version and counts no launch on either route.
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
