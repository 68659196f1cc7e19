"""PyTorch port: which kernel a CUDA call would launch.

``flash_attention.forward_route``, ``flash_attention.backward_route``
and ``toolchain.matmul_route`` pick the tensor-core kernel (wgmma fed
by TMA) or the CUDA-core kernel from the inputs alone, before any
launch; ``paged_attention.paged_route`` picks the split-KV kernel or
the one-pass kernel the same way, and ``blocks_per_split`` sizes the
split kernel's grid from host-known numbers; ``toolchain.rms_norm_route``
and ``toolchain.softmax_route`` pick the row kernels' new routes
(16-byte loads, the row held in registers) or their first kernels.
These are pure functions of dtype, shape, strides and alignment, so they are checked here on CPU tensors of the same
layouts; a CPU call of any wrapper still takes the plain version and
counts no launch on either route.
"""

import pytest
import torch

from kind_tpu_sim_torch.ops import flash_attention as fa
from kind_tpu_sim_torch.ops import paged_attention as pa
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


def _paged_inputs(slots=8, kv=4, g=4, hd=128, nblocks=129, bsz=64, width=8,
                  dtype=torch.bfloat16, offset=0):
    """Inputs of the serving path's decode call (default: the flagship
    shape), the pools starting ``offset`` elements into their
    allocations."""
    n = nblocks * bsz * kv * hd
    pools = [torch.zeros(offset + n, dtype=dtype)[offset:].view(
        nblocks, bsz, kv, hd) for _ in range(2)]
    return (torch.zeros(slots, kv, g, hd, dtype=dtype), *pools,
            torch.zeros(slots, width, dtype=torch.int32),
            torch.zeros(slots, dtype=torch.int32))


SPLIT, ONE = pa.SPLIT_KV, pa.ONE_PASS
PAGED_CASES = {
    "bf16 flagship": ({}, SPLIT),
    "bf16 full context width 16": ({"width": 16, "nblocks": 200}, SPLIT),
    "bf16 gqa8 hd64 bsz16": ({"g": 8, "hd": 64, "bsz": 16}, SPLIT),
    "bf16 hd256 bsz256": ({"kv": 2, "hd": 256, "bsz": 256,
                           "nblocks": 9}, SPLIT),
    "bf16 g3 hd24 width 505": ({"slots": 1, "kv": 1, "g": 3, "hd": 24,
                                "nblocks": 9, "width": 505}, SPLIT),
    "fp32 flagship": ({"dtype": torch.float32}, ONE),
    "fp32 small model": ({"slots": 4, "kv": 2, "g": 2, "hd": 32,
                          "nblocks": 9, "bsz": 16, "width": 5,
                          "dtype": torch.float32}, ONE),
    "bf16 hd 12": ({"hd": 12}, ONE),
    "bf16 pools one element off": ({"offset": 1}, ONE),
    "bf16 table too wide for shared memory": ({"width": 40000}, ONE),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_route(case):
    kwargs, want = PAGED_CASES[case]
    args = _paged_inputs(**kwargs)
    if case != "bf16 pools one element off":
        pa._check(*args)  # every other case is one the wrapper takes
    assert pa.paged_route(*args) == want


@pytest.mark.parametrize("shape,want", [
    # (width, bsz)
    ((8, 64), 1),        # the flagship decode call: 8 x 4 x 8 blocks
    ((16, 64), 1),       # the flagship's full max_len
    ((8, 16), 4),        # at least one 64-position tile
    ((12, 16), 4),
    ((3, 16), 3),        # never more than the table
    ((8, 256), 1),
    ((1, 64), 1),
    ((505, 64), 1),
    ((1024, 64), 2),     # never more than MAX_SPLITS splits
])
def test_blocks_per_split(shape, want):
    width, bsz = shape
    bps = pa.blocks_per_split(width, bsz)
    assert bps == want
    assert -(-width // bps) <= pa.MAX_SPLITS


def test_split_smem_bytes_matches_the_kernel_layout():
    """csrc/paged_attention_split.cu's layout at the flagship shape (8
    splits): one stage of K and V (64 rows of 17 16-byte chunks each),
    q in fp32, 64 x 8 scores, one table entry."""
    q_off = 2 * 64 * 17 * 16
    assert pa.split_layout(4, 128, 1, 1, 8) == (
        q_off, q_off + 4 * 128 * 4, q_off + 4 * 128 * 4 + 64 * 8 * 4,
        q_off + 4 * 128 * 4 + 64 * 8 * 4 + 16)
    # the row-group sums outgrow a one-stage ring at head dim 8
    assert pa.split_layout(8, 8, 1, 1, 8)[-1] == (
        128 * 8 * 8 * 4 + 8 * 8 * 4 + 64 * 8 * 4 + 16)
    # and the combine's m and l outgrow both at 512 splits
    assert pa.split_layout(8, 8, 1, 1, 512)[-1] == (
        512 * 8 * 2 * 4 + 8 * 8 * 4 + 64 * 8 * 4 + 16)


@pytest.mark.parametrize("g,hd,stages,bps,n_splits", [
    (3, 24, 1, 1, 505),   # the combine's m and l (12120 bytes) lead
    (1, 8, 1, 1, 511),
    (5, 40, 2, 7, 73),
    (4, 128, 2, 2, 8),
    (8, 256, 2, 3, 3),
])
def test_split_layout_keeps_16_byte_boundaries(g, hd, stages, bps,
                                               n_splits):
    """q is read as float4 and the tile ring by 16-byte copies: every
    part of the layout starts on a 16-byte boundary, whichever of the
    ring, the row-group sums and the combine's m and l is largest."""
    layout = pa.split_layout(g, hd, stages, bps, n_splits)
    assert all(off % 16 == 0 for off in layout)
    assert layout[0] >= n_splits * g * 2 * 4


def test_cpu_paged_calls_take_the_plain_version_and_count_no_route():
    routes = dict(pa.paged_attention.launches_by_route)
    qg, kp, vp, tables, lengths = _paged_inputs(
        slots=2, kv=2, g=2, hd=16, nblocks=5, bsz=8, width=2)
    qg, kp, vp = (x.normal_() for x in (qg, kp, vp))
    lengths[:] = torch.tensor([9, 3])
    tables[:] = torch.tensor([[1, 2], [3, 0]])
    got = pa.paged_attention(qg, kp, vp, tables, lengths)
    want = pa.paged_attention_ref(qg, kp, vp, tables, lengths)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pa.paged_attention.launches_by_route == routes
    assert set(routes) == {SPLIT, ONE}


def _rows(rows, d, dtype=torch.bfloat16, offset=0):
    """An uninitialised (rows, d) tensor ``offset`` elements into its
    allocation (``empty``: the flagship's rows take no memory until
    written)."""
    return torch.empty(offset + rows * d, dtype=dtype)[offset:].view(rows, d)


VEC, SCA = tc.VECTOR, tc.SCALAR
BF16, FP32, FP16 = torch.bfloat16, torch.float32, torch.float16
# (x rows, d, dtype, offset), (weight dtype, offset), route
RMS_NORM_CASES = {
    "gate fp32 (64,128)": ((64, 128, FP32, 0), (FP32, 0), VEC),
    "flagship bf16 (8192,2048), fp32 weight": ((8192, 2048, BF16, 0),
                                               (FP32, 0), VEC),
    "flagship bf16 (8192,2048), bf16 weight": ((8192, 2048, BF16, 0),
                                               (BF16, 0), VEC),
    "fp16 d 1032": ((4, 1032, FP16, 0), (FP16, 0), VEC),
    "bf16 d 2044 (d % 8 = 4)": ((4, 2044, BF16, 0), (FP32, 0), SCA),
    "fp32 d 2044 (d % 4 = 0)": ((4, 2044, FP32, 0), (BF16, 0), VEC),
    "fp32 d 2046 (d % 4 = 2)": ((4, 2046, FP32, 0), (FP32, 0), SCA),
    "bf16 x at storage offset 1": ((4, 2048, BF16, 1), (FP32, 0), SCA),
    "bf16 x at storage offset 8 (16 bytes)": ((4, 2048, BF16, 8),
                                              (FP32, 0), VEC),
    "fp32 weight at storage offset 1": ((4, 2048, BF16, 0), (FP32, 1), SCA),
    "bf16 longest row held, d 65536": ((4, 65536, BF16, 0), (FP32, 0), VEC),
    "bf16 one element past it": ((4, 65537, BF16, 0), (FP32, 0), SCA),
    "bf16 one chunk past it": ((4, 65544, BF16, 0), (FP32, 0), SCA),
    "fp32 longest row held, d 32768": ((4, 32768, FP32, 0), (FP32, 0), VEC),
    "fp32 one element past it": ((4, 32769, FP32, 0), (FP32, 0), SCA),
    "fp32 one chunk past it": ((4, 32772, FP32, 0), (FP32, 0), SCA),
}


@pytest.mark.parametrize("case", list(RMS_NORM_CASES))
def test_rms_norm_route(case):
    (rows, d, dtype, off), (w_dtype, w_off), want = RMS_NORM_CASES[case]
    x = _rows(rows, d, dtype, off)
    w = torch.empty(w_off + d, dtype=w_dtype)[w_off:]
    assert tc._rms_norm_check(x, w) == -1  # a case the wrapper takes
    assert tc.rms_norm_route(x, w) == want


ONE_READ, TWO_PASS = tc.ONE_READ, tc.TWO_PASS
# (rows, n, dtype, offset), route
SOFTMAX_CASES = {
    "gate fp32 (64,128)": ((64, 128, FP32, 0), ONE_READ),
    "flagship fp32 (8192,32768)": ((8192, 32768, FP32, 0), ONE_READ),
    "flagship bf16 (8192,32768)": ((8192, 32768, BF16, 0), ONE_READ),
    "fp16 n 2056": ((4, 2056, FP16, 0), ONE_READ),
    "bf16 n 1020 (n % 8 = 4)": ((4, 1020, BF16, 0), TWO_PASS),
    "fp32 n 1020 (n % 4 = 0)": ((4, 1020, FP32, 0), ONE_READ),
    "fp32 n 1022 (n % 4 = 2)": ((4, 1022, FP32, 0), TWO_PASS),
    "fp32 at storage offset 1": ((4, 1024, FP32, 1), TWO_PASS),
    "fp32 at storage offset 4 (16 bytes)": ((4, 1024, FP32, 4), ONE_READ),
    "bf16 one element past the longest row held": ((4, 32769, BF16, 0), TWO_PASS),
    "bf16 one chunk past it": ((4, 32776, BF16, 0), TWO_PASS),
    "fp32 one element past the longest row held": ((4, 32769, FP32, 0), TWO_PASS),
    "fp32 one chunk past it": ((4, 32772, FP32, 0), TWO_PASS),
}


@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_softmax_route(case):
    (rows, n, dtype, off), want = SOFTMAX_CASES[case]
    x = _rows(rows, n, dtype, off)
    assert tc._softmax_check(x) == -1  # a case the wrapper takes
    assert tc.softmax_route(x) == want


def test_softmax_route_reads_the_last_axis():
    x = torch.empty(2, 3, 32768)
    assert tc.softmax_route(x) == ONE_READ
    assert tc.softmax_route(torch.empty(2, 32772, 4)) == ONE_READ
    assert tc.softmax_route(torch.empty(2, 32772, 1)) == TWO_PASS
    assert tc.softmax_route(torch.empty(1, 2, 32772)) == TWO_PASS


def test_cpu_row_calls_take_the_plain_versions_and_count_no_route():
    counts = {fn: (fn.launches, dict(fn.launches_by_route))
              for fn in (tc.rms_norm, tc.softmax)}
    x, w = torch.randn(9, 64), torch.randn(64)
    assert torch.equal(tc.rms_norm(x, w), tc.rms_norm_ref(x, w))
    assert torch.equal(tc.softmax(x), tc.softmax_ref(x))
    tc.toolchain_smoke(device="cpu")
    for fn, (n, routes) in counts.items():
        assert fn.launches == n and fn.launches_by_route == routes
    assert set(counts[tc.rms_norm][1]) == {VEC, SCA}
    assert set(counts[tc.softmax][1]) == {ONE_READ, TWO_PASS}
