"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Three kernels, each replacing a Pallas TPU kernel of
``kind_tpu_sim/ops/pallas_kernels.py``:

* ``csrc/flash_attention.cu`` — the forward, ``_flash_impl``;
* ``csrc/flash_attention_bwd_tc.cu`` and ``csrc/flash_attention_bwd.cu``
  — the backward's dq kernel and its dk/dv kernel, ``_flash_bwd``.

Every wrapper dispatches on the tensors' device alone: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain version
written step by step in PyTorch. Each kernel comes in two routes,
chosen before the launch from the inputs alone (``forward_route``,
``backward_route``): bf16 on the tensor cores (wgmma fed by TMA) where
TMA can read every input, else the CUDA-core kernel; each wrapper's
``launches_by_route`` counts its launches per route.
``FlashAttentionFunction`` joins the forward and the backward for
autograd; ``flash_attention`` goes through it.
"""

from __future__ import annotations

import ctypes

import torch

from kind_tpu_sim_torch.ops import _build
from kind_tpu_sim_torch.ops._build import CUDA_CORES, ROUTES, TENSOR_CORES

SOURCE = "kind_tpu_sim_torch/csrc/flash_attention.cu"
# the pallas_call of _flash_impl, the TPU kernel this one replaces
REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:313"
BWD_SOURCE = "kind_tpu_sim_torch/csrc/flash_attention_bwd_tc.cu"
BWD_CUDA_CORES_SOURCE = "kind_tpu_sim_torch/csrc/flash_attention_bwd.cu"
# the pallas_calls of _flash_bwd's dq and dk/dv kernels
DQ_REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:416"
DKV_REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:485"
NEG = -1e30
BLOCK_KV = 64  # the kernel's kv tile; the plain version walks the same tiles
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
             + (ctypes.c_longlong,) * 12
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
# the tensor-core entry point takes no dtype: bf16 only
_TC_ARGTYPES = _ARGTYPES[:5] + _ARGTYPES[6:]


def _bwd_argtypes(n_out: int, route: str) -> tuple:
    """q, k, v, g, lse, dsum and the outputs; dtype (the CUDA-core
    route only: the tensor-core one is bf16 alone), b, t, s, h, kv, d;
    the strides of q, k, v, g and of each output; scale, causal,
    stream."""
    n_int = 6 if route == TENSOR_CORES else 7
    return ((ctypes.c_void_p,) * (6 + n_out) + (ctypes.c_int,) * n_int
            + (ctypes.c_longlong,) * (12 + 3 * n_out)
            + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention wants q (b,t,h,d), k/v (b,s,kv,d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not match q "
            f"{tuple(q.shape)} (batch, head dim, kv heads dividing h)")
    if t < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention needs t >= 1 and s >= 1")
    if d > 128 or d % 8:
        raise ValueError(
            f"flash_attention: head dim {d} must be <= 128 and a "
            "multiple of 8")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            "flash_attention wants q, k, v all bf16 or all fp32; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")


def _check_bwd(q, k, v, out, lse, g) -> None:
    _check(q, k, v)
    b, t, h, _ = q.shape
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(
            f"flash backward: out {tuple(out.shape)} and g "
            f"{tuple(g.shape)} must have q's shape {tuple(q.shape)}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(
            f"flash backward: lse must be (b, h, t) fp32; got "
            f"{tuple(lse.shape)} {lse.dtype}")
    if any(x.device != q.device for x in (out, lse, g)):
        raise ValueError("flash backward: inputs on different devices")


def flash_attention_ref(q, k, v, causal: bool = True,
                        return_lse: bool = False):
    """The kernel's arithmetic in plain PyTorch: an online softmax over
    kv tiles of ``BLOCK_KV`` with fp32 running max, denominator and
    accumulator, P rounded to the value dtype before the PV product.
    Causal means column <= row with both counted from 0, as the
    reference kernel masks. Returns out (b, t, h, d) in q's dtype and,
    with ``return_lse``, the logsumexp (b, h, t) fp32."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = d ** -0.5
    qf = q.float().permute(0, 2, 1, 3)                        # (b,h,t,d)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    m = torch.full((b, h, t), NEG, device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    rows = torch.arange(t, device=q.device)
    kv_end = min(s, t) if causal else s
    for k0 in range(0, kv_end, BLOCK_KV):
        k1 = min(k0 + BLOCK_KV, s)
        sc = torch.einsum("bhtd,bhsd->bhts", qf, kf[:, :, k0:k1]) * scale
        if causal:
            cols = torch.arange(k0, k1, device=q.device)
            sc = sc.masked_fill(cols[None, :] > rows[:, None], NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhts,bhsd->bhtd", p.to(v.dtype).float(), vf[:, :, k0:k1])
        m = m_new
    out = (acc / l[..., None]).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    if return_lse:
        return out, m + torch.log(l)
    return out


def _route(q, tensors) -> str:
    """``TENSOR_CORES`` for bf16 with the head dim a multiple of 16 up
    to 128 and, for each of ``tensors``, a base address on a 16-byte
    boundary and batch, sequence and head strides that are positive
    multiples of 16 bytes, which TMA needs (the stride of an axis of
    length 1 is never followed); ``CUDA_CORES`` for everything else,
    fp32 included."""
    d = q.shape[3]
    if q.dtype != torch.bfloat16 or d % 16 or d > 128:
        return CUDA_CORES
    for x in tensors:
        if x.data_ptr() % 16 or any(
                size > 1 and (stride <= 0 or (2 * stride) % 16)
                for size, stride in zip(x.shape[:3], x.stride()[:3])):
            return CUDA_CORES
    return TENSOR_CORES


def forward_route(q, k, v) -> str:
    """The kernel a CUDA call of the forward launches, from the inputs
    alone (``_route`` over q, k and v). Inputs already passed
    ``_check``."""
    return _route(q, (q, k, v))


def backward_route(q, k, v, g) -> str:
    """The kernels a CUDA call of the backward launches (dq and dk/dv
    alike), from the inputs alone: the forward's rule over q, k, v and
    ``g``, the upstream gradient as ``_kernel_inputs`` hands it to the
    kernels (q's dtype, contiguous head dim); raises for any other g.
    Inputs already passed ``_check_bwd``."""
    if g.dtype != q.dtype or g.stride(-1) != 1:
        raise ValueError(
            "backward_route takes the g that _kernel_inputs hands the "
            f"kernels (q's dtype, contiguous head dim); got {g.dtype} "
            f"with strides {g.stride()}")
    return _route(q, (q, k, v, g))


def _forward_launch(q, k, v, causal: bool, return_lse: bool, route: str):
    """One launch of ``route``'s forward kernel on checked CUDA inputs;
    counts nothing (``_forward`` counts its own launches). Returns
    (out, lse or None)."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    rest = (b, t, s, h, kv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], d ** -0.5, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if route == TENSOR_CORES:
        fn = _build.function("kts_flash_attention_fwd_tc", _TC_ARGTYPES)
        err = fn(*args, *rest)
    else:
        fn = _build.function("kts_flash_attention_fwd", _ARGTYPES)
        err = fn(*args, _DTYPE_CODES[q.dtype], *rest)
    _build.check("flash_attention", err)
    return out, lse


def _forward(q, k, v, causal: bool, return_lse: bool):
    """The forward kernel's wrapper (no autograd)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, return_lse)
    route = forward_route(q, k, v)
    out, lse = _forward_launch(q, k, v, causal, return_lse, route)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------
# backward


def _dsum(out, g):
    """D = rowsum(float(g) * float(out)), (b, h, t) fp32 — elementwise
    work outside the kernels, as the reference computes it (:373-375)."""
    return (g.float() * out.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def _bwd_scores(q, k, v, out, lse, g, causal):
    """What both halves of the plain backward share, head-major fp32:
    q, g, k and v (k and v repeated over each GQA group), P and dS."""
    t, h, d = q.shape[1:]
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    qf = q.float().permute(0, 2, 1, 3)                        # (b,h,t,d)
    gf = g.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    sc = torch.einsum("bhtd,bhsd->bhts", qf, kf) * d ** -0.5
    if causal:
        mask = (torch.arange(s, device=q.device)[None, :]
                > torch.arange(t, device=q.device)[:, None])
        sc = sc.masked_fill(mask, NEG)
    p = torch.exp(sc - lse[..., None])
    dp = torch.einsum("bhtd,bhsd->bhts", gf, vf)
    ds = p * (dp - _dsum(out, g)[..., None])
    return qf, gf, kf, p, ds


def _dq_from(q, kf, ds):
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf) * q.shape[3] ** -0.5
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def _dkv_from(q, k, v, qf, gf, p, ds):
    b, s, kv, d = k.shape
    group = q.shape[2] // kv
    dk_h = torch.einsum("bhts,bhtd->bhsd", ds, qf) * d ** -0.5
    dv_h = torch.einsum("bhts,bhtd->bhsd", p, gf)

    def group_sum(x, dtype):                  # (b,h,s,d) -> (b,s,kv,d)
        return (x.reshape(b, kv, group, s, d).sum(dim=2)
                .permute(0, 2, 1, 3).to(dtype).contiguous())

    return group_sum(dk_h, k.dtype), group_sum(dv_h, v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, g, causal: bool = True):
    """The backward's arithmetic in plain PyTorch, with the numerics of
    the reference's ``_flash_bwd``: scores recomputed in fp32 as
    (q k^T) * scale with masked entries -1e30, P = exp(S - lse) in fp32
    (not rounded, unlike the forward's P before PV), dP = g v^T,
    dS = P * (dP - D) with D = rowsum(g * out); dq = dS k * scale,
    dv = P^T g and dk = dS^T q * scale, accumulated per q head in fp32
    and summed over each GQA group before the one cast to k's and v's
    dtype. Returns (dq, dk, dv) in the inputs' shapes and dtypes."""
    qf, gf, kf, p, ds = _bwd_scores(q, k, v, out, lse, g, causal)
    return (_dq_from(q, kf, ds), *_dkv_from(q, k, v, qf, gf, p, ds))


def flash_attention_bwd_dq_ref(q, k, v, out, lse, g, causal: bool = True):
    """The dq kernel's plain version: ``flash_attention_bwd_ref``'s dq
    alone."""
    _, _, kf, _, ds = _bwd_scores(q, k, v, out, lse, g, causal)
    return _dq_from(q, kf, ds)


def flash_attention_bwd_dkv_ref(q, k, v, out, lse, g, causal: bool = True):
    """The dk/dv kernel's plain version: ``flash_attention_bwd_ref``'s
    (dk, dv) alone."""
    qf, gf, _, p, ds = _bwd_scores(q, k, v, out, lse, g, causal)
    return _dkv_from(q, k, v, qf, gf, p, ds)


def _kernel_inputs(q, out, lse, g):
    """What the kernels read besides q, k, v: g in q's dtype with a
    contiguous head dim, lse contiguous on a 16-byte boundary (the
    tensor-core dk/dv kernel reads its rows by TMA), and D."""
    if g.stride(-1) != 1 or g.dtype != q.dtype:
        g = g.to(q.dtype).contiguous()
    lse = lse.contiguous()
    if lse.data_ptr() % 16:
        lse = lse.clone()
    return g, lse, _dsum(out, g)


def _bwd_launch(kernel: str, route: str, q, k, v, g, lse, dsum, causal):
    """One launch of ``route``'s ``kernel`` ("dq" or "dkv") on checked
    CUDA inputs from ``_kernel_inputs``; counts nothing (the wrappers
    count their own launches). Returns [dq] or [dk, dv]."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    outs = ([torch.empty(q.shape, dtype=q.dtype, device=q.device)]
            if kernel == "dq" else
            [torch.empty(x.shape, dtype=x.dtype, device=x.device)
             for x in (k, v)])
    name = f"kts_flash_attention_bwd_{kernel}"
    dims = (b, t, s, h, kv, d)
    if route == TENSOR_CORES:
        name += "_tc"
    else:
        dims = (_DTYPE_CODES[q.dtype], *dims)
    fn = _build.function(name, _bwd_argtypes(len(outs), route))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), dsum.data_ptr(), *(x.data_ptr() for x in outs),
             *dims,
             *(st for x in (q, k, v, g, *outs) for st in x.stride()[:3]),
             d ** -0.5, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, err)
    return outs


def _launch(kernel: str, q, k, v, g, lse, dsum, causal):
    """``_bwd_launch`` on ``backward_route``'s route, counted on the
    kernel's wrapper."""
    route = backward_route(q, k, v, g)
    outs = _bwd_launch(kernel, route, q, k, v, g, lse, dsum, causal)
    wrapper = flash_attention_bwd_dq if kernel == "dq" else \
        flash_attention_bwd_dkv
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1
    return outs


def flash_attention_bwd_dq(q, k, v, out, lse, g, causal: bool = True):
    """dq (b, t, h, d) in q's dtype: the dq kernel on CUDA tensors, the
    plain backward's dq on CPU tensors."""
    _check_bwd(q, k, v, out, lse, g)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, out, lse, g, causal)
    return _launch("dq", q, k, v, *_kernel_inputs(q, out, lse, g),
                   causal)[0]


def flash_attention_bwd_dkv(q, k, v, out, lse, g, causal: bool = True):
    """(dk, dv), each (b, s, kv, d) in k's and v's dtype, GQA group
    summed in fp32: the dk/dv kernel on CUDA tensors, the plain
    backward's dk and dv on CPU tensors."""
    _check_bwd(q, k, v, out, lse, g)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, out, lse, g, causal)
    return tuple(_launch("dkv", q, k, v, *_kernel_inputs(q, out, lse, g),
                         causal))


def flash_attention_bwd(q, k, v, out, lse, g, causal: bool = True):
    """(dq, dk, dv) for the upstream gradient ``g`` of ``out``: both
    kernels on CUDA tensors, D computed once for the two; the plain
    backward on CPU tensors."""
    _check_bwd(q, k, v, out, lse, g)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, g, causal)
    inputs = _kernel_inputs(q, out, lse, g)
    return (*_launch("dq", q, k, v, *inputs, causal),
            *_launch("dkv", q, k, v, *inputs, causal))


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd around the flash kernels, as the reference's
    ``jax.custom_vjp``: the forward saves q, k, v, out and the
    logsumexp, the backward runs the dq and dk/dv kernels (the plain
    backward for CPU tensors) once: it builds no graph, so a second
    derivative raises. The logsumexp is computed only when
    ``needs_lse`` — a gradient is wanted or the caller asked for it —
    so the serving path's launches and outputs stay those of the
    forward alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, needs_lse: bool):
        ctx.causal = causal
        if not needs_lse:
            return _forward(q, k, v, causal, False), None
        out, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """Fused attention. q (b, t, h, d); k/v (b, s, kv, d) with kv
    dividing h (GQA), any strides with a contiguous head dim; bf16 or
    fp32; d <= 128 and a multiple of 8. Returns out (b, t, h, d) in
    q's dtype and, with ``return_lse``, the logsumexp (b, h, t) fp32.
    Differentiable in q, k and v through ``FlashAttentionFunction``."""
    wants_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    out, lse = FlashAttentionFunction.apply(q, k, v, causal,
                                            wants_grad or return_lse)
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # kernel launches (CPU calls not counted)
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_route = dict.fromkeys(ROUTES, 0)
