"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``kind_tpu_sim/ops/pallas_kernels.py:_flash_impl``. ``flash_attention``
dispatches on the tensors' device alone: CUDA tensors launch the kernel
(or raise), CPU tensors take ``flash_attention_ref``, the same online
softmax written step by step in PyTorch. The backward kernels belong
to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from kind_tpu_sim_torch.ops import _build

SOURCE = "kind_tpu_sim_torch/csrc/flash_attention.cu"
# the pallas_call of _flash_impl, the TPU kernel this one replaces
REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:313"
NEG = -1e30
BLOCK_KV = 64  # the kernel's kv tile; the plain version walks the same tiles
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
             + (ctypes.c_longlong,) * 12
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


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """Fused attention forward. q (b, t, h, d); k/v (b, s, kv, d) with kv
    dividing h (GQA), any strides with a contiguous head dim; bf16 or
    fp32; d <= 128 and a multiple of 8. Returns out (b, t, h, d) in
    q's dtype and, with ``return_lse``, the logsumexp (b, h, t) fp32."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, return_lse)
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _build.function("kts_flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             _DTYPE_CODES[q.dtype], b, t, s, h, kv, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], d ** -0.5, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # kernel launches (CPU calls not counted)
