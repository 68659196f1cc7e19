"""Paged attention (decode): the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``kind_tpu_sim/ops/pallas_kernels.py:paged_attention``.
``paged_attention`` dispatches on the tensors' device alone: CUDA
tensors launch the kernel (or raise), CPU tensors take
``paged_attention_ref``, the same block walk written in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from kind_tpu_sim_torch.ops import _build

SOURCE = "kind_tpu_sim_torch/csrc/paged_attention.cu"
# the pallas_call of paged_attention, the TPU kernel this one replaces
REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:651"
NEG = -1e30
G_MAX, HD_MAX = 8, 256
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
             + (ctypes.c_float, ctypes.c_void_p))


def _check(qg, k_pool, v_pool, tables, lengths) -> None:
    if qg.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            "paged_attention wants qg (slots,kv,g,hd) and pools "
            f"(num_blocks,bsz,kv,hd); got {tuple(qg.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    slots, kv, g, hd = qg.shape
    if (k_pool.shape[2], k_pool.shape[3]) != (kv, hd):
        raise ValueError(
            f"paged_attention: pool {tuple(k_pool.shape)} does not match "
            f"qg {tuple(qg.shape)}")
    if tables.ndim != 2 or tables.shape[0] != slots or tuple(
            lengths.shape) != (slots,):
        raise ValueError(
            f"paged_attention wants tables ({slots}, width) and lengths "
            f"({slots},); got {tuple(tables.shape)}, "
            f"{tuple(lengths.shape)}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: tables and lengths must be int32")
    if not (qg.dtype == k_pool.dtype == v_pool.dtype) or (
            qg.dtype not in _DTYPE_CODES):
        raise ValueError(
            "paged_attention wants qg and pools all bf16 or all fp32; got "
            f"{qg.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if g > G_MAX or hd > HD_MAX or 4 * g * (hd + k_pool.shape[1]) > 48 * 1024:
        raise ValueError(
            f"paged_attention: group {g} (<= {G_MAX}), head dim {hd} "
            f"(<= {HD_MAX}) or block size {k_pool.shape[1]} too large")
    tensors = (qg, k_pool, v_pool, tables, lengths)
    if len({x.device for x in tensors}) != 1:
        raise ValueError("paged_attention: inputs on different devices")
    if qg.device.type not in ("cuda", "cpu"):
        raise ValueError(f"paged_attention: unsupported device {qg.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")


def paged_attention_ref(qg, k_pool, v_pool, tables, lengths):
    """The kernel's arithmetic in plain PyTorch: every slot walks its
    table block by block with an fp32 online softmax whose mask
    multiplies p. Returns (acc (slots,kv,g,hd), m (slots,kv,g),
    l (slots,kv,g)), fp32 and unnormalised; a zero-length slot gives
    acc = 0, l = 0, m = -1e30. Blocks past the longest slot's last
    live block are not read."""
    slots, kv, g, hd = qg.shape
    bsz = k_pool.shape[1]
    scale = hd ** -0.5
    q = qg.float()
    acc = torch.zeros((slots, kv, g, hd), device=qg.device)
    m = torch.full((slots, kv, g), NEG, device=qg.device)
    l = torch.zeros((slots, kv, g), device=qg.device)
    longest = int(lengths.max()) if slots else 0
    n_blocks = min(tables.shape[1], -(-longest // bsz))
    offsets = torch.arange(bsz, device=qg.device)
    for b in range(n_blocks):
        blocks = tables[:, b].long()
        kb = k_pool[blocks].float()                   # (slots,bsz,kv,hd)
        vb = v_pool[blocks].float()
        live = (b * bsz + offsets)[None, :] < lengths[:, None]
        mask = live[:, None, None, :]                 # (slots,1,1,bsz)
        sc = torch.einsum("skgd,sbkd->skgb", q, kb) * scale
        sc = torch.where(mask, sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None]) * mask
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("skgb,sbkd->skgd", p, vb)
        m = m_new
    return acc, m, l


def paged_attention(qg, k_pool, v_pool, tables, lengths):
    """Softmax partials of one query token per slot over its paged KV
    prefix. qg (slots, kv, g, hd); pools (num_blocks, bsz, kv, hd);
    tables (slots, width) int32; lengths (slots,) int32 — slot s
    attends positions [0, lengths[s]). Returns fp32 (acc, m, l)."""
    _check(qg, k_pool, v_pool, tables, lengths)
    if qg.device.type == "cpu":
        return paged_attention_ref(qg, k_pool, v_pool, tables, lengths)
    slots, kv, g, hd = qg.shape
    acc = torch.empty((slots, kv, g, hd), dtype=torch.float32,
                      device=qg.device)
    m = torch.empty((slots, kv, g), dtype=torch.float32, device=qg.device)
    l = torch.empty((slots, kv, g), dtype=torch.float32, device=qg.device)
    if slots == 0:
        return acc, m, l
    fn = _build.function("kts_paged_attention", _ARGTYPES)
    err = fn(qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tables.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
             m.data_ptr(), l.data_ptr(), _DTYPE_CODES[qg.dtype], slots, kv,
             g, hd, k_pool.shape[1], tables.shape[1], hd ** -0.5,
             torch.cuda.current_stream(qg.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return acc, m, l


paged_attention.launches = 0  # kernel launches (CPU calls not counted)
