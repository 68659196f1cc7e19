"""Exact int8 x int8 -> int32 batched products: the CUDA kernel's wrapper
and plain version.

The JAX package runs its W8A8 contractions (``quant.linear`` and
``quant.readout`` with ``native=True``, and the int8 KV cache's scores
and values in ``decode._cache_scores`` / ``_cache_values``) as XLA
``dot_general``s with ``preferred_element_type=int32``, not as a Pallas
kernel. PyTorch has no batched int8 product on CUDA, and a float GEMM of
int8 values stops being exact once partial sums pass 2^24 (K > ~1040;
the flagship's contractions run over 2048-8192), so the port adds one
kernel: ``csrc/int8_matmul.cu`` (``__dp4a`` over 4-byte groups of K,
int32 accumulation, K split across blocks with exact int32 atomics when
the tiles alone cannot fill the card).

``int8_matmul(a, b)`` dispatches on the tensors' device alone: CUDA
tensors launch the kernel (or raise), CPU tensors take
``int8_matmul_ref``. It counts its launches in ``.launches`` and, per
route (one, ``dp4a``), in ``.launches_by_route``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kind_tpu_sim_torch.ops import _build

SOURCE = "kind_tpu_sim_torch/csrc/int8_matmul.cu"
# no TPU kernel: the XLA int8 dot_general of the W8A8 path
REPLACES = "kind_tpu_sim/models/quant.py:118"
DP4A = "dp4a"
ROUTES = (DP4A,)
BLOCK_M = BLOCK_N = BLOCK_K = 64   # the kernel's tile (csrc/int8_matmul.cu)
# split K until the grid holds this many blocks (2 per SM of an H100),
# keeping at least MIN_K_STEPS steps of BLOCK_K a split
TARGET_BLOCKS, MIN_K_STEPS = 264, 4
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P) + (_I,) * 5 + (_L,) * 6 + (_I,) * 3 + (_P,)
REF_CHUNK = 1 << 24   # elements of one int64 partial product (plain)


def _operands(a, b):
    """Check a (*batch, M, K) and b (*batch, K, N), both int8 with the
    same batch shape (at most two dimensions) on one device, a with K
    contiguous, b with N or K contiguous. Returns (batch, a, b,
    b_kn)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(
            f"int8_matmul wants int8 operands; got {a.dtype}, {b.dtype}")
    if a.dim() < 2 or a.dim() > 4 or b.dim() != a.dim():
        raise ValueError(
            "int8_matmul wants a (*batch, M, K) and b (*batch, K, N) with "
            f"at most two batch dimensions; got {tuple(a.shape)}, "
            f"{tuple(b.shape)}")
    batch = tuple(a.shape[:-2])
    if tuple(b.shape[:-2]) != batch or a.shape[-1] != b.shape[-2]:
        raise ValueError(
            f"int8_matmul: shapes {tuple(a.shape)} and {tuple(b.shape)} do "
            "not multiply")
    if a.device != b.device:
        raise ValueError("int8_matmul: operands on different devices")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    if a.stride(-1) != 1 and a.shape[-1] > 1:
        a = a.contiguous()
    if b.stride(-1) == 1 or b.shape[-1] == 1:
        b_kn = True
    elif b.stride(-2) == 1 or b.shape[-2] == 1:
        b_kn = False
    else:
        raise ValueError(
            "int8_matmul: b must have N or K contiguous (read in place); "
            f"strides {b.stride()}")
    return batch, a, b, b_kn


def int8_matmul_ref(a, b):
    """The exact int32 product in plain PyTorch, on any device: both
    operands upcast to int64 BEFORE the product (an int8 einsum would
    wrap in int8), the K axis summed in runs whose partial products
    hold at most ``REF_CHUNK`` elements, the sum cast to int32 (|C| <=
    127^2 K fits for K < 133,000). Used by the tests, the CPU paths and
    chip_smoke's comparison; by nothing on the card's main path."""
    a64, b64 = a.long(), b.long()
    k = a.shape[-1]
    rows = a.shape[-2] * b.shape[-1]
    for n in a.shape[:-2]:
        rows *= n
    step = max(1, REF_CHUNK // max(rows, 1))
    out = None
    for k0 in range(0, k, step):
        part = (a64[..., :, k0:k0 + step, None]
                * b64[..., None, k0:k0 + step, :]).sum(dim=-2)
        out = part if out is None else out + part
    if out is None:
        out = a64.new_zeros(a.shape[:-1] + b.shape[-1:])
    return out.to(torch.int32)


@functools.lru_cache(maxsize=1024)
def k_splits(batch: int, m: int, n: int, k: int) -> tuple:
    """(splits, K per split) from the shape alone: split K in halves
    while the grid holds fewer than ``TARGET_BLOCKS`` blocks and each
    split keeps at least ``MIN_K_STEPS`` steps of ``BLOCK_K``."""
    tiles = (-(-m // BLOCK_M)) * (-(-n // BLOCK_N)) * batch
    steps = -(-k // BLOCK_K)
    splits = 1
    while (tiles * splits < TARGET_BLOCKS
           and steps // (2 * splits) >= MIN_K_STEPS):
        splits *= 2
    per = -(-steps // splits) * BLOCK_K
    return -(-k // per), per


def _launch(batch, a, b, b_kn: bool):
    """One launch on checked CUDA operands; counts nothing. Returns the
    int32 product (*batch, M, N)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    b1, b2 = batch + (1,) * (2 - len(batch))
    a_s = tuple(a.stride()[:-2]) + (0,) * (2 - len(batch))
    b_s = tuple(b.stride()[:-2]) + (0,) * (2 - len(batch))
    splits, per = k_splits(b1 * b2, m, n, k)
    alloc = torch.zeros if splits > 1 else torch.empty
    c = alloc(batch + (m, n), dtype=torch.int32, device=a.device)
    ldb = b.stride(-2) if b_kn else b.stride(-1)
    index = a.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = _build.function("kts_int8_matmul", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), b1, b2, m, n, k,
        a_s[0], a_s[1], a.stride(-2), b_s[0], b_s[1], ldb, int(b_kn),
        splits, per, stream)
    _build.check("int8_matmul", err)
    return c


def int8_matmul(a, b):
    """a (*batch, M, K) int8 @ b (*batch, K, N) int8 -> int32 (*batch, M,
    N), exact. At most two batch dimensions, the same on both. b is read
    in place in either layout: N contiguous (a weight, (K, N)) or K
    contiguous (``embed.q.t()``, a cache permuted to (b, kv, hd, s)); a
    is made K-contiguous if it is not."""
    batch, a, b, b_kn = _operands(a, b)
    if a.device.type == "cpu":
        return int8_matmul_ref(a, b)
    out = _launch(batch, a, b, b_kn)
    int8_matmul.launches += 1
    int8_matmul.launches_by_route[DP4A] += 1
    return out


int8_matmul.launches = 0  # kernel launches (CPU calls not counted)
int8_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
