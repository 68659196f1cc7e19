"""Exact int8 x int8 -> int32 batched products: the CUDA kernels' wrapper
and plain version.

The JAX package runs its W8A8 contractions (``quant.linear`` and
``quant.readout`` with ``native=True``, and the int8 KV cache's scores
and values in ``decode._cache_scores`` / ``_cache_values``) as XLA
``dot_general``s with ``preferred_element_type=int32``, not as a Pallas
kernel. PyTorch has no batched int8 product on CUDA, and a float GEMM of
int8 values stops being exact once partial sums pass 2^24 (K > ~1040;
the flagship's contractions run over 2048-8192), so the port adds its
own kernels, three routes chosen by ``int8_route`` from the inputs
alone, before the launch:

* ``WGMMA`` (``csrc/int8_matmul_tc.cu``): the tensor cores (wgmma
  m64n256k32 s8, fed by TMA) for more than ``GEMV_MAX_M`` rows of A:
  prefill, admission waves, chunked prefill. Bound by operations. It
  reads B K-major only (the 8-bit wgmma forms have no transpose), so
  the port keeps its W8A8 weights K-major (``quant.quantize_params``).
* ``GEMV`` (``csrc/int8_gemv.cu``): up to ``GEMV_MAX_M`` rows, as a
  decode step or a verify window has them. Bound by bytes: every byte
  of B read once in 16-byte loads, A held on chip, K reduced inside the
  block, C written once (one launch a call). B in either layout.
* ``DP4A`` (``csrc/int8_matmul.cu``, the first kernel): everything the
  other two do not take: K not a multiple of 16, bases or strides off
  16-byte boundaries, a "kn" B with more than ``GEMV_MAX_M`` rows of A.

``int8_matmul(a, b)`` dispatches on the tensors' device alone: CUDA
tensors launch a kernel (or raise), CPU tensors take ``int8_matmul_ref``.
It counts its launches in ``.launches`` and per route in
``.launches_by_route``; ``_launch(route, a, b)`` launches one route
uncounted (for timing the routes in turns).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from kind_tpu_sim_torch.ops import _build

SOURCE = "kind_tpu_sim_torch/csrc/int8_matmul.cu"
DP4A, GEMV, WGMMA = "dp4a", "gemv", "wgmma"
ROUTES = (DP4A, GEMV, WGMMA)
SOURCES = {DP4A: SOURCE, GEMV: "kind_tpu_sim_torch/csrc/int8_gemv.cu",
           WGMMA: "kind_tpu_sim_torch/csrc/int8_matmul_tc.cu"}
# no TPU kernel: the XLA int8 dot_generals of the W8A8 path (linear; the
# readout at :153, the int8 cache at decode.py:143 and :176)
REPLACES = "kind_tpu_sim/models/quant.py:118"
BLOCK_M = BLOCK_N = BLOCK_K = 64   # the dp4a kernel's tile
# dp4a: split K until the grid holds this many blocks (2 per SM of an
# H100), keeping at least MIN_K_STEPS steps of BLOCK_K a split
TARGET_BLOCKS, MIN_K_STEPS = 264, 4
# gemv: the most rows of A it takes (a verify window's 8 slots x 5)
GEMV_MAX_M = 40
# gemv "nk": (rows of A held, columns a lane holds), the first that holds
# M rows is taken (csrc/int8_gemv.cu instantiates these)
GEMV_ROWS = ((8, 2), (16, 2), (24, 2), (40, 2))
GEMV_WARPS = 8           # a block of 256 threads
GEMV_BLOCKS = 128        # about one block per SM: below it, split K
GEMV_SLAB = 64 << 10     # bytes of A in shared memory at once
KN_ROWS, KN_COLS = 4, 16  # gemv "kn": rows a pass, columns a thread
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STRIDES = (_L,) * 6
_ARGTYPES = {
    DP4A: (_P, _P, _P) + (_I,) * 5 + _STRIDES + (_I,) * 3 + (_P,),
    GEMV: (_P, _P, _P) + (_I,) * 5 + _STRIDES + (_I,) * 7 + (_P,),
    WGMMA: (_P, _P, _P) + (_I,) * 5 + _STRIDES + (_P,)}
_ENTRIES = {DP4A: "kts_int8_matmul", GEMV: "kts_int8_gemv",
            WGMMA: "kts_int8_matmul_tc"}
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
    """dp4a: (splits, K per split) from the shape alone: split K in
    halves while the grid holds fewer than ``TARGET_BLOCKS`` blocks and
    each split keeps at least ``MIN_K_STEPS`` steps of ``BLOCK_K``."""
    tiles = (-(-m // BLOCK_M)) * (-(-n // BLOCK_N)) * batch
    steps = -(-k // BLOCK_K)
    splits = 1
    while (tiles * splits < TARGET_BLOCKS
           and steps // (2 * splits) >= MIN_K_STEPS):
        splits *= 2
    per = -(-steps // splits) * BLOCK_K
    return -(-k // per), per


@functools.lru_cache(maxsize=1024)
def gemv_plan(batch: int, m: int, n: int, k: int, b_kn: bool) -> tuple:
    """gemv: (rows held, lanes, warps along K, slab, column tiles,
    shared bytes) from the shape alone (csrc/int8_gemv.cu's
    ``kts_int8_gemv``). "nk": the first of ``GEMV_ROWS`` that holds M
    rows; ``lanes`` of a warp along K (32, 16 where K is under 512, and
    under 256 one: a lane holds its columns' whole K run), the rest on
    columns; K split among the block's warps in
    halves while the tiles number fewer than ``GEMV_BLOCKS`` and each
    warp keeps two steps. "kn": 4 rows a pass, ``lanes`` threads along N
    (16 columns each, a power of 2 up to 16), the block's other threads
    along K, a block for all of K. A's rows are staged in slabs of at
    most ``GEMV_SLAB`` bytes."""
    if b_kn:
        lanes = 1
        while lanes < 16 and lanes * KN_COLS < n:
            lanes *= 2
        tiles = -(-n // (KN_COLS * lanes))
        slab = min(k, GEMV_SLAB // KN_ROWS)
        return (KN_ROWS, lanes, 1, slab, tiles,
                KN_ROWS * KN_COLS * lanes * 4 + KN_ROWS * slab)
    mt, cw = next(rc for rc in GEMV_ROWS if m <= rc[0])
    lanes = 32 if k >= 512 else 16 if k >= 256 else 1

    def cols(warps_k):
        return GEMV_WARPS // warps_k * (32 // lanes) * cw

    warps_k = 1
    while (warps_k < GEMV_WARPS
           and -(-n // cols(warps_k)) * batch < GEMV_BLOCKS
           and k >= 2 * warps_k * lanes * 16
           and m * 2 * warps_k * lanes * 16 <= GEMV_SLAB):
        warps_k *= 2
    step = warps_k * lanes * 16
    slab = k if m * k <= GEMV_SLAB else GEMV_SLAB // (m * step) * step
    red = -(-mt * cols(warps_k) * 4 // 16) * 16
    return (mt, lanes, warps_k, slab, -(-n // cols(warps_k)), red + m * slab)


class _Plan(NamedTuple):
    route: str
    takes: tuple    # every route that takes these inputs


def _aligned(t, contiguous_axis: int) -> bool:
    """16-byte base and, on every axis longer than 1 but the contiguous
    one, a stride that is a multiple of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        s % 16 == 0 for i, (n, s) in enumerate(zip(t.shape, t.stride()))
        if n > 1 and i != contiguous_axis % t.dim())


@functools.lru_cache(maxsize=1024)
def _plan(m: int, n: int, k: int, b_kn: bool, aligned: bool,
          batch: int) -> _Plan:
    """The routes that take a product of this shape and layout, and the
    one ``int8_matmul`` launches: ``GEMV`` for at most ``GEMV_MAX_M``
    rows, then ``WGMMA``, then ``DP4A``, which takes everything. Both new
    routes need 16-byte-aligned bases and strides (``aligned``) and K a
    multiple of 16; gemv "kn" N a multiple of 16; wgmma B K-major."""
    takes = [DP4A]
    fits = aligned and k % 16 == 0 and batch <= 65535
    if fits and m <= GEMV_MAX_M and (not b_kn or n % 16 == 0):
        takes.append(GEMV)
    if fits and not b_kn:
        takes.append(WGMMA)
    route = (GEMV if GEMV in takes else WGMMA if WGMMA in takes else DP4A)
    return _Plan(route, tuple(takes))


def _plan_of(batch, a, b, b_kn) -> _Plan:
    n_batch = 1
    for x in batch:
        n_batch *= x
    aligned = _aligned(a, -1) and _aligned(b, -1 if b_kn else -2)
    return _plan(a.shape[-2], b.shape[-1], a.shape[-1], b_kn, aligned,
                 n_batch)


def int8_route(a, b) -> str:
    """The kernel a CUDA call of ``int8_matmul(a, b)`` launches, from the
    inputs alone: M, the layout of b, K and N, the 16-byte alignment of
    the bases and strides, the batch size (``_plan``)."""
    return _plan_of(*_operands(a, b)).route


def int8_routes(a, b) -> tuple:
    """Every route that takes ``int8_matmul(a, b)``, ``DP4A`` first."""
    return _plan_of(*_operands(a, b)).takes


def _strides(t, batch: tuple, ld_axis: int) -> tuple:
    """(batch stride 1, batch stride 2, leading stride) in elements. The
    stride of an axis of size 1 is never followed; the leading one is
    then given as the contiguous axis' length rounded up to 16, a stride
    TMA takes."""
    inner = t.shape[-1 if ld_axis == -2 else -2]
    ld = (t.stride(ld_axis) if t.shape[ld_axis] > 1
          else -(-inner // 16) * 16)
    s = [t.stride(i) for i in range(len(batch))] + [0] * (2 - len(batch))
    return s[0], s[1], ld


def _launch(route: str, a, b):
    """One launch of ``route``'s kernel on CUDA operands; counts nothing
    (``int8_matmul`` counts its own launches). Raises if the route does
    not take them. Returns the int32 product (*batch, M, N)."""
    batch, a, b, b_kn = _operands(a, b)
    if route not in _plan_of(batch, a, b, b_kn).takes:
        raise ValueError(f"int8_matmul: route {route} does not take "
                         f"{tuple(a.shape)} x {tuple(b.shape)} (strides "
                         f"{a.stride()}, {b.stride()})")
    return _run(route, batch, a, b, b_kn)


def _run(route: str, batch, a, b, b_kn: bool):
    m, k = a.shape[-2:]
    n = b.shape[-1]
    b1, b2 = batch + (1,) * (2 - len(batch))
    a_st = _strides(a, batch, -2)
    b_st = _strides(b, batch, -2 if b_kn else -1)
    if route == DP4A:
        splits, per = k_splits(b1 * b2, m, n, k)
        alloc = torch.zeros if splits > 1 else torch.empty
        extra = (int(b_kn), splits, per)
    else:
        alloc = torch.empty
        extra = ((int(b_kn),) + gemv_plan(b1 * b2, m, n, k, b_kn)
                 if route == GEMV else ())
    c = alloc(batch + (m, n), dtype=torch.int32, device=a.device)
    stream = torch._C._cuda_getCurrentRawStream(a.get_device())
    err = _build.function(_ENTRIES[route], _ARGTYPES[route])(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), b1, b2, m, n, k, *a_st,
        *b_st, *extra, stream)
    _build.check(f"int8_matmul ({route})", err)
    return c


def int8_matmul(a, b):
    """a (*batch, M, K) int8 @ b (*batch, K, N) int8 -> int32 (*batch, M,
    N), exact. At most two batch dimensions, the same on both. b is read
    in place in either layout: K contiguous (the K-major W8A8 weights,
    ``embed.q.t()``, a key cache permuted to (b, kv, hd, s)) or N
    contiguous (a value cache permuted to (b, kv, s, hd)); a is made
    K-contiguous if it is not. The route: ``int8_route``."""
    batch, a, b, b_kn = _operands(a, b)
    if a.device.type == "cpu":
        return int8_matmul_ref(a, b)
    route = _plan_of(batch, a, b, b_kn).route
    out = _run(route, batch, a, b, b_kn)
    int8_matmul.launches += 1
    int8_matmul.launches_by_route[route] += 1
    return out


int8_matmul.launches = 0  # kernel launches (CPU calls not counted)
int8_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
