"""The kernel-toolchain gate: matmul, rms_norm and softmax kernels.

Counterpart of ``kind_tpu_sim/ops/pallas_kernels.py``'s first three
Pallas TPU kernels (``matmul``, ``rms_norm``, ``softmax``) and of its
``toolchain_smoke``, the gate the pallas pod runs: the kernels build,
launch and agree with plain numerics. Each kernel is hand-written CUDA
C++ (``csrc/matmul.cu``, ``csrc/rms_norm.cu``, ``csrc/softmax.cu``).

Every wrapper dispatches on the tensors' device alone: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain version
(``matmul_ref``, ``rms_norm_ref``, ``softmax_ref``). Each wrapper counts
its launches in ``.launches`` and, per route, in ``.launches_by_route``.
Each has two kernels, one chosen from the inputs alone before the
launch (``matmul_route``, ``rms_norm_route``, ``softmax_route``):

* ``matmul``: bf16 on the tensor cores (wgmma fed by TMA) where TMA can
  read the operands, else the CUDA-core kernel;
* ``rms_norm``: ``VECTOR`` (16-byte loads, the row held in registers
  and read once) where 16-byte loads can read the rows and registers
  hold one, else ``SCALAR``, the first kernel;
* ``softmax``: ``ONE_READ`` (16-byte loads, the row held in registers,
  read once and written once) on the same terms, else ``TWO_PASS``,
  the first kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from kind_tpu_sim_torch.device import resolve
from kind_tpu_sim_torch.ops import _build
from kind_tpu_sim_torch.ops._build import CUDA_CORES, ROUTES, TENSOR_CORES

MATMUL_SOURCE = "kind_tpu_sim_torch/csrc/matmul.cu"
RMS_NORM_SOURCE = "kind_tpu_sim_torch/csrc/rms_norm.cu"
SOFTMAX_SOURCE = "kind_tpu_sim_torch/csrc/softmax.cu"
# the pallas_calls of the TPU kernels these replace
MATMUL_REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:65"
RMS_NORM_REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:98"
SOFTMAX_REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:122"
# the row kernels' routes: 16-byte loads, the row held on chip (new), or
# the first kernels (kept)
VECTOR, SCALAR = "vector", "scalar"
RMS_NORM_ROUTES = (VECTOR, SCALAR)
ONE_READ, TWO_PASS = "one_read", "two_pass"
SOFTMAX_ROUTES = (ONE_READ, TWO_PASS)
_MATMUL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_FLOAT_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_INT_MAX = 2**31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int


def _device_index(name: str, *tensors) -> int:
    """The index of the card the tensors lie on, -1 for the CPU; raises
    unless they all lie on one card or all on the CPU, contiguous. Reads
    ``get_device()``, the cheapest of a tensor's device attributes."""
    index = tensors[0].get_device()
    for x in tensors:
        if x.get_device() != index:
            raise ValueError(f"{name}: inputs on different devices")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if index < 0:
        for x in tensors:
            if not x.is_cpu:
                raise ValueError(f"{name}: unsupported device {x.device}")
    return index


def _launch(name: str, fn_name: str, argtypes: tuple, *args) -> None:
    _build.check(name, _build.function(fn_name, argtypes)(*args))


# ---------------------------------------------------------------------
# matmul


def _matmul_check(a, b, block_m: int, block_n: int, block_k: int) -> None:
    """The reference's contract: A (m, k) @ B (k, n) with each block
    ``min(block, dim)`` dividing its dim (``pallas_kernels.py:46-52``);
    both fp32 or both bf16."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul wants A (m, k) and B (k, n); got {tuple(a.shape)}, "
            f"{tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    blocks = (min(block_m, m), min(block_n, n), min(block_k, k))
    if 0 in blocks or m % blocks[0] or n % blocks[1] or k % blocks[2]:
        raise ValueError(
            f"matmul: (m, n, k) = {(m, n, k)} is not divisible by the "
            f"blocks {blocks} (min(block, dim) each)")
    if a.dtype != b.dtype or a.dtype not in _MATMUL_DTYPES:
        raise ValueError(
            f"matmul wants A and B both fp32 or both bf16; got {a.dtype}, "
            f"{b.dtype}")
    if max(m, n, k) > _INT_MAX:
        raise ValueError("matmul: a dimension does not fit in 32 bits")
    _device_index("matmul", a, b)


def matmul_ref(a, b):
    """The kernel's arithmetic in plain PyTorch: every product and sum
    in fp32, fp32 out."""
    return torch.matmul(a.float(), b.float())


def matmul_route(a, b) -> str:
    """The kernel a CUDA call of ``matmul`` launches, from the inputs
    alone: ``TENSOR_CORES`` for bf16 A (m, k) and B (k, n) whose row
    strides (k and n elements) and base addresses are multiples of 16
    bytes, which TMA needs; ``CUDA_CORES`` for everything else. fp32
    stays on the CUDA cores: TF32 keeps about three digits, and the
    gate holds the fp32 product to 2e-4. Both operands are contiguous
    (``_matmul_check``)."""
    k, n = a.shape[1], b.shape[1]
    if (a.dtype == torch.bfloat16 and (2 * k) % 16 == 0
            and (2 * n) % 16 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0):
        return TENSOR_CORES
    return CUDA_CORES


def _matmul_launch(a, b, route: str):
    """One launch of ``route``'s kernel on checked CUDA inputs; counts
    nothing (``matmul`` counts its own launches)."""
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if route == TENSOR_CORES:
        _launch("matmul", "kts_matmul_tc", (_P, _P, _P) + (_I,) * 3 + (_P,),
                a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, stream)
    else:
        _launch("matmul", "kts_matmul", (_P, _P, _P) + (_I,) * 4 + (_P,),
                a.data_ptr(), b.data_ptr(), c.data_ptr(),
                _MATMUL_DTYPES[a.dtype], m, n, k, stream)
    return c


def matmul(a, b, block_m: int = 128, block_n: int = 128, block_k: int = 128):
    """C = A @ B, fp32 out with fp32 accumulation. ``block_*`` keep the
    reference's tiling contract (shapes they do not divide are refused
    with ``ValueError``); they are not the CUDA kernels' tiles."""
    _matmul_check(a, b, block_m, block_n, block_k)
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    route = matmul_route(a, b)
    c = _matmul_launch(a, b, route)
    matmul.launches += 1
    matmul.launches_by_route[route] += 1
    return c


matmul.launches = 0  # kernel launches (CPU calls not counted)
matmul.launches_by_route = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------------
# rms_norm and softmax: one row at a time, two routes each


class _RowPlan(NamedTuple):
    route: str
    entry: str      # the C entry point
    codes: tuple    # dtype codes: x's (and the weight's, for rms_norm)


# rms_norm's vector kernel holds a row in at most 1024 threads x 8
# chunks of 16 bytes (csrc/rms_norm.cu)
RMS_NORM_ROW_BYTES = 1024 * 8 * 16
_RMS_NORM_ENTRIES = {VECTOR: "kts_rms_norm_vec", SCALAR: "kts_rms_norm"}
_RMS_NORM_ARGTYPES = (_P, _P, _P) + (_I,) * 4 + (ctypes.c_float, _P)


def _rms_norm_check(x, weight) -> int:
    """Raise unless the inputs are ones the kernels take; returns their
    card's index, -1 for the CPU."""
    shape = x.shape
    if (len(shape) != 2 or weight.ndim != 1
            or weight.shape[0] != shape[1]):
        raise ValueError(
            f"rms_norm wants x (rows, d) and weight (d,); got "
            f"{tuple(shape)}, {tuple(weight.shape)}")
    if x.dtype not in _FLOAT_DTYPES or weight.dtype not in _FLOAT_DTYPES:
        raise ValueError(
            f"rms_norm wants bf16, fp16 or fp32 tensors; got {x.dtype}, "
            f"{weight.dtype}")
    if shape[0] > _INT_MAX or shape[1] > _INT_MAX:
        raise ValueError("rms_norm: a dimension does not fit in 32 bits")
    return _device_index("rms_norm", x, weight)


def rms_norm_ref(x, weight, eps: float = 1e-6):
    """The kernel's arithmetic in plain PyTorch:
    ``x * rsqrt(mean(x^2) + eps) * w`` in fp32, cast to x's dtype."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=256)
def _rms_norm_plan(route, dtype, w_dtype, d: int, aligned: bool) -> _RowPlan:
    """Everything about a launch that the host knows before it, cached
    by dtypes, row length and alignment. ``route`` None:
    ``rms_norm_route``'s rule."""
    if route is None:
        row_bytes = d * dtype.itemsize
        route = (VECTOR if aligned and row_bytes % 16 == 0
                 and 0 < row_bytes <= RMS_NORM_ROW_BYTES else SCALAR)
    return _RowPlan(route, _RMS_NORM_ENTRIES[route],
                    (_FLOAT_DTYPES[dtype], _FLOAT_DTYPES[w_dtype]))


def rms_norm_route(x, weight) -> str:
    """The kernel a CUDA call of ``rms_norm`` launches, from the inputs
    alone: ``VECTOR`` where 16-byte loads can read the rows (x and the
    weight on 16-byte boundaries, a row a whole number of 16-byte
    chunks) and registers hold one (at most ``RMS_NORM_ROW_BYTES``:
    bf16 d <= 65536, fp32 d <= 32768); ``SCALAR`` for everything
    else. Inputs already passed ``_rms_norm_check``."""
    return _rms_norm_plan(None, x.dtype, weight.dtype, x.shape[1],
                          (x.data_ptr() | weight.data_ptr()) % 16 == 0).route


def _rms_norm_run(plan: _RowPlan, x, xp: int, wp: int, eps: float,
                  index: int):
    """One launch of ``plan`` on checked CUDA inputs (``xp`` and ``wp``
    the addresses of x and the weight, on card ``index``); counts
    nothing."""
    out = torch.empty_like(x)
    rows, d = x.shape
    _build.check("rms_norm", _build.function(
        plan.entry, _RMS_NORM_ARGTYPES)(
            xp, wp, out.data_ptr(), *plan.codes, rows, d, eps,
            torch._C._cuda_getCurrentRawStream(index)))
    return out


def _rms_norm_launch(x, weight, route: str, eps: float = 1e-6):
    """One launch of ``route``'s kernel on checked, non-empty CUDA
    inputs; counts nothing (``rms_norm`` counts its own launches)."""
    plan = _rms_norm_plan(route, x.dtype, weight.dtype, x.shape[1], True)
    return _rms_norm_run(plan, x, x.data_ptr(), weight.data_ptr(), eps,
                         x.get_device())


def rms_norm(x, weight, eps: float = 1e-6):
    """Row-wise RMSNorm of x (rows, d) with weight (d,); fp32 inside,
    x's dtype out."""
    index = _rms_norm_check(x, weight)
    if index < 0:
        return rms_norm_ref(x, weight, eps)
    if x.numel() == 0:
        return torch.empty_like(x)
    xp, wp = x.data_ptr(), weight.data_ptr()
    plan = _rms_norm_plan(None, x.dtype, weight.dtype, x.shape[1],
                          (xp | wp) % 16 == 0)
    out = _rms_norm_run(plan, x, xp, wp, eps, index)
    rms_norm.launches += 1
    rms_norm.launches_by_route[plan.route] += 1
    return out


rms_norm.launches = 0  # kernel launches (CPU calls not counted)
rms_norm.launches_by_route = dict.fromkeys(RMS_NORM_ROUTES, 0)


# softmax's one_read kernel holds a row in at most 1024 threads x 32
# fp32 values (csrc/softmax.cu)
SOFTMAX_ROW_MAX = 1024 * 32
_SOFTMAX_ENTRIES = {ONE_READ: "kts_softmax_one_read", TWO_PASS: "kts_softmax"}
_SOFTMAX_ARGTYPES = (_P, _P) + (_I,) * 3 + (_P,)


def _softmax_check(x) -> int:
    """Raise unless x is one the kernels take; returns its card's
    index, -1 for the CPU."""
    if x.ndim < 1:
        raise ValueError("softmax wants at least one axis")
    if x.dtype not in _FLOAT_DTYPES:
        raise ValueError(f"softmax wants bf16, fp16 or fp32; got {x.dtype}")
    if x.shape[-1] > _INT_MAX or x.numel() // max(x.shape[-1], 1) > _INT_MAX:
        raise ValueError("softmax: rows or row length do not fit in 32 bits")
    return _device_index("softmax", x)


def softmax_ref(x):
    """The kernel's arithmetic in plain PyTorch: over the last axis in
    fp32, subtract the row max, exp, divide by the sum; x's dtype out."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


@functools.lru_cache(maxsize=256)
def _softmax_plan(route, dtype, n: int, aligned: bool) -> _RowPlan:
    """Everything about a launch that the host knows before it, cached
    by dtype, row length and alignment. ``route`` None:
    ``softmax_route``'s rule."""
    if route is None:
        route = (ONE_READ if aligned and (n * dtype.itemsize) % 16 == 0
                 and 0 < n <= SOFTMAX_ROW_MAX else TWO_PASS)
    return _RowPlan(route, _SOFTMAX_ENTRIES[route], (_FLOAT_DTYPES[dtype],))


def softmax_route(x) -> str:
    """The kernel a CUDA call of ``softmax`` launches, from the input
    alone: ``ONE_READ`` where 16-byte loads can read the rows (x on a
    16-byte boundary, a row a whole number of 16-byte chunks) and
    registers hold one (at most ``SOFTMAX_ROW_MAX`` values);
    ``TWO_PASS`` for everything else. x already passed
    ``_softmax_check``."""
    return _softmax_plan(None, x.dtype, x.shape[-1],
                         x.data_ptr() % 16 == 0).route


def _softmax_run(plan: _RowPlan, x, xp: int, numel: int, index: int):
    """One launch of ``plan`` on a checked CUDA input (``xp`` its
    address, ``numel`` its elements, on card ``index``); counts
    nothing."""
    out = torch.empty_like(x)
    n = x.shape[-1]
    _build.check("softmax", _build.function(plan.entry, _SOFTMAX_ARGTYPES)(
        xp, out.data_ptr(), *plan.codes, numel // n, n,
        torch._C._cuda_getCurrentRawStream(index)))
    return out


def _softmax_launch(x, route: str):
    """One launch of ``route``'s kernel on a checked, non-empty CUDA
    input; counts nothing (``softmax`` counts its own launches)."""
    return _softmax_run(_softmax_plan(route, x.dtype, x.shape[-1], True), x,
                        x.data_ptr(), x.numel(), x.get_device())


def softmax(x):
    """Row-stable softmax over the last axis of x (any rank)."""
    index = _softmax_check(x)
    if index < 0:
        return softmax_ref(x)
    numel = x.numel()
    if numel == 0:
        return torch.empty_like(x)
    xp = x.data_ptr()
    plan = _softmax_plan(None, x.dtype, x.shape[-1], xp % 16 == 0)
    out = _softmax_run(plan, x, xp, numel, index)
    softmax.launches += 1
    softmax.launches_by_route[plan.route] += 1
    return out


softmax.launches = 0  # kernel launches (CPU calls not counted)
softmax.launches_by_route = dict.fromkeys(SOFTMAX_ROUTES, 0)


# ---------------------------------------------------------------------
# the gate


def toolchain_smoke(device="cuda") -> dict:
    """The pallas-pod gate (``pallas_kernels.py:toolchain_smoke``): each
    kernel runs once at the reference's shapes and is checked at its
    tolerances -- a 256 x 256 fp32 matmul against numpy at atol 2e-4, a
    (64, 128) fp32 rms_norm with unit weight against numpy at 1e-5, its
    softmax against ``torch.softmax`` at 1e-6. Inputs come from
    ``np.random.RandomState`` seeds 0, 1 and 2 (``jax.random``'s draws
    cannot be reproduced). On the card the kernels run (``interpret``
    False); on the CPU the plain versions do."""
    dev = resolve(device)
    a = np.random.RandomState(0).standard_normal((256, 256)).astype(np.float32)
    b = np.random.RandomState(1).standard_normal((256, 256)).astype(np.float32)
    x = np.random.RandomState(2).standard_normal((64, 128)).astype(np.float32)

    def on_dev(arr):
        return torch.from_numpy(arr).to(dev)

    c = matmul(on_dev(a), on_dev(b)).cpu().numpy()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    matmul_ok = bool(np.allclose(c, ref, atol=2e-4))

    xt = on_dev(x)
    normed = rms_norm(xt, torch.ones(128, device=dev)).cpu().numpy()
    var = np.mean(np.square(x), axis=-1, keepdims=True)
    norm_ok = bool(np.allclose(normed, x / np.sqrt(var + 1e-6), atol=1e-5))

    sm = softmax(xt).cpu().numpy()
    sm_ref = torch.softmax(xt, dim=-1).cpu().numpy()
    sm_ok = bool(np.allclose(sm, sm_ref, atol=1e-6))

    return {
        "backend": dev.type,
        "interpret": dev.type == "cpu",
        "matmul_ok": matmul_ok,
        "rms_norm_ok": norm_ok,
        "softmax_ok": sm_ok,
        "ok": matmul_ok and norm_ok and sm_ok,
    }
