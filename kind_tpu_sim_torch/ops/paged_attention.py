"""Paged attention (decode): the CUDA kernels' wrapper and plain versions.

Two kernels replace the Pallas TPU kernel
``kind_tpu_sim/ops/pallas_kernels.py:paged_attention``, one a route:

* ``SPLIT_KV`` (``csrc/paged_attention_split.cu``): the sequence split
  across blocks over the block table, 16-byte asynchronous copies, and
  the splits combined in fixed split order by the last block of each
  (slot, kv head) to finish;
* ``ONE_PASS`` (``csrc/paged_attention.cu``): one block per (slot, kv
  head) walks the whole table; kept for fp32 and for what 16-byte
  copies cannot read.

``paged_attention`` dispatches on the tensors' device alone: CUDA
tensors launch the kernel of ``paged_route`` (or raise), CPU tensors
take ``paged_attention_ref``, the same block walk written in PyTorch.
It counts its launches in ``.launches`` and, per route, in
``.launches_by_route``. ``paged_attention_split_ref`` is the plain
version of the split-and-combine arithmetic, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from kind_tpu_sim_torch.ops import _build

SOURCE = "kind_tpu_sim_torch/csrc/paged_attention_split.cu"
ONE_PASS_SOURCE = "kind_tpu_sim_torch/csrc/paged_attention.cu"
# the pallas_call of paged_attention, the TPU kernel these replace
REPLACES = "kind_tpu_sim/ops/pallas_kernels.py:651"
NEG = -1e30
G_MAX, HD_MAX = 8, 256
SPLIT_KV, ONE_PASS = "split_kv", "one_pass"
ROUTES = (SPLIT_KV, ONE_PASS)
# the split kernel's shape of work (csrc/paged_attention_split.cu)
TILE, THREADS, SMEM_MAX, MAX_SPLITS = 64, 128, 232448, 512
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 7 + (ctypes.c_float, _P)
_SPLIT_ARGTYPES = (_P,) * 10 + (_I,) * 7 + (ctypes.c_float, _P)


def _check(qg, k_pool, v_pool, tables, lengths) -> torch.device:
    """Raise unless the inputs are ones the kernels take; returns their
    device."""
    q_shape, p_shape, t_shape = qg.shape, k_pool.shape, tables.shape
    if len(q_shape) != 4 or len(p_shape) != 4 or p_shape != v_pool.shape:
        raise ValueError(
            "paged_attention wants qg (slots,kv,g,hd) and pools "
            f"(num_blocks,bsz,kv,hd); got {tuple(q_shape)}, "
            f"{tuple(p_shape)}, {tuple(v_pool.shape)}")
    slots, kv, g, hd = q_shape
    if p_shape[2] != kv or p_shape[3] != hd:
        raise ValueError(
            f"paged_attention: pool {tuple(p_shape)} does not match "
            f"qg {tuple(q_shape)}")
    if len(t_shape) != 2 or t_shape[0] != slots or lengths.shape != (
            slots,):
        raise ValueError(
            f"paged_attention wants tables ({slots}, width) and lengths "
            f"({slots},); got {tuple(t_shape)}, {tuple(lengths.shape)}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: tables and lengths must be int32")
    dtype = qg.dtype
    if not (dtype == k_pool.dtype == v_pool.dtype) or (
            dtype not in _DTYPE_CODES):
        raise ValueError(
            "paged_attention wants qg and pools all bf16 or all fp32; got "
            f"{dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if g > G_MAX or hd > HD_MAX or 4 * g * (hd + p_shape[1]) > 48 * 1024:
        raise ValueError(
            f"paged_attention: group {g} (<= {G_MAX}), head dim {hd} "
            f"(<= {HD_MAX}) or block size {p_shape[1]} too large")
    dev = qg.device
    if not (k_pool.device == dev and v_pool.device == dev
            and tables.device == dev and lengths.device == dev):
        raise ValueError("paged_attention: inputs on different devices")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if not (qg.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous() and tables.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("paged_attention: inputs must be contiguous")
    return dev


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


def paged_attention_split_ref(qg, k_pool, v_pool, tables, lengths,
                              blocks_per_split: int):
    """The split kernel's arithmetic in plain PyTorch: the table cut
    into runs of ``blocks_per_split`` entries, each run's fp32 softmax
    partial (a run wholly past a slot's length is the empty partial
    m = -1e30, l = 0, acc = 0), then the runs combined in order:
    m = max m_s, l = sum l_s exp(m_s - m), acc = sum acc_s exp(m_s - m).
    Same outputs as ``paged_attention_ref``; the tests use it, no main
    path does."""
    slots, kv, g, hd = qg.shape
    bsz, width = k_pool.shape[1], tables.shape[1]
    scale = hd ** -0.5
    q = qg.float()
    parts = []
    for first in range(0, width, blocks_per_split):
        entries = tables[:, first:first + blocks_per_split].long()
        n = entries.shape[1] * bsz
        kb = k_pool[entries].float().reshape(slots, n, kv, hd)
        vb = v_pool[entries].float().reshape(slots, n, kv, hd)
        pos = first * bsz + torch.arange(n, device=qg.device)
        mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
        sc = torch.einsum("skgd,snkd->skgn", q, kb) * scale
        sc = torch.where(mask, sc, torch.full_like(sc, NEG))
        m_s = sc.amax(dim=-1)
        p = torch.exp(sc - m_s[..., None]) * mask
        parts.append((torch.einsum("skgn,snkd->skgd", p, vb), m_s,
                      p.sum(dim=-1)))
    m = torch.stack([m_s for _, m_s, _ in parts]).amax(dim=0)
    acc = torch.zeros((slots, kv, g, hd), device=qg.device)
    l = torch.zeros((slots, kv, g), device=qg.device)
    for acc_s, m_s, l_s in parts:
        w = torch.exp(m_s - m)
        acc = acc + acc_s * w[..., None]
        l = l + l_s * w
    return acc, m, l


def blocks_per_split(width: int, bsz: int) -> int:
    """Table entries each block of the split kernel covers, from
    host-known sizes alone (never from ``lengths``, which lives on the
    card): one tile of positions at least, the whole table in at most
    ``MAX_SPLITS`` splits. Larger splits (fewer, longer blocks) were no
    faster at any measured shape (PERF.md)."""
    return min(width, max(1, -(-TILE // bsz), -(-width // MAX_SPLITS)))


def split_layout(g: int, hd: int, stages: int, bps: int,
                 n_splits: int) -> tuple:
    """Byte offsets (q, scores, table entries, end) of a split-kernel
    block's dynamic shared memory, as the kernel's ``layout`` lays it
    out: the K/V tile ring, the row-group sums or the combine's m and l
    (whichever is largest), then q in fp32, a tile's scores, the
    split's table entries; each part on a 16-byte boundary."""
    chunks = hd // 8
    ring = stages * 2 * TILE * (chunks | 1) * 16
    sums = (THREADS // chunks) * g * hd * 4
    combine = _round16(n_splits * g * 2 * 4)
    q_off = max(ring, sums, combine)
    p_off = q_off + g * hd * 4
    tbl_off = p_off + TILE * G_MAX * 4
    return q_off, p_off, tbl_off, tbl_off + _round16(bps * 4)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _round4(n: int) -> int:
    return -(-n // 4) * 4  # floats to a 16-byte boundary


class _Plan(NamedTuple):
    route: str
    entry: str          # the C entry point
    argtypes: tuple
    floats: int         # one fp32 allocation: acc, m, l, the scratch
    acc_view: tuple     # as_strided arguments of acc, m, l
    m_view: tuple
    l_view: tuple
    m_byte: int         # byte offsets of m, l and the scratch
    l_byte: int
    scratch_byte: int
    tickets: int        # the split kernel's tickets (0: one split)
    tail: tuple         # the entry point's arguments after the pointers


@functools.lru_cache(maxsize=256)
def _plan(route, dtype, aligned: bool, shape, bsz: int, width: int,
          bps: int) -> _Plan:
    """Everything about one launch that the host knows before it, cached
    by shape: the route (``None``: ``paged_route``'s rule, from the
    dtype, the pools' 16-byte alignment ``aligned`` and the sizes),
    the split size (``bps``, 0: ``blocks_per_split``) and the one
    allocation that acc, m, l and the split scratch share, each part on
    a 16-byte boundary."""
    slots, kv, g, hd = shape
    if route is None:
        fits = hd % 8 == 0 and split_layout(
            g, hd, 2, width, min(width, MAX_SPLITS))[-1] <= SMEM_MAX
        route = (SPLIT_KV if dtype == torch.bfloat16 and aligned and fits
                 else ONE_PASS)
    n_ml = slots * kv * g
    o_m = _round4(n_ml * hd)
    o_l = o_m + _round4(n_ml)
    o_s = o_l + _round4(n_ml)
    views = (((slots, kv, g, hd), (kv * g * hd, g * hd, hd, 1), 0),
             ((slots, kv, g), (kv * g, g, 1), o_m),
             ((slots, kv, g), (kv * g, g, 1), o_l))
    if route == SPLIT_KV:
        bps = bps or blocks_per_split(width, bsz)
        n_splits = -(-width // bps)
        scratch = n_splits * n_ml * (hd + 2) if n_splits > 1 else 0
        return _Plan(route, "kts_paged_attention_split", _SPLIT_ARGTYPES,
                     o_s + scratch, *views, 4 * o_m, 4 * o_l, 4 * o_s,
                     slots * kv if n_splits > 1 else 0,
                     (slots, kv, g, hd, bsz, width, bps, hd ** -0.5))
    return _Plan(route, "kts_paged_attention", _ARGTYPES, o_s, *views,
                 4 * o_m, 4 * o_l, 4 * o_s, 0,
                 (_DTYPE_CODES[dtype], slots, kv, g, hd, bsz, width,
                  hd ** -0.5))


def paged_route(qg, k_pool, v_pool, tables, lengths) -> str:
    """The kernel a CUDA call of ``paged_attention`` launches, from the
    inputs alone: ``SPLIT_KV`` for bf16 whose pool rows and bases allow
    16-byte copies (head dim a multiple of 8, pools on 16-byte
    boundaries) and whose blocks fit in shared memory (counted for the
    widest split, the whole table); ``ONE_PASS`` for everything else,
    fp32 included. Inputs already passed ``_check``."""
    return _plan(None, qg.dtype,
                 (k_pool.data_ptr() | v_pool.data_ptr()) % 16 == 0,
                 qg.shape, k_pool.shape[1], tables.shape[1], 0).route


_TICKETS = {}  # (card, stream) -> the split kernel's int32 tickets


def _tickets(index: int, stream: int, n: int) -> int:
    """Address of ``n`` zeroed tickets, one per (slot, kv head), for the
    split kernel on ``stream``: the last block of each (slot, kv head)
    sets its ticket back to 0, so they stay zero between calls, and
    calls on one stream never overlap. Grown (zeroed on that stream)
    when a call needs more."""
    tickets = _TICKETS.get((index, stream))
    if tickets is None or tickets.numel() < n:
        tickets = torch.zeros(n, dtype=torch.int32, device=index)
        _TICKETS[(index, stream)] = tickets
    return tickets.data_ptr()


def _launch(plan: _Plan, qg, kp: int, vp: int, tables, lengths):
    """One launch of ``plan`` on checked CUDA inputs (``kp`` and ``vp``
    the pools' addresses); counts nothing. Returns fp32 (acc, m, l),
    views of one allocation."""
    index = qg.get_device()
    buf = torch.empty(plan.floats, dtype=torch.float32, device=qg.device)
    acc = buf.as_strided(*plan.acc_view)
    m = buf.as_strided(*plan.m_view)
    l = buf.as_strided(*plan.l_view)
    if qg.shape[0] == 0:
        return acc, m, l
    base = buf.data_ptr()
    # the raw handle of the current stream, without a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    fn = _build.function(plan.entry, plan.argtypes)
    if plan.route == SPLIT_KV:
        tickets = (_tickets(index, stream, plan.tickets) if plan.tickets
                   else 0)
        err = fn(qg.data_ptr(), kp, vp, tables.data_ptr(),
                 lengths.data_ptr(), base, base + plan.m_byte,
                 base + plan.l_byte, base + plan.scratch_byte, tickets,
                 *plan.tail, stream)
    else:
        err = fn(qg.data_ptr(), kp, vp, tables.data_ptr(),
                 lengths.data_ptr(), base, base + plan.m_byte,
                 base + plan.l_byte, *plan.tail, stream)
    _build.check("paged_attention", err)
    return acc, m, l


def _paged_launch(route: str, qg, k_pool, v_pool, tables, lengths,
                  bps: int = 0):
    """One launch of ``route``'s kernel on checked CUDA inputs; counts
    nothing (``paged_attention`` counts its own launches). The split
    route covers ``bps`` table entries a block (0:
    ``blocks_per_split``). Returns fp32 (acc, m, l)."""
    plan = _plan(route, qg.dtype, True, qg.shape, k_pool.shape[1],
                 tables.shape[1], bps)
    return _launch(plan, qg, k_pool.data_ptr(), v_pool.data_ptr(), tables,
                   lengths)


def paged_attention(qg, k_pool, v_pool, tables, lengths):
    """Softmax partials of one query token per slot over its paged KV
    prefix. qg (slots, kv, g, hd); pools (num_blocks, bsz, kv, hd);
    tables (slots, width) int32; lengths (slots,) int32 — slot s
    attends positions [0, lengths[s]). Returns fp32 (acc, m, l)."""
    if _check(qg, k_pool, v_pool, tables, lengths).type == "cpu":
        return paged_attention_ref(qg, k_pool, v_pool, tables, lengths)
    kp, vp = k_pool.data_ptr(), v_pool.data_ptr()
    plan = _plan(None, qg.dtype, (kp | vp) % 16 == 0, qg.shape,
                 k_pool.shape[1], tables.shape[1], 0)
    out = _launch(plan, qg, kp, vp, tables, lengths)
    paged_attention.launches += 1
    paged_attention.launches_by_route[plan.route] += 1
    return out


paged_attention.launches = 0  # kernel launches (CPU calls not counted)
paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
