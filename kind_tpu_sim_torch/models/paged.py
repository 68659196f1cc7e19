"""Paged KV cache for the serving engine, in PyTorch.

Counterpart of ``kind_tpu_sim/models/paged.py`` (the vLLM PagedAttention
memory model). KV lives in per-layer pools of fixed-size blocks
``(num_blocks, block_size, kv_heads, head_dim)``; each slot holds a
block list, mapped by a ``(max_slots, width)`` int32 block table.
Block 0 is a reserved garbage sink: every masked write (inactive slot,
padding position) is aimed there, so scatters stay dense and
branch-free, and its contents are never read as live KV.

Two decode tiers over the same pools:

* **gather** (``paged_decode_chunk``): once per chunk, gather each
  slot's blocks into a dense (slots, width*block_size) view, run the
  shared chunk scan against it, scatter the chunk's new k/v back.
* **kernel** (``paged_decode_chunk_kernel``): the big-cache attention
  runs on the CUDA paged-attention kernel (ops/paged_attention.py),
  which reads pool blocks directly through the table; its fp32
  partials are merged with the chunk-buffer and in-flight groups by
  the flash combine.

Pool writes are in place (the JAX package donates the pools). Block
allocation is host-side bookkeeping at scheduling boundaries
(``BlockAllocator``); pool exhaustion triggers recompute preemption in
``serving.PagedServingEngine``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from kind_tpu_sim_torch.models.decode import (
    NEG,
    _attend_token,
    _cache_scores,
    _finish_block,
    init_cache,
)
from kind_tpu_sim_torch.models.quant import embed_lookup
from kind_tpu_sim_torch.models.transformer import (
    ModelConfig,
    _block_core,
    _readout,
    _rms_norm,
)
from kind_tpu_sim_torch.device import torch_dtype

GARBAGE_BLOCK = 0


def init_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
               device="cuda"):
    """Per-layer block pools: a decode cache with num_blocks as batch."""
    return init_cache(cfg, num_blocks, block_size, device=device)


def gather_view(pools, tables):
    """Each slot's blocks as a dense (slots, width*B, kv, hd) view, one
    dict per layer. Padding entries gather whatever block they name;
    the scan masks them by length."""
    slots, width = tables.shape
    flat = tables.reshape(-1).long()

    def view(arr):
        return arr[flat].reshape((slots, width * arr.shape[1])
                                 + tuple(arr.shape[2:]))

    return [{"k": view(lc["k"]), "v": view(lc["v"])} for lc in pools]


def _scatter_flat(pool_arr, blocks, offsets, rows) -> None:
    """pool[blocks[i], offsets[i]] = rows[i] for every flat row i, in
    place. Duplicate targets occur only in the garbage block."""
    pool_arr[blocks.long(), offsets.long()] = rows.to(pool_arr.dtype)


def _window_indices(length: int, base: int, block_size: int, width: int,
                    true_len: int, table_row):
    """Flat (blocks, offsets) for writing ``length`` window positions
    from ``base``: positions past ``true_len`` or past the table's
    width go to the garbage block."""
    idx = torch.arange(length, device=table_row.device)
    pos = base + idx
    logical = pos // block_size
    blocks = table_row[torch.clamp(logical, 0, width - 1)]
    valid = (idx < true_len) & (logical < width)
    return (torch.where(valid, blocks, torch.full_like(blocks,
                                                       GARBAGE_BLOCK)),
            pos % block_size)


def _write_layer(lc, kk, vv, write) -> None:
    """One layer's k/v update through ``write(pool_arr, upd)``."""
    write(lc["k"], kk)
    write(lc["v"], vv)


def _last_logits(x, params, true_len: int):
    """fp32 logits (vocab,) at the window's TRUE last position."""
    h = _rms_norm(x[:, true_len - 1, :], params["final_norm"])
    return _readout(h, params["embed"])[0].float()


def scatter_rows(pools, tables, starts, rows_per_layer, active) -> None:
    """Write each slot's chunk-buffer rows (slots, chunk, kv, hd) into
    its pool blocks at positions starts[b]..starts[b]+chunk-1, in
    place. Inactive slots write to the garbage block."""
    slots, width = tables.shape
    chunk = rows_per_layer[0]["k"].shape[1]
    block_size = pools[0]["k"].shape[1]
    pos = (starts.long()[:, None]
           + torch.arange(chunk, device=tables.device)[None, :])
    logical = pos // block_size
    offsets = (pos % block_size).reshape(-1)
    # a logical index past the table only occurs for a slot on its
    # final round (it retires this round); its writes go to garbage
    blocks = tables.long().gather(1, torch.clamp(logical, 0, width - 1))
    valid = active[:, None] & (logical < width)
    blocks = torch.where(valid, blocks, torch.full_like(
        blocks, GARBAGE_BLOCK)).reshape(-1)

    def write(pool_arr, upd):
        _scatter_flat(pool_arr, blocks, offsets,
                      upd.reshape((slots * chunk,) + tuple(upd.shape[2:])))

    for lc, rows in zip(pools, rows_per_layer):
        _write_layer(lc, rows["k"], rows["v"], write)


def paged_prefill(params, pools, tokens, true_len: int, table_row, *,
                  cfg: ModelConfig):
    """Run a prompt (1, t_pad) through the forward, scattering k/v for
    positions < true_len into the slot's pool blocks (table_row:
    (width,) int32), in place. Returns the fp32 logits at the true
    last position."""
    t_p = tokens.shape[1]
    positions = torch.arange(t_p, device=tokens.device)[None, :]
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    blocks, offsets = _window_indices(
        t_p, 0, pools[0]["k"].shape[1], table_row.shape[0], true_len,
        table_row)

    def write(pool_arr, upd):
        _scatter_flat(pool_arr, blocks, offsets, upd[0])

    for bparams, lc in zip(params["blocks"], pools):
        x, _, k, v = _block_core(x, bparams, cfg, positions)
        _write_layer(lc, k, v, write)
    return _last_logits(x, params, true_len)


def paged_decode_chunk(params, pools, tables, lengths, last_token, active,
                       sampling_state, presence, *, cfg: ModelConfig,
                       chunk: int):
    """One scheduling quantum on the gather tier: gather the block view
    once, run the shared chunk scan, scatter the chunk buffer back.
    Returns (last_token, emitted, presence, logprobs)."""
    from kind_tpu_sim_torch.models.serving import _chunk_scan

    view = gather_view(pools, tables)
    token, small, emitted, presence, lps = _chunk_scan(
        params, view, lengths, last_token, active, sampling_state,
        presence, cfg=cfg, chunk=chunk)
    scatter_rows(pools, tables, lengths, small, active)
    return token, emitted, presence, lps


def _block_decode_kernel(x, bparams, cfg: ModelConfig, pool_lc, tables,
                         small_lc, lengths, i):
    """One decode-chunk block whose big-cache attention is the paged
    kernel: the pool is read directly through the block table. The
    kernel's fp32 partials (acc, m, l) over the paged prefix are merged
    with the chunk-buffer and in-flight groups by the flash combine —
    the same softmax as the gather tier's one concatenated softmax,
    summed in another order."""
    from kind_tpu_sim_torch.ops.paged_attention import paged_attention

    b = x.shape[0]
    positions = (lengths + i)[:, None]
    qg, k1, v1 = _attend_token(x, bparams, cfg, positions)
    scale = cfg.head_dim ** -0.5

    acc_b, m_b, l_b = paged_attention(qg, pool_lc["k"], pool_lc["v"],
                                      tables, lengths)

    c_len = small_lc["k"].shape[1]
    sm_mask = torch.arange(c_len, device=x.device) < i
    sc_sm = _cache_scores(qg, small_lc["k"], scale).masked_fill(
        ~sm_mask[None, None, None, :], NEG)
    rest = torch.cat([sc_sm, _cache_scores(qg, k1, scale)], -1)
    v_cat = torch.cat([small_lc["v"], v1], 1)           # (b, c+1, kv, hd)

    # the in-flight token is always live, so m_tot is finite and the
    # denominator positive even for an empty paged prefix
    m_tot = torch.maximum(m_b, rest.amax(dim=-1))
    p_rest = torch.exp(rest - m_tot[..., None])
    attn_rest = torch.einsum("bkgs,bskd->bkgd", p_rest, v_cat.float())
    corr = torch.exp(m_b - m_tot)
    l_tot = l_b * corr + p_rest.sum(dim=-1)
    attn = ((acc_b * corr[..., None] + attn_rest) / l_tot[..., None]).to(
        torch_dtype(cfg.dtype)).reshape(b, cfg.d_model)

    small_lc["k"][:, i] = k1[:, 0]
    small_lc["v"][:, i] = v1[:, 0]
    return _finish_block(x, attn, bparams, cfg), small_lc


def paged_decode_chunk_kernel(params, pools, tables, lengths, last_token,
                              active, sampling_state, presence, *,
                              cfg: ModelConfig, chunk: int):
    """paged_decode_chunk's kernel tier: same scheduling quantum, with
    the big-cache attention reading pool blocks directly through the
    table — no per-chunk gather, no transient view. ``tables`` and
    ``lengths`` are int32 device tensors. Returns (last_token, emitted,
    presence, logprobs)."""
    from kind_tpu_sim_torch.models.serving import _chunk_scan

    def block_fn(x, bparams, pool_lc, small_lc, i):
        return _block_decode_kernel(x, bparams, cfg, pool_lc, tables,
                                    small_lc, lengths, i)

    token, small, emitted, presence, lps = _chunk_scan(
        params, pools, lengths, last_token, active, sampling_state,
        presence, cfg=cfg, chunk=chunk, block_fn=block_fn)
    scatter_rows(pools, tables, lengths, small, active)
    return token, emitted, presence, lps


# ---------------------------------------------------------------------
# host-side block allocator


class BlockAllocator:
    """Refcounted free-list allocator over pool blocks 1..num_blocks-1
    (block 0 is the garbage sink and never allocated). ``free``
    decrements and returns a block to the pool at zero references."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (one is garbage)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: dict = {}
        self.peak_in_use = 0  # highest simultaneous allocation

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks (ref 1 each), or None (all-or-nothing)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def share(self, blocks: List[int]) -> None:
        """Add a reference to already-allocated blocks."""
        for b in blocks:
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"share of unallocated block {b}")
            self._refs[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference; blocks return to the pool at ref 0."""
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            refs = self._refs.get(b, 0)
            if refs < 1:
                raise ValueError(f"double free of block {b}")
            if refs == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = refs - 1

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)


def blocks_needed(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size)


def width_bucket(n: int, lo: int = 2) -> int:
    """Next power of two >= n: the dynamic block-table width."""
    b = lo
    while b < n:
        b *= 2
    return b
