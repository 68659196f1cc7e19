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
``serving.PagedServingEngine``. ``PagedPrefixCache`` shares whole
prompt blocks between requests by reference count; ``paged_suffix``
runs a prompt's suffix against the shared blocks. Speculative verify
windows (``paged_verify_step`` / ``paged_verify_scan``) run on the
gather tier: one view a window, the window's k/v scattered back.

With ``ModelConfig.int8_kv`` the pools are int8 ``QuantArray``s (q and a
per-row scale share the paging geometry): every write quantizes its
rows (``decode._write``), every view gathers both parts. int8 pools
serve on the gather tier only; the engine refuses the kernel tier for
them, as the reference does.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import torch

from kind_tpu_sim_torch.models.decode import (
    NEG,
    _attend_token,
    _cache_scores,
    _finish_block,
    _map_kv,
    _write,
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

    return [{"k": _map_kv(lc["k"], view), "v": _map_kv(lc["v"], view)}
            for lc in pools]


def _scatter_flat(pool_arr, blocks, offsets, rows) -> None:
    """pool[blocks[i], offsets[i]] = rows[i] for every flat row i, in
    place (quantized per row into an int8 pool). Duplicate targets
    occur only in the garbage block."""
    _write(pool_arr, (blocks.long(), offsets.long()), rows)


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


def _last_logits(x, params, true_len: int, cfg: ModelConfig):
    """fp32 logits (vocab,) at the window's TRUE last position."""
    h = _rms_norm(x[:, true_len - 1, :], params["final_norm"])
    return _readout(h, params["embed"], cfg.int8_native)[0].float()


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
    return paged_prefill_many(params, pools, tokens, [true_len],
                              table_row[None, :], cfg=cfg)[0]


def paged_prefill_many(params, pools, tokens, true_lens, tables, *,
                       cfg: ModelConfig):
    """K whole-prompt prefills (an admission wave: the reference's
    ``serving._paged_prefill_many``) as ONE stacked forward over
    ``tokens`` (K, t_pad): row r's k/v for its first ``true_lens[r]``
    positions scatter through its table row ``tables[r]`` (positions
    past them, or past the width, to the garbage block), in place. Each
    row's result equals its own ``paged_prefill``; the flash kernel
    launches once per layer for the wave, an MoE routes each prompt
    alone. Returns (K, vocab) fp32
    logits at each row's true last position."""
    k_rows, t_p = tokens.shape
    dev = tokens.device
    positions = torch.arange(t_p, device=dev)[None, :].expand(k_rows, t_p)
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    idx = [_window_indices(t_p, 0, pools[0]["k"].shape[1], tables.shape[1],
                           n, row) for n, row in zip(true_lens, tables)]
    blocks = torch.cat([b for b, _ in idx])
    offsets = torch.cat([o for _, o in idx])

    def write(pool_arr, upd):
        flat = upd.reshape((k_rows * t_p,) + tuple(upd.shape[2:]))
        _scatter_flat(pool_arr, blocks, offsets, flat)

    for bparams, lc in zip(params["blocks"], pools):
        x, _, k, v = _block_core(x, bparams, cfg, positions, "rows")
        _write_layer(lc, k, v, write)
    lens = torch.as_tensor(true_lens, device=dev)
    h = _rms_norm(x[torch.arange(k_rows, device=dev), lens - 1],
                  params["final_norm"])
    return _readout(h, params["embed"], cfg.int8_native).float()


def paged_suffix(params, pools, tokens, true_len: int, base: int, table_row,
                 *, cfg: ModelConfig):
    """Prefix-cache admission (and every chunked-prefill window after
    the first), paged: the slot's table already points at the blocks
    holding positions < ``base``; run the window (1, w_pad) through the
    model attending to the gathered prefix view, scatter its k/v into
    the slot's blocks from ``base`` on, in place, and return the fp32
    logits at the true last window position. Shared blocks are never
    written: a hit's suffix starts on a block boundary, so every write
    lands in blocks this slot allocated itself."""
    from kind_tpu_sim_torch.models.speculative import _window_block

    w = tokens.shape[1]
    view = gather_view(pools, table_row[None, :])
    x = embed_lookup(params["embed"], tokens, torch_dtype(cfg.dtype))
    base_vec = torch.full((1,), base, device=tokens.device)
    blocks, offsets = _window_indices(
        w, base, pools[0]["k"].shape[1], table_row.shape[0], true_len,
        table_row)

    def write(pool_arr, upd):
        _scatter_flat(pool_arr, blocks, offsets, upd[0])

    for bparams, lc, view_lc in zip(params["blocks"], pools, view):
        x, kk, vv = _window_block(x, bparams, cfg, view_lc, base_vec)
        _write_layer(lc, kk, vv, write)
    return _last_logits(x, params, true_len, cfg)


def paged_decode_chunk(params, pools, tables, lengths, last_token, active,
                       sampling, presence, *, cfg: ModelConfig, chunk: int):
    """One scheduling quantum on the gather tier: gather the block view
    once, run the shared chunk scan (``serving._chunk_scan``: device
    inputs only, ``last_token`` and ``presence`` updated in place),
    scatter the chunk buffer back. Returns (emitted, logprobs)."""
    from kind_tpu_sim_torch.models.serving import _chunk_scan

    view = gather_view(pools, tables)
    small, emitted, lps = _chunk_scan(
        params, view, lengths, last_token, active, sampling, presence,
        cfg=cfg, chunk=chunk)
    scatter_rows(pools, tables, lengths, small, active)
    return emitted, lps


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
        torch_dtype(cfg.dtype)).reshape(b, -1)

    small_lc["k"][:, i] = k1[:, 0]
    small_lc["v"][:, i] = v1[:, 0]
    return _finish_block(x, attn, bparams, cfg), small_lc


def paged_decode_chunk_kernel(params, pools, tables, lengths, last_token,
                              active, sampling, presence, *,
                              cfg: ModelConfig, chunk: int):
    """paged_decode_chunk's kernel tier: same scheduling quantum, with
    the big-cache attention reading pool blocks directly through the
    table — no per-chunk gather, no transient view. ``tables`` and
    ``lengths`` are int32 device tensors. Returns (emitted,
    logprobs)."""
    from kind_tpu_sim_torch.models.serving import _chunk_scan

    def block_fn(x, bparams, pool_lc, small_lc, i):
        return _block_decode_kernel(x, bparams, cfg, pool_lc, tables,
                                    small_lc, lengths, i)

    small, emitted, lps = _chunk_scan(
        params, pools, lengths, last_token, active, sampling, presence,
        cfg=cfg, chunk=chunk, block_fn=block_fn)
    scatter_rows(pools, tables, lengths, small, active)
    return emitted, lps


def paged_verify_step(params, pools, tables, out, total, active, sampling,
                      *, cfg: ModelConfig, k: int):
    """One speculative verify window over paged storage: gather the
    block view once per window (amortized over up to k+1 emitted
    tokens), run the window forward against it, scatter the window's
    k/v into each slot's blocks from its base (inactive slots to the
    garbage block), in place, and run the shared accept/emit
    (``speculative._accept_and_emit``). Returns (out, total, emit, m,
    lp)."""
    from kind_tpu_sim_torch.models.speculative import (
        _accept_and_emit,
        _window_forward,
    )

    view = gather_view(pools, tables)
    draft, base, logits, rows = _window_forward(params, view, out, total,
                                                cfg=cfg, k=k)
    scatter_rows(pools, tables, base, rows, active)
    return _accept_and_emit(logits, draft, out, total, active, sampling, k=k)


def paged_verify_scan(params, pools, tables, out, total, active, sampling,
                      *, cfg: ModelConfig, k: int, windows: int):
    """``windows`` paged verify windows in one dispatch (a loop that
    never reads the device), the paged twin of
    ``speculative._grid_verify_scan`` (its inputs are the same device
    tensors; ``out`` and ``total`` are updated in place). ``tables``
    stay fixed across the windows: the caller grows every slot's block
    list to cover windows*(k+1) positions first; each window gathers
    the view again, as the pools advanced. Returns (emits (W, b, k+1),
    ms (W, b), lps (W, b, k+1))."""
    from kind_tpu_sim_torch.models.speculative import _scan_windows

    def step(out, total):
        return paged_verify_step(params, pools, tables, out, total, active,
                                 sampling, cfg=cfg, k=k)

    return _scan_windows(step, out, total, windows)


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


class PagedPrefixCache:
    """Block-granular prompt-prefix sharing (exact-prefix tier): a
    stored prefix is a list of FULL pool blocks, refcounted by the
    allocator and keyed by the token tuple those blocks hold. A hit
    points the new slot's table at the shared blocks (no copy, no
    forward over the shared positions) and runs only the block-aligned
    suffix. Shared blocks are never written (writes start at the first
    block past the shared ones)."""

    def __init__(self, capacity: int, alloc: BlockAllocator,
                 block_size: int):
        self.capacity = capacity
        self.alloc = alloc
        self.block_size = block_size
        self.entries = collections.OrderedDict()
        self._len_count = collections.Counter()
        self.hits = 0
        self.misses = 0
        # blocks every hit pointed at instead of allocating and
        # prefilling them (x block_size: prompt tokens skipped)
        self.shared_blocks = 0

    def lookup(self, prompt: List[int]):
        """Longest stored full-block STRICT prefix of ``prompt`` (so at
        least its last token runs through the model), LRU-refreshed;
        None on a miss."""
        for length in sorted(self._len_count, reverse=True):
            if length >= len(prompt):
                continue
            key = tuple(prompt[:length])
            entry = self.entries.get(key)
            if entry is None:
                continue
            self.hits += 1
            self.shared_blocks += len(entry["blocks"])
            self.entries.move_to_end(key)
            return entry
        self.misses += 1
        return None

    def store(self, prompt: List[int], blocks: List[int]) -> None:
        """Share the slot's full blocks of ``prompt`` into the cache
        (only whole blocks are cacheable)."""
        n_full = len(prompt) // self.block_size
        usable = blocks[:n_full]
        if not usable:
            return
        key = tuple(prompt[:n_full * self.block_size])
        if key in self.entries:
            self.entries.move_to_end(key)
            return
        self.alloc.share(usable)
        self.entries[key] = {"blocks": list(usable),
                             "len": n_full * self.block_size}
        self._len_count[len(key)] += 1
        while len(self.entries) > self.capacity:
            self.evict_lru()

    def evict_lru(self) -> bool:
        """Drop the least recently used entry and its block references
        (blocks a live slot still uses stay allocated until it
        retires); False when the cache is empty. Runs on store
        overflow and under pool pressure, so cache-held blocks never
        starve admission."""
        if not self.entries:
            return False
        old_key, old = self.entries.popitem(last=False)
        self.alloc.free(old["blocks"])
        self._len_count[len(old_key)] -= 1
        if not self._len_count[len(old_key)]:
            del self._len_count[len(old_key)]
        return True

    def report(self) -> dict:
        return {"entries": len(self.entries), "hits": self.hits,
                "misses": self.misses, "shared_blocks": self.shared_blocks}


def blocks_needed(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size)


def width_bucket(n: int, lo: int = 2) -> int:
    """Next power of two >= n: the dynamic block-table width."""
    b = lo
    while b < n:
        b *= 2
    return b
