"""Ring attention: sequence-parallel attention over a ring of ranks, in
PyTorch.

Counterpart of ``kind_tpu_sim/parallel/ring_attention.py``. The
sequence is split over a mesh axis: each rank holds its block of q, k
and v, the K/V blocks travel round the ring (each rank sends its block
to the next rank and receives the previous rank's) and an online
softmax accumulates in fp32, so attention over a sequence n times
longer than one rank holds runs with neighbour traffic only.

The per-rank body is the reference's: inputs cast to fp32 before each
product (what ``preferred_element_type=float32`` computes), positions
global (``index * t_local + arange``), query head h reading kv group
``h // group``. Two orderings: double-buffered (the default; the next
rotation is posted before the current block is computed) and serial
(rotate after the block). ``KIND_TPU_SIM_RING_DOUBLE_BUFFER`` means
what it means to the reference (``0``, ``false``, ``no`` or empty:
serial). Under a causal mask a block that lies wholly in the future
adds exactly zero (after the diagonal block at step 0 the running max
is finite, so its probabilities are exp(-1e30 - m) = 0 and the
correction is 1): its products are skipped, the rotation still runs.

The ring is one ``torch.autograd.Function``: the forward keeps the
fp32 output and the row log-sum-exp, the backward recomputes each
block's probabilities, and the K/V gradients travel round the ring with
their blocks and take one more step home. Every rank runs the same
rotations in the same order whatever its mask skips.

The transport follows the world's backend (``tp.start_exchange``):
NCCL moves the card's tensors, gloo host tensors (a card's block is
staged through the host). A rotation moves 2 * b * t_local * kv_heads *
head_dim elements of the input dtype each way.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from kind_tpu_sim_torch.parallel import tp

NEG_INF = -1e30
DOUBLE_BUFFER_ENV = "KIND_TPU_SIM_RING_DOUBLE_BUFFER"
# the reference's knob parser: these values mean off, anything else on
_FALSE_VALUES = ("", "0", "false", "no")


def double_buffer_default(environ=None) -> bool:
    """The reference's default ordering: double-buffered unless
    ``KIND_TPU_SIM_RING_DOUBLE_BUFFER`` says off."""
    env = os.environ if environ is None else environ
    raw = env.get(DOUBLE_BUFFER_ENV)
    return True if raw is None else raw.lower() not in _FALSE_VALUES


def _neighbours(ax):
    """(next, previous) world ranks of this rank on the ring ``ax``."""
    return (ax.ranks[(ax.index + 1) % ax.size],
            ax.ranks[(ax.index - 1) % ax.size])


class _Ring:
    """One rank's view of the ring: index, size and the rotation."""

    def __init__(self, ax, double_buffer: bool):
        self.ax = ax
        self.index, self.size = (0, 1) if ax is None else (ax.index, ax.size)
        self.double_buffer = double_buffer

    def rotate(self, x, tag: int = 0) -> tp.Pending:
        nxt, prev = _neighbours(self.ax)
        return tp.start_exchange(x, nxt, prev, tag)

    def blocks(self, kv):
        """Yield (step, source rank, the K/V block held at that step):
        ``size`` blocks, ``size - 1`` rotations, in the chosen order."""
        cur = kv
        for step in range(self.size):
            last = step + 1 == self.size
            pending = None
            if not last and self.double_buffer:
                pending = self.rotate(cur)
            yield step, (self.index - step) % self.size, cur
            if not last:
                cur = (pending if pending is not None
                       else self.rotate(cur)).wait()


def _scores(qg, k, scale, q_pos, k_pos, causal):
    """(b, heads, t_q, t_k) fp32 scores of the grouped q against one
    K block; masked entries -1e30."""
    b, tq, kvh, g, _ = qg.shape
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()).reshape(
        b, kvh * g, tq, k.shape[1]) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    return s


def _grouped(x, kvh):
    b, t, h, d = x.shape
    return x.reshape(b, t, kvh, h // kvh, d)


def _ring_forward(ring: _Ring, q, k, v, causal: bool):
    """(out fp32 (b, t, h, d), lse (b, h, t)) of this rank's queries."""
    b, tl, h, d = q.shape
    kvh = k.shape[2]
    scale = d ** -0.5
    qg = _grouped(q.float(), kvh)
    pos = torch.arange(tl, device=q.device)
    q_pos = ring.index * tl + pos
    m = torch.full((b, h, tl), NEG_INF, device=q.device)
    l = torch.zeros((b, h, tl), device=q.device)
    acc = torch.zeros((b, tl, h, d), device=q.device)
    for _, src, kv in ring.blocks(torch.stack([k, v])):
        if causal and src > ring.index:
            continue  # wholly in the future: adds exactly zero
        s = _scores(qg, kv[0], scale, q_pos, src * tl + pos,
                    causal and src == ring.index)
        new_m = torch.maximum(m, s.amax(dim=-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        l = l * correction + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bqhgd",
                          p.reshape(b, kvh, h // kvh, tl, tl),
                          kv[1].float()).reshape(b, tl, h, d)
        acc = acc * correction.transpose(1, 2)[..., None] + pv
        m = new_m
    denom = l.transpose(1, 2)[..., None]
    out = acc / torch.where(denom == 0.0, 1.0, denom)
    return out, m + torch.log(l)


def _ring_backward(ring: _Ring, q, k, v, out, lse, dout, causal: bool):
    """(dq, dk, dv) fp32: each block's probabilities recomputed from
    the log-sum-exp; the K/V gradients ride the ring with their block
    and take one more step to the rank that owns it."""
    b, tl, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    qg = _grouped(q.float(), kvh)
    do = dout.float()
    dog = _grouped(do, kvh)
    delta = (do * out).sum(dim=-1).transpose(1, 2)        # (b, h, t)
    pos = torch.arange(tl, device=q.device)
    q_pos = ring.index * tl + pos
    dq = torch.zeros((b, tl, kvh, g, d), device=q.device)
    dkv = torch.zeros((2, b, tl, kvh, d), device=q.device)
    for step, src, kv in ring.blocks(torch.stack([k, v])):
        if step:
            # the gradient of the block now held arrives from the
            # previous rank (which added its share one step before)
            dkv = pending.wait()
        if not (causal and src > ring.index):
            s = _scores(qg, kv[0], scale, q_pos, src * tl + pos,
                        causal and src == ring.index)
            p = torch.exp(s - lse[..., None]).reshape(b, kvh, g, tl, tl)
            dkv[1] += torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, kv[1].float())
            ds = p * (dp - delta.reshape(b, kvh, g, tl)[..., None])
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kv[0].float()) * scale
            dkv[0] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
        if ring.size > 1:
            pending = ring.rotate(dkv, tag=1)
    if ring.size > 1:
        dkv = pending.wait()
    return dq.reshape(b, tl, h, d), dkv[0], dkv[1]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal):
        out, lse = _ring_forward(ring, q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal = ring, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(ctx.ring, q, k, v, out, lse, dout,
                                    ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention_shard(q, k, v, ax: Optional[tp.Axis], causal: bool = True,
                         double_buffer: Optional[bool] = None):
    """Attention of this rank's query block over the whole sequence,
    its blocks held by the ranks of ``ax`` in ring order (None: one
    rank holds it all). q (b, t_local, heads, d); k/v (b, t_local,
    kv_heads, d) with kv_heads dividing heads. Differentiable."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} do not divide "
                         f"{q.shape[2]} query heads")
    if double_buffer is None:
        double_buffer = double_buffer_default()
    if ax is not None and ax.size == 1:
        ax = None
    return _RingAttention.apply(q, k, v, _Ring(ax, double_buffer), causal)


def _shardable(dim: int, mesh, axis) -> bool:
    return axis is not None and dim % int(mesh.shape[axis]) == 0


def ring_specs(q_shape, kv_shape, mesh, axis_name: str = "chip"):
    """(q spec, kv spec): the reference's placement of the global
    (batch, seq, heads, head_dim) inputs, one axis name or None per
    dimension. The sequence rides ``axis_name``; the batch rides 'data'
    where the mesh has more than that axis and it divides; the heads
    ride 'model' where both q and kv heads divide (else neither does,
    which keeps the group mapping whole within a rank)."""
    names = mesh.axis_names
    batch_axis = "data" if ("data" in names and names != (axis_name,)
                            and _shardable(q_shape[0], mesh, "data")
                            ) else None
    model = "model" if "model" in names else None
    q_head_axis = model if _shardable(q_shape[2], mesh, model) else None
    kv_head_axis = (model if q_head_axis is not None
                    and _shardable(kv_shape[2], mesh, model) else None)
    if kv_head_axis is None:
        q_head_axis = None
    return ((batch_axis, axis_name, q_head_axis, None),
            (batch_axis, axis_name, kv_head_axis, None))


def ring_attention(q, k, v, mesh, axis_name: str = "chip",
                   causal: bool = True,
                   double_buffer: Optional[bool] = None):
    """Attention with the sequence split over ``axis_name``, called on
    every rank of ``mesh`` with this rank's shards of the global inputs
    as ``ring_specs`` places them (``tp.shard_tensor``); returns this
    rank's shard of the output, placed like q. The output matches full
    attention. ``double_buffer`` None: ``double_buffer_default()``."""
    return ring_attention_shard(q, k, v, tp.axis(mesh, axis_name), causal,
                                double_buffer)


def reference_attention(q, k, v, causal: bool = True):
    """Single-device attention: the flagship model's own plain
    attention, so the ring is held to the numerics the transformer
    uses."""
    from kind_tpu_sim_torch.models.transformer import _attention

    return _attention(q, k, v, causal=causal).to(q.dtype)


def bench_report(small_tokens: int = 8192, large_tokens: int = 32768,
                 head_dim: int = 16, heads: int = 2, mesh=None,
                 device=None) -> dict:
    """The reference's ring against dense attention section, on every
    rank of a ('seq',) mesh over the world (``mesh`` None: one is
    made): dense and ring at ``small_tokens``, the ring alone at
    ``large_tokens``, the reference's keys. Dense runs whole on every
    rank; its time is this device's attention rate, the ceiling the
    ring's is read against. ``device`` None: the rank's device."""
    import numpy as np

    from kind_tpu_sim_torch.models import flops as F
    from kind_tpu_sim_torch.parallel import launch
    from kind_tpu_sim_torch.parallel.mesh import Mesh

    if mesh is None:
        mesh = Mesh((torch.distributed.get_world_size(),), ("seq",))
    dev = torch.device(device) if device is not None else launch.rank_device()
    ax = tp.axis(mesh, "seq")

    def inputs(tokens):
        gen = torch.Generator().manual_seed(0)
        shape = (1, tokens, heads, head_dim)
        return [torch.randn(shape, generator=gen).to(dev) for _ in range(3)]

    def local(x):
        return tp.shard_tensor(x, (None, "seq", None, None), mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        torch.distributed.barrier()

    def timeit(fn, *args, reps=3):
        last = fn(*args)
        sync()
        best = None
        for _ in range(reps):
            t0 = time.monotonic()
            last = fn(*args)
            sync()
            dt = time.monotonic() - t0
            best = dt if best is None else min(best, dt)
        return best, last

    out: dict = {}
    q, k, v = inputs(small_tokens)
    with torch.no_grad():
        dense_s, dense_out = timeit(reference_attention, q, k, v)
        ring_s, ring_out = timeit(
            lambda *a: ring_attention_shard(*a, ax), local(q), local(k),
            local(v))
    out["dense_8k_s"] = round(dense_s, 3)
    out["ring_8k_s"] = round(ring_s, 3)
    np.testing.assert_allclose(ring_out.cpu().numpy(),
                               local(dense_out).cpu().numpy(),
                               atol=2e-4, rtol=2e-4)
    del q, k, v, dense_out, ring_out
    q, k, v = (local(x) for x in inputs(large_tokens))
    with torch.no_grad():
        s32, _ = timeit(lambda *a: ring_attention_shard(*a, ax), q, k, v,
                        reps=1)
    out["ring_32k_s"] = round(s32, 3)
    out["ring_32k_tokens_per_s"] = round(large_tokens / s32)
    fl8 = F.attention_flops(small_tokens, heads, head_dim)
    fl32 = F.attention_flops(large_tokens, heads, head_dim)
    ceiling = fl8 / dense_s
    out["host_attn_gflops_per_s"] = round(ceiling / 1e9, 2)
    out["ring_32k_gflops_per_s"] = round(fl32 / s32 / 1e9, 2)
    out["ring_32k_expected_s"] = round(fl32 / ceiling, 3)
    out["ring_32k_pct_of_expected"] = round(
        100.0 * out["ring_32k_expected_s"] / s32, 1)
    n_dev = ax.size
    comm_bytes = 2 * (n_dev - 1) * large_tokens * heads * head_dim * 4
    out["ring_32k_comm_mb"] = round(comm_bytes / 2**20, 1)
    out["ring_8k_overhead_vs_dense"] = round(ring_s / dense_s, 3)
    return out
