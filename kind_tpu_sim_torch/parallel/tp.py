"""Tensor, expert and data parallelism written out by hand.

The reference places its parameters with ``PartitionSpec``s and lets
GSPMD insert the collectives. Here every rank holds its shard of each
parameter as a plain tensor in the usual dict tree, and the model code
calls the collectives itself, on the groups of the ``Shards`` in scope:

* ``model``: Megatron tensor parallelism. Column-parallel weights
  (wqkv by heads, w_up) take the replicated activation through
  ``copy_in`` (identity forward, all-reduce of the gradient);
  row-parallel ones (wo, w_down) give partial sums that ``reduce_out``
  all-reduces (all-reduce forward, identity gradient). The embedding
  is split over the vocabulary: each rank looks its rows up and the
  lookups are summed; the tied readout gives each rank its vocabulary
  columns, which ``gather_last`` joins where whole logits are needed.
* ``expert``: the experts of an MoE block (the 'expert' axis, else
  'model'); tokens are replicated over it and the combine is summed.
* ``data``: set while the tokens of the call are split over data ranks
  (the train step, a serving round whose slots are split). An MoE then
  routes over the global batch: capacity from the global token count,
  queue positions continued across ranks, the auxiliary loss's means
  over every token.
* ``seq``: set while the call's sequence is split over the 'seq' axis
  (each rank holds its columns of every row): attention rides the ring
  (``parallel/ring_attention.py``) or the sequence gathered along it,
  positions are global. ``tokens`` is then the ranks that share the
  call's tokens, ('dcn', 'data') and 'seq' jointly (seq innermost), and
  ``seq_tokens`` the positions of the global sequence an MoE routes (0:
  all of them; the loss without the ring leaves the last one out, as
  the reference's forward over ``tokens[:, :-1]`` does).

``scope(shards)`` sets what is in scope for a block of code (a context
variable, so nothing outside the block sees it); ``current()`` reads
it. Outside any scope every helper here is the identity.

Floating all-reduces run in fp32 (a bf16 partial sum is widened first
and the total rounded once), integer ones in their own type.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """A group of ranks one collective rides: its process group, size,
    this rank's index in it and the world ranks in group order."""

    group: object
    size: int
    index: int
    ranks: tuple


class Shards(NamedTuple):
    """The mesh axes the computation in flight is split over (None:
    not split over it)."""

    model: Optional[Axis] = None
    expert: Optional[Axis] = None
    data: Optional[Axis] = None
    seq: Optional[Axis] = None
    tokens: Optional[Axis] = None
    seq_tokens: int = 0

    def token_group(self) -> Optional[Axis]:
        """Every rank holding a part of the call's tokens: ``tokens``
        where the sequence is split, else ``data``."""
        return self.tokens if self.tokens is not None else self.data


def axis(mesh, *names: str) -> Optional[Axis]:
    """The mesh's group over ``names`` jointly (the present ones), or
    None when none is in the mesh."""
    present = tuple(a for a in mesh.axis_names if a in names)
    if not present:
        return None
    ranks = []
    for i in range(mesh.axis_size(*present)):
        coords, rest = {}, i
        for a in reversed(present):
            coords[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
        ranks.append(mesh.group_rank(**coords))
    return Axis(mesh.group(*present), mesh.axis_size(*present),
                mesh.axis_index(*present), tuple(ranks))


def shards_of(mesh, data_axes=("dcn", "data")) -> Shards:
    """The split a mesh gives a computation: 'model', the expert axis
    ('expert' if present, else 'model') and, when the call's tokens are
    split over them, ``data_axes`` and a 'seq' axis longer than 1 (None:
    tokens replicated, over 'seq' too)."""
    if mesh is None:
        return Shards()
    model = axis(mesh, "model")
    expert = axis(mesh, "expert") if "expert" in mesh.axis_names else model
    if not data_axes:
        return Shards(model, expert)
    data = axis(mesh, *data_axes)
    if mesh.shape.get("seq", 1) == 1:
        return Shards(model, expert, data)
    return Shards(model, expert, data, axis(mesh, "seq"),
                  axis(mesh, *data_axes, "seq"))


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "kind_tpu_sim_torch_shards", default=Shards())


@contextlib.contextmanager
def scope(shards: Shards):
    """Run the block with ``shards`` in scope."""
    token = _CURRENT.set(shards)
    try:
        yield shards
    finally:
        _CURRENT.reset(token)


def current() -> Shards:
    return _CURRENT.get()


def model_size() -> int:
    m = current().model
    return 1 if m is None else m.size


# ---------------------------------------------------------------------
# collectives on tensors (no autograd)


def all_reduce(x: torch.Tensor, ax: Axis, op: str = "sum"):
    """A new tensor: ``x`` summed (or, ``op="max"``, maxed) over ``ax``;
    floating tensors are reduced in fp32."""
    if x.is_floating_point():
        buf = x.to(torch.float32, copy=True)
    else:
        buf = x.clone()
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(buf, op=reduce_op, group=ax.group)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order."""
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, ax: Axis, src_index: int) -> torch.Tensor:
    """``x`` of the rank at ``src_index`` in ``ax``, on every rank of it
    (in place; ``x`` must have the right shape and dtype everywhere)."""
    dist.broadcast(x, src=ax.ranks[src_index], group=ax.group)
    return x


class Pending:
    """A posted point-to-point exchange: ``wait()`` gives the received
    tensor (zeros where nothing is received)."""

    def __init__(self, works, buf, device, keep):
        self._works, self._buf, self._device = works, buf, device
        self._keep = keep  # the sent buffer lives until the send is done

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._works, self._keep = [], None
        if self._device is not None:
            return self._buf.to(self._device)
        return self._buf


def start_exchange(x: torch.Tensor, send_to: Optional[int],
                   recv_from: Optional[int], tag: int = 0) -> Pending:
    """Post the send of ``x`` to world rank ``send_to`` and the receive
    of a tensor like it from ``recv_from`` (either None: not posted).
    The transport follows the world's backend: NCCL moves the card's
    tensors; gloo moves host tensors, so a card's tensor is staged
    through the host (gloo's send of a CUDA tensor aborts the rank)."""
    staged = x.is_cuda and dist.get_backend() == "gloo"
    src = (x.detach().cpu() if staged else x.detach()).contiguous()
    buf = torch.zeros_like(src)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, src, send_to, tag=tag))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, buf, recv_from, tag=tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, buf, x.device if staged else None, src)


# ---------------------------------------------------------------------
# collectives with gradients


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAcross(torch.autograd.Function):
    """A sum over ranks that each rank's loss reads: the gradient of
    the sum reaches every rank's input summed over the ranks' losses."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-1]
        return all_gather(x, ax, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.ax.index * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None


class _GatherDim(torch.autograd.Function):
    """The ranks' slices joined along ``dim``; the backward is the
    reduce-scatter (every rank's gradient of the whole summed, this
    rank's slice kept)."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        whole = all_reduce(g, ctx.ax)
        return (whole.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n)
                .contiguous(), None, None)


def gather_dim(x, ax: Optional[Axis], dim: int):
    """The ranks' slices of ``x`` joined along ``dim`` (differentiable:
    the gradient is reduce-scattered back)."""
    return x if ax is None else _GatherDim.apply(x, ax, dim)


def copy_in(x, ax: Optional[Axis]):
    """Enter a split region: identity forward, gradient all-reduced."""
    return x if ax is None else _CopyIn.apply(x, ax)


def reduce_out(x, ax: Optional[Axis]):
    """Leave a split region: partial sums all-reduced, identity
    gradient."""
    return x if ax is None else _ReduceOut.apply(x, ax)


def sum_across(x, ax: Optional[Axis]):
    """A sum over the ranks of ``ax`` inside a loss every rank takes."""
    return x if ax is None else _SumAcross.apply(x, ax)


def gather_last(x, ax: Optional[Axis]):
    """The ranks' last-axis slices joined (whole logits)."""
    return x if ax is None else _GatherLast.apply(x, ax)


# ---------------------------------------------------------------------
# placement: a spec per leaf, as the reference's PartitionSpec


def qkv_columns(n_heads: int, kv_heads: int, head_dim: int, size: int,
                index: int) -> torch.Tensor:
    """The fused wqkv's columns rank ``index`` of ``size`` holds: its q
    heads, then its k heads, then its v heads (a contiguous column
    slice would give the first ranks q heads only)."""
    def heads(first, count):
        per = count // size
        lo = first + index * per * head_dim
        return torch.arange(lo, lo + per * head_dim)

    q = n_heads * head_dim
    kv = kv_heads * head_dim
    return torch.cat([heads(0, n_heads), heads(q, kv_heads),
                      heads(q + kv, kv_heads)])


def _divisible(shape, dim: int, n: int) -> None:
    if shape[dim] % n:
        raise ValueError(
            f"a leaf sharded over {n} ranks along dimension {dim}: the "
            f"global size of its dimension {dim} should be divisible by "
            f"{n}, but it is equal to {shape[dim]} (full shape: "
            f"{tuple(shape)})")


def shard_tensor(t: torch.Tensor, spec, mesh,
                 columns_of=None) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec`` (one
    axis name or None per dimension). ``columns_of(size, index)`` gives
    the last dimension's columns of rank ``index`` where they are not
    a contiguous slice (wqkv's heads)."""
    out = t
    for dim, name in enumerate(spec):
        if name is None or name not in mesh.shape:
            continue
        n = mesh.shape[name]
        _divisible(t.shape, dim, n)
        if n == 1:
            continue
        if dim == t.dim() - 1 and columns_of is not None:
            cols = columns_of(n, mesh.coords[name])
            out = out.index_select(dim, cols.to(out.device))
            continue
        step = t.shape[dim] // n
        out = out.narrow(dim, mesh.coords[name] * step, step)
    return out.contiguous() if out is not t else t


def gather_tensor(local: torch.Tensor, spec, mesh,
                  columns_of=None) -> torch.Tensor:
    """``shard_tensor``'s inverse: the whole tensor, on every rank.
    ``columns_of(size, index)`` gives the last dimension's columns of
    rank ``index`` where they are not a contiguous slice."""
    out = local.detach()
    for dim, name in enumerate(spec):
        if name is None or mesh.shape.get(name, 1) == 1:
            continue
        ax = axis(mesh, name)
        joined = all_gather(out, ax, dim)
        if dim == local.dim() - 1 and columns_of is not None:
            order = torch.cat([columns_of(ax.size, i)
                               for i in range(ax.size)])
            whole = torch.empty_like(joined)
            whole.index_copy_(dim, order.to(joined.device), joined)
            joined = whole
        out = joined
    return out


def split_rows(n: int, ax: Optional[Axis]) -> List[int]:
    """[lo, hi) of the rows of ``n`` this rank of ``ax`` holds."""
    if ax is None:
        return [0, n]
    if n % ax.size:
        raise ValueError(f"{n} rows not divisible by {ax.size} ranks")
    per = n // ax.size
    return [ax.index * per, (ax.index + 1) * per]
