"""Differentiable exchanges for the SPMD functions of the sequence, expert
and pipeline tier (ring, zigzag and Ulysses attention, MoE, the pipeline).

``tpulab`` writes these functions as ``shard_map`` bodies and lets JAX's
autodiff transpose ``ppermute`` and ``all_to_all``.  The port's ranks are
processes, so each exchange here is a ``torch.autograd.Function`` whose
backward is the transposed exchange, under one rule for gradients: every
rank calls a function with the same full (replicated) inputs, gets the
same full result, computes the same loss from it and calls ``backward``;
each rank's gradient for a full input is then the single-device
gradient, not p times it.

* :func:`distribute` takes this rank's shard of each replicated input; its
  backward all-gathers the shards' gradients into the full gradient.  An
  input that every rank uses whole (``None`` in the plan) gets the ranks'
  gradients summed.
* :func:`collect` gathers the ranks' output shards; its backward is this
  rank's own shard of the incoming gradient, with no sum.
* :func:`from_rank` hands every rank one rank's tensor (a broadcast); its
  backward is the incoming gradient on that rank and zero on the others.
* :func:`ring_shift` hands each rank the tensor of the rank before it; its
  backward shifts the other way.  :func:`all_to_all` exchanges the blocks
  of dim 0; its backward is the same exchange (its own transpose).
* :func:`keep` returns its first tensor and holds the others in the graph
  with a zero gradient, so that every rank's backward reaches every
  exchange.

Every rank must post the same collectives in the same order, forward and
backward, or the others wait in one until ``COLLECTIVE_TIMEOUT``.  So a
function branches on its rank only in arithmetic; each exchange's input
depends on the exchange before it, so the backward meets them in reverse
order on every rank; what a rank's loss would not reach is held by
:func:`keep`; and the gradients of one call's inputs travel in one node.

A shard's *layout* cuts a dim into equal blocks and lists each rank's
blocks: :func:`contiguous` gives rank ``r`` block ``r`` of ``p``;
:func:`zigzag` gives it half-blocks ``r`` and ``2p - 1 - r`` of ``2p``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from tpulab_torch.parallel.collectives import check_dtype, gather_group
from tpulab_torch.parallel.mesh import axis_size, mesh_anchor

Layout = Tuple[Tuple[int, ...], ...]


@dataclass(frozen=True)
class Axis:
    """A mesh axis as this rank sees it: the process group over its ranks,
    this rank's index along it, and its size."""

    group: Any
    idx: int
    p: int

    def global_rank(self, r: int) -> int:
        return dist.get_global_rank(self.group, r % self.p)


#: fused-axis groups by (device type, mesh layout, axes, world group)
_FUSED: Dict[tuple, Axis] = {}


def mesh_axis(mesh, axis) -> Axis:
    """``axis`` of ``mesh``: a name, or a tuple of names fused into one axis
    whose ranks are ordered row-major in the tuple's order (``tpulab``'s
    ``P(("dp", "sp"))``).  A fused axis's process groups, one for each
    coordinate of the other axes, are made by every rank together on first
    use and kept."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(names) == 1:
        return Axis(mesh.get_group(names[0]), mesh.get_local_rank(names[0]),
                    axis_size(mesh, names[0]))
    key = (mesh.device_type, tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape), names,
           id(dist.group.WORLD))
    if key not in _FUSED:
        dims = [list(mesh.mesh_dim_names).index(a) for a in names]
        rest = [i for i in range(mesh.mesh.dim()) if i not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(
            mesh.mesh.shape[i] for i in dims)).tolist()
        me = dist.get_rank()
        for row in rows:  # every rank makes every group, in the same order
            group = dist.new_group(row)
            if me in row:
                _FUSED[key] = Axis(group, row.index(me), len(row))
    return _FUSED[key]


def stage(x, mesh) -> torch.Tensor:
    """``x`` (host array or tensor) on this rank's device in ``mesh``; a
    tensor moves differentiably."""
    if isinstance(x, torch.Tensor):
        return x.to(mesh_anchor(mesh))
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh_anchor(mesh))


# ------------------------------------------------------------ layouts


def contiguous(p: int) -> Layout:
    return tuple((r,) for r in range(p))


def zigzag(p: int) -> Layout:
    return tuple((r, 2 * p - 1 - r) for r in range(p))


def take(x: torch.Tensor, dim: int, layout: Layout, r: int) -> torch.Tensor:
    """Rank ``r``'s shard of ``x`` along ``dim`` (a new tensor)."""
    n = x.shape[dim] // sum(len(b) for b in layout)
    parts = [x.narrow(dim, b * n, n) for b in layout[r]]
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0].clone(
        memory_format=torch.contiguous_format)


def assemble(parts: Sequence[torch.Tensor], dim: int, layout: Layout) -> torch.Tensor:
    """The full tensor from every rank's shard (the inverse of :func:`take`)."""
    blocks: list = [None] * sum(len(b) for b in layout)
    for r, part in enumerate(parts):
        for b, piece in zip(layout[r], part.chunk(len(layout[r]), dim)):
            blocks[b] = piece
    return torch.cat(blocks, dim)


# ------------------------------------------------------------ raw exchanges


def _all_gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every rank's ``x``, stacked along a new dim 0 in rank order."""
    return gather_group(x, ax.group, ax.p).view(ax.p, *x.shape)


def _shift(x: torch.Tensor, ax: Axis, step: int) -> torch.Tensor:
    """The ``x`` of rank ``idx - step`` (each rank sends to ``idx + step``)."""
    if ax.p == 1:
        return x.clone()
    check_dtype(x.dtype, ax.group, "batch_isend_irecv")
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ax.global_rank(ax.idx + step), ax.group),
           dist.P2POp(dist.irecv, out, ax.global_rank(ax.idx - step), ax.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _a2a(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Block ``j`` of dim 0 to rank ``j``; block ``j`` of the result from rank ``j``."""
    if ax.p == 1:
        return x.clone()
    check_dtype(x.dtype, ax.group, "all_to_all_single")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ax.group)
    return out


# ------------------------------------------------------------ autograd


class _Distribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, plan, *xs):
        ctx.ax, ctx.plan = ax, plan
        return tuple(x.view_as(x) if how is None else take(x, *how, ax.idx)
                     for x, how in zip(xs, plan))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        out = []
        for g, how, need in zip(grads, ctx.plan, ctx.needs_input_grad[2:]):
            if not need:
                out.append(None)
                continue
            parts = _all_gather(g, ctx.ax)
            out.append(parts.sum(dim=0) if how is None
                       else assemble(list(parts.unbind(0)), *how))
        return (None, None, *out)


def distribute(ax: Axis, plan, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This rank's part of each replicated input: ``plan[i]`` is ``(dim,
    layout)`` for a shard, ``None`` for the whole tensor.  One node, whose
    backward all-gathers each gradient in turn (shards assembled, wholes
    summed)."""
    return _Distribute.apply(ax, tuple(plan), *xs)


class _Collect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, layout, x):
        ctx.ax, ctx.dim, ctx.layout = ax, dim, layout
        return assemble(list(_all_gather(x, ax).unbind(0)), dim, layout)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, None, None, take(g, ctx.dim, ctx.layout, ctx.ax.idx)


def collect(x: torch.Tensor, ax: Axis, dim: int, layout: Layout) -> torch.Tensor:
    """Every rank's shard ``x`` gathered into the full tensor."""
    return _Collect.apply(ax, dim, layout, x)


class _FromRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, src, x):
        ctx.mine = ax.idx == src
        buf = x.detach().clone(memory_format=torch.contiguous_format)
        if ax.p > 1:
            check_dtype(buf.dtype, ax.group, "broadcast")
            dist.broadcast(buf, src=ax.global_rank(src), group=ax.group)
        return buf

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, None, g if ctx.mine else torch.zeros_like(g)


def from_rank(x: torch.Tensor, ax: Axis, src: int) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (``x`` elsewhere: a tensor of its
    shape and dtype)."""
    return _FromRank.apply(ax, src, x)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return _shift(x, ax, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, _shift(g, ctx.ax, -1)


def ring_shift(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The ``x`` of the rank before this one along the ring (``ppermute``
    with ``[(i, (i + 1) % p)]``)."""
    return _Shift.apply(ax, x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return _a2a(x, ax)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, _a2a(g, ctx.ax)


def all_to_all(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``: dim 0
    (a multiple of p) cut into p blocks, block ``j`` sent to rank ``j``."""
    return _AllToAll.apply(ax, x)


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *held):
        ctx.held = [(h.shape, h.dtype, h.device) for h in held]
        return x.view_as(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.held))


def keep(x: torch.Tensor, *held: Optional[torch.Tensor]) -> torch.Tensor:
    """``x``, with ``held`` kept in the graph (zero gradient) where grad is
    on and one of them requires it: the exchanges behind ``held`` then run
    in this rank's backward even where its loss does not reach them."""
    held = tuple(h for h in held if h is not None and h.requires_grad)
    if not held or not torch.is_grad_enabled():
        return x
    return _Keep.apply(x, *held)


# ------------------------------------------------------------ sharded training
#
# The mesh trainer (:mod:`tpulab_torch.models.sharded`) keeps each rank's own
# shards of the parameters and its own slice of the batch, so its exchanges
# follow Megatron's rule instead of the one above: a rank's loss is its
# share of the global loss, and a gradient is summed over the ranks whose
# shares it collects.  ``None`` for an axis means size 1: every op is then
# the identity, and the one-device arithmetic runs unchanged.


def all_reduce_(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Sum ``x`` over ``ax`` in place (every rank gets the same bits)."""
    if ax is not None and ax.p > 1:
        check_dtype(x.dtype, ax.group, "all_reduce")
        dist.all_reduce(x, group=ax.group)
    return x


def gather_dim(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``ax`` concatenated along ``dim`` in rank order."""
    if ax is None or ax.p == 1:
        return x
    return torch.cat(list(_all_gather(x.contiguous(), ax).unbind(0)), dim)


def reduce_scatter_dim(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """This rank's block of ``x`` summed over ``ax``, cut along ``dim``
    (``reduce_scatter_tensor``)."""
    if ax is None or ax.p == 1:
        return x
    check_dtype(x.dtype, ax.group, "reduce_scatter")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // ax.p, *src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, group=ax.group)
    return out.movedim(0, dim)


def all_reduce_buckets(pairs, axes: Dict[str, Optional[Axis]]) -> None:
    """Sum each tensor of ``pairs`` (``(tensor, axis names)``) over its
    axes (``axes[name]``) in place, the tensors of one key in one flat
    buffer."""
    buckets: Dict[Tuple[str, ...], list] = {}
    for t, key in pairs:
        if key:
            buckets.setdefault(tuple(key), []).append(t)
    for key, ts in buckets.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        for a in key:
            all_reduce_(flat, axes[a])
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.ax)


def copy_to(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """``x`` entering a region split over ``ax`` (Megatron's ``f``): the
    identity, whose backward sums the ranks' partial input gradients."""
    if ax is None or ax.p == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(ax, x)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), ax)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, g


def reduce_from(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum over ``ax`` of the ranks' partial results (Megatron's ``g``):
    an all-reduce, whose backward hands each rank the whole gradient."""
    if ax is None or ax.p == 1:
        return x
    return _ReduceFrom.apply(ax, x)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim = ax, dim
        return gather_dim(x, ax, dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, None, reduce_scatter_dim(g, ctx.ax, ctx.dim)


def gather_shards(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """The whole tensor from the ranks' shards along ``dim``, where each rank
    uses it on its own data: the backward sums the ranks' gradients and
    hands each its block (a reduce-scatter)."""
    if ax is None or ax.p == 1:
        return x
    return _GatherShards.apply(ax, dim, x)


class Partition:
    """One way to cut a whole tensor among the p ranks of an axis:
    ``take(whole, r)`` is rank r's part, ``assemble(parts)`` the inverse."""

    def __init__(self, take_fn, assemble_fn):
        self.take, self.assemble = take_fn, assemble_fn


class _Repartitioned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, src, dst, x):
        ctx.ax, ctx.src, ctx.dst = ax, src, dst
        parts = list(_all_gather(x.contiguous(), ax).unbind(0))
        return dst.take(src.assemble(parts), ax.idx).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        parts = list(_all_gather(g.contiguous(), ctx.ax).unbind(0))
        return None, None, None, ctx.src.take(ctx.dst.assemble(parts), ctx.ax.idx).contiguous()


def repartition(x: torch.Tensor, ax: Optional[Axis], src: Partition,
                dst: Partition) -> torch.Tensor:
    """This rank's part under ``dst`` of the whole tensor whose parts under
    ``src`` the ranks hold (a permutation of the whole, so its backward is
    the permutation back)."""
    if ax is None or ax.p == 1:
        return x
    return _Repartitioned.apply(ax, src, dst, x)
