"""The port's collectives over one axis of the mesh (``mesh.Axis``), written
once for both backends: NCCL on the card, gloo on the CPU. gloo has no
``ReduceOp.AVG`` and no reduce-scatter, so a mean there is a sum divided
by the axis size, and a reduce-scatter an all-reduce and a slice. An axis
with no group (a run of one process) makes every collective the identity;
a group of one rank still runs it (a world-1 NCCL run goes through NCCL).

The autograd functions carry the gradient across ranks:

- ``all_reduce_sum``: a sum over the axis whose backward sums the
  gradients over the axis (BatchNorm's statistics over the data axis);
- ``all_gather``: the ranks' tensors stacked, whose backward hands each
  rank the sum of the gradients of its slot (the scan's chunk summaries);
- ``scatter_chunks`` / ``gather_chunks``: a tensor that every rank of the
  axis holds whole, cut into a chunk per rank, and back; the gradient of
  the whole tensor is the same on every rank on both sides;
- ``copy_to_axis``: a whole tensor that each rank uses on its own chunk;
  the backward sums the ranks' gradients.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _active(axis) -> bool:
    return axis is not None and axis.group is not None


def _nccl(axis) -> bool:
    return dist.get_backend(axis.group) == "nccl"


def all_reduce_(tensor: torch.Tensor, axis, mean: bool = False) -> torch.Tensor:
    """In place: the sum (or ``mean``) of ``tensor`` over ``axis``."""
    if not _active(axis):
        return tensor
    if mean and _nccl(axis):
        dist.all_reduce(tensor, op=dist.ReduceOp.AVG, group=axis.group)
        return tensor
    dist.all_reduce(tensor, group=axis.group)
    if mean:
        tensor.div_(axis.size)
    return tensor


def all_reduce_max_(tensor: torch.Tensor, axis) -> torch.Tensor:
    """In place: the largest value of ``tensor`` over ``axis``, elementwise."""
    if _active(axis):
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=axis.group)
    return tensor


def all_reduce_many_(tensors: Sequence[torch.Tensor], axis, mean: bool = False) -> None:
    """In place, each of ``tensors`` (of one dtype and device) summed (or
    averaged) over ``axis``, through one flat buffer: one collective."""
    if not _active(axis) or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, axis, mean)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def gather(tensor: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The ranks' ``tensor`` (of one shape) concatenated along ``dim`` in the
    order of their index on ``axis``; no gradient."""
    if not _active(axis):
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(axis.size)]
    dist.all_gather(parts, tensor.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_mean(tensor: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` (``axis.size`` contiguous chunks) of
    the mean of ``tensor`` over ``axis``."""
    if not _active(axis):
        return tensor
    if _nccl(axis):
        parts = [c.contiguous() for c in tensor.chunk(axis.size, dim=dim)]
        out = torch.empty_like(parts[axis.index])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.AVG, group=axis.group)
        return out
    total = all_reduce_(tensor.clone(), axis, mean=True)
    return total.chunk(axis.size, dim=dim)[axis.index].contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis):
        ctx.axis = axis
        return all_reduce_(tensor.clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.axis), None


def all_reduce_sum(tensor: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``tensor`` over ``axis``; its backward sums the ranks'
    gradients (every rank's loss reads the sum)."""
    return _AllReduceSum.apply(tensor, axis) if _active(axis) else tensor


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis):
        ctx.axis = axis
        parts = [torch.empty_like(tensor) for _ in range(axis.size)]
        dist.all_gather(parts, tensor.contiguous(), group=axis.group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.axis)[ctx.axis.index], None


def all_gather(tensor: torch.Tensor, axis) -> torch.Tensor:
    """The ranks' ``tensor`` stacked on a new dim 0, in the order of their
    index on ``axis``; the gradient of slot i goes, summed over the ranks,
    to rank i's ``tensor``."""
    if not _active(axis):
        return tensor[None]
    return _AllGather.apply(tensor, axis)


class _ScatterChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return tensor.chunk(axis.size, dim=dim)[axis.index].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather(grad.contiguous(), ctx.axis, ctx.dim), None, None


def scatter_chunks(tensor: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a ``tensor`` that every rank of
    ``axis`` holds whole; the backward gathers the chunks' gradients, so
    that every rank has the whole tensor's."""
    return _ScatterChunks.apply(tensor, axis, dim) if _active(axis) else tensor


class _GatherChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return gather(tensor, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.axis.size, dim=ctx.dim)[ctx.axis.index].contiguous(), None, None


def gather_chunks(tensor: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ranks' chunks concatenated along ``dim``: a whole tensor on every
    rank, whose gradient (the same on every rank) goes back by chunk."""
    return _GatherChunks.apply(tensor, axis, dim) if _active(axis) else tensor


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, axis):
        ctx.axis = axis
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.axis), None


def copy_to_axis(tensor: torch.Tensor, axis) -> torch.Tensor:
    """``tensor`` as it is; its gradient is the sum of the ranks' (each rank
    uses the whole tensor on its own part of the work)."""
    return _CopyToAxis.apply(tensor, axis) if _active(axis) else tensor
