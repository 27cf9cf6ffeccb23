"""Collectives and the output-channel-parallel pair f and g.

The collectives are `torch.distributed` calls over a group: NCCL where
each rank has its own GPU, gloo on the CPU and where ranks share one GPU
(NCCL refuses two ranks on one device). Gloo takes CUDA tensors for every
collective used here (all-reduce, all-gather, all-gather-object, measured
on an H100 with torch 2.11), so no tensor is staged through the host by
this module. A group of None is one rank: every collective is then the
identity.

f and g wrap a layer whose output channels are split over the model axis
(`mesh.shard_model`), as in Megatron's column-parallel linear:

  f: identity forward, all-reduce backward. It sits in front of the split
     layer: each model rank's slice gives only its part of dL/dx, and the
     replicated layers below need the sum.
  g: all-gather forward along the channel axis, after the split layer. Its
     backward takes this rank's slice of the incoming gradient, with no
     reduction: every model rank computes the same loss from the gathered
     output, so each already holds the whole gradient, and summing it over
     the group (the backward of `torch.distributed.nn.functional.
     all_gather`, a reduce-scatter) would scale the slice's gradient by the
     model axis's size.
"""

from __future__ import annotations

import torch


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """x reduced over `group`, in place; returns x."""
    if group is None:
        return x
    import torch.distributed as dist

    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors, in rank order, concatenated along `dim`."""
    if group is None:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    """f: identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """g: the model group's slices gathered along `dim`; backward, this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, rank, dim):
        ctx.rank, ctx.dim, ctx.k = rank, dim, y.shape[dim]
        return all_gather(y, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def gather_from_model(y: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(y, mesh.model_group, mesh.m, dim % y.dim())
