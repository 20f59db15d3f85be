"""Collectives that autograd differentiates.

The JAX package leaves its collectives to GSPMD, which transposes each one
for the backward pass. Here each is an ``autograd.Function`` with the
backward its use needs:

* :func:`all_reduce_sum`: the sum over the group, whose backward sums the
  incoming gradients over the group again. It serves a term that every
  rank's loss holds (the global dice's sums) when the ranks' gradients are
  then averaged (DDP, FSDP): each rank's share comes back ``W`` times, and
  the average divides by ``W``. (The global BatchNorm in
  ``parallel/data.py`` calls the collectives itself.)
* :func:`reduce_from`, :func:`copy_to`, :func:`split_to` and
  :func:`gather_from`: Megatron's four region boundaries for tensor and
  spatial parallelism, where the ranks go on with the same replicated
  values after the boundary (so its backward takes no sum) or with their
  own parts of them (so it sums).

With ``group=None`` each acts on the default process group. Tensors go to
the collectives contiguous; a group of one rank returns its input.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def world(group=None) -> int:
    """The group's size; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in the group; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _sum(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _gather(x, dim, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _chunk(x, dim, group):
    return x.chunk(world(group), dim)[rank(group)].contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sum_grads):
        ctx.dim, ctx.group, ctx.sum_grads = dim, group, sum_grads
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = _sum(g, ctx.group)
        return _chunk(g, ctx.dim, ctx.group), None, None, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group on every rank; its backward sums the
    gradients over the group (``torch.distributed.nn``'s convention)."""
    if world(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def reduce_from(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of the ranks' partial results, which every rank then uses
    alike: the gradient passes back as it is."""
    if world(group) == 1:
        return x
    return _Reduce.apply(x, group)


def copy_to(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is, entering a region where each rank computes its own
    part from it: the backward sums the ranks' gradients of ``x``."""
    if world(group) == 1:
        return x
    return _Copy.apply(x, group)


def split_to(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's chunk of a replicated ``x`` along ``dim`` (equal chunks,
    ``torch.chunk``'s); the backward gathers the chunks' gradients."""
    if world(group) == 1:
        return x
    return _Split.apply(x, dim, group)


def gather_from(x: torch.Tensor, dim: int, group=None,
                sum_grads: bool = False) -> torch.Tensor:
    """The ranks' equal-shaped ``x`` concatenated along ``dim``, on every
    rank. The backward hands each rank the gradient of its own chunk: as
    it is when every rank uses the result alike (``sum_grads=False``),
    summed over the ranks when each uses it its own way (a halo)."""
    if world(group) == 1:
        return x
    return _Gather.apply(x, dim, group, sum_grads)
