"""The global batch's semantics under data parallelism.

The JAX package computes every reduction of a data-parallel step over the
whole sharded batch (GSPMD; pinned in ``srbh_tpu/train/steps.py:12-20``), so
a DP step equals the single-device step. DDP and FSDP2 average the ranks'
gradients and nothing more; what else couples a batch's rows is here:

* :class:`GlobalBatchNorm2d`: BatchNorm whose training statistics are taken
  over the data group, its running statistics updated with the global
  count as ``nn.BatchNorm2d`` does in one process. Over more than one rank
  it is ``SyncBatchNorm``'s scheme in ops that run on the CPU too: each
  rank's per-channel mean and centred sum of squares (``var_mean``) are
  all-gathered and combined by Chan's parallel formula, the input is
  normalised by one ``batch_norm`` call with the global statistics, and the
  backward all-reduces the two per-channel sums its formula needs (one
  collective each way). Over one rank the global batch is the local one,
  and the module's own BatchNorm runs (cuDNN's on a card): the multi-rank
  form issues ~20 small ops more for each of the flagship's 136
  BatchNorms, and holds a step on one card back on the host
  (``chip_smoke.py`` phase 13 checks and times both).
  :func:`global_batchnorm` turns a model's ``nn.BatchNorm2d`` into it in
  place (parameters, buffers and hooks stay; an FSDP2-wrapped model keeps
  its shards). ``torch.nn.SyncBatchNorm`` refuses CPU tensors, so the CPU
  tests could not use it.
* :class:`BatchRows` and :func:`uniform_rows`: per-sample random draws by
  the sample's global row, so that a rank's rows get the draws the
  single-process step gives them (drop-connect, ``device_aug``).
* :func:`average_gradients`: one flattened all-reduce of a set of
  gradients, divided by the group's size (the GAN step's two networks, the
  height step's log-vars).
* :func:`mean_over`: a metric's mean over the group, without gradient.

For these two ``group=None`` is one process: nothing is reduced.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from srbh_tpu_torch.parallel.collectives import world


class BatchRows(NamedTuple):
    """A generator for the rows ``rank, rank + world, ...`` of a global
    batch (:func:`srbh_tpu_torch.parallel.mesh.shard_batch`'s rows)."""

    generator: torch.Generator
    rank: int
    world: int


def uniform_rows(shape, generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` in float32 whose dim 0 is the batch; with a
    :class:`BatchRows` the whole global batch is drawn and this rank's rows
    kept."""
    if isinstance(generator, BatchRows):
        g, r, n = generator
        full = torch.rand((shape[0] * n, *shape[1:]), generator=g,
                          device=device, dtype=torch.float32)
        return full[r::n]
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


class _Shared:
    """A process group that copies of a module share (``copy.deepcopy``
    cannot copy one)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class _GlobalBatchNorm(torch.autograd.Function):
    """y = (x - mean) * invstd * weight + bias with the data group's mean
    and variance; the running statistics are updated in the forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, group):
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1]
        var, local = torch.var_mean(x, dims, correction=0)
        stats = torch.stack([local, var * n])
        parts = [torch.empty_like(stats) for _ in range(world(group))]
        dist.all_gather(parts, stats, group=group)
        means, m2s = torch.stack(parts).unbind(1)
        count = n * len(parts)
        mean = means.mean(0)
        var = (m2s.sum(0) + n * ((means - mean) ** 2).sum(0)) / count
        if bn.track_running_stats:
            bn.num_batches_tracked.add_(1)
            m = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
                 else bn.momentum)
            bn.running_mean.mul_(1 - m).add_(mean * m)
            bn.running_var.mul_(1 - m).add_(var * (count / (count - 1)) * m)
        invstd = torch.rsqrt(var + bn.eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.count, ctx.eps = group, count, bn.eps
        return torch.nn.functional.batch_norm(x, mean, var, weight, bias,
                                              False, 0.0, bn.eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd = ctx.saved_tensors
        g = g.contiguous()
        # this rank's sum of g and of g * xhat (the weight's gradient)
        _, g_weight, g_bias = torch.ops.aten.native_batch_norm_backward(
            g, x, weight, None, None, mean, invstd, True, ctx.eps,
            [False, True, True])
        sums = torch.stack([g_bias, g_weight])
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xhat = sums / ctx.count
        a = invstd * weight
        k1 = -a * invstd * mean_dy_xhat
        k0 = -a * mean_dy - mean * k1
        shape = (1, -1, 1, 1)
        g_x = torch.addcmul(torch.addcmul(k0.view(shape), x, k1.view(shape)),
                            g, a.view(shape))
        return g_x, g_weight, g_bias, None, None


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` over the data group's global batch in training
    mode (the group :func:`global_batchnorm` set; every rank's batch of one
    size), as it is in eval mode and over one rank. Statistics are
    float32."""

    def forward(self, x):
        group = self.data_group.group
        if not self.training or world(group) == 1:
            return super().forward(x)
        y = _GlobalBatchNorm.apply(x.float(), self.weight, self.bias, self,
                                   group)
        return y.to(x.dtype)


def global_batchnorm(module: nn.Module, group=None) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` of ``module`` a
    :class:`GlobalBatchNorm2d` over ``group``, in place; returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            if not m.affine:
                raise ValueError("the global BatchNorm takes affine ones")
            m.__class__ = GlobalBatchNorm2d
            m.data_group = _Shared(group)
    return module


def average_gradients(params: Iterable[torch.Tensor], group=None) -> None:
    """Replace each parameter's gradient by its mean over the group: one
    all-reduce of the gradients flattened together. Parameters without a
    gradient are left out (alike on every rank)."""
    n = 1 if group is None else world(group)
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def mean_over(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group (detached)."""
    n = 1 if group is None else world(group)
    x = x.detach()
    if n == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / n

