"""GPipe pipeline parallelism over the ``model`` dim of the mesh.

Counterpart of ``srbh_tpu/parallel/pipeline.py``: the RRDBNet trunk's body
(``num_block`` structurally identical RRDBs) splits into ``S`` contiguous
stages, one a rank of the model group, and microbatches stream through
them. The JAX form runs the schedule as one ``lax.scan`` of ``ppermute``
hand-offs and lets JAX transpose it; here the schedule is written out:

* forward: for each microbatch in turn, stage 0 reads it, every later
  stage receives the activation from the stage before (``recv``), runs its
  blocks and sends the result on (``send``); the last stage collects the
  outputs, which are then broadcast to every rank of the group (the JAX
  form's final ``psum``);
* backward (an ``autograd.Function``): the ranks' output gradients are
  averaged (every rank holds the replicated output, and the gradient is
  that of the ranks' mean loss), then the microbatches go back through the
  stages in reverse, each stage receiving its output's gradient from the
  next, running its blocks' backward (which accumulates its parameters'
  gradients in ``.grad``) and sending its input's gradient to the one
  before; stage 0's input gradients are broadcast to every rank.

GPipe's bubble is ``(S - 1) / (S - 1 + M)`` of the ticks. The stage's
blocks' gradients reach ``.grad`` as the backward runs (as in activation
checkpointing), so take them with ``loss.backward()``, not
``torch.autograd.grad``.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from srbh_tpu_torch.parallel.collectives import rank, world
from srbh_tpu_torch.parallel.mesh import MODEL_AXIS


def _peer(group, r: int) -> int:
    return dist.get_global_rank(group, r)


def _buffer(like: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor to receive ``like``'s shape into."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _forward(run, group, mbs, keep):
    """The forward schedule; returns (outputs on every rank, the stage's
    (input, output) pairs when ``keep``)."""
    s, n = rank(group), world(group)
    pairs, outs = [], []
    for m in range(mbs.shape[0]):
        if s == 0:
            x = mbs[m]
        else:
            x = _buffer(mbs[m])
            dist.recv(x, _peer(group, s - 1), group=group)
        if keep:
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = run(x)
            pairs.append((x, y))
        else:
            y = run(x)
        if s < n - 1:
            dist.send(y.detach().contiguous(), _peer(group, s + 1), group=group)
        else:
            outs.append(y.detach())
    # the broadcast sends the storage as it lies: contiguous, as the
    # receivers' buffers are (a channels-last stack is not)
    out = torch.stack(outs).contiguous() if s == n - 1 else _buffer(mbs)
    dist.broadcast(out, _peer(group, n - 1), group=group)
    return out, pairs


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, group, mbs, *params):
        out, ctx.pairs = _forward(run, group, mbs, keep=True)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, grad):
        group, pairs = ctx.group, ctx.pairs
        s, n = rank(group), world(group)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        grad /= n
        grads_in = [None] * len(pairs)
        for m in reversed(range(len(pairs))):
            x, y = pairs[m]
            if s == n - 1:
                g = grad[m]
            else:
                g = _buffer(y)
                dist.recv(g, _peer(group, s + 1), group=group)
            torch.autograd.backward(y, g)
            if s > 0:
                dist.send(x.grad.contiguous(), _peer(group, s - 1), group=group)
            else:
                grads_in[m] = x.grad
        g_mbs = (torch.stack(grads_in).contiguous() if s == 0
                 else _buffer(grad))
        dist.broadcast(g_mbs, _peer(group, 0), group=group)
        ctx.pairs = None
        return (None, None, g_mbs) + (None,) * (len(ctx.needs_input_grad) - 3)


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                   mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Run (M, mb, ...) microbatches through ``S`` pipelined stages, ``S``
    the mesh's ``axis`` size; returns the (M, mb, ...) outputs on every
    rank.

    ``stage_fn(local_params, x) -> y`` must keep the shape (the RRDB body
    does); ``stage_params`` holds one entry per stage, a module or a tensor
    (a sequence of them, or a tensor whose leading dim is ``S``), and the
    rank of stage ``s`` runs ``stage_fn(stage_params[s], x)``. The schedule is the module
    docstring's; with gradients on it is differentiable."""
    group = mesh.get_group(axis)
    n = world(group)
    if len(stage_params) != n:
        raise ValueError("stage_params leading dim must equal mesh axis size "
                         f"({len(stage_params)} != {n})")
    local = stage_params[rank(group)]

    def run(x):
        return stage_fn(local, x)

    params = (list(local.parameters()) if isinstance(local, nn.Module)
              else [local])
    if n == 1:
        return torch.stack([run(x) for x in microbatches])
    if torch.is_grad_enabled() and (microbatches.requires_grad or any(
            p.requires_grad for p in params)):
        return _Pipeline.apply(run, group, microbatches, *params)
    return _forward(run, group, microbatches, keep=False)[0]


class _PipelinedBody(nn.Module):
    """An RRDBNet body whose stages run as :func:`pipeline_apply` over the
    mesh's ``axis``, the batch cut into ``m`` microbatches."""

    def __init__(self, stages, mesh, axis: str, m: int):
        super().__init__()
        self.stages = nn.ModuleList(stages)
        self.mesh, self.axis, self.m = mesh, axis, m

    def forward(self, feat):
        mbs = feat.reshape((self.m, feat.shape[0] // self.m)
                           + tuple(feat.shape[1:]))
        out = pipeline_apply(lambda stage, h: stage(h), self.stages, mbs,
                             self.mesh, self.axis)
        return out.reshape(feat.shape)


def rrdb_pipeline_features(sr, x: torch.Tensor, mesh,
                           num_microbatches: Optional[int] = None,
                           axis: str = MODEL_AXIS) -> torch.Tensor:
    """``sr(x, features_only=True)`` (an RRDBNet on NCHW ``x``) with its
    RRDB body pipelined over the mesh's ``axis``: the head and the tail run
    on every rank; stage ``s`` runs RRDBs ``[s * B / S, (s + 1) * B / S)``.
    ``num_microbatches`` defaults to ``S``. Raises when ``num_block`` or the
    batch does not divide, or for fewer than one microbatch."""
    if getattr(sr, "quantize", False):
        # the JAX package has no pipelined int8 trunk, so nor does the port
        raise NotImplementedError("rrdb_pipeline_features of a quantised "
                                  "RRDBNet: the JAX package refuses it too "
                                  "(srbh_tpu/parallel/pipeline.py:112-119)")
    n = world(mesh.get_group(axis))
    blocks = len(sr.body)
    if blocks % n:
        raise ValueError(f"num_block={blocks} not divisible by {n} stages")
    m = n if num_microbatches is None else num_microbatches
    if m < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {m}")
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} "
                         f"microbatches")
    per = blocks // n
    # sr's own forward over a copy whose body is the pipelined one
    piped = copy.copy(sr)
    piped._modules = dict(sr._modules)
    piped.body = _PipelinedBody(
        [sr.body[s * per:(s + 1) * per] for s in range(n)], mesh, axis, m)
    return piped(x, features_only=True)
