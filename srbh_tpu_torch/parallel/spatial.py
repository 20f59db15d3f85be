"""Row-sharded convolution: the conv analog of sequence parallelism.

Counterpart of ``srbh_tpu/parallel/mesh.py:spatial_sharding``, where GSPMD
partitions every conv of the frozen RRDBNet trunk over image rows and
inserts the halo exchanges. Here each rank of the model group holds a
contiguous band of rows, and :func:`spatial_parallel` gives a copy of a
module whose stride-1 convolutions first exchange ``k // 2`` halo rows
with each neighbour (one all-gather of every rank's edge rows, whose
backward sums the neighbours' gradients of them). The first rank's top
halo and the last rank's bottom halo are zeros: the conv's own padding.
What else the trunk does is local to a band of rows: pointwise
activations, channel concatenations, residual sums, nearest upsampling,
and pixel-unshuffle when the band's height divides.

:func:`split_rows` and :func:`gather_rows` move a whole image to the bands
and back. Convolutions DTensor would shard only on the batch dim, so this
is written by hand.
"""
from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.parallel.collectives import (
    gather_from,
    rank,
    split_to,
    world,
)


def split_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's band of the rows (dim 2) of a replicated NCHW tensor;
    the rows must divide over the group."""
    if x.shape[2] % world(group):
        raise ValueError(f"{x.shape[2]} rows do not divide over "
                         f"{world(group)} ranks")
    return split_to(x, 2, group)


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The whole image (the bands along dim 2) on every rank."""
    return gather_from(x, 2, group)


class HaloConv2d(nn.Module):
    """A stride-1 ``nn.Conv2d`` with symmetric padding ``k // 2`` on a
    band of rows: the halo rows come from the neighbouring ranks."""

    def __init__(self, conv: nn.Conv2d, group=None):
        super().__init__()
        k, p = conv.kernel_size, conv.padding
        if (conv.stride != (1, 1) or conv.dilation != (1, 1)
                or p != (k[0] // 2, k[1] // 2) or k[0] % 2 == 0
                or conv.padding_mode != "zeros"):
            raise ValueError(f"row sharding takes stride-1 convs padded k//2 "
                             f"with zeros; got {conv}")
        self.conv, self.group, self.halo = conv, group, p[0]

    def forward(self, x):
        h, conv, group = self.halo, self.conv, self.group
        if h == 0 or world(group) == 1:
            return conv(x)
        if x.shape[2] < h:
            raise ValueError(f"a band of {x.shape[2]} rows is thinner than "
                             f"the halo of {h}")
        edges = gather_from(torch.cat([x[:, :, :h], x[:, :, -h:]], 2)[None],
                            0, group, sum_grads=True)
        r, n = rank(group), world(group)
        zeros = torch.zeros_like(x[:, :, :h])
        above = edges[r - 1][:, :, h:] if r > 0 else zeros
        below = edges[r + 1][:, :, :h] if r < n - 1 else zeros
        x = torch.cat([above, x, below], 2)
        return F.conv2d(x, conv.weight, conv.bias, 1, (0, conv.padding[1]),
                        1, conv.groups)


def spatial_parallel(module: nn.Module, group=None) -> nn.Module:
    """A copy of ``module`` for row-sharded inputs: each ``nn.Conv2d`` of
    it a :class:`HaloConv2d` over ``group`` (the model group). Its outputs
    are the bands of the whole module's outputs."""
    module = copy.deepcopy(module)
    convs = [(name, m) for name, m in module.named_modules()
             if isinstance(m, nn.Conv2d)]
    for name, conv in convs:
        parent, _, child = name.rpartition(".")
        setattr(module.get_submodule(parent), child, HaloConv2d(conv, group))
    return module
