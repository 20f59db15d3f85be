"""Channel-parallel (tensor-parallel) convolutions and linear layers.

Counterpart of ``srbh_tpu/parallel/mesh.py:shard_params_tp``: there the
parameters get ``tp_param_spec`` shardings over the ``model`` axis and GSPMD
inserts the collectives. DTensor would gather a conv weight sharded on its
output channels back to a whole weight without a word (its conv strategy
shards only the input's batch dim), so the split is written by hand.
:func:`tensor_parallel` gives a copy of a module in which each conv and
linear layer keeps ``1/n`` of its weight on each rank of the model group,
by :func:`~srbh_tpu_torch.parallel.mesh.tp_param_spec`:

* output channels (dim 0; :class:`ColumnParallel`): each rank computes its
  channels from the whole input and the outputs are all-gathered. A
  grouped conv (the depthwise convs) takes its groups' input channels
  only, and needs the groups to divide;
* input channels (dim 1; :class:`RowParallel`), where the outputs do not
  divide (B4's squeeze-excite reduce convs, the one-channel heads): each
  rank convolves its input channels, the partial sums are all-reduced and
  the bias added once;
* neither: the layer stays whole on every rank.

Every rank then holds the same replicated activations between layers;
the collectives' backward passes are Megatron's (``parallel/collectives``).
"""
from __future__ import annotations

import copy

from torch import nn

from srbh_tpu_torch.parallel.collectives import (
    copy_to,
    gather_from,
    rank,
    reduce_from,
    split_to,
    world,
)
from srbh_tpu_torch.parallel.mesh import tp_param_spec


def _slice(n_parts: int, r: int, size: int) -> slice:
    return slice(r * size // n_parts, (r + 1) * size // n_parts)


def _channel_dim(layer: nn.Module) -> int:
    return 1 if isinstance(layer, nn.Conv2d) else -1


class ColumnParallel(nn.Module):
    """A layer with this rank's share of its output channels."""

    def __init__(self, layer: nn.Module, group=None):
        super().__init__()
        n, r = world(group), rank(group)
        local = copy.deepcopy(layer)
        out = _slice(n, r, layer.weight.shape[0])
        local.weight = nn.Parameter(layer.weight.detach()[out].clone(),
                                    layer.weight.requires_grad)
        if layer.bias is not None:
            local.bias = nn.Parameter(layer.bias.detach()[out].clone(),
                                      layer.bias.requires_grad)
        self.grouped = isinstance(layer, nn.Conv2d) and layer.groups > 1
        if isinstance(layer, nn.Conv2d):
            local.out_channels = layer.out_channels // n
            if self.grouped:
                local.groups = layer.groups // n
                local.in_channels = layer.in_channels // n
        else:
            local.out_features = layer.out_features // n
        self.local, self.group, self.dim = local, group, _channel_dim(layer)

    def forward(self, x):
        x = (split_to(x, self.dim, self.group) if self.grouped
             else copy_to(x, self.group))
        return gather_from(self.local(x), self.dim, self.group)


class RowParallel(nn.Module):
    """A layer with this rank's share of its input channels; the bias is
    added after the partial sums are reduced."""

    def __init__(self, layer: nn.Module, group=None):
        super().__init__()
        n, r = world(group), rank(group)
        local = copy.deepcopy(layer)
        cut = _slice(n, r, layer.weight.shape[1])
        local.weight = nn.Parameter(layer.weight.detach()[:, cut].clone(),
                                    layer.weight.requires_grad)
        local.bias = None
        if isinstance(layer, nn.Conv2d):
            local.in_channels = layer.in_channels // n
        else:
            local.in_features = layer.in_features // n
        self.bias = (None if layer.bias is None else nn.Parameter(
            layer.bias.detach().clone(), layer.bias.requires_grad))
        self.local, self.group, self.dim = local, group, _channel_dim(layer)

    def forward(self, x):
        y = reduce_from(self.local(split_to(x, self.dim, self.group)),
                        self.group)
        if self.bias is None:
            return y
        shape = [1] * y.ndim
        shape[self.dim] = -1
        return y + self.bias.view(shape)


def _parallel(layer: nn.Module, n: int, group):
    d = tp_param_spec(layer.weight, n)
    groups = getattr(layer, "groups", 1)
    if d == 0 and (groups == 1 or groups % n == 0):
        return ColumnParallel(layer, group)
    if d == 1 and groups == 1:
        return RowParallel(layer, group)
    return None


def tensor_parallel(module: nn.Module, group=None) -> nn.Module:
    """A copy of ``module`` with every conv and linear layer split over
    ``group`` (the model group) where :func:`tp_param_spec` allows; on
    every rank it computes what ``module`` does."""
    module = copy.deepcopy(module)
    n = world(group)
    if n == 1:
        return module
    layers = [(name, m) for name, m in module.named_modules()
              if isinstance(m, (nn.Conv2d, nn.Linear))]
    for name, layer in layers:
        split = _parallel(layer, n, group)
        if split is not None:
            parent, _, child = name.rpartition(".")
            setattr(module.get_submodule(parent), child, split)
    return module

