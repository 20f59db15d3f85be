"""Operations and bytes of a forward or a training step, counted from shapes
on the meta device, on the benchmark's own reference modules.

:func:`conv_counts` is a copy of ``srbh_tpu_torch/tools/timing.py:flop_count``
(forward hooks on ``Conv2d`` / ``ConvTranspose2d`` / ``Linear``, 2 operations
per multiply-add), extended with the bytes each layer needs at least: its
input read once, its weight read once and its output written once.
:func:`step_flops` counts every forward and backward operation a step's
algorithm runs with ``torch.utils.flop_counter.FlopCounterMode``.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def conv_counts(module, *inputs, itemsize: int = 4, **kwargs) -> dict:
    """``{"flops", "bytes"}`` of the conv and linear layers of one forward
    of ``module`` on ``inputs`` (meta tensors compute nothing), the bytes
    at ``itemsize`` bytes an element. Element-wise work is not counted."""
    macs = 0
    nbytes = 0

    def count(m, args, out):
        nonlocal macs, nbytes
        x = args[0]
        if isinstance(m, nn.ConvTranspose2d):
            macs += (x.numel() * m.out_channels // m.groups
                     * math.prod(m.kernel_size))
        elif isinstance(m, nn.Conv2d):
            macs += (out.numel() * m.in_channels // m.groups
                     * math.prod(m.kernel_size))
        else:
            macs += out.numel() * m.in_features
        nbytes += itemsize * (x.numel() + m.weight.numel() + out.numel())

    hooks = [m.register_forward_hook(count) for m in module.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        with torch.no_grad():
            module(*inputs, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return {"flops": 2 * macs, "bytes": nbytes}


def step_flops(fn, *args, **kwargs) -> int:
    """Operations of everything ``fn(*args, **kwargs)`` runs, backward
    passes included, as ``FlopCounterMode`` counts them (convolutions and
    matrix products, 2 per multiply-add; a backward's input and weight
    gradients only where autograd asks for them)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())
