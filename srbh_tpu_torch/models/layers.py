"""Shared building blocks (NCHW), counterparts of ``srbh_tpu/models/layers.py``
in their literal form.

* ``tconv`` pads ``k//2`` on both sides, as ``nn.Conv2d(padding=k//2)``.
* ``TorchBatchNorm`` takes the flax momentum of the JAX package and returns an
  ``nn.BatchNorm2d`` with torch momentum ``1 - momentum``.
* Module and parameter names are the reference's torch names, so reference
  state dicts load by name.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from srbh_tpu_torch.ops.shuffle import pixel_shuffle


def tconv(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
          bias: bool = True) -> nn.Conv2d:
    """Conv with torch padding semantics (``k//2`` both sides)."""
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride, kernel_size // 2,
                     bias=bias)


def TorchBatchNorm(num_features: int, momentum: float = 0.9,
                   eps: float = 1e-5) -> nn.BatchNorm2d:
    """BatchNorm2d from the JAX package's flax-convention momentum."""
    return nn.BatchNorm2d(num_features, eps=eps, momentum=1.0 - momentum)


class ConvBNAct(nn.Sequential):
    """Conv3x3 -> BatchNorm -> ReLU; children ``0`` (conv) and ``1`` (bn) are
    smp's ``Conv2dReLU`` names."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            tconv(in_ch, out_ch, 3, bias=False),
            TorchBatchNorm(out_ch),
            nn.ReLU(),
        )


class BasicBlock(nn.Module):
    """ResNet-v1 basic block with a 1x1 projection shortcut when the stride
    or the width changes (SR/HRfuse.py:115-159 naming: conv1/bn1/conv2/bn2/
    downsample.{0,1})."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = tconv(in_ch, planes, 3, stride, bias=False)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = tconv(planes, planes, 3, 1, bias=False)
        self.bn2 = TorchBatchNorm(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(
                tconv(in_ch, planes, 1, stride, bias=False),
                TorchBatchNorm(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class PixelShuffle(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return pixel_shuffle(x, self.scale)


class PixelShuffleUpsampler(nn.Sequential):
    """Conv + depth-to-space ladder: x2 per octave for power-of-two scales, a
    single x3 step for scale 3. Convs sit at even indices (``{2k}``)."""

    def __init__(self, scale: int, n_feats: int):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [tconv(n_feats, 4 * n_feats, 3), PixelShuffle(2)]
        elif scale == 3:
            layers += [tconv(n_feats, 9 * n_feats, 3), PixelShuffle(3)]
        else:
            raise NotImplementedError(f"scale {scale}")
        super().__init__(*layers)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init, drawn on the generator's device (a CPU generator
    gives every device the same weights; a CUDA one builds a large model in
    place on the card): conv and linear weights U(+-1/sqrt(fan_in))
    (torch's default scale), biases 0, norms scale 1 / shift 0, BN running
    stats 0 / 1. Other parameters (SwinIR's relative-position tables, the
    CLIP towers' embeddings) N(0, 0.02) clipped to 2 std. Returns
    ``module``."""
    dev = generator.device
    done = set()
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = m.weight[0].numel() ** -0.5
            m.weight.copy_(torch.empty(m.weight.shape, device=dev).uniform_(
                -bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in done:
            p.copy_(torch.empty(p.shape, device=dev).normal_(
                0.0, 0.02, generator=generator).clamp_(-0.04, 0.04))
    return module
