"""EfficientNet encoder with U-Net feature taps (NCHW, smp-compatible).

Counterpart of ``srbh_tpu/models/efficientnet.py``: MBConv blocks with
squeeze-excite and swish, TF-SAME padding, BatchNorm eps 1e-3 with flax
momentum 0.99 (torch momentum 0.01), the SE width taken from the block
*input* channels, and taps ``[x, f2, f4, f8, f16, f32]``. Names follow
efficientnet-pytorch: ``_conv_stem``, ``_bn0``, ``_blocks.{n}._expand_conv/
_bn0/_depthwise_conv/_bn1/_se_reduce/_se_expand/_project_conv/_bn2``.

Drop-connect (training mode only) follows ``srbh_tpu/models/efficientnet.py
:115-125``: on identity blocks, one uniform ``u`` per sample, the mask
``floor(keep + u)`` and ``h / keep * mask``, at the block rate
``drop_connect_rate * block_idx / total_blocks``. The draws come from the
``generator`` passed to ``forward`` (the global generator if none is
given); their bits differ from the JAX package's PRNG.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.models.layers import TorchBatchNorm

# (expand_ratio, kernel, stride, base_channels, base_repeats) per stage (B0)
_B0_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

# name -> (width_coefficient, depth_coefficient, dropout)
SCALING = {
    # minimal config for fast CPU tests: 7 blocks, 8-channel floor widths
    "efficientnet-test": (0.1, 0.1, 0.2),
    "efficientnet-b0": (1.0, 1.0, 0.2),
    "efficientnet-b1": (1.0, 1.1, 0.2),
    "efficientnet-b2": (1.1, 1.2, 0.3),
    "efficientnet-b3": (1.2, 1.4, 0.3),
    "efficientnet-b4": (1.4, 1.8, 0.4),
    "efficientnet-b5": (1.6, 2.2, 0.4),
    "efficientnet-b6": (1.8, 2.6, 0.5),
    "efficientnet-b7": (2.0, 3.1, 0.5),
}

# stages (1-based) after which the encoder taps a feature for the decoder
_TAP_STAGES = (2, 3, 5, 7)
# smp / efficientnet-pytorch default, as in the JAX package
DROP_CONNECT_RATE = 0.2
SE_RATIO = 0.25


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    f = filters * width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one spatial axis: the output has
    ``ceil(size / stride)`` pixels and the odd pixel of padding goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with TF-SAME padding computed from the input size
    (efficientnet-pytorch's ``Conv2dStaticSamePadding``; flax ``"SAME"``)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, groups=1):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding=0,
                         groups=groups, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_padding(x.shape[-2], k, s)
        left, right = same_padding(x.shape[-1], k, s)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


def _bn(ch):
    return TorchBatchNorm(ch, momentum=0.99, eps=1e-3)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int, kernel: int,
                 stride: int, drop_rate: float = 0.0):
        super().__init__()
        mid = in_ch * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self._expand_conv = Conv2dSame(in_ch, mid, 1)
            self._bn0 = _bn(mid)
        self._depthwise_conv = Conv2dSame(mid, mid, kernel, stride, groups=mid)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(in_ch * SE_RATIO))  # from the block INPUT width
        self._se_reduce = nn.Conv2d(mid, se_ch, 1)
        self._se_expand = nn.Conv2d(se_ch, mid, 1)
        self._project_conv = Conv2dSame(mid, out_ch, 1)
        self._bn2 = _bn(out_ch)
        self.identity = stride == 1 and in_ch == out_ch
        self.drop_rate = drop_rate

    def forward(self, x, generator=None):
        h = x
        if self.has_expand:
            h = F.silu(self._bn0(self._expand_conv(h)))
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        s = h.mean(dim=(2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        h = h * torch.sigmoid(s)
        h = self._bn2(self._project_conv(h))
        if self.identity:
            if self.training and self.drop_rate > 0.0:
                keep = 1.0 - self.drop_rate
                u = torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                               device=x.device, dtype=torch.float32)
                h = h / keep * torch.floor(keep + u).to(h.dtype)
            h = h + x
        return h


class EfficientNetEncoder(nn.Module):
    """EfficientNet trunk returning smp-style pyramid features
    ``[x, f2, f4, f8, f16, f32]``; B4 widths (C_in, 48, 32, 56, 160, 448)."""

    def __init__(self, model_name: str = "efficientnet-b4",
                 in_channels: int = 8,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        width, depth, _ = SCALING[model_name]
        stem = round_filters(32, width)
        self._conv_stem = Conv2dSame(in_channels, stem, 3, 2)
        self._bn0 = _bn(stem)
        repeats = [round_repeats(r, depth) for *_, r in _B0_STAGES]
        total = sum(repeats)
        blocks = []
        self._taps = []  # block index after which each decoder tap is taken
        ch = stem
        for si, (expand, kernel, stride, base_c, _) in enumerate(_B0_STAGES, 1):
            out_ch = round_filters(base_c, width)
            for bi in range(repeats[si - 1]):
                rate = drop_connect_rate * len(blocks) / total
                blocks.append(MBConv(ch, out_ch, expand, kernel,
                                     stride if bi == 0 else 1, drop_rate=rate))
                ch = out_ch
            if si in _TAP_STAGES:
                self._taps.append(len(blocks) - 1)
        self._blocks = nn.ModuleList(blocks)

    @staticmethod
    def out_channels(model_name: str, in_channels: int) -> Tuple[int, ...]:
        width, _, _ = SCALING[model_name]
        ch = [round_filters(c, width) for _, _, _, c, _ in _B0_STAGES]
        return (in_channels, round_filters(32, width), ch[1], ch[2], ch[4],
                ch[6])

    def forward(self, x, generator=None) -> List[torch.Tensor]:
        feats = [x]
        h = F.silu(self._bn0(self._conv_stem(x)))
        feats.append(h)
        for i, block in enumerate(self._blocks):
            h = block(h, generator)
            if i in self._taps:
                feats.append(h)
        return feats
