"""HR-feature fusion blocks of the height model (NCHW), literal form.

Counterparts of ``srbh_tpu/models/hrfuse.py``:

* :class:`HRFeature` (SR/HRfuse.py:164-169): 3 ResNet basic blocks adapting
  the frozen SR features to the fusion width; names ``{i}.*``.
* :class:`HRFuseResidual` (SR/HRfuse.py:173-190): pixel-shuffle x4 the LR
  decoder features, concatenate the HR features, 3 basic blocks and a 3x3
  head; names ``upsampler.{2k}``, ``fuse.{i}``, ``conv_last``.
"""
from __future__ import annotations

import torch
from torch import nn

from srbh_tpu_torch.models.layers import BasicBlock, PixelShuffleUpsampler, tconv


class HRFeature(nn.Sequential):
    def __init__(self, in_chans: int = 64, mid_chans: int = 64,
                 out_chans: int = 64):
        super().__init__(
            BasicBlock(in_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
            BasicBlock(mid_chans, out_chans),
        )


class HRFuseResidual(nn.Module):
    def __init__(self, lr_chans: int, hr_chans: int, mid_chans: int = 16,
                 out_chans: int = 1, upscale: int = 4):
        super().__init__()
        self.upsampler = PixelShuffleUpsampler(upscale, lr_chans)
        self.fuse = nn.Sequential(
            BasicBlock(lr_chans + hr_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
        )
        self.conv_last = tconv(mid_chans, out_chans, 3)

    def forward(self, x_lr, x_hr):
        x = torch.cat([self.upsampler(x_lr), x_hr], dim=1)
        return self.conv_last(self.fuse(x))
