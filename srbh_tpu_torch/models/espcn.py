"""ESPCN, the efficient sub-pixel convolution SR network (NCHW).

Counterpart of ``srbh_tpu/models/espcn.py`` (the reference's ``ESPC``,
SR/espcn.py:9-23): 5x5, 3x3 and 3x3 convs, tanh after the first two, then a
pixel shuffle by ``upscale_factor``. Names ``conv1``, ``conv2``, ``conv3``.
"""
from __future__ import annotations

import torch
from torch import nn

from srbh_tpu_torch.models.layers import tconv
from srbh_tpu_torch.ops.shuffle import pixel_shuffle


class ESPCN(nn.Module):
    def __init__(self, upscale_factor: int = 4, in_channels: int = 3,
                 out_channels: int = 3):
        super().__init__()
        self.upscale_factor = upscale_factor
        r = upscale_factor
        self.conv1 = tconv(in_channels, 64, 5)
        self.conv2 = tconv(64, 32, 3)
        self.conv3 = tconv(32, out_channels * r * r, 3)

    def forward(self, x):
        x = torch.tanh(self.conv1(x))
        x = torch.tanh(self.conv2(x))
        return pixel_shuffle(self.conv3(x), self.upscale_factor)
