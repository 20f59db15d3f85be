"""HR-feature fusion blocks of the height model (NCHW).

Counterparts of ``srbh_tpu/models/hrfuse.py``:

* :class:`HRFeature` (SR/HRfuse.py:164-169): 3 ResNet basic blocks adapting
  the frozen SR features to the fusion width; names ``{i}.*``.
* :class:`HRFuseResidual` (SR/HRfuse.py:173-190): pixel-shuffle x4 the LR
  decoder features, concatenate the HR features, 3 basic blocks and a 3x3
  head; names ``upsampler.{2k}``, ``fuse.{i}``, ``conv_last``.
* :class:`HRUpsample` (SR/HRfuse.py:193-202): the no-SR ablation's head,
  pixel-shuffle x4 then a 3x3 conv; names ``upsampler.{2k}``,
  ``conv_last``;
* :class:`HRFuse` / :class:`HRFuseX2` (SR/HRfuse.py:47-89): two
  conv-BN-ReLU fuse stages, then (HRFuse) or after (HRFuseX2) the
  pixel-shuffle x4; names ``fuse.{0,1}`` / ``fuse.{3,4}`` (one flat
  Sequential of conv, BN, ReLU, conv, BN, ReLU), ``upsampler.{2k}``,
  ``conv_last``;
* :class:`GeoNet` (SR/HRfuse.py:205-213): 3 basic blocks over the
  lon/lat/alt planes; names ``{i}.*``;
* :class:`RefineResidual` (SR/HRfuse.py:216-228): concatenate, 3 basic
  blocks and a 3x3 head; names ``fuse.{i}``, ``conv_last``.

``HRFeature.forward_packed`` and ``HRFuseResidual.forward_packed`` are the
JAX package's ``packed=True`` forms (``srbh_tpu/models/hrfuse.py:45-92``):
the fusion stack in the space-to-depth domain (``ops/s2d.py``) with the
same parameters, inference only.
"""
from __future__ import annotations

import torch
from torch import nn

from srbh_tpu_torch.models.layers import (
    BasicBlock,
    PixelShuffleUpsampler,
    TorchBatchNorm,
    tconv,
)
from srbh_tpu_torch.ops import s2d


class HRFeature(nn.Sequential):
    def __init__(self, in_chans: int = 64, mid_chans: int = 64,
                 out_chans: int = 64):
        super().__init__(
            BasicBlock(in_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
            BasicBlock(mid_chans, out_chans),
        )

    def forward_packed(self, x):
        """(B, C, H, W) features -> the parity-0 packed adapter output."""
        x = s2d.pack(x)
        for block in self:
            x = block.forward_packed(x)
        return x


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

    def forward_packed(self, x_lr, xp_hr):
        """``x_hr`` as a parity-0 packed tensor (``HRFeature.forward_packed``):
        the upsampler emits packed output, the fusion runs packed, and only
        the head's small output is unpacked."""
        x = torch.cat([self.upsampler(x_lr, packed_output=True), xp_hr], dim=1)
        perm = s2d.concat_perm([x_lr.shape[1], xp_hr.shape[1] // 4])
        x = self.fuse[0].forward_packed(x, kin_perm=perm)
        for block in self.fuse[1:]:
            x = block.forward_packed(x)
        out = s2d.conv3x3_packed(x, 0, self.conv_last.weight,
                                 self.conv_last.bias)
        return s2d.unpack(out, parity=1)


class HRUpsample(nn.Module):
    def __init__(self, in_chans: int, out_chans: int = 3, upscale: int = 4):
        super().__init__()
        self.upsampler = PixelShuffleUpsampler(upscale, in_chans)
        self.conv_last = tconv(in_chans, out_chans, 3)

    def forward(self, x):
        return self.conv_last(self.upsampler(x))


def _fuse_stages(in_chans: int, mid_chans: int) -> nn.Sequential:
    return nn.Sequential(
        tconv(in_chans, mid_chans, 3, bias=False), TorchBatchNorm(mid_chans),
        nn.ReLU(),
        tconv(mid_chans, mid_chans, 3, bias=False), TorchBatchNorm(mid_chans),
        nn.ReLU())


class HRFuse(nn.Module):
    """Fuse, then upsample: ``x_lr`` and ``x_hr`` share one resolution."""

    def __init__(self, in_chans: int, mid_chans: int = 16, out_chans: int = 3,
                 upscale: int = 4):
        super().__init__()
        self.fuse = _fuse_stages(in_chans, mid_chans)
        self.upsampler = PixelShuffleUpsampler(upscale, mid_chans)
        self.conv_last = tconv(mid_chans, out_chans, 3)

    def forward(self, x_lr, x_hr):
        x = self.fuse(torch.cat([x_lr, x_hr], dim=1))
        return self.conv_last(self.upsampler(x))


class HRFuseX2(nn.Module):
    """Upsample ``x_lr`` (``mid_chans`` wide) to ``x_hr``'s size, then
    fuse."""

    def __init__(self, hr_chans: int, mid_chans: int = 16, out_chans: int = 3,
                 upscale: int = 4):
        super().__init__()
        self.upsampler = PixelShuffleUpsampler(upscale, mid_chans)
        self.fuse = _fuse_stages(mid_chans + hr_chans, mid_chans)
        self.conv_last = tconv(mid_chans, out_chans, 3)

    def forward(self, x_lr, x_hr):
        x = torch.cat([self.upsampler(x_lr), x_hr], dim=1)
        return self.conv_last(self.fuse(x))


class GeoNet(nn.Sequential):
    def __init__(self, in_chans: int = 3, mid_chans: int = 16):
        super().__init__(
            BasicBlock(in_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
        )


class RefineResidual(nn.Module):
    def __init__(self, in_chans: int, mid_chans: int = 16, out_chans: int = 3):
        super().__init__()
        self.fuse = nn.Sequential(
            BasicBlock(in_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
            BasicBlock(mid_chans, mid_chans),
        )
        self.conv_last = tconv(mid_chans, out_chans, 3)

    def forward(self, x_lr, x_hr):
        return self.conv_last(self.fuse(torch.cat([x_lr, x_hr], dim=1)))
