"""RRDBNet, the (Real-)ESRGAN generator and frozen feature extractor (NCHW).

Counterpart of ``srbh_tpu/models/rrdbnet.py`` in its literal form
(``fused=False``): 23 residual-in-residual dense blocks of 5 growth convs
with LeakyReLU 0.2 and 0.2-scaled residuals, a trunk skip, two nearest-x2 +
conv stages, then ``conv_hr``. ``features_only=True`` returns ``conv_hr``'s
output *without* the LeakyReLU that the image path applies
(SR/rrdbnet_arch.py:225-240). State-dict names are the reference's:
``conv_first``, ``body.{i}.rdb{r}.conv{c}``, ``conv_body``, ``conv_up1/2``,
``conv_hr``, ``conv_last``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srbh_tpu_torch.models.layers import tconv
from srbh_tpu_torch.ops.resize import upsample_nearest
from srbh_tpu_torch.ops.shuffle import pixel_unshuffle


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    """5-conv dense block with a 0.2-scaled residual."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        nf, gc = num_feat, num_grow_ch
        self.conv1 = tconv(nf, gc)
        self.conv2 = tconv(nf + gc, gc)
        self.conv3 = tconv(nf + 2 * gc, gc)
        self.conv4 = tconv(nf + 3 * gc, gc)
        self.conv5 = tconv(nf + 4 * gc, nf)

    def forward(self, x):
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = _lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = _lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    """Residual-in-residual dense block."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """ESRGAN generator, scale 1/2/4 (scale < 4 pixel-unshuffles the input)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32):
        super().__init__()
        self.scale = scale
        self.num_feat = num_feat
        in_ch = num_in_ch * {4: 1, 2: 4, 1: 16}[scale]
        self.conv_first = tconv(in_ch, num_feat)
        self.body = nn.Sequential(
            *[RRDB(num_feat, num_grow_ch) for _ in range(num_block)])
        self.conv_body = tconv(num_feat, num_feat)
        self.conv_up1 = tconv(num_feat, num_feat)
        self.conv_up2 = tconv(num_feat, num_feat)
        self.conv_hr = tconv(num_feat, num_feat)
        self.conv_last = tconv(num_feat, num_out_ch)

    def forward(self, x, features_only: bool = False):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = _lrelu(self.conv_up1(upsample_nearest(feat, 2)))
        feat = _lrelu(self.conv_up2(upsample_nearest(feat, 2)))
        hr = self.conv_hr(feat)
        if features_only:
            return hr
        return self.conv_last(_lrelu(hr))
