"""U-Net decoder matching segmentation_models_pytorch's UnetDecoder.

(N, C, H, W) tensors, in the input's memory format: the upsample and the
concatenation keep it, so a channels-last encoder (the serving step's)
gives a channels-last decoder.

Counterpart of ``srbh_tpu/models/unet_decoder.py``: 5 blocks, no center
block; each block nearest-upsamples x2, concatenates the encoder skip (the
last block has none) and applies two Conv3x3-BN-ReLU stages. Names:
``blocks.{i}.conv{1,2}.{0,1}``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from srbh_tpu_torch.models.layers import ConvBNAct
from srbh_tpu_torch.ops.resize import upsample_nearest


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch + skip_ch, out_ch)
        self.conv2 = ConvBNAct(out_ch, out_ch)

    def forward(self, x, skip=None):
        x = upsample_nearest(x, 2)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    """``encoder_channels`` are the encoder's tap widths
    ``(C_in, f2, f4, f8, f16, f32)``."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # drop input tap; deepest first
        in_chs = [enc[0]] + list(decoder_channels[:-1])
        skip_chs = enc[1:] + [0] * (len(decoder_channels) - len(enc) + 1)
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o)
            for i, s, o in zip(in_chs, skip_chs, decoder_channels))

    def forward(self, *features):
        feats = list(features[1:])[::-1]  # drop input tap; deepest first
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x
