"""The height model (NCHW), literal form.

Counterpart of ``srbh_tpu/models/height_model.py:SRRegressClsFeature``
(mymodels.py:233-337): an EfficientNet encoder over the 8-channel S2+S1
tile, two U-Net decoders (height / build), an :class:`HRFeature` adapter on
the frozen Real-ESRGAN features, two :class:`HRFuseResidual` heads and an
optional 64x64 ``aggre_height`` 3x3 conv on the height-decoder features.

Outputs are NCHW: height (N, 1, 256, 256), build logits (N, C, 256, 256),
aggregated height (N, 1, 64, 64).
"""
from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from srbh_tpu_torch.models.efficientnet import (
    DROP_CONNECT_RATE,
    EfficientNetEncoder,
)
from srbh_tpu_torch.models.hrfuse import HRFeature, HRFuseResidual
from srbh_tpu_torch.models.layers import tconv
from srbh_tpu_torch.models.unet_decoder import UnetDecoder


IN_CHANNELS = 8  # 6 Sentinel-2 bands + 2 Sentinel-1 bands
DECODER_CHANNELS = (256, 128, 64, 32, 16)
UPSCALE = 4


class SRRegressClsFeature(nn.Module):
    """Frozen-SR-feature fused height + build prediction. ``sr_chans`` is
    the width of the SR features (the RRDBNet's ``num_feat``);
    ``drop_connect_rate`` is the encoder's (training mode only)."""

    def __init__(self, encoder_name: str = "efficientnet-b4",
                 super_mid: int = 16, isaggre: bool = False,
                 chans_build: int = 2, sr_chans: int = 64,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        self.isaggre = isaggre
        self.encoder = EfficientNetEncoder(encoder_name, IN_CHANNELS,
                                           drop_connect_rate)
        enc_ch = EfficientNetEncoder.out_channels(encoder_name, IN_CHANNELS)
        self.decoder1 = UnetDecoder(enc_ch, decoder_channels)
        self.decoder2 = UnetDecoder(enc_ch, decoder_channels)
        self.hrfeat = HRFeature(sr_chans, super_mid, super_mid)
        mid = decoder_channels[-1]
        self.reg = HRFuseResidual(mid, super_mid, mid, 1, UPSCALE)
        self.seg = HRFuseResidual(mid, super_mid, mid, chans_build, UPSCALE)
        if isaggre:
            self.aggre_height = tconv(mid, 1, 3)

    def forward(self, x, super_fea, with_build: bool = True,
                with_aggre: Optional[bool] = None, generator=None):
        """x: (N, 8, 64, 64) normalised S2+S1; super_fea: (N, sr_chans, 256,
        256) frozen RRDBNet features. ``with_build=False, with_aggre=False``
        is the reference's ``forward_unsup``; ``with_build=False`` alone is
        ``forward_nobuild``. ``generator`` draws the encoder's drop-connect
        masks in training mode."""
        with_aggre = self.isaggre if with_aggre is None else (
            with_aggre and self.isaggre)
        feats = self.encoder(x, generator)
        hr = self.hrfeat(super_fea)
        height_fea = self.decoder1(*feats)
        outputs = [self.reg(height_fea, hr)]
        if with_build:
            outputs.append(self.seg(self.decoder2(*feats), hr))
        if with_aggre:
            outputs.append(self.aggre_height(height_fea))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]
