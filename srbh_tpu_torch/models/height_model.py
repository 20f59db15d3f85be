"""The height models (NCHW), literal form.

Counterparts of ``srbh_tpu/models/height_model.py``:

* :class:`SRRegressClsFeature` (mymodels.py:233-337): an EfficientNet
  encoder over the 8-channel S2+S1 tile, two U-Net decoders (height /
  build), an :class:`HRFeature` adapter on the frozen Real-ESRGAN features,
  two :class:`HRFuseResidual` heads and an optional 64x64 ``aggre_height``
  3x3 conv on the height-decoder features;
* :class:`SRRegressClsNosuper` (mymodels.py:341-409): the no-SR ablation,
  the same encoder and decoders with two :class:`HRUpsample` heads and no
  SR input;
* :class:`SRRegressClsFeatureGeo` (mymodels.py:513-578): a :class:`GeoNet`
  over the lon/lat/alt planes that follow the image channels, its features
  concatenated with both decoder outputs before the heads and the
  aggregation conv;
* :class:`SRRegressClsFeatureRefine` (mymodels.py:582-650): a second-stage
  :class:`RefineResidual` (width 8) over ``cat(height, build)`` and the HR
  features.

Outputs are NCHW: height (N, 1, 256, 256), build logits (N, C, 256, 256),
aggregated height (N, 1, 64, 64).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from srbh_tpu_torch.models.efficientnet import (
    DROP_CONNECT_RATE,
    EfficientNetEncoder,
)
from srbh_tpu_torch.models.hrfuse import (
    GeoNet,
    HRFeature,
    HRFuseResidual,
    HRUpsample,
    RefineResidual,
)
from srbh_tpu_torch.models.layers import tconv
from srbh_tpu_torch.models.unet_decoder import UnetDecoder


IN_CHANNELS = 8  # 6 Sentinel-2 bands + 2 Sentinel-1 bands
DECODER_CHANNELS = (256, 128, 64, 32, 16)
UPSCALE = 4


def _trunk(model: nn.Module, encoder_name: str, decoder_channels,
           drop_connect_rate: float, in_chans: int = IN_CHANNELS,
           decoders=("decoder1", "decoder2")) -> int:
    """The encoder over ``in_chans`` channels and the U-Net decoders the
    height models share; returns the decoders' output width."""
    model.encoder = EfficientNetEncoder(encoder_name, in_chans,
                                        drop_connect_rate)
    enc_ch = EfficientNetEncoder.out_channels(encoder_name, in_chans)
    for name in decoders:
        setattr(model, name, UnetDecoder(enc_ch, decoder_channels))
    return decoder_channels[-1]


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
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate)
        self.hrfeat = HRFeature(sr_chans, super_mid, super_mid)
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


class SRRegressClsNosuper(nn.Module):
    """The no-SR ablation: height + build (+ the 64x64 aggregated height
    with ``isaggre``) from the S2+S1 tile alone. ``generator`` draws the
    encoder's drop-connect masks in training mode."""

    def __init__(self, encoder_name: str = "efficientnet-b4",
                 isaggre: bool = False, chans_build: int = 2,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        self.isaggre = isaggre
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate)
        self.reg = HRUpsample(mid, 1, UPSCALE)
        self.seg = HRUpsample(mid, chans_build, UPSCALE)
        if isaggre:
            self.aggre_height = tconv(mid, 1, 3)

    def forward(self, x, generator=None):
        feats = self.encoder(x, generator)
        height_fea = self.decoder1(*feats)
        outputs = (self.reg(height_fea), self.seg(self.decoder2(*feats)))
        if self.isaggre:
            return outputs + (self.aggre_height(height_fea),)
        return outputs


class SRRegressClsFeatureGeo(nn.Module):
    """:class:`SRRegressClsFeature` with a geo prior: ``x`` holds
    ``in_chans`` image channels, then ``geo_chans`` lon/lat/alt planes
    (``x[:, in_chans:]``). Returns (height, build) or, with ``isaggre``,
    (height, build, aggregated height)."""

    def __init__(self, encoder_name: str = "efficientnet-b4",
                 in_chans: int = IN_CHANNELS, geo_chans: int = 3,
                 super_mid: int = 16, geo_mid: int = 16, isaggre: bool = False,
                 chans_build: int = 2, sr_chans: int = 64,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        self.in_chans, self.isaggre = in_chans, isaggre
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate,
                     in_chans)
        self.hrfeat = HRFeature(sr_chans, super_mid, super_mid)
        self.geoprior = GeoNet(geo_chans, geo_mid)
        self.reg = HRFuseResidual(mid + geo_mid, super_mid, mid, 1, UPSCALE)
        self.seg = HRFuseResidual(mid + geo_mid, super_mid, mid, chans_build,
                                  UPSCALE)
        if isaggre:
            self.aggre_height = tconv(mid + geo_mid, 1, 3)

    def forward(self, x, super_fea, generator=None):
        geo_fea = self.geoprior(x[:, self.in_chans:])
        feats = self.encoder(x[:, :self.in_chans], generator)
        hr = self.hrfeat(super_fea)
        height_fea = torch.cat([self.decoder1(*feats), geo_fea], dim=1)
        build_fea = torch.cat([self.decoder2(*feats), geo_fea], dim=1)
        outputs = (self.reg(height_fea, hr), self.seg(build_fea, hr))
        if self.isaggre:
            return outputs + (self.aggre_height(height_fea),)
        return outputs


class SRRegressClsFeatureRefine(nn.Module):
    """:class:`SRRegressClsFeature` with a refinement stage. Returns
    (height, build, refined) or, with ``isaggre``, (height, build,
    aggregated height, refined)."""

    def __init__(self, encoder_name: str = "efficientnet-b4",
                 super_mid: int = 16, isaggre: bool = False,
                 chans_build: int = 2, sr_chans: int = 64,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        self.isaggre = isaggre
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate)
        self.hrfeat = HRFeature(sr_chans, super_mid, super_mid)
        self.reg = HRFuseResidual(mid, super_mid, mid, 1, UPSCALE)
        self.seg = HRFuseResidual(mid, super_mid, mid, chans_build, UPSCALE)
        self.refine = RefineResidual(1 + chans_build + super_mid, 8, 1)
        if isaggre:
            self.aggre_height = tconv(mid, 1, 3)

    def forward(self, x, super_fea, generator=None):
        feats = self.encoder(x, generator)
        hr = self.hrfeat(super_fea)
        height_fea = self.decoder1(*feats)
        height = self.reg(height_fea, hr)
        build = self.seg(self.decoder2(*feats), hr)
        refined = self.refine(torch.cat([height, build], dim=1), hr)
        if self.isaggre:
            return height, build, self.aggre_height(height_fea), refined
        return height, build, refined
