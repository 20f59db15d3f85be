"""The height models (NCHW).

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
aggregated height (N, 1, 64, 64), at the default ``upscale`` 4.
:class:`SRRegressClsNosuper` runs at any power-of-two ``upscale`` (or 3), as
the JAX class does. The classes that fuse the frozen RRDBNet features, whose
resolution is always x4 of the tile, refuse any other ``upscale`` when they
are built: the JAX classes take the field and then fail at their first call
(a concatenate of x4 features with x``upscale`` heads).

:class:`SRRegressClsFeature` takes the JAX package's two layout options
(``srbh_tpu/models/height_model.py:43-73``), both off by default and both
with the same parameters: ``compute_mode="packed"`` runs the 256^2 fusion
stack (the adapter and both heads) in the space-to-depth domain
(``ops/s2d.py``), inference only; ``remat=True`` recomputes that stack's
activations in the backward pass (``models.layers.remat``).
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
from srbh_tpu_torch.models.layers import remat as remat_call
from srbh_tpu_torch.models.layers import tconv
from srbh_tpu_torch.models.unet_decoder import UnetDecoder


IN_CHANNELS = 8  # 6 Sentinel-2 bands + 2 Sentinel-1 bands
DECODER_CHANNELS = (256, 128, 64, 32, 16)
UPSCALE = 4  # the frozen RRDBNet features' scale


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


def _fused_upscale(upscale: int, source: str = "frozen RRDBNet") -> int:
    """``upscale`` of a class that fuses x4 SR features: only theirs."""
    if upscale != UPSCALE:
        raise ValueError(f"upscale {upscale}: the {source} features are "
                         f"x{UPSCALE} of the tile, so a model that fuses them "
                         f"runs at x{UPSCALE} only (the JAX class fails at its "
                         "first call with any other)")
    return upscale


class SRRegressClsFeature(nn.Module):
    """Frozen-SR-feature fused height + build prediction. ``sr_chans`` is
    the width of the SR features (the RRDBNet's ``num_feat``);
    ``drop_connect_rate`` is the encoder's (training mode only).
    ``compute_mode`` is ``"literal"`` or ``"packed"`` (eval mode only: the
    packed blocks raise in training mode); ``remat`` recomputes the fusion
    stack in the backward pass."""

    def __init__(self, encoder_name: str = "efficientnet-b4",
                 super_mid: int = 16, isaggre: bool = False,
                 chans_build: int = 2, sr_chans: int = 64,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE,
                 compute_mode: str = "literal", remat: bool = False,
                 upscale: int = UPSCALE):
        super().__init__()
        if compute_mode not in ("literal", "packed"):
            raise ValueError(f"compute_mode {compute_mode!r}: 'literal' or "
                             "'packed'")
        upscale = _fused_upscale(upscale)
        self.compute_mode, self.remat = compute_mode, remat
        self.isaggre = isaggre
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate)
        self.hrfeat = HRFeature(sr_chans, super_mid, super_mid)
        self.reg = HRFuseResidual(mid, super_mid, mid, 1, upscale)
        self.seg = HRFuseResidual(mid, super_mid, mid, chans_build, upscale)
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
        hr = self._fusion(self.hrfeat, super_fea)
        height_fea = self.decoder1(*feats)
        outputs = [self._fusion(self.reg, height_fea, hr)]
        if with_build:
            outputs.append(self._fusion(self.seg, self.decoder2(*feats), hr))
        if with_aggre:
            outputs.append(self.aggre_height(height_fea))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]

    def _fusion(self, module, *args):
        """A module of the 256^2 fusion stack in the model's layout."""
        if self.compute_mode == "packed":
            return module.forward_packed(*args)
        if self.remat:
            return remat_call(module, *args)
        return module(*args)


class SRRegressClsNosuper(nn.Module):
    """The no-SR ablation: height + build at x``upscale`` of the tile (+ the
    aggregated height at the tile's size with ``isaggre``) from the S2+S1
    tile alone. ``generator`` draws the encoder's drop-connect masks in
    training mode."""

    def __init__(self, encoder_name: str = "efficientnet-b4",
                 isaggre: bool = False, chans_build: int = 2,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE,
                 upscale: int = UPSCALE):
        super().__init__()
        self.isaggre = isaggre
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate)
        self.reg = HRUpsample(mid, 1, upscale)
        self.seg = HRUpsample(mid, chans_build, upscale)
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
                 drop_connect_rate: float = DROP_CONNECT_RATE,
                 upscale: int = UPSCALE):
        super().__init__()
        upscale = _fused_upscale(upscale)
        self.in_chans, self.isaggre = in_chans, isaggre
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate,
                     in_chans)
        self.hrfeat = HRFeature(sr_chans, super_mid, super_mid)
        self.geoprior = GeoNet(geo_chans, geo_mid)
        self.reg = HRFuseResidual(mid + geo_mid, super_mid, mid, 1, upscale)
        self.seg = HRFuseResidual(mid + geo_mid, super_mid, mid, chans_build,
                                  upscale)
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
                 drop_connect_rate: float = DROP_CONNECT_RATE,
                 upscale: int = UPSCALE):
        super().__init__()
        upscale = _fused_upscale(upscale)
        self.isaggre = isaggre
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate)
        self.hrfeat = HRFeature(sr_chans, super_mid, super_mid)
        self.reg = HRFuseResidual(mid, super_mid, mid, 1, upscale)
        self.seg = HRFuseResidual(mid, super_mid, mid, chans_build, upscale)
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
