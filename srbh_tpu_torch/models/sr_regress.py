"""The trainable-SR height models, the reference's earlier ablations (NCHW).

Counterparts of ``srbh_tpu/models/sr_regress.py`` (mymodels.py):

* :class:`SRRegress` (:16-26): EDSR x4, then an EfficientNet U-Net that
  regresses height at the SR resolution;
* :class:`SRRegressClsEDSR` (:29-68): an EDSR feature branch (also mapped
  to a 3-channel SR image by ``super_out``), two U-Net decoders with 3x3
  heads at the SR resolution; returns (sr, height, build);
* :class:`SRRegressClsDecision` (:181-228): an ``EDSR(return_features=
  "hr")`` branch over the first ``super_in`` channels, whose HR features
  fuse with the decoders through :class:`HRFuseX2`; returns (sr, height,
  build).

Names: ``super_res.*`` (:mod:`srbh_tpu_torch.models.edsr`'s), ``encoder.*``
(efficientnet-pytorch's), ``decoder*.blocks.*`` (smp's), and the heads by
their JAX attribute names (``head``, ``super_out``, ``seg1``, ``seg2``).
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from srbh_tpu_torch.models.edsr import EDSR
from srbh_tpu_torch.models.efficientnet import DROP_CONNECT_RATE
from srbh_tpu_torch.models.height_model import (
    DECODER_CHANNELS,
    IN_CHANNELS,
    UPSCALE,
    _trunk,
)
from srbh_tpu_torch.models.hrfuse import HRFuseX2
from srbh_tpu_torch.models.layers import tconv


class SRRegress(nn.Module):
    def __init__(self, encoder_name: str = "efficientnet-b4",
                 in_chans: int = IN_CHANNELS, super_channels: int = 4,
                 classes: int = 1,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        self.super_res = EDSR(in_chans, n_out=super_channels)
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate,
                     super_channels, decoders=("decoder",))
        self.head = tconv(mid, classes, 3)

    def forward(self, x, generator=None):
        feats = self.encoder(self.super_res(x), generator)
        return self.head(self.decoder(*feats))


class SRRegressClsEDSR(nn.Module):
    def __init__(self, encoder_name: str = "efficientnet-b4",
                 in_chans: int = IN_CHANNELS, super_channels: int = 4,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        self.super_res = EDSR(in_chans, n_out=super_channels)
        self.super_out = tconv(super_channels, 3, 3)
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate,
                     super_channels)
        self.seg1 = tconv(mid, 1, 3)
        self.seg2 = tconv(mid, 2, 3)

    def forward(self, x, generator=None):
        fea = self.super_res(x)
        feats = self.encoder(fea, generator)
        return (self.super_out(fea), self.seg1(self.decoder1(*feats)),
                self.seg2(self.decoder2(*feats)))


class SRRegressClsDecision(nn.Module):
    def __init__(self, encoder_name: str = "efficientnet-b4",
                 in_chans: int = IN_CHANNELS, super_in: int = 4,
                 super_mid: int = 64,
                 decoder_channels: Sequence[int] = DECODER_CHANNELS,
                 drop_connect_rate: float = DROP_CONNECT_RATE):
        super().__init__()
        self.super_in = super_in
        self.super_res = EDSR(super_in, n_feats=super_mid, n_out=3,
                              return_features="hr")
        mid = _trunk(self, encoder_name, decoder_channels, drop_connect_rate,
                     in_chans)
        self.seg1 = HRFuseX2(super_mid, mid, 1, UPSCALE)
        self.seg2 = HRFuseX2(super_mid, mid, 2, UPSCALE)

    def forward(self, x, generator=None):
        sup_out, sup_fea = self.super_res(x[:, :self.super_in])
        feats = self.encoder(x, generator)
        return (sup_out, self.seg1(self.decoder1(*feats), sup_fea),
                self.seg2(self.decoder2(*feats), sup_fea))
