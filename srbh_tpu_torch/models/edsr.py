"""EDSR super-resolution network (NCHW).

Counterpart of ``srbh_tpu/models/edsr.py`` (SR/edsr.py:105-324): a head
conv, residual blocks without BatchNorm (residual scaled by ``res_scale``),
a body conv with the global skip, a pixel-shuffle upsampler and a tail conv.
``return_features`` picks the reference's variants: ``None`` returns the SR
image (``EDSR``), ``"lr"`` also the LR body features (``EDSR_fea``), ``"hr"``
also the upsampled features before the tail conv (``EDSR_feaHR``). The
parameters are the same in every mode.

State-dict names are the reference's: ``head.0``, ``body.{i}.body.{0,2}``,
``body.{n_resblocks}`` (the body conv), ``tail.0.{2k}`` (the upsampler's
convs) and ``tail.1``.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from srbh_tpu_torch.models.layers import PixelShuffleUpsampler, tconv


class ResBlock(nn.Module):
    def __init__(self, n_feats: int, res_scale: float = 0.1):
        super().__init__()
        self.res_scale = res_scale
        self.body = nn.Sequential(tconv(n_feats, n_feats, 3), nn.ReLU(),
                                  tconv(n_feats, n_feats, 3))

    def forward(self, x):
        return x + self.body(x) * self.res_scale


class EDSR(nn.Module):
    def __init__(self, in_chans: int = 3, n_resblocks: int = 16,
                 n_feats: int = 128, n_out: int = 3, up_scale: int = 4,
                 res_scale: float = 0.1, return_features: Optional[str] = None):
        super().__init__()
        if return_features not in (None, "lr", "hr"):
            raise ValueError(f"return_features {return_features!r}")
        self.return_features = return_features
        self.head = nn.Sequential(tconv(in_chans, n_feats, 3))
        self.body = nn.Sequential(
            *[ResBlock(n_feats, res_scale) for _ in range(n_resblocks)],
            tconv(n_feats, n_feats, 3))
        self.tail = nn.Sequential(PixelShuffleUpsampler(up_scale, n_feats),
                                  tconv(n_feats, n_out, 3))

    def forward(self, x):
        x = self.head(x)
        res = self.body(x) + x
        up = self.tail[0](res)
        out = self.tail[1](up)
        if self.return_features == "lr":
            return out, res
        if self.return_features == "hr":
            return out, up
        return out
