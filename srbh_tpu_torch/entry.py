"""The flagship inference pipeline, built at full width with seeded weights.

Counterpart of ``__graft_entry__._flagship`` / ``entry``: frozen Real-ESRGAN
RRDBNet-23 features feeding the EfficientNet-B4 U-Net height model (the
configuration trained by the reference, train.py:133-148). No pretrained
weights are in the repository, so weights are random, drawn from ``seed``.
"""
from __future__ import annotations

import functools

import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.models.height_model import SRRegressClsFeature
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.rrdbnet import RRDBNet


def flagship(tile: int = 64, batch: int = 8, tiny: bool = False, device=None,
             seed: int = 0):
    """(model, sr, x): the height model and the RRDBNet in eval mode on
    ``device`` (``None`` is the card), and a zero NHWC image batch
    (batch, tile, tile, 8). ``tiny=True`` is the small test configuration
    (RRDBNet-2 of width 16, ``efficientnet-test``)."""
    dev = resolve_device(device)
    if tiny:
        sr = RRDBNet(num_block=2, num_feat=16, num_grow_ch=8)
        model = SRRegressClsFeature("efficientnet-test", super_mid=8,
                                    isaggre=True, chans_build=7, sr_chans=16)
    else:
        sr = RRDBNet(num_block=23, num_feat=64, num_grow_ch=32)
        model = SRRegressClsFeature("efficientnet-b4", super_mid=16,
                                    isaggre=True, chans_build=7, sr_chans=64)
    gen = torch.Generator().manual_seed(seed)
    init_weights(sr, gen)
    init_weights(model, gen)
    x = torch.zeros((batch, tile, tile, 8), device=dev)
    return model.eval().to(dev), sr.eval().to(dev), x


def forward(model, sr, image):
    """The flagship's float forward on an NHWC (B, 64, 64, 8) batch under
    ``torch.inference_mode()``, with the JAX ``entry``'s output layout:
    height (B, 256, 256), build logits (B, 256, 256, 7) and aggregated
    height (B, 64, 64)."""
    img = image.permute(0, 3, 1, 2)
    with torch.inference_mode():
        fea = sr(img[:, :3], features_only=True)
        height, build, aggre = model(img, fea)
    return height[:, 0], build.permute(0, 2, 3, 1), aggre[:, 0]


def entry(device=None, seed: int = 0):
    """(fn, (x,)): :func:`forward` bound to the full-width flagship, and an
    NHWC (8, 64, 64, 8) example batch."""
    model, sr, x = flagship(tile=64, batch=8, device=device, seed=seed)
    return functools.partial(forward, model, sr), (x,)
