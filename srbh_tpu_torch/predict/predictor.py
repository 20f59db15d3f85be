"""The city predictor's per-batch step.

Counterpart of ``srbh_tpu/predict/predictor.py:make_city_step`` (no mesh):
frozen RRDBNet features, the height model, then the post-processing of
predict_realesanet_feature_globe.py:172-177. The sliding-window tiling, the
mosaic stitchers and the GeoTIFF writers around it are not ported yet.
"""
from __future__ import annotations

import contextlib

import torch

from srbh_tpu_torch import resolve_device


def make_city_step(model, sr_model, rgb_idx=(0, 1, 2), dtype=torch.bfloat16,
                   device=None):
    """Batch step: NHWC image (B, 64, 64, 8) -> (uint16 height in decimetres
    (B, 256, 256), uint8 build softmax x 255 (B, 256, 256, C)).

    ``dtype`` is the compute type: for anything but float32 the two models
    run under ``torch.autocast`` in that type (weights stay float32, as the
    JAX package's ``dtype`` keeps its params float32); the post-processing is
    float32. Both models move to ``device`` (``None`` is the card) in eval
    mode, and the step runs under ``torch.inference_mode()``. Outputs stay on
    the device.

    Post-processing as predict/predictor.py:50-56: heights
    ``round(clamp(h, 0) * 10)`` and build maps ``round(softmax * 255)``;
    ``torch.round`` rounds half to even, like ``jnp.round``. The float ->
    uint16 cast is direct (torch supports it on CUDA and on the CPU).
    """
    dev = resolve_device(device)
    model = model.eval().to(dev)
    sr_model = sr_model.eval().to(dev)
    rgb = list(rgb_idx)

    def compute():
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(dev.type, dtype=dtype)

    def step(image):
        x = torch.as_tensor(image, device=dev).permute(0, 3, 1, 2).float()
        with torch.inference_mode():
            with compute():
                fea = sr_model(x[:, rgb], features_only=True)
                outs = model(x, fea)
            height, build = outs[0].float(), outs[1].float()
            h = torch.round(height[:, 0].clamp(min=0) * 10).to(torch.uint16)
            b = torch.round(torch.softmax(build, dim=1) * 255).to(torch.uint8)
            return h, b.permute(0, 2, 3, 1).contiguous()

    return step
