"""SwinIR test harness: task presets, window padding and tiled inference.

Counterpart of ``srbh_tpu/tools/swinir_harness.py`` (SR/main_test_swinir.py)
for ``define_model``, ``setup``, ``pad_to_window_multiple`` and
``tiled_inference``, plus :func:`apply`, the NHWC forward those take. The
harness's image file I/O, its metrics and its ``main`` are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.models.layers import init_weights
from srbh_tpu_torch.models.swinir import SwinIR

TASKS = ("classical_sr", "lightweight_sr", "real_sr", "gray_dn", "color_dn",
         "jpeg_car", "color_jpeg_car")


def _preset(task: str, scale: int, large_model: bool) -> dict:
    """SwinIR arguments per task (SR/main_test_swinir.py:128-192)."""
    base = dict(depths=(6,) * 6, num_heads=(6,) * 6, embed_dim=180,
                window_size=8, mlp_ratio=2, img_range=1.0,
                resi_connection="1conv")
    if task == "classical_sr":
        return dict(base, upscale=scale, in_chans=3, upsampler="pixelshuffle")
    if task == "lightweight_sr":
        return dict(base, upscale=scale, in_chans=3, embed_dim=60,
                    depths=(6,) * 4, num_heads=(6,) * 4,
                    upsampler="pixelshuffledirect")
    if task == "real_sr":
        if large_model:
            return dict(base, upscale=scale, in_chans=3, embed_dim=240,
                        depths=(6,) * 9, num_heads=(8,) * 9,
                        upsampler="nearest+conv", resi_connection="3conv")
        return dict(base, upscale=scale, in_chans=3, upsampler="nearest+conv")
    if task in ("gray_dn", "color_dn"):
        chans = 1 if task == "gray_dn" else 3
        return dict(base, upscale=1, in_chans=chans, out_chans=chans,
                    upsampler="")
    if task in ("jpeg_car", "color_jpeg_car"):
        chans = 1 if task == "jpeg_car" else 3
        return dict(base, upscale=1, in_chans=chans, out_chans=chans,
                    window_size=7, img_range=255.0, upsampler="")
    raise ValueError(f"unknown task {task!r}")


def define_model(task: str, scale: int = 1, large_model: bool = False,
                 device=None, seed: int = 0) -> SwinIR:
    """The task's SwinIR preset with seeded random weights, in eval mode on
    ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    model = SwinIR(**_preset(task, scale, large_model))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)


def apply(model: SwinIR, x) -> torch.Tensor:
    """Run ``model`` on an NHWC image batch (array or tensor) on the model's
    device under ``torch.inference_mode()``; returns NHWC."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)
    with torch.inference_mode():
        return model(x).permute(0, 2, 3, 1)


def setup(task: str, scale: int = 1) -> Tuple[int, int]:
    """(crop border, window size) per task (SR/main_test_swinir.py:195-226)."""
    if task in ("classical_sr", "lightweight_sr"):
        return scale, 8
    if task in ("real_sr", "gray_dn", "color_dn"):
        return 0, 8
    if task in ("jpeg_car", "color_jpeg_car"):
        return 0, 7
    raise ValueError(task)


def pad_to_window_multiple(img: np.ndarray, window_size: int) -> np.ndarray:
    """Flip-concat padding to the NEXT window multiple
    (SR/main_test_swinir.py:100-110 — always pads at least one window)."""
    h, w = img.shape[:2]
    h_pad = (h // window_size + 1) * window_size - h
    w_pad = (w // window_size + 1) * window_size - w
    img = np.concatenate([img, img[::-1]], axis=0)[: h + h_pad]
    img = np.concatenate([img, img[:, ::-1]], axis=1)[:, : w + w_pad]
    return img


def tiled_inference(apply_fn: Callable, img_lq: np.ndarray, scale: int,
                    tile: Optional[int] = None, tile_overlap: int = 32,
                    window_size: int = 8) -> np.ndarray:
    """Whole-image or overlap-average tiled inference
    (SR/main_test_swinir.py:278-306). ``apply_fn`` maps an NHWC
    (1,H,W,C) array to a (1,sH,sW,C) tensor, as :func:`apply` does."""
    def run(patch):
        return apply_fn(patch).float().cpu().numpy()[0]

    x = img_lq[None]
    if tile is None:
        return run(x)
    h, w = x.shape[1:3]
    tile = min(tile, h, w)
    if tile % window_size != 0:
        raise ValueError("tile size must be a multiple of window_size")
    stride = tile - tile_overlap
    h_idx = list(range(0, h - tile, stride)) + [h - tile]
    w_idx = list(range(0, w - tile, stride)) + [w - tile]
    E = np.zeros((h * scale, w * scale, x.shape[3]), np.float32)
    W = np.zeros_like(E)
    for hi in h_idx:
        for wi in w_idx:
            out = run(np.ascontiguousarray(x[:, hi: hi + tile, wi: wi + tile]))
            E[hi * scale: (hi + tile) * scale,
              wi * scale: (wi + tile) * scale] += out
            W[hi * scale: (hi + tile) * scale,
              wi * scale: (wi + tile) * scale] += 1
    return E / W
