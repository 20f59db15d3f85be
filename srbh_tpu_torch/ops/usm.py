"""Unsharp-mask sharpening (USM) of GAN ground truths (NCHW, torch).

Counterpart of ``srbh_tpu/ops/usm.py`` (``USMSharp`` / ``filter2D``,
SR/rrdbnet_arch.py:387-434): a 51-tap Gaussian blur (the
``cv2.getGaussianKernel(51, 0)`` sigma rule), the residual thresholded at
10/255, and a soft-mask blend. The blur is a reflect-padded separable
depthwise convolution: two 1-D passes with ``groups=C``. (The JAX package's
banded-matrix contractions are its TPU form of the same filter.) Torch's
``reflect`` padding needs the padding below each side, so images need sides
above ``ksize // 2`` (26 at 51 taps).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def cv2_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.getGaussianKernel``: sigma <= 0 takes
    0.3 * ((ksize - 1) * 0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    if min(x.shape[-2:]) <= pad:
        raise ValueError(
            f"reflect padding of {pad} needs image sides above {pad}, got "
            f"{tuple(x.shape[-2:])}")
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def filter2d_reflect(x: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Depthwise 2-D filter of (N, C, H, W) with a (k, k) window, reflect
    padded (``filter2D``)."""
    k, c = window.shape[0], x.shape[1]
    w = torch.as_tensor(np.asarray(window), dtype=x.dtype, device=x.device)
    return F.conv2d(_reflect_pad(x, k // 2), w.expand(c, 1, k, k), groups=c)


def separable_filter_reflect(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """The filter of window ``outer(k1d, k1d)``, as a column pass and a row
    pass over the reflect-padded (N, C, H, W) input."""
    k, c = len(k1d), x.shape[1]
    w = torch.as_tensor(np.asarray(k1d), dtype=x.dtype, device=x.device)
    xp = _reflect_pad(x, k // 2)
    xp = F.conv2d(xp, w.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(xp, w.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
              threshold: float = 10.0, sigma: float = 0.0) -> torch.Tensor:
    """USM-sharpen a [0, 1] (N, C, H, W) batch (rrdbnet_arch.py:425-434)."""
    ksize = radius if radius % 2 else radius + 1
    k1d = cv2_gaussian_kernel(ksize, sigma)
    residual = img - separable_filter_reflect(img, k1d)
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = separable_filter_reflect(mask, k1d)
    sharp = (img + weight * residual).clamp(0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img
