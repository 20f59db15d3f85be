"""SSIM and PSNR on the card (NCHW, float32).

Counterpart of ``srbh_tpu/ops/ssim.py``, the MATLAB-equivalent SSIM of
SR/psnr_ssim.py:321-382: an 11-tap Gaussian window (sigma 1.5), VALID
filtering, C1 = (0.01 * 255)^2 and C2 = (0.03 * 255)^2 on the [0, 255]
scale. The window is separable, so the filter is two depthwise 1-D passes
(``groups=C``): the same sums as the JAX package's 11x11 depthwise conv.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from srbh_tpu_torch.ops.usm import cv2_gaussian_kernel

_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2


def gaussian_kernel_1d(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """``cv2.getGaussianKernel``'s normalised 1-D Gaussian."""
    return cv2_gaussian_kernel(ksize, sigma)


def filter_separable(x: torch.Tensor, ksize: int = 11, sigma: float = 1.5,
                     padding: int = 0) -> torch.Tensor:
    """Depthwise filter of (N, C, H, W) by the outer product of the 1-D
    Gaussian with itself: VALID with ``padding=0``, zero-padded SAME with
    ``padding=ksize // 2``."""
    c = x.shape[1]
    k = torch.tensor(gaussian_kernel_1d(ksize, sigma), dtype=x.dtype,
                     device=x.device)
    x = F.conv2d(x, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1),
                 padding=(padding, 0), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize),
                    padding=(0, padding), groups=c)


def ssim_map(img: torch.Tensor, img2: torch.Tensor, ksize: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM of two (N, C, H, W) images on the [0, 255] scale."""
    filt = lambda t: filter_separable(t, ksize, sigma)  # noqa: E731
    mu1, mu2 = filt(img), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img * img) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img * img2) - mu1_mu2
    cs = (2 * sigma12 + _C2) / (sigma1_sq + sigma2_sq + _C2)
    return ((2 * mu1_mu2 + _C1) / (mu1_sq + mu2_sq + _C1)) * cs


def ssim(img: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of each image: (N,), inputs (N, C, H, W) in [0, 255]."""
    return ssim_map(img, img2).mean(dim=(1, 2, 3))


def psnr(img: torch.Tensor, img2: torch.Tensor,
         max_val: float = 255.0) -> torch.Tensor:
    """PSNR of each image (SR/psnr_ssim.py:208-232, with its +1e-8)."""
    mse = torch.mean((img - img2) ** 2, dim=tuple(range(1, img.ndim)))
    return 10.0 * torch.log10(max_val * max_val / (mse + 1e-8))


def rgb_to_y(img01: torch.Tensor) -> torch.Tensor:
    """BT.601 Y of an (N, 3, H, W) RGB image in [0, 1], as (N, 1, H, W) in
    [0, 1] (``rgb2ycbcr_pt(..., y_only=True)``, SR/psnr_ssim.py:123-144)."""
    w = torch.tensor([65.481, 128.553, 24.966], dtype=img01.dtype,
                     device=img01.device)
    y = torch.einsum("nchw,c->nhw", img01, w) + 16.0
    return (y / 255.0).unsqueeze(1)
