"""Host float64 image-quality metrics: PSNR, SSIM, cPSNR, PSNR-B.

A copy of the host part of ``srbh_tpu/metrics/image.py`` (SR/psnr_ssim.py),
which the port may not import: ``calculate_psnr`` / ``calculate_ssim``
(:163-318; numpy float64, MATLAB's Gaussian-window SSIM, the BT.601
Y-channel option), ``calculate_cpsnr`` (:390-442, PROBA-V's shift and
bias search over 8 pixels) and ``calculate_psnrb``
(SR/util_calculate_psnr_ssim.py:127-218, PSNR with the blocking-effect
factor, the SwinIR harness's JPEG metric). Images are [0, 255] arrays, HWC
or CHW. The
SSIM window is ``ops/usm.py``'s ``cv2_gaussian_kernel``, the same formula as
the JAX package's ``gaussian_kernel_1d``.

The batched ``_pt`` twins (:148-206; the reference's torch functions,
SR/psnr_ssim.py:203-232, 283-318, 443-490) take NCHW tensors in [0, 1] and
run where the tensors lie: ``calculate_psnr_pt`` and ``calculate_ssim_pt``
return one value per image, ``calculate_cpsnr_pt`` one for the batch.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import convolve

from srbh_tpu_torch.ops import ssim as device_ssim
from srbh_tpu_torch.ops.usm import cv2_gaussian_kernel


def reorder_image(img: np.ndarray, input_order: str = "HWC") -> np.ndarray:
    """An HWC view of an 'HWC' or 'CHW' image (SR/psnr_ssim.py:63-87)."""
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order!r}")
    if img.ndim == 2:
        return img[..., None]
    if input_order == "CHW":
        return img.transpose(1, 2, 0)
    return img


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BT.601 BGR -> YCbCr (SR/psnr_ssim.py:90-120) of a uint8 [0, 255] or
    float [0, 1] image."""
    img_type = img.dtype
    x = img.astype(np.float32)
    if img_type == np.uint8:
        x = x / 255.0
    if y_only:
        out = x @ np.asarray([24.966, 128.553, 65.481]) + 16.0
    else:
        out = x @ np.asarray(
            [[24.966, 112.0, -18.214], [128.553, -74.203, -93.786],
             [65.481, -37.797, 112.0]]) + np.asarray([16.0, 128.0, 128.0])
    if img_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(img_type)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """A [0, 255] image's BT.601 Y channel, [0, 255] float
    (SR/psnr_ssim.py:147-160)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)[..., None]
    return img * 255.0


def _prepare(img, img2, crop_border, input_order, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f"Image shapes differ: {img.shape} vs {img2.shape}")
    img = reorder_image(np.asarray(img), input_order)
    img2 = reorder_image(np.asarray(img2), input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img, img2 = to_y_channel(img), to_y_channel(img2)
    return img.astype(np.float64), img2.astype(np.float64)


def calculate_psnr(img, img2, crop_border=0, input_order="HWC",
                   test_y_channel=False, **kwargs) -> float:
    """PSNR of [0, 255] images; inf when they are equal."""
    img, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def _ssim_channel(img: np.ndarray, img2: np.ndarray) -> float:
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    k = cv2_gaussian_kernel(11, 1.5)  # the JAX package's gaussian_kernel_1d
    window = np.outer(k, k)

    def filt(x):  # the filter's VALID region
        return convolve(x, window, mode="nearest")[5:-5, 5:-5]

    mu1, mu2 = filt(img), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(img**2) - mu1_sq
    sigma2_sq = filt(img2**2) - mu2_sq
    sigma12 = filt(img * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def calculate_ssim(img, img2, crop_border=0, input_order="HWC",
                   test_y_channel=False, **kwargs) -> float:
    """SSIM averaged over the channels (SR/psnr_ssim.py:236-285)."""
    img, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    return float(np.mean([_ssim_channel(img[..., i], img2[..., i])
                          for i in range(img.shape[2])]))


def calculate_cpsnr(img, img2, crop_border=0, input_order="HWC",
                    test_y_channel=False, **kwargs) -> float:
    """cPSNR: the best PSNR over +-8 pixel shifts, each with its channels'
    bias corrected."""
    img1, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    max_offset = 8
    h, w = img1.shape[:2]
    ch, cw = h - max_offset, w - max_offset
    best_mse = None
    for ro in range(max_offset + 1):
        for co in range(max_offset + 1):
            a = img1[ro: ro + ch, co: co + cw]
            b = img2[max_offset - ro: max_offset - ro + ch,
                     max_offset - co: max_offset - co + cw].copy()
            b += (a - b).mean(axis=(0, 1), keepdims=True)
            mse = float(np.mean((a - b) ** 2))
            if best_mse is None or mse < best_mse:
                best_mse = mse
    if best_mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / best_mse)


def _prepare_pt(img, img2, crop_border: int, test_y_channel: bool):
    if img.shape != img2.shape:
        raise ValueError(f"Image shapes differ: {img.shape} vs {img2.shape}")
    if crop_border != 0:
        img = img[:, :, crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[:, :, crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img, img2 = device_ssim.rgb_to_y(img), device_ssim.rgb_to_y(img2)
    return img.float(), img2.float()


def calculate_psnr_pt(img, img2, crop_border: int = 0,
                      test_y_channel: bool = False, **kwargs):
    """PSNR of each image, ``10 log10(1 / (mse + 1e-8))``: (N,)."""
    img, img2 = _prepare_pt(img, img2, crop_border, test_y_channel)
    mse = torch.mean((img - img2) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


def calculate_ssim_pt(img, img2, crop_border: int = 0,
                      test_y_channel: bool = False, **kwargs):
    """SSIM of each image, the VALID Gaussian SSIM at the x255 scale: (N,)."""
    img, img2 = _prepare_pt(img, img2, crop_border, test_y_channel)
    return device_ssim.ssim(img * 255.0, img2 * 255.0)


def calculate_cpsnr_pt(img, img2, crop_border: int = 0,
                       test_y_channel: bool = False, **kwargs):
    """cPSNR of the batch: the least whole-batch MSE over the 9x9 grid of
    offsets, each with a whole-batch bias per channel. The reference's quirk
    stays: the inputs are [0, 1] and the numerator is 255^2."""
    img, img2 = _prepare_pt(img, img2, crop_border, test_y_channel)
    max_offset = 8
    h, w = img.shape[2], img.shape[3]
    ch, cw = h - max_offset, w - max_offset
    mses = []
    for ro in range(max_offset + 1):
        for co in range(max_offset + 1):
            a = img[:, :, ro: ro + ch, co: co + cw]
            b = img2[:, :, max_offset - ro: max_offset - ro + ch,
                     max_offset - co: max_offset - co + cw]
            bias = torch.mean(a - b, dim=(0, 2, 3), keepdim=True)
            mses.append(torch.mean(torch.square(a - (b + bias))))
    best = torch.min(torch.stack(mses))
    return 10.0 * torch.log10(255.0 * 255.0 / best)


def _blocking_effect_factor(im: np.ndarray, block_size: int = 8) -> float:
    """Blocking-effect factor of an (H, W) [0, 1] image
    (SR/util_calculate_psnr_ssim.py:127-164): the squared differences across
    8x8 block boundaries against those elsewhere, each over its count of
    edges; a positive excess scaled by ``log2(8) / log2(min(H, W))``, else
    0."""
    h, w = im.shape
    hb = np.arange(block_size - 1, w - 1, block_size)  # boundary columns
    vb = np.arange(block_size - 1, h - 1, block_size)  # boundary rows
    hnb = np.setdiff1d(np.arange(0, w - 1), hb)
    vnb = np.setdiff1d(np.arange(0, h - 1), vb)

    h_block = float(((im[:, hb] - im[:, hb + 1]) ** 2).sum())
    v_block = float(((im[vb, :] - im[vb + 1, :]) ** 2).sum())
    h_nonblock = float(((im[:, hnb] - im[:, hnb + 1]) ** 2).sum())
    v_nonblock = float(((im[vnb, :] - im[vnb + 1, :]) ** 2).sum())

    n_boundary_horiz = h * (w // block_size - 1)
    n_boundary_vert = w * (h // block_size - 1)
    boundary = (h_block + v_block) / (n_boundary_horiz + n_boundary_vert)
    n_nonboundary_horiz = h * (w - 1) - n_boundary_horiz
    n_nonboundary_vert = w * (h - 1) - n_boundary_vert
    nonboundary = (h_nonblock + v_nonblock) / (n_nonboundary_horiz
                                               + n_nonboundary_vert)

    scaler = np.log2(block_size) / np.log2(min(h, w))
    return scaler * (boundary - nonboundary) if boundary > nonboundary else 0.0


def calculate_psnrb(img, img2, crop_border=0, input_order="HWC",
                    test_y_channel=False, **kwargs) -> float:
    """PSNR-B of [0, 255] images, averaged over the channels; the blocking
    factor is the first image's, as the reference measures it."""
    img, img2 = _prepare(img, img2, crop_border, input_order, test_y_channel)
    img, img2 = img / 255.0, img2 / 255.0
    total = 0.0
    for c in range(img.shape[2]):
        mse = np.mean((img[..., c] - img2[..., c]) ** 2)
        bef = _blocking_effect_factor(img[..., c])
        total += 10.0 * np.log10(1.0 / (mse + bef))
    return float(total / img.shape[2])
