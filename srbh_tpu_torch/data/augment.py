"""Joint image/mask training augmentation, in numpy (no OpenCV).

The port's ``augment_pair_lowres`` of ``srbh_tpu/data/augment.py:79-115``:
the reference's albumentations pipeline (BH_loader.py:17-28), each step
with p=0.5,

* ``Flip``: vertical, horizontal or both (cv2 codes 0 / 1 / -1),
* ``RandomGridShuffle(2, 2)``: the four quadrants permuted,
* ``Rotate(limit=90)``: an angle uniform in [-90, 90] about
  ``(w/2 - 0.5, h/2 - 0.5)`` (``cv2.getRotationMatrix2D``), BORDER_REFLECT_101,
  bilinear for the image and nearest for the mask,

fused with the dataset's x4-nearest-up / x0.25-down of the image. Flips and
shuffles are exact index permutations. The rotation is computed in float32
as the JAX package's float twin does (``srbh_tpu/ops/device_aug.py``), not
with OpenCV's fixed-point weights, so it agrees with cv2 to about 1 % of the
value range (``tests/test_torch_data.py``). The random draws come in the
same order and types as the JAX package's, so a generator ends in the same
state after either. ``augment_lrhr_pair`` does the same for the SR
finetune's LR / HR pairs.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def flip(arr: np.ndarray, d: int) -> np.ndarray:
    """``cv2.flip`` codes on an (H, W, ...) array: 0 reverses the rows, 1
    the columns, -1 both."""
    if d == 0:
        return np.ascontiguousarray(arr[::-1])
    if d == 1:
        return np.ascontiguousarray(arr[:, ::-1])
    return np.ascontiguousarray(arr[::-1, ::-1])


def grid_shuffle_2x2(arr: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Destination quadrant ``dst`` (row-major) takes source quadrant
    ``order[dst]``; with odd H or W the last row/column keeps its values."""
    h, w = arr.shape[:2]
    hh, hw = h // 2, w // 2
    cells = [(0, 0), (0, hw), (hh, 0), (hh, hw)]
    out = arr.copy()
    for dst, src in enumerate(order):
        dy, dx = cells[dst]
        sy, sx = cells[src]
        out[dy: dy + hh, dx: dx + hw] = arr[sy: sy + hh, sx: sx + hw]
    return out


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """OpenCV BORDER_REFLECT_101 index folding (gfedcb|abcdefgh|gfedcba)."""
    if n == 1:
        return np.zeros_like(idx)
    m = 2 * (n - 1)
    idx = np.abs(idx) % m
    return np.minimum(idx, m - idx)


def _source(angle: float, h: int, w: int, ys: np.ndarray, xs: np.ndarray):
    """Source coordinates (float32) of destination pixels (ys, xs) under
    ``cv2.warpAffine(getRotationMatrix2D(c, angle, 1))``: the inverse of a
    rotation about c is its transpose."""
    cy, cx = np.float32(h / 2.0 - 0.5), np.float32(w / 2.0 - 0.5)
    t = angle * (math.pi / 180.0)
    a, b = np.float32(math.cos(t)), np.float32(math.sin(t))
    dx, dy = xs - cx, ys - cy
    return cy + b * dx + a * dy, cx + a * dx - b * dy


def rotate_mask_nearest(mask: np.ndarray, angle: float) -> np.ndarray:
    """Nearest-neighbour rotation of an (H, W) mask, BORDER_REFLECT_101."""
    h, w = mask.shape
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    sy, sx = _source(angle, h, w, ys, xs)
    yi = _reflect101(np.floor(sy + np.float32(0.5)).astype(np.int64), h)
    xi = _reflect101(np.floor(sx + np.float32(0.5)).astype(np.int64), w)
    return mask[yi, xi]


def rotate_image_lowres(img_lr: np.ndarray, angle: float,
                        scale: int = 4) -> np.ndarray:
    """Bilinear rotation (BORDER_REFLECT_101) of the x``scale``
    nearest-replicated (H, W, C) image, sampled back at stride ``scale``.
    The replicated image is never built: each bilinear tap of it is the
    low-res pixel ``index // scale``."""
    h, w = img_lr.shape[:2]
    hh, ww = h * scale, w * scale
    ys = (np.arange(h, dtype=np.float32) * scale)[:, None]
    xs = (np.arange(w, dtype=np.float32) * scale)[None, :]
    sy, sx = _source(angle, hh, ww, ys, xs)
    y0 = np.floor(sy).astype(np.int64)
    x0 = np.floor(sx).astype(np.int64)
    fy = (sy - y0).astype(np.float32)[..., None]
    fx = (sx - x0).astype(np.float32)[..., None]

    def tap(yi, xi):
        return img_lr[_reflect101(yi, hh) // scale, _reflect101(xi, ww) // scale]

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return (top + fy * (bot - top)).astype(img_lr.dtype)


def augment_pair_lowres(rng: np.random.Generator, img_lr: np.ndarray,
                        mask: np.ndarray, scale: int = 4
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Flip, grid shuffle and rotation, each with p=0.5, of the low-res
    image ``img_lr`` (H, W, C) and the hi-res ``mask`` (scale*H, scale*W),
    as the reference applies them to the x4-nearest-upsampled image and the
    mask before sampling the image back by ``[::scale, ::scale]``. Flips and
    shuffles are 4x4-block aligned, so they act on the low-res image
    exactly."""
    if rng.random() < 0.5:
        d = int(rng.integers(-1, 2))
        img_lr, mask = flip(img_lr, d), flip(mask, d)
    if rng.random() < 0.5:
        order = rng.permutation(4)
        img_lr = grid_shuffle_2x2(img_lr, order)
        mask = grid_shuffle_2x2(mask, order)
    if rng.random() < 0.5:
        angle = float(rng.uniform(-90.0, 90.0))
        img_lr = rotate_image_lowres(img_lr, angle, scale)
        mask = rotate_mask_nearest(mask, angle)
    return img_lr, mask


def augment_lrhr_pair(rng: np.random.Generator, lr: np.ndarray, hr: np.ndarray,
                      scale: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """The SR pairs' joint augmentation (``srbh_tpu/data/augment.py:118-147``,
    BH_loader.py:713-736): flip, grid shuffle and rotation, each with
    p=0.5, of the LR image (H, W, C) and the HR image (scale*H, scale*W, C),
    in the JAX package's draw order. Both halves rotate bilinear: the LR in
    the fused low-res form, the HR at full resolution
    (``rotate_image_lowres`` with scale 1)."""
    if rng.random() < 0.5:
        d = int(rng.integers(-1, 2))
        lr, hr = flip(lr, d), flip(hr, d)
    if rng.random() < 0.5:
        order = rng.permutation(4)
        lr, hr = grid_shuffle_2x2(lr, order), grid_shuffle_2x2(hr, order)
    if rng.random() < 0.5:
        angle = float(rng.uniform(-90.0, 90.0))
        lr = rotate_image_lowres(lr, angle, scale)
        hr = rotate_image_lowres(hr, angle, 1)
    return lr, hr


_LUMA = np.asarray([0.2989, 0.587, 0.114], np.float32)  # ITU-R 601
_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# cv2's HSV -> RGB sector table: the (r, g, b) entries of
# (v, v(1-s), v(1-sh), v(1-s(1-h))) for each sextant of the hue
_SECTORS = np.asarray([[0, 3, 1], [2, 0, 1], [1, 0, 3],
                       [1, 2, 0], [3, 1, 0], [0, 1, 2]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a float32 image: H in
    [0, 360), ``S = (V - min) / (V + FLT_EPSILON)``, V the maximum."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = (60.0 / (diff + _FLT_EPSILON).astype(np.float64)).astype(np.float32)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0),
                          (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a float32 image with H
    in degrees: the hue's sextant picks each channel from
    ``(v, v(1-s), v(1-s h), v(1-s(1-h)))``."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.fmod(h * np.float32(6.0 / 360.0), np.float32(6.0))
    h = np.where(h < 0, h + np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, np.float32(0.0), h)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], axis=-1)
    rgb = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)


def color_jitter(rng: np.random.Generator, img01: np.ndarray,
                 brightness=0.5, contrast=0.5, saturation=0.5, hue=0.25,
                 p=0.8) -> np.ndarray:
    """The reference's strong augmentation of a [0, 1] RGB image
    (BH_loader.py:24-28; ``srbh_tpu/data/augment.py:153``): with
    probability ``p``, factors drawn from [max(0, 1-x), 1+x] (the hue shift
    from [-hue, hue], in turns), the four adjustments in a random order,
    each result clamped to [0, 1]. Contrast blends against the scalar mean
    of the ITU-R 601 gray image, saturation against the per-pixel gray, and
    the hue turns in cv2's float32 HSV. The draws (``random``, four
    ``uniform``, ``permutation(4)``) are the JAX package's."""
    if rng.random() >= p:
        return img01
    b = float(rng.uniform(max(0.0, 1.0 - brightness), 1.0 + brightness))
    c = float(rng.uniform(max(0.0, 1.0 - contrast), 1.0 + contrast))
    s = float(rng.uniform(max(0.0, 1.0 - saturation), 1.0 + saturation))
    hshift = float(rng.uniform(-hue, hue))
    out = img01.astype(np.float32).copy()
    for op in rng.permutation(4):
        if op == 0:
            out = np.clip(out * b, 0.0, 1.0)
        elif op == 1:
            mean = float((out @ _LUMA).mean())
            out = np.clip(c * out + (1.0 - c) * mean, 0.0, 1.0)
        elif op == 2:
            gray = (out @ _LUMA)[..., None]
            out = np.clip(s * out + (1.0 - s) * gray, 0.0, 1.0)
        else:
            hsv = rgb_to_hsv(out)
            hsv[..., 0] = (hsv[..., 0] + hshift * 360.0) % 360.0
            out = np.clip(hsv_to_rgb(hsv), 0.0, 1.0)
    return out
