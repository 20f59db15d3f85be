"""Legacy sliding-window whole-image prediction helpers.

Twin of utils/predimg_func.py:8-127 (``predict_whole_image_over{,2,3}``): run
a tile predictor over a stride grid covering the whole raster, accumulate
overlapping outputs with a hit-count canvas, divide at the end. The
reference notes its own bug ("weight zeros instead of ones",
utils/predimg_func.py:5) — the count canvas here is correct.

The port's copy of ``srbh_tpu/predict/sliding.py`` (numpy). Every window is
exactly ``grid`` x ``grid`` (the right/bottom edges re-anchor at
``size - grid``, like the fishnet boundary cells).
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def window_anchors(size: int, grid: int, stride: int):
    """Start offsets covering [0, size) with a final snapped-to-edge window."""
    if size < grid:
        raise ValueError(
            f"image extent {size} is smaller than the window {grid}; pad the "
            "input (the reference's whole-image loaders symmetric-pad, "
            "BH_loader.py:795-801) or reduce the window")
    anchors = list(range(0, size - grid, stride))
    anchors.append(size - grid)
    return anchors


def predict_whole_image(
    image: np.ndarray,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    grid: int = 64,
    stride: int = 60,
    out_scale: int = 1,
    out_channels: int = 1,
    batch_size: int = 16,
) -> np.ndarray:
    """(H, W, C) image -> (H*s, W*s, out_channels) blended prediction.

    ``predict_fn``: (N, grid, grid, C) -> (N, grid*s, grid*s, out_channels).
    """
    h, w = image.shape[:2]
    ys = window_anchors(h, grid, stride)
    xs = window_anchors(w, grid, stride)
    positions = [(y, x) for y in ys for x in xs]

    acc = np.zeros((h * out_scale, w * out_scale, out_channels), np.float64)
    cnt = np.zeros((h * out_scale, w * out_scale, 1), np.float64)
    s = out_scale
    for start in range(0, len(positions), batch_size):
        chunk = positions[start: start + batch_size]
        batch = np.stack([image[y: y + grid, x: x + grid] for y, x in chunk])
        preds = np.asarray(predict_fn(batch))
        for (y, x), pred in zip(chunk, preds):
            acc[y * s: (y + grid) * s, x * s: (x + grid) * s] += pred
            cnt[y * s: (y + grid) * s, x * s: (x + grid) * s] += 1.0
    return (acc / np.maximum(cnt, 1.0)).astype(np.float32)
