"""Overlap-blend stitching of tiled predictions into a city mosaic (host).

The port's copy of ``srbh_tpu/predict/stitcher.py:MosaicAccumulator``, twin
of the canvas accumulation in predict_realesanet_feature_globe.py:156-209:
height predictions (clamped, x10 decimetre uint16) and per-class build
softmax (x255, uint8 or uint16) are summed into full-resolution canvases
together with an overlap counter; the mosaic divides by the counter at the
end and the build canvas argmaxes to a class map.

The sums are int64 (no uint16 overflow mid-sum), and the final
``round(sum / weight) -> uint16`` is the reference's. Each tile is added as
one slice of each canvas, in numpy (the JAX package's C++ blender is not
used).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class MosaicAccumulator:
    def __init__(self, width: int, height: int, n_classes: int, upscale: int = 4):
        self.upscale = upscale
        self.w = width * upscale
        self.h = height * upscale
        self.height_sum = np.zeros((self.h, self.w), np.int64)
        self.build_sum = np.zeros((n_classes, self.h, self.w), np.int64)
        self.weight = np.zeros((self.h, self.w), np.uint16)

    def add_batch(self, height_u16: np.ndarray, build_u16: np.ndarray,
                  pos: np.ndarray):
        """height (N, T, T) uint16; build (N, T, T, C) uint8 or uint16;
        pos (N, 4) [xoff, yoff, xcount, ycount] in source pixels. Only the
        first ``ycount x upscale`` rows and ``xcount x upscale`` columns of
        a tile are added."""
        s = self.upscale
        for i in range(height_u16.shape[0]):
            xoff, yoff, xc, yc = (int(v) * s for v in pos[i])
            rows, cols = slice(yoff, yoff + yc), slice(xoff, xoff + xc)
            self.height_sum[rows, cols] += height_u16[i, :yc, :xc]
            self.build_sum[:, rows, cols] += \
                build_u16[i, :yc, :xc].transpose(2, 0, 1)
            self.weight[rows, cols] += np.uint16(1)

    def finalize(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(height uint16 decimetres, build class uint8, weight uint16)."""
        build_cls = np.argmax(self.build_sum, axis=0).astype(np.uint8)
        mask = self.weight > 0
        height = np.zeros((self.h, self.w), np.uint16)
        height[mask] = np.round(
            self.height_sum[mask] / self.weight[mask]).astype(np.uint16)
        return height, build_cls, self.weight.copy()
