"""Overlap-blend stitching of city mosaics on the device.

Counterpart of ``srbh_tpu/predict/device_stitcher.py`` (single device): the
canvases stay on the device as int32 (H, W) height sum, (H, W, C) build sum
and (H, W) weight, at the output resolution; each batch of tiles the model
produced there is added in place, one slice add per tile and canvas, so no
tile leaves the device; ``finalize_mosaic`` computes the mosaic there and
one compact result is copied to the host per city.

The JAX form's ``lax.scan`` with a donated carry and its roll trick for
clamped ``dynamic_slice`` starts have no counterpart: a slice add needs
neither. The windows' positions are host integers (the loader keeps them on
the host), so slicing waits for nothing on the device.

Semantics match :class:`srbh_tpu_torch.predict.stitcher.MosaicAccumulator`
exactly: integer sums, ragged edge windows cut to ``xcount / ycount``,
``round(sum / weight) -> uint16`` (float32 here, float64 on the host: the
sums stay below 2^24, so both quotients round to the same integer) and the
first class among equal sums (``torch.argmax``, as ``np.argmax``). The
mesh-sharded ``stitch_tiles_sharded`` is not ported (``ROADMAP.md`` Queue 1
item 13).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from srbh_tpu_torch import resolve_device


def _add_tiles(hs, bs, wt, height, build, pos, upscale: int) -> None:
    """Add tiles (N, T, T) and (N, T, T, C) of any integer type into the
    int32 canvases, each cut to its window; ``pos`` (N, 4) holds host
    integers [xoff, yoff, xcount, ycount] in source pixels."""
    # torch's uint16 has few kernels on CUDA: only the cast reads it
    height = torch.as_tensor(height, device=hs.device).to(torch.int32)
    build = torch.as_tensor(build, device=hs.device).to(torch.int32)
    for i, p in enumerate(np.asarray(pos).tolist()):
        x0, y0, xc, yc = (int(v) * upscale for v in p)
        rows, cols = slice(y0, y0 + yc), slice(x0, x0 + xc)
        hs[rows, cols] += height[i, :yc, :xc]
        bs[rows, cols] += build[i, :yc, :xc]
        wt[rows, cols] += 1


def stitch_tiles(height_u16, build_u16, pos, canvas_hw: Tuple[int, int],
                 upscale: int = 4):
    """Stitch a whole tile list on the tiles' device.

    ``height_u16`` (N, T, T) and ``build_u16`` (N, T, T, C) integer tiles,
    ``pos`` (N, 4) source-pixel windows. Returns int32 (H, W) height sum,
    (H, W, C) build sum and (H, W) weight, H, W = ``canvas_hw`` (at the
    output resolution)."""
    h, w = canvas_hw
    dev = torch.as_tensor(height_u16).device
    hs = torch.zeros((h, w), dtype=torch.int32, device=dev)
    bs = torch.zeros((h, w, build_u16.shape[-1]), dtype=torch.int32, device=dev)
    wt = torch.zeros((h, w), dtype=torch.int32, device=dev)
    _add_tiles(hs, bs, wt, height_u16, build_u16, pos, upscale)
    return hs, bs, wt


class DeviceMosaicAccumulator:
    """:class:`MosaicAccumulator`'s interface with the canvases on
    ``device`` (``None`` is the card; without one this raises).

    ``add_batch`` takes the model's tiles where they are (on the device in
    the predictor loop) and adds them in place; ``finalize`` returns numpy
    arrays."""

    def __init__(self, width: int, height: int, n_classes: int,
                 upscale: int = 4, device=None):
        dev = resolve_device(device)
        self.upscale = upscale
        self.h, self.w = height * upscale, width * upscale
        self.hs = torch.zeros((self.h, self.w), dtype=torch.int32, device=dev)
        self.bs = torch.zeros((self.h, self.w, n_classes), dtype=torch.int32,
                              device=dev)
        self.wt = torch.zeros((self.h, self.w), dtype=torch.int32, device=dev)

    def add_batch(self, height_u16, build_u16, pos):
        """Tiles (N, T, T[, C]); pos (N, 4) [xoff, yoff, xc, yc] source
        pixels, on the host. A zero-count window (xc = yc = 0) adds
        nothing."""
        _add_tiles(self.hs, self.bs, self.wt, height_u16, build_u16, pos,
                   self.upscale)

    def finalize(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        height, build_cls, weight = finalize_mosaic(self.hs, self.bs, self.wt)
        return height.cpu().numpy(), build_cls.cpu().numpy(), weight.cpu().numpy()


def finalize_mosaic(height_sum, build_sum, weight):
    """``MosaicAccumulator.finalize`` on the canvases' device: height =
    round(sum / weight) (half to even) as uint16, 0 where never covered;
    build = argmax class uint8; weight uint16."""
    quotient = torch.round(height_sum.float() / weight.clamp(min=1).float())
    height = torch.where(weight > 0, quotient, 0.0).to(torch.uint16)
    build_cls = torch.argmax(build_sum, dim=-1).to(torch.uint8)
    return height, build_cls, weight.to(torch.uint16)
