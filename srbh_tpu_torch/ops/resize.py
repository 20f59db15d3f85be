"""Nearest resizes with torch's index rule, NCHW.

Counterpart of ``srbh_tpu/ops/resize.py``. Output index ``o`` of a size
``out`` axis reads input index ``floor(o * in / out)`` in exact integers,
which is torch's and cv2's nearest rule at integer factors
(BH_loader.py:354-369; SR/rrdbnet_arch.py:219-220). The learned metrics
resize with torch's float32 scale instead (``metrics/learned.py:
_nearest_torch``), which differs at some non-integer ratios.
"""
from __future__ import annotations

import torch


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W) -> (..., out_h, out_w)."""
    h, w = x.shape[-2:]
    rows = torch.arange(out_h, device=x.device) * h // out_h
    cols = torch.arange(out_w, device=x.device) * w // out_w
    return x.index_select(-2, rows).index_select(-1, cols)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H*scale, W*scale): each pixel repeated."""
    return x.repeat_interleave(scale, dim=-2).repeat_interleave(scale, dim=-1)


def downsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(..., H, W) -> every ``scale``-th row and column from the first, as
    ``F.interpolate(scale_factor=1/scale, mode="nearest")``."""
    return x[..., ::scale, ::scale]
