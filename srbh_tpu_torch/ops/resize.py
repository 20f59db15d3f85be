"""Integer-factor nearest upsampling, NCHW.

Counterpart of ``srbh_tpu/ops/resize.py:upsample_nearest``: each pixel is
repeated ``scale`` times along H and W, which is torch's ``nearest`` rule
(output index ``o`` reads input ``floor(o / scale)``).
"""
from __future__ import annotations

import torch


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H*scale, W*scale)."""
    return x.repeat_interleave(scale, dim=-2).repeat_interleave(scale, dim=-1)
