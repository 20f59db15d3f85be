"""Depth-to-space / space-to-depth (pixel shuffle), NCHW.

Counterpart of ``srbh_tpu/ops/shuffle.py``. The channel order is ESRGAN's
and torch's: ``out[n, c, h*r + i, w*r + j] = x[n, c*r*r + i*r + j, h, w]``,
so converted checkpoints keep their meaning.
"""
from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C*r^2, H, W) -> (N, C, H*r, W*r)."""
    n, c, h, w = x.shape
    r = scale
    if c % (r * r) != 0:
        raise ValueError(f"channels {c} not divisible by scale^2 {r * r}")
    c_out = c // (r * r)
    x = x.reshape(n, c_out, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c_out, h * r, w * r)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C, H*r, W*r) -> (N, C*r^2, H, W); exact inverse of
    :func:`pixel_shuffle` (ESRGAN's ``pixel_unshuffle``)."""
    n, c, hh, ww = x.shape
    r = scale
    if hh % r != 0 or ww % r != 0:
        raise ValueError(f"spatial dims ({hh},{ww}) not divisible by {r}")
    h, w = hh // r, ww // r
    x = x.reshape(n, c, h, r, w, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h, w)
