"""Depth-to-space / space-to-depth (pixel shuffle) on (N, C, H, W) tensors.

Counterpart of ``srbh_tpu/ops/shuffle.py``. The channel order is ESRGAN's
and torch's: ``out[n, c, h*r + i, w*r + j] = x[n, c*r*r + i*r + j, h, w]``,
so converted checkpoints keep their meaning. :func:`pixel_shuffle` keeps a
channels-last input channels-last (the serving step's layout).
"""
from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C*r^2, H, W) -> (N, C, H*r, W*r), in ``x``'s memory format."""
    n, c, h, w = x.shape
    r = scale
    if c % (r * r) != 0:
        raise ValueError(f"channels {c} not divisible by scale^2 {r * r}")
    c_out = c // (r * r)
    if x.is_contiguous(memory_format=torch.channels_last):
        # the same permutation on the (N, H, W, C) view: one copy, and the
        # result's NCHW view is channels-last
        y = x.permute(0, 2, 3, 1).reshape(n, h, w, c_out, r, r)
        y = y.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r, c_out)
        return y.permute(0, 3, 1, 2)
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
