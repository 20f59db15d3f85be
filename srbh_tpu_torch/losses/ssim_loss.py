"""SSIM and MS-SSIM losses (NCHW), the losses_pytorch/fastssim.py and
ssim_loss.py twins.

Counterpart of ``srbh_tpu/losses/ssim_loss.py``:

* :func:`ssim` / :func:`ssim_loss` (fastssim.py:248-288): VALID Gaussian
  SSIM with C1 / C2 on ``data_range``, ``1 - mean``; ``nonnegative``
  clamps each image's SSIM at 0;
* :func:`ssim_same` / :func:`log_ssim_loss` (ssim_loss.py:68-117): the
  zero-padded SAME filter of ``F.conv2d(padding=k // 2)``, constants on
  ``data_range`` (1 by default); LOGSSIM min-max normalises the map over
  the whole batch and takes the mean of ``-log(map + 1e-8)``;
* :func:`ms_ssim` / :func:`ms_ssim_loss` (fastssim.py:155-200, 291-331):
  five scales with weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), a 2x2
  average pool between them, each scale's contrast term clamped at 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from srbh_tpu_torch.ops.ssim import filter_separable

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _maps(x, y, data_range: float, win_size: int = 11, win_sigma: float = 1.5,
          padding: int = 0, k=(0.01, 0.03)):
    """(ssim map, contrast-structure map)."""
    c1, c2 = (k[0] * data_range) ** 2, (k[1] * data_range) ** 2
    filt = lambda t: filter_separable(t, win_size, win_sigma, padding)  # noqa: E731
    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu1_mu2
    cs_map = (2 * s12 + c2) / (s1 + s2 + c2)
    return ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map, cs_map


def _ssim_and_cs(x, y, data_range: float, win_size: int = 11,
                 win_sigma: float = 1.5):
    smap, cs_map = _maps(x, y, data_range, win_size, win_sigma)
    return smap.mean(dim=(1, 2, 3)), cs_map.mean(dim=(1, 2, 3))


def ssim(x, y, data_range: float = 255.0, nonnegative: bool = False,
         win_size: int = 11, win_sigma: float = 1.5):
    """SSIM of each image of NCHW batches: (N,)."""
    s, _ = _ssim_and_cs(x, y, data_range, win_size, win_sigma)
    return torch.clamp(s, min=0.0) if nonnegative else s


def ssim_loss(x, y, data_range: float = 255.0, nonnegative: bool = False):
    """1 - mean SSIM."""
    return 1.0 - ssim(x, y, data_range, nonnegative).mean()


def _ssim_map_same(x, y, data_range: float = 1.0, win_size: int = 11,
                   win_sigma: float = 1.5):
    return _maps(x, y, data_range, win_size, win_sigma, win_size // 2)[0]


def ssim_same(x, y, data_range: float = 1.0, win_size: int = 11,
              win_sigma: float = 1.5):
    """Mean SSIM with ssim_loss.py's SAME zero padding: the SSIM that
    myloss.py's composite losses take."""
    return _ssim_map_same(x, y, data_range, win_size, win_sigma).mean()


def log_ssim_loss(x, y, data_range: float = 1.0, win_size: int = 11,
                  win_sigma: float = 1.5):
    """LOGSSIM: the SAME SSIM map min-max normalised over the batch, then
    the mean of ``-log(map + 1e-8)``."""
    smap = _ssim_map_same(x, y, data_range, win_size, win_sigma)
    smap = (smap - smap.min()) / (smap.max() - smap.min())
    return torch.mean(-torch.log(smap + 1e-8))


def avg_pool2(x):
    """2x2 average pool, stride 2, odd edges dropped."""
    return F.avg_pool2d(x, 2, 2)


def ms_ssim(x, y, data_range: float = 255.0,
            weights: Optional[Sequence[float]] = None, win_size: int = 11,
            win_sigma: float = 1.5):
    """Multi-scale SSIM of each image: (N,)."""
    w = torch.tensor(weights if weights is not None else MS_SSIM_WEIGHTS,
                     dtype=x.dtype, device=x.device)
    levels = w.shape[0]
    mcs = []
    for i in range(levels):
        s, cs = _ssim_and_cs(x, y, data_range, win_size, win_sigma)
        if i < levels - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            x, y = avg_pool2(x), avg_pool2(y)
    stack = torch.stack(mcs + [torch.clamp(s, min=0.0)])  # (levels, N)
    return torch.prod(stack ** w[:, None], dim=0)


def ms_ssim_loss(x, y, data_range: float = 255.0):
    """1 - mean MS-SSIM."""
    return 1.0 - ms_ssim(x, y, data_range).mean()
