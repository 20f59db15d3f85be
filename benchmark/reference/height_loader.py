"""Plain reference of the height dataset's training samples, numpy.

Written from the reference repository's ``BH_loader.py:282-400`` (the S1 +
S2 dataset with ``aug``, ``isaggre`` and ``ishir``) and the albumentations
pipeline it applies (``BH_loader.py:17-28``); nothing of the port is
imported. A sample of tile ``index`` from the arrays the tiles were
written from:

1. the image: the first six S2 bands, then the two S1 bands, float32,
   x4 nearest to the heights' 256 x 256 grid;
2. the augmentation, image and heights together, each step with p 0.5 in
   this order: a flip (cv2 code -1, 0 or 1), a 2 x 2 grid shuffle (a
   permutation of the four quadrants, destination ``k`` from source
   ``order[k]``, row-major), a rotation by an angle uniform in [-90, 90]
   degrees about ``(w/2 - 0.5, h/2 - 0.5)`` with BORDER_REFLECT_101,
   bilinear for the image and nearest for the heights. The draws come from
   ``numpy.random.default_rng((seed, epoch, index))`` in that order (one
   ``random()`` a step, then its parameter), as the port's dataset draws
   them; the geometry here is computed in float64 at full resolution;
3. min-max normalisation of each band (S2 over [0, 5000], S1 over
   [-25, 5] dB: the tables the tiles come with), every fourth pixel of
   each axis back to 64 x 64, clipped to [0, 1];
4. the targets: the heights in metres (float32), their class in the
   height hierarchy ``hir`` (class ``i`` for ``hir[i] <= h < hir[i + 1]``)
   and the class's weight; the 4 x 4 block means of the heights (64 x 64)
   with the weight of their class (by the mean's integer part). The
   weights are the inverse square roots of each class's share of the
   heights' histogram, scaled to sum to the number of classes.

``rotate_heights=False`` rotates the image alone: a planted fault.
"""
from __future__ import annotations

import math

import numpy as np


def class_weights(hist: np.ndarray, hir) -> np.ndarray:
    """Each class's weight (float64) from a 256-bin height histogram."""
    hist = np.asarray(hist, np.float64)
    freq = np.array([hist[a:b].sum() for a, b in zip(hir[:-1], hir[1:])])
    w = 1.0 / np.sqrt(freq / hist.sum())
    return (len(hir) - 1) * w / w.sum()


def _flip(a, code):
    if code == 0:
        return a[::-1]
    if code == 1:
        return a[:, ::-1]
    return a[::-1, ::-1]


def _shuffle(a, order):
    h, w = a.shape[0] // 2, a.shape[1] // 2
    quads = [a[:h, :w], a[:h, w:], a[h:, :w], a[h:, w:]]
    q = [quads[s] for s in order]
    return np.concatenate([np.concatenate(q[:2], 1),
                           np.concatenate(q[2:], 1)], 0)


def _fold(i, n):
    """BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)."""
    m = 2 * (n - 1)
    i = np.abs(i) % m
    return np.minimum(i, m - i)


def _source(angle, h, w):
    """Source (y, x) of every destination pixel, float64."""
    t = math.radians(angle)
    a, b = math.cos(t), math.sin(t)
    cy, cx = h / 2 - 0.5, w / 2 - 0.5
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return cy + b * (x - cx) + a * (y - cy), cx + a * (x - cx) - b * (y - cy)


def _bilinear(img, angle):
    h, w = img.shape[:2]
    sy, sx = _source(angle, h, w)
    y0, x0 = np.floor(sy).astype(np.int64), np.floor(sx).astype(np.int64)
    fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]
    ya, yb = _fold(y0, h), _fold(y0 + 1, h)
    xa, xb = _fold(x0, w), _fold(x0 + 1, w)
    img = img.astype(np.float64)
    top = img[ya, xa] * (1 - fx) + img[ya, xb] * fx
    bot = img[yb, xa] * (1 - fx) + img[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def _nearest(a, angle):
    h, w = a.shape[:2]
    sy, sx = _source(angle, h, w)
    return a[_fold(np.rint(sy).astype(np.int64), h),
             _fold(np.rint(sx).astype(np.int64), w)]


def sample(s2, s1, bh, index: int, seed: int, epoch: int, weights, hir,
           s2_range=(0.0, 5000.0), s1_range=(-25.0, 5.0),
           rotate_heights: bool = True) -> dict:
    """One training sample (module docstring) from tile ``index``'s S2 (64,
    64, >= 6), S1 (64, 64, 2) and heights (256, 256)."""
    img = np.concatenate([s2[..., :6], s1], -1).astype(np.float32)
    img = np.repeat(np.repeat(img, 4, 0), 4, 1)
    h = bh
    rng = np.random.default_rng((seed, epoch, index))
    if rng.random() < 0.5:
        code = int(rng.integers(-1, 2))
        img, h = _flip(img, code), _flip(h, code)
    if rng.random() < 0.5:
        order = rng.permutation(4)
        img, h = _shuffle(img, order), _shuffle(h, order)
    if rng.random() < 0.5:
        angle = float(rng.uniform(-90.0, 90.0))
        img = _bilinear(img, angle)
        if rotate_heights:
            h = _nearest(h, angle)
    lo = np.array([s2_range[0]] * 6 + [s1_range[0]] * 2)
    span = np.array([s2_range[1] - s2_range[0]] * 6
                    + [s1_range[1] - s1_range[0]] * 2)
    img = np.clip(((img - lo) / span)[::4, ::4], 0.0, 1.0)
    height = h.astype(np.float32)
    cls = np.searchsorted(np.asarray(hir), h, side="right") - 1
    w32 = np.asarray(weights, np.float32)
    aggre = h.astype(np.float64).reshape(64, 4, 64, 4).mean((1, 3))
    acls = np.searchsorted(np.asarray(hir), np.floor(aggre),
                           side="right") - 1
    return {"image": img.astype(np.float32), "height": height,
            "build": cls.astype(np.int32), "weight": w32[cls],
            "height_aggre": aggre.astype(np.float32),
            "weight_aggre": w32[acls]}


def batch(s2, s1, bh, indices, seed: int, epoch: int, hist, hir,
          **kw) -> dict:
    """The samples of tiles ``indices`` stacked: ``s2[k]``, ``s1[k]`` and
    ``bh[k]`` are tile ``indices[k]``'s arrays; ``hist`` is the histogram
    of every tile's heights."""
    w = class_weights(hist, hir)
    got = [sample(s2[k], s1[k], bh[k], i, seed, epoch, w, hir, **kw)
           for k, i in enumerate(indices)]
    return {k: np.stack([g[k] for g in got]) for k in got[0]}
