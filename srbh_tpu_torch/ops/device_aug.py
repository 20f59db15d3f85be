"""Training augmentation and target building inside the train step (torch).

Counterpart of ``srbh_tpu/ops/device_aug.py``: the reference's
albumentations pipeline (BH_loader.py:17-22: Flip p=0.5,
RandomGridShuffle(2, 2) p=0.5, Rotate(limit 90) p=0.5) on the low-res image
and the x4 height map, and the hierarchy mask / pixel weights / block
aggregation targets (BH_loader.py:373-392), on the step's device.

The random draws are taken apart from their application. The JAX package
draws from ``jax.random`` (threefry), which torch cannot reproduce, so
:func:`draw_augment` draws every sample's coins, flip code, quadrant order
and angle from a ``torch.Generator`` on the device, and
:func:`augment_batch` applies given draws to the whole batch with gathers on
computed indices: no per-sample host sync. Fed the JAX package's draws,
:func:`augment_batch` gives its pixels (tests/test_torch_device_aug.py).

Semantics against the host path (``data/augment.py``): flips and 2x2 grid
shuffles are exact permutations; the rotation has the same geometry
(``cv2.getRotationMatrix2D`` about ``(w/2 - 0.5, h/2 - 0.5)``,
BORDER_REFLECT_101, bilinear image at the x4 grid sampled back by 4, nearest
mask) in float32 arithmetic. Image and height sides must be even.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from srbh_tpu_torch.ops.aggregate import aggregate

# the augmentation stream's tag ('aug'), as the JAX step folds it into its key
AUG_TAG = 0x617567


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 index folding (gfedcb|abcdefgh|gfedcba)."""
    if n == 1:
        return torch.zeros_like(idx)
    m = 2 * (n - 1)
    idx = idx.abs() % m
    return torch.minimum(idx, m - idx)


def _rows(n: int, h: int, w: int, device):
    """Per-sample (N, 1, 1) batch indices and (1, H, 1) / (1, 1, W) pixel
    coordinates."""
    return (torch.arange(n, device=device)[:, None, None],
            torch.arange(h, device=device)[None, :, None],
            torch.arange(w, device=device)[None, None, :])


def flip(x: torch.Tensor, code: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``cv2.flip`` of each (N, H, W, ...) sample where ``do``: code 0
    reverses the rows, 1 the columns, -1 both."""
    n, h, w = x.shape[:3]
    bi, ys, xs = _rows(n, h, w, x.device)
    rev_y = (do & (code != 1))[:, None, None]
    rev_x = (do & (code != 0))[:, None, None]
    return x[bi, torch.where(rev_y, h - 1 - ys, ys),
             torch.where(rev_x, w - 1 - xs, xs)]


def grid_shuffle_2x2(x: torch.Tensor, order: torch.Tensor,
                     do: torch.Tensor) -> torch.Tensor:
    """RandomGridShuffle(2, 2) of each (N, H, W, ...) sample where ``do``:
    destination quadrant ``dst`` (row-major) takes source quadrant
    ``order[:, dst]``."""
    n, h, w = x.shape[:3]
    hh, hw = h // 2, w // 2
    bi, ys, xs = _rows(n, h, w, x.device)
    ident = torch.arange(4, device=x.device).expand(n, 4)
    order = torch.where(do[:, None], order.to(x.device), ident)
    dst = (ys // hh) * 2 + xs // hw  # (1, H, W)
    src = order.gather(1, dst.reshape(1, -1).expand(n, -1)).reshape(n, h, w)
    return x[bi, (src // 2) * hh + ys % hh, (src % 2) * hw + xs % hw]


def _source(angle: torch.Tensor, h: int, w: int, ys, xs):
    """Source coordinates (float32) of destination pixels under
    ``cv2.warpAffine(getRotationMatrix2D(c, angle, 1))``: the inverse of a
    rotation about c is its transpose. ``angle`` is (N,)."""
    cy, cx = h / 2.0 - 0.5, w / 2.0 - 0.5
    t = angle[:, None, None] * (math.pi / 180.0)
    a, b = torch.cos(t), torch.sin(t)
    dx, dy = xs - cx, ys - cy
    return cy + b * dx + a * dy, cx + a * dx - b * dy


def rotate_mask_nearest(mask: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour rotation of (N, H, W) masks, BORDER_REFLECT_101."""
    n, h, w = mask.shape
    dev = mask.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    sy, sx = _source(angle.to(dev, torch.float32), h, w, ys, xs)
    yi = _reflect101(torch.round(sy).long(), h)
    xi = _reflect101(torch.round(sx).long(), w)
    return mask[torch.arange(n, device=dev)[:, None, None], yi, xi]


def rotate_image_lowres(img: torch.Tensor, angle: torch.Tensor,
                        scale: int = 4) -> torch.Tensor:
    """Bilinear rotation (BORDER_REFLECT_101) of each (N, h, w, C) image's
    x``scale`` nearest-replicated form, sampled back at stride ``scale``. The
    replicated image is never built: each bilinear tap of it is the low-res
    pixel ``index // scale``."""
    n, h, w = img.shape[:3]
    dev = img.device
    hh, ww = h * scale, w * scale
    ys = (torch.arange(h, dtype=torch.float32, device=dev) * scale)[None, :, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev) * scale)[None, None, :]
    sy, sx = _source(angle.to(dev, torch.float32), hh, ww, ys, xs)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    bi = torch.arange(n, device=dev)[:, None, None]

    def tap(yi, xi):
        return img[bi, _reflect101(yi, hh) // scale, _reflect101(xi, ww) // scale]

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def draw_augment(n: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every draw of a batch of ``n`` samples, on the generator's device:
    ``flip``, ``shuffle``, ``rotate`` (coins, p=0.5), ``flip_code`` in
    {-1, 0, 1}, ``order`` (a permutation of the four quadrants) and
    ``angle`` ~ U[-90, 90) degrees."""
    dev = generator.device
    coins = torch.rand(n, 3, generator=generator, device=dev) < 0.5
    return {
        "flip": coins[:, 0], "shuffle": coins[:, 1], "rotate": coins[:, 2],
        "flip_code": torch.randint(-1, 2, (n,), generator=generator, device=dev),
        "order": torch.rand(n, 4, generator=generator, device=dev).argsort(1),
        "angle": torch.rand(n, generator=generator, device=dev) * 180.0 - 90.0,
    }


def augment_batch(images: torch.Tensor, heights: torch.Tensor,
                  draws: Dict[str, torch.Tensor], scale: int = 4):
    """Flip -> grid shuffle -> rotation of the low-res images (N, h, w, C)
    and the x``scale`` heights (N, scale*h, scale*w), jointly, per the
    draws (:func:`draw_augment`). Heights keep their dtype."""
    d = {k: v.to(images.device) for k, v in draws.items()}
    images = flip(images, d["flip_code"], d["flip"])
    heights = flip(heights, d["flip_code"], d["flip"])
    images = grid_shuffle_2x2(images, d["order"], d["shuffle"])
    heights = grid_shuffle_2x2(heights, d["order"], d["shuffle"])
    rot = d["rotate"]
    images = torch.where(rot[:, None, None, None],
                         rotate_image_lowres(images, d["angle"], scale), images)
    heights = torch.where(rot[:, None, None],
                          rotate_mask_nearest(heights, d["angle"]), heights)
    return images, heights


def build_targets(height: torch.Tensor, lut, class_weight,
                  isaggre: bool = True) -> Dict[str, torch.Tensor]:
    """Hierarchy classes, per-pixel weights and (``isaggre``) the aggregated
    height and its weights from (N, H, W) heights, given the 256-entry class
    LUT and the class weights (arrays, or tensors already on the device):
    the twin of the host dataset's ``_finish_sample`` (BH_loader.py:373-392),
    bit-exact (the int
    cast truncates as numpy's ``astype``; the aggregation is
    ``aggregate_torch``'s block mean). Classes and weights are looked up
    with gathers (the JAX package's compare chain is a TPU form of the same
    lookup)."""
    height = height.float()
    dev = height.device
    lut_t = torch.as_tensor(lut, device=dev).long()
    cw_t = torch.as_tensor(class_weight, device=dev).float()

    def classes_of(h):
        return lut_t[h.to(torch.int32).clamp(0, 255).long()]

    build = classes_of(height)
    out = {"height": height, "build": build.to(torch.int32),
           "weight": cw_t[build]}
    if isaggre:
        aggre = aggregate(height, 0.25)
        out["height_aggre"] = aggre
        out["weight_aggre"] = cw_t[classes_of(aggre)]
    return out
