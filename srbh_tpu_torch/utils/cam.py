"""Class-activation-map utilities (utils/camutils.py:4-175), on the host.

A copy of ``srbh_tpu/utils/cam.py``, which the port may not import, with its
two OpenCV calls rebuilt on numpy and scipy, so that it needs no OpenCV:

* :func:`resize_linear` is ``cv2.resize(..., INTER_LINEAR)``: half-pixel
  centres, ``src = (dst + 0.5) * in / out - 0.5``, the index clamped at
  both edges (a uint8 image is rounded back to uint8, where cv2's fixed
  point may differ by one);
* :func:`gaussian_blur` is ``cv2.GaussianBlur(..., BORDER_CONSTANT)``: two
  zero-padded 1-D passes of ``cv2.getGaussianKernel``'s window.

Images and CAMs are NHWC numpy arrays, as in the JAX package: ``cam_fn``
maps an (N, H, W, C) image batch to (N, h, w, K) raw class maps.

* :func:`multi_scale_cam` and its variants average flip-symmetrised CAMs
  over scales;
* :func:`cam_to_label` labels by the background threshold;
* :func:`crf_refine` is a mean-field refinement with a Gaussian pairwise
  kernel (and optionally a joint-bilateral one), in place of pydensecrf;
* :func:`compute_seg_label` carves pseudo-labels (utils/utils_rrm.py:39-92).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import correlate1d

from srbh_tpu_torch.ops.usm import cv2_gaussian_kernel


def multi_scale_cam(cam_fn: Callable[[np.ndarray], np.ndarray],
                    image: np.ndarray,
                    scales: Sequence[float] = (1.0, 0.5, 1.5)) -> np.ndarray:
    """Average flip-symmetrised CAMs over scales.

    ``cam_fn``: (N, H, W, C) image -> (N, h, w, K) raw class maps.
    Returns (N, H, W, K) normalised CAMs at the input resolution.
    Reference recipe (camutils.py:4-25): per scale, run [image; hflip],
    bilinear the raw maps back to input size, max-fuse the flip pair,
    relu, sum over scales, then min-shift/max-divide normalisation.
    """
    return _norm_ref(_multi_scale_sum(cam_fn, image, scales))


def _linear_taps(n_in: int, n_out: int):
    """Per output index: the two source indices and the second's weight."""
    src = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    frac[i0 < 0] = 0.0
    i0 = np.maximum(i0, 0)
    top = i0 >= n_in - 1
    i0[top], frac[top] = n_in - 1, 0.0
    return i0, np.minimum(i0 + 1, n_in - 1), frac.astype(np.float32)


def resize_linear(im: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(im, (w, h))`` (INTER_LINEAR) of an (H, W) or (H, W, C)
    image; the width pass first, then the height pass."""
    x = im.astype(np.float32)
    c0, c1, fx = _linear_taps(x.shape[1], w)
    fx = fx.reshape((1, w) + (1,) * (x.ndim - 2))
    x = x[:, c0] * (1 - fx) + x[:, c1] * fx
    r0, r1, fy = _linear_taps(x.shape[0], h)
    fy = fy.reshape((h,) + (1,) * (x.ndim - 1))
    x = x[r0] * (1 - fy) + x[r1] * fy
    if im.dtype == np.uint8:
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return x.astype(im.dtype, copy=False)


def gaussian_blur(a: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(a, (ksize, ksize), sigma,
    borderType=cv2.BORDER_CONSTANT)`` of a 2-D float array."""
    k = cv2_gaussian_kernel(ksize, sigma)
    out = correlate1d(a, k, axis=1, mode="constant", cval=0.0)
    return correlate1d(out, k, axis=0, mode="constant", cval=0.0)


def _resize_batch(images: np.ndarray, h: int, w: int) -> np.ndarray:
    """Each image resized; channel-less images come back as (N, h, w, 1)."""
    out = np.stack([resize_linear(im, h, w) for im in images])
    return out[..., None] if out.ndim == 3 else out


def _flip_max(cams: np.ndarray, n: int) -> np.ndarray:
    """Reference fusion of the forward/flip halves: elementwise max of the
    forward maps and the un-flipped flipped maps (camutils.py:17-18)."""
    return np.maximum(cams[:n], cams[n:, :, ::-1])


def _norm_ref(cam: np.ndarray) -> np.ndarray:
    """Reference normalisation (camutils.py:22-23): shift per-(image, class)
    spatial min to 0, divide by the max (+1e-5)."""
    cam = cam - cam.min(axis=(1, 2), keepdims=True)
    return cam / (cam.max(axis=(1, 2), keepdims=True) + 1e-5)


def _multi_scale_sum(cam_fn, image, scales, include_unit_first=False,
                     stage=None, relu=True):
    """Shared body of the reference multi-scale CAM drivers: per scale, run
    the model on [image; hflip(image)], max-fuse the two halves, bilinear
    back to input size, relu, and sum over scales."""
    n, h, w = image.shape[:3]
    total = None
    scale_list = ([1.0] + [s for s in scales if s != 1.0]
                  if include_unit_first else list(scales))
    for s in scale_list:
        imgs = image if s == 1.0 else _resize_batch(image, int(h * s), int(w * s))
        both = np.concatenate([imgs, imgs[:, :, ::-1]], axis=0)
        out = cam_fn(both)
        cams = np.asarray(out[stage] if stage is not None else out)
        # reference order (camutils.py:16-17): bilinear to input size
        # FIRST, then max-fuse the flip pair (max and resize don't commute)
        cam = _flip_max(_resize_batch(cams, h, w), n)
        if relu:
            cam = np.maximum(cam, 0)
        total = cam if total is None else total + cam
    return total


def multi_scale_puzzle(cam_fn, image, scales=(0.5, 1.5)) -> np.ndarray:
    """multi_scale_puzzle (camutils.py:27-57): scale-1 pass first, then the
    non-unit scales; max flip fusion, relu, sum, reference normalisation.
    ``cam_fn``: (N, H, W, C) -> (N, h, w, K) raw class maps."""
    return _norm_ref(_multi_scale_sum(cam_fn, image, scales,
                                      include_unit_first=True))


def multi_scale_seam(cam_fn, image, scales=(0.5, 1.5), pos: int = 0) -> np.ndarray:
    """multi_scale_seam (camutils.py:60-98): the model returns a tuple of
    heads; fuse head ``pos`` across scales (relu only when ``pos == 0``)."""
    return _norm_ref(_multi_scale_sum(cam_fn, image, scales,
                                      include_unit_first=True, stage=pos,
                                      relu=(pos == 0)))


def multi_scale_cam_multistage(cam_fn, image, scales=(0.5, 1.5)) -> np.ndarray:
    """multi_scale_cam_multistage (camutils.py:99-128): ``cam_fn`` returns a
    list of per-stage maps; every stage of every scale joins one sum."""
    n, h, w = image.shape[:3]
    total = None
    for s in [1.0] + [x for x in scales if x != 1.0]:
        imgs = image if s == 1.0 else _resize_batch(image, int(h * s), int(w * s))
        both = np.concatenate([imgs, imgs[:, :, ::-1]], axis=0)
        for cams in cam_fn(both):
            cam = np.maximum(_flip_max(_resize_batch(np.asarray(cams), h, w), n), 0)
            total = cam if total is None else total + cam
    return _norm_ref(total)


def multi_scale_cam_multistage_v2(cam_fn, image, scales=(1.0, 0.5, 1.5),
                                  weights=(1, 1, 1, 1)) -> np.ndarray:
    """multi_scale_cam_multistagev2 (camutils.py:131-164): normalise each
    stage's scale-sum separately, weight, sum, and re-normalise."""
    n, h, w = image.shape[:3]
    stage_totals: list = []
    for s in scales:
        imgs = image if s == 1.0 else _resize_batch(image, int(h * s), int(w * s))
        both = np.concatenate([imgs, imgs[:, :, ::-1]], axis=0)
        cam_all = cam_fn(both)
        for i, cams in enumerate(cam_all):
            cam = np.maximum(_flip_max(_resize_batch(np.asarray(cams), h, w), n), 0)
            if i >= len(stage_totals):
                stage_totals.append(cam)
            else:
                stage_totals[i] = stage_totals[i] + cam
    fused = sum(_norm_ref(t) * weights[i] for i, t in enumerate(stage_totals))
    return _norm_ref(fused)


def make_cam(x: np.ndarray, epsilon: float = 1e-5) -> np.ndarray:
    """make_cam (camutils.py:166-175): relu then scale by the per-(image,
    class) spatial max — ``relu(x - eps) / (max + eps)``."""
    x = np.maximum(x, 0)
    mx = x.max(axis=(1, 2), keepdims=True)
    return np.maximum(x - epsilon, 0) / (mx + epsilon)


def compute_seg_label(image: np.ndarray, cam_label: np.ndarray,
                      norm_cam: np.ndarray, num_classes: int = 21,
                      ignore_index: int = 255) -> np.ndarray:
    """Pseudo-label carving (utils/utils_rrm.py:39-92 capability twin).

    ``image``: (H, W, 3) uint8; ``cam_label``: (K,) image-level class
    presence; ``norm_cam``: (K, H, W) normalised CAMs (K foreground classes,
    labels are ``class + 1`` over background 0).

    Reference recipe: background score = (1 - max cam)^alpha; low-alpha (4)
    and high-alpha (32) CRF refinements; pixels are kept only where both the
    CAM is inside its class's top-40% confidence region and the CRF
    probability is confident, everything else -> ``ignore_index``. The CRF
    here is :func:`crf_refine` (pure numpy) instead of pydensecrf."""
    k, h, w = norm_cam.shape
    cam_np = np.where((cam_label > 1e-5)[:, None, None], norm_cam, 0.0)

    def crf_with_alpha(alpha):
        bg = np.power(1 - cam_np.max(axis=0, keepdims=True), alpha)
        score = np.concatenate([bg, cam_np], axis=0)  # (K+1, H, W)
        prob = score / np.maximum(score.sum(axis=0, keepdims=True), 1e-8)
        ref = crf_refine(prob.transpose(1, 2, 0), image)
        return ref.transpose(2, 0, 1)

    bg_score = np.power(1 - cam_np.max(axis=0, keepdims=True), 32)
    cam_all = np.concatenate([bg_score, cam_np], axis=0)
    cam_img = np.argmax(cam_all, axis=0)

    crf_la, crf_ha = crf_with_alpha(4), crf_with_alpha(32)
    crf_la_label = np.argmax(crf_la, axis=0)
    crf_ha_label = np.argmax(crf_ha, axis=0)
    crf_label = crf_la_label.copy()
    crf_label[crf_la_label == 0] = ignore_index

    sure = np.zeros((h, w), bool)
    for ci in np.unique(crf_la_label):
        cam_class = np.where(cam_img == ci, cam_all[ci], 0.0)
        if ci != 0:
            vals = np.sort(cam_class[cam_class > 0.1])
            if vals.size == 0:
                continue
            conf = vals[min(int(vals.shape[0] * 0.6), vals.shape[0] - 1)]
            sure |= cam_class > conf
        else:
            sure |= cam_class > 0.8
    crf_label[crf_ha_label == 0] = 0
    crf_prob = np.concatenate([crf_ha[:1], crf_la[1:]], axis=0)
    not_sure = (crf_prob.max(axis=0) < 0.8) | ~sure
    crf_label[not_sure] = ignore_index
    return crf_label


def cam_to_label(cam: np.ndarray, bkg_thre: float = 0.3,
                 ignore_index: int = 255) -> np.ndarray:
    """(N, H, W, K) CAMs -> labels with an uncertain band marked ignore."""
    score = cam.max(axis=-1)
    label = cam.argmax(axis=-1) + 1  # classes are 1-based over background
    label[score < bkg_thre] = 0
    band = (score >= bkg_thre * 0.7) & (score < bkg_thre)
    label[band] = ignore_index
    return label.astype(np.int32)


def _bilateral_message(q: np.ndarray, image: np.ndarray, sxy: float,
                       srgb: float, radius: int,
                       stride: int = 1) -> np.ndarray:
    """Windowed joint-bilateral message: for each pixel, the
    appearance-AND-space weighted sum of its neighbours' label
    distributions. Exact within ``radius`` at ``stride=1``; for
    long-range kernels (pydensecrf's sxy=80) the window is DILATED —
    offsets sampled at ``stride`` px still cover +-radius*stride, a
    standard lattice-style approximation of the dense kernel."""
    h, w, k = q.shape
    img = image.astype(np.float32)
    msg = np.zeros_like(q)
    norm = np.zeros((h, w, 1), q.dtype)
    for dy in range(-radius * stride, radius * stride + 1, stride):
        for dx in range(-radius * stride, radius * stride + 1, stride):
            if dy == 0 and dx == 0:
                continue  # pydensecrf convention: no self-message
            if abs(dy) >= h or abs(dx) >= w:
                continue  # offset larger than the image: empty overlap
            ys0, ys1 = max(dy, 0), h + min(dy, 0)
            xs0, xs1 = max(dx, 0), w + min(dx, 0)
            yd0, yd1 = max(-dy, 0), h + min(-dy, 0)
            xd0, xd1 = max(-dx, 0), w + min(-dx, 0)
            dI = img[yd0:yd1, xd0:xd1] - img[ys0:ys1, xs0:xs1]
            wgt = np.exp(-(dy * dy + dx * dx) / (2.0 * sxy * sxy)
                         - (dI * dI).sum(-1) / (2.0 * srgb * srgb))[..., None]
            msg[yd0:yd1, xd0:xd1] += wgt * q[ys0:ys1, xs0:xs1]
            norm[yd0:yd1, xd0:xd1] += wgt
    return msg / np.maximum(norm, 1e-8)


def crf_refine(prob: np.ndarray, image: np.ndarray, iters: int = 5,
               sxy: float = 3.0, compat: float = 3.0,
               bilateral: Optional[Tuple[float, float, float]] = None,
               radius: Optional[int] = None) -> np.ndarray:
    """Mean-field refinement of (H, W, K) probabilities
    (utils/utils_rrm.py:6-92; a stand-in for pydensecrf). Pairwise terms,
    negative-Potts compatibility:

    * a Gaussian spatial kernel (``sxy``, ``compat``) — pydensecrf's
      ``addPairwiseGaussian(sxy=3, compat=3)``'s spatial term. The
      self-pixel is EXCLUDED and the message is row-normalised per pixel
      over its in-image neighbours (the paper's K·Q / K·1 mean-field
      message, matched exactly by the dense oracle of the JAX package's
      tests/test_crf.py): the separable blur runs with BORDER_CONSTANT
      zero-padding, the centre tap's weight is subtracted, and the
      remainder is divided by the same blur of a ones image — the dense
      kernel truncated at ±3 sigma. NOTE pydensecrf's default
      ``NormalizationType`` is NORMALIZE_SYMMETRIC
      (1/sqrt(norm_i) · K · 1/sqrt(norm_j)); this one-sided
      row-normalisation approximates but does not bit-reproduce it;
    * optionally a joint-bilateral appearance kernel ``bilateral =
      (sxy_b, srgb, compat_b)`` — ``addPairwiseBilateral(sxy=80, srgb=13,
      compat=10)``'s edge-aware term. Computed over a window of
      ``2*radius+1`` sampled offsets (default radius 24): exact when
      ``3*sxy_b <= radius``; for longer-range kernels the window is
      DILATED (stride ``ceil(3*sxy_b/radius)``) so it still spans +-3
      sigma — the lattice-style approximation of the dense kernel.
      Held to a brute-force dense oracle in tests/test_crf.py.

    Update rule per iteration: ``Q = softmax(log(prob) + sum_m compat_m *
    normalised_message_m)`` — neighbourhood consensus pulls each pixel's
    label distribution toward its (spatially/appearance) weighted
    neighbours'.
    """
    q = prob.copy().astype(np.float32)
    k = int(2 * round(3 * sxy) + 1)  # window spans +-3 sigma
    w0 = float(cv2_gaussian_kernel(k, sxy)[k // 2] ** 2)  # the 2-D centre tap

    def _blur(a):
        return gaussian_blur(a, k, sxy)

    # per-pixel normaliser: total in-image neighbour weight (self excluded)
    gnorm = np.maximum(
        _blur(np.ones(prob.shape[:2], np.float32)) - w0, 1e-8)[..., None]
    for _ in range(iters):
        msg = np.stack([_blur(q[..., c]) - w0 * q[..., c]
                        for c in range(q.shape[-1])], axis=-1) / gnorm
        logits = np.log(np.clip(prob, 1e-8, 1.0)) + compat * msg
        if bilateral is not None:
            sxy_b, srgb, compat_b = bilateral
            r = radius if radius is not None else min(int(3 * sxy_b), 24)
            r = max(r, 1)
            stride = max(1, -(-int(3 * sxy_b) // r))  # span +-3 sigma
            logits = logits + compat_b * _bilateral_message(
                q, image, sxy_b, srgb, r, stride)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        q = e / e.sum(axis=-1, keepdims=True)
    return q
