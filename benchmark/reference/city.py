"""Plain reference of a mapped city: the windows, the normalisation, the
model (``flagship.py``), the quantisation, the overlap blend and the
finalize of ``predict_realesanet_feature_globe.py:68-233``, written apart
from the port.

* windows: the valid 64-px cells of the 56-px fishnet (``synth/city.py``);
* a window's input: S2 and S1 bands, each ``(x - min) / (max - min)`` by its
  table (no clip), float32;
* the model's float heights and softmax, quantised as the predictor does
  (uint16 ``round(10 h)``, uint8 ``round(255 p)``, half to even);
* the blend: integer sums of every window's quantised outputs over its
  ``4 x`` footprint, and the count of windows over each pixel;
* finalize: heights ``round(sum / count)``, classes the argmax of the
  build sums.

:func:`compare` reads the program's mosaic against this one.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import flagship


def window_batch(s2, s1, pos, tables):
    """(N, 64, 64, 8) float32 inputs of windows ``pos``."""
    (o2, k2), (o1, k1) = tables
    out = []
    for x, y, xc, yc in pos:
        img = np.concatenate([s2[y:y + yc, x:x + xc],
                              s1[y:y + yc, x:x + xc]], -1).astype(np.float32)
        img[..., :6] = (img[..., :6] - o2) / k2
        img[..., 6:] = (img[..., 6:] - o1) / k1
        out.append(img)
    return np.stack(out)


def mosaic(hm, sr, city, pos, tables, dev, batch=32, rgb=(0, 1, 2),
           dtype=torch.float32):
    """(heights uint16, build sums int64 (C, H, W), counts) of a city
    mapped by the reference modules ``hm``, ``sr`` on ``dev`` in
    ``dtype``."""
    side = city["s2"].shape[0]
    n_cls = hm.seg.conv_last.out_channels
    hs = np.zeros((4 * side, 4 * side), np.int64)
    bs = np.zeros((n_cls, 4 * side, 4 * side), np.int64)
    cnt = np.zeros((4 * side, 4 * side), np.int64)
    for i in range(0, len(pos), batch):
        chunk = pos[i:i + batch]
        x = torch.from_numpy(window_batch(city["s2"], city["s1"], chunk,
                                          tables)).to(dev)
        h, p, _ = flagship.serve(hm, sr, x, rgb, dtype)
        h = torch.round(h * 10).to(torch.int64).cpu().numpy()
        p = torch.round(p * 255).to(torch.int64).cpu().numpy()
        for k, (x0, y0, xc, yc) in enumerate(chunk):
            r = slice(4 * y0, 4 * (y0 + yc))
            c = slice(4 * x0, 4 * (x0 + xc))
            hs[r, c] += h[k, :4 * yc, :4 * xc]
            bs[:, r, c] += p[k, :4 * yc, :4 * xc].transpose(2, 0, 1)
            cnt[r, c] += 1
    height = np.zeros_like(hs, dtype=np.uint16)
    m = cnt > 0
    height[m] = np.round(hs[m] / cnt[m]).astype(np.uint16)
    return height, bs, cnt


def _gap(classes, bsum, cnt, m):
    cls = classes.astype(np.int64)
    if cls.max() >= bsum.shape[0]:
        return np.inf
    chosen = np.take_along_axis(bsum, cls[None], 0)[0]
    return float(((bsum.max(0) - chosen)[m] / (255.0 * cnt[m])).mean())


def block_rms(h, ref, m, block=256, least=None) -> np.ndarray:
    """Each ``block`` x ``block`` square's root-mean-square difference of
    the integer maps ``h`` and ``ref`` over its pixels in ``m``, for the
    squares with at least ``least`` such pixels (a sixteenth of a square by
    default)."""
    least = block * block // 16 if least is None else least
    out = []
    for y in range(0, h.shape[0], block):
        for x in range(0, h.shape[1], block):
            mb = m[y:y + block, x:x + block]
            n = int(mb.sum())
            if n >= least:
                d = (h[y:y + block, x:x + block].astype(np.int64)
                     - ref[y:y + block, x:x + block].astype(np.int64))[mb]
                out.append(np.sqrt(float((d * d).sum()) / n))
    return np.asarray(out)


def compare(prog_height, prog_classes, truth, yard) -> dict:
    """The program's mosaic against the truth's (``(heights, build sums,
    counts)`` of :func:`mosaic` in float32), in units of the yardstick's
    (the same in the configuration's compute type), over the pixels some
    window covers:

    * ``height_block_ratio``: the worst square of one window's footprint
      (256 x 256 output pixels, :func:`block_rms`) by root-mean-square
      height difference, program over yardstick: one wrong window reads
      its own error, not a share of the city's;
    * ``class_ratio``: the mean gap by which the truth's blended
      probability of the class written lies below its best (0 where they
      agree), program over yardstick;
    * ``outside``: the share of uncovered pixels the program set (0 when
      sound)."""
    t_h, t_b, cnt = truth
    y_h, y_b, _ = yard
    m = cnt > 0
    y_cls = np.argmax(y_b, 0)
    worst_y = float(block_rms(y_h, t_h, m).max(initial=0.0))
    return {"height_block_ratio": float(block_rms(prog_height, t_h, m).max(
                initial=0.0)) / max(worst_y, 1e-12),
            "class_ratio": _gap(prog_classes, t_b, cnt, m)
            / max(_gap(y_cls, t_b, cnt, m), 1e-12),
            "outside": float((prog_height[~m] != 0).mean()) if (~m).any()
            else 0.0}
