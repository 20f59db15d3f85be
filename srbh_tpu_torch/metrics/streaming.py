"""Streaming metric accumulators: the confusion matrix, the per-class height
errors and the running average.

Counterpart of ``srbh_tpu/metrics/streaming.py`` (metrics.py):

* :func:`confusion_update` / :func:`height_update`: one batch, as functions
  on tensors on any device;
* :class:`SegmentationMetric` (metrics.py:6-86): OA, precision (UA), recall
  (PA), F1, IoU, mIoU, FWIoU and mFWIoU of the streamed confusion matrix,
  NaN for an empty class (without numpy's warning);
* :class:`HeightMetric` (metrics.py:163-234): per hierarchy class, the
  reference's count-weighted mean of *per-batch* RMSE / MAE / ME, not a
  pooled RMSE;
* :class:`AverageMeter` (metrics.py:143-160), the console dumps
  :func:`accprint` / :func:`accprint_seg` and :func:`plot_confusionmatrix`.

The arithmetic is the JAX package's: each batch's counts and rows in
float32, added into float64 totals. The totals live on the device of the
first batch (a cast from float32 to float64 is exact, so the sums are the
same), so streaming a test set never waits for the card; the finalisers
read them once, in numpy float64.
"""
from __future__ import annotations

import numpy as np
import torch


def confusion_update(cm: torch.Tensor, pred, label) -> torch.Tensor:
    """``cm`` (C, C) plus one batch's counts (metrics.py:71-79): row =
    label, column = prediction. Labels or predictions outside [0, C) (an
    ignore index of -1) are left out. Counted with ``scatter_add_``:
    ``torch.bincount`` on a card reads the largest index back to the host,
    which would make every batch wait."""
    c = cm.shape[0]
    label = torch.as_tensor(label, device=cm.device).reshape(-1).long()
    pred = torch.as_tensor(pred, device=cm.device).reshape(-1).long()
    valid = (label >= 0) & (label < c) & (pred >= 0) & (pred < c)
    idx = torch.where(valid, label * c + pred, c * c)
    flat = torch.zeros(c * c + 1, dtype=torch.int64, device=cm.device)
    flat.scatter_add_(0, idx, torch.ones_like(idx))
    return cm + flat[: c * c].reshape(c, c).to(cm.dtype)


def height_update(stats: torch.Tensor, counts: torch.Tensor, pred, ref,
                  buildhir) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch of the reference's ``HeightMetric.addBatch``
    (metrics.py:186-200): ``stats`` (C, 3) plus each class's [rmse, mae,
    me] of the batch times its pixel count, ``counts`` (C, 1) plus the
    counts; a class absent from the batch adds nothing. In float32."""
    num_class = stats.shape[0]
    pred = torch.as_tensor(pred, device=stats.device).reshape(-1).float()
    ref = torch.as_tensor(ref, device=stats.device).reshape(-1).float()
    cls = torch.as_tensor(buildhir, device=stats.device).reshape(-1)
    mask = cls[None] == torch.arange(num_class, device=stats.device)[:, None]
    count = mask.float().sum(1)
    safe = count.clamp(min=1.0)
    diff = torch.where(mask, (pred - ref)[None], 0.0)
    rows = torch.stack([torch.sqrt((diff * diff).sum(1) / safe),
                        diff.abs().sum(1) / safe, diff.sum(1) / safe], 1)
    return stats + rows * count[:, None], counts + count[:, None]


def _totals(shape, like) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float64, device=torch.as_tensor(like).device)


class SegmentationMetric:
    """Streaming confusion-matrix metrics (metrics.py:6-86)."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.reset()

    def reset(self):
        self.cm = None  # float64 totals on the first batch's device

    def add_batch(self, pred, label):
        c = self.num_class
        if self.cm is None:
            self.cm = _totals((c, c), pred)
        batch = confusion_update(
            torch.zeros((c, c), dtype=torch.float32, device=self.cm.device),
            pred, label)
        self.cm = self.cm + batch.double()

    addBatch = add_batch  # the reference's name

    def confusion_matrix(self) -> np.ndarray:
        if self.cm is None:
            return np.zeros((self.num_class, self.num_class))
        return self.cm.cpu().numpy()

    # 0/0 on an empty class is NaN, as the reference's torch divides give
    def overall_accuracy(self):
        cm = self.confusion_matrix()
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.diag(cm).sum() / cm.sum()

    def precision(self):  # UA (metrics.py:20-24)
        cm = self.confusion_matrix()
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.diag(cm) / cm.sum(axis=0)

    def recall(self):  # PA (metrics.py:26-29)
        cm = self.confusion_matrix()
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.diag(cm) / cm.sum(axis=1)

    def f1(self):
        p, r = self.precision(), self.recall()
        with np.errstate(invalid="ignore", divide="ignore"):
            return 2 * p * r / (p + r)

    def iou(self):
        cm = self.confusion_matrix()
        inter = np.diag(cm)
        union = cm.sum(axis=1) + cm.sum(axis=0) - inter
        with np.errstate(invalid="ignore", divide="ignore"):
            return inter / union

    def miou(self):
        return np.mean(self.iou())

    def fwiou(self):  # per-class frequency-weighted IoU (metrics.py:55-63)
        cm = self.confusion_matrix()
        freq = cm.sum(axis=1) / (cm.sum() + 1e-8)
        iu = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm) + 1e-8)
        return freq * iu

    def mfwiou(self):
        return self.fwiou().sum()


class HeightMetric:
    """Per-hierarchy-class height errors (metrics.py:163-234)."""

    def __init__(self, num_class: int = 7):
        self.num_class = num_class
        self.reset()

    def reset(self):
        self._stats = self._counts = None  # float64, the first batch's device

    def add_batch(self, pred, ref, build_class):
        c = self.num_class
        if self._stats is None:
            self._stats, self._counts = _totals((c, 3), pred), _totals((c, 1), pred)
        dev = self._stats.device
        rows, cnts = height_update(
            torch.zeros((c, 3), dtype=torch.float32, device=dev),
            torch.zeros((c, 1), dtype=torch.float32, device=dev),
            pred, ref, build_class)
        self._stats = self._stats + rows.double()
        self._counts = self._counts + cnts.double()

    addBatch = add_batch

    @property
    def stats(self) -> np.ndarray:
        return (np.zeros((self.num_class, 3)) if self._stats is None
                else self._stats.cpu().numpy())

    def count(self) -> np.ndarray:
        return (np.zeros((self.num_class, 1)) if self._counts is None
                else self._counts.cpu().numpy())

    def avg_each(self):
        return self.stats / (self.count() + 1e-10)

    def avg_balance(self):
        return self.avg_each().mean(axis=0)

    def avg_all(self):
        with np.errstate(invalid="ignore", divide="ignore"):
            return self.stats.sum(axis=0) / self.count().sum()


# metrics.py:89-140 / 238-289 are confusion-matrix classes identical to
# SegmentationMetric but for the IoU family
ClassificationMetric = SegmentationMetric
MultilabelMetric = SegmentationMetric


def plot_confusionmatrix(cm):
    """Console dump of a matrix, 3 decimals, space-separated
    (metrics.py:335-341)."""
    for row in np.asarray(cm):
        print(" ".join(f"{v:.3f}" for v in row))


def accprint(metric: SegmentationMetric):
    """Console dump of the classification metric (metrics.py:292-309): the
    f1 / ua / pa block and the transposed confusion matrix."""
    print("oa, miou, iou, f1, ua, pa, confusion_matrix")
    print()
    plot_confusionmatrix(
        np.vstack([metric.f1(), metric.precision(), metric.recall()]))
    cm = metric.confusion_matrix().T
    plot_confusionmatrix(cm)
    print(f"numtotal: {int(cm.sum())}")


def accprint_seg(metric: SegmentationMetric):
    """Console dump (metrics.py:311-333): oa / miou / iou, f1 / ua / pa,
    the transposed confusion matrix, then the building class's summary."""
    print("oa, miou, iou, f1, ua, pa, confusion_matrix")
    print(f"{metric.overall_accuracy():.3f}")
    print(f"{metric.miou():.3f}")
    print(" ".join(f"{v:.3f}" for v in metric.iou()))
    plot_confusionmatrix(
        np.vstack([metric.f1(), metric.precision(), metric.recall()]))
    cm = metric.confusion_matrix().T
    plot_confusionmatrix(cm)
    print(f"numtotal: {int(cm.sum())}")
    for v in (metric.overall_accuracy(), metric.iou()[1], metric.f1()[1],
              metric.precision()[1], metric.recall()[1]):
        print(f"{v:.3f}")


class AverageMeter:
    """Running value/sum/count/average (metrics.py:143-160)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count
