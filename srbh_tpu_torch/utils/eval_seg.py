"""Segmentation scores on the host (utils/eval_seg.py:3-28): a copy of
``srbh_tpu/utils/eval_seg.py``."""
from __future__ import annotations

import numpy as np


def fast_hist(label_true: np.ndarray, label_pred: np.ndarray,
              num_classes: int) -> np.ndarray:
    """The (true, predicted) confusion counts of labels in range."""
    mask = (label_true >= 0) & (label_true < num_classes)
    return np.bincount(
        num_classes * label_true[mask].astype(int) + label_pred[mask],
        minlength=num_classes**2,
    ).reshape(num_classes, num_classes)


def scores(label_trues, label_preds, num_classes: int = 21) -> dict:
    """Pixel accuracy, mean class accuracy, mean IoU over the classes that
    occur, and each class's IoU (NaN for a class in neither labels nor
    predictions, without a warning)."""
    hist = np.zeros((num_classes, num_classes))
    for lt, lp in zip(label_trues, label_preds):
        hist += fast_hist(lt.flatten(), lp.flatten(), num_classes)
    acc = np.diag(hist).sum() / hist.sum()
    with np.errstate(invalid="ignore", divide="ignore"):
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
    valid = hist.sum(axis=1) > 0
    return {
        "Pixel Accuracy": acc,
        "Mean Accuracy": acc_cls,
        "Mean IoU": np.nanmean(iu[valid]),
        "Class IoU": dict(zip(range(num_classes), iu)),
    }
